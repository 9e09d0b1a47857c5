"""The sweep that found the rate a serving cell's traffic file fixes: the
cell's set-up once, then one open-loop window at each rate.

    python3 benchmark/sweep_serve.py --workload srf_wsj.serve \\
        --rates 50,100,150 --seconds 20 --seed 1

Prints one JSON line a rate: requests sent and completed a second, p50
and p95 latency (ms), the mean batch, and the backlog's growth: the median
latency of the window's last quarter of requests over its first quarter's
(about 1 while the system keeps up; growing with the window past the
knee). No benchmark run calls this.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    # run as a script: import the benchmark as a package from the checkout
    # (the script's own folder first on the path would shadow the standard
    # library's modules with the benchmark's)
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
    sys.path.insert(0, os.path.dirname(_HERE))

from benchmark import harness, training, weights as weights_mod  # noqa: E402
from benchmark.traffic import serve_open  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    harness.cache_dirs(harness.ROOT)
    from srf_tpu_torch.serve import Recognizer
    from srf_tpu_torch.serve_daemon import BatchingFrontend

    ctx = harness.load_context(args.workload, args.seed, args.seconds, False)
    cfg, traffic = ctx.model, dict(ctx.traffic)
    rec = Recognizer(training.parse_config(ctx, "cuda"),
                     state_dict=weights_mod.make(
                         ctx.family.param_shapes(cfg), args.seed, "cuda"),
                     device="cuda")
    frontend = BatchingFrontend(rec, max_batch=traffic["max_batch"],
                                max_wait_ms=traffic["max_wait_ms"],
                                pad_batch=traffic["pad_batch"])
    try:
        serve_open.warm_up(frontend, traffic, cfg["feat_dim"], args.seed)
        for rate in (float(r) for r in args.rates.split(",")):
            traffic["rate"] = rate
            plan = serve_open.requests(traffic, args.seconds, args.seed,
                                       cfg["feat_dim"])
            frontend.stats["batch_sizes"].clear()
            start, futures, done, late = serve_open.send(frontend, traffic,
                                                         plan)
            latencies, failed = serve_open.settle(
                plan, start, futures, done,
                start + args.seconds + serve_open.LATE_S)
            end = max(d for d in done if d is not None)
            ms = [1e3 * x for x in latencies]
            quarter = max(1, len(ms) // 4)
            sizes = frontend.stats["batch_sizes"]
            print(json.dumps({
                "rate": rate, "sent": len(plan), "failed": failed,
                "completed_per_s": (len(plan) - failed) / (end - start),
                "p50_ms": harness.percentile(ms, 50),
                "p95_ms": harness.percentile(ms, 95),
                "mean_batch": sum(sizes) / max(1, len(sizes)),
                "backlog_growth": harness.percentile(ms[-quarter:], 50)
                / harness.percentile(ms[:quarter], 50),
                "sender_late_s": late}), flush=True)
    finally:
        frontend.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
