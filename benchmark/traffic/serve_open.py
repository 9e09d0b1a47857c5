"""General generator of an open loop of single-utterance requests through
the port's ``serve_daemon.BatchingFrontend``, in process.

The mix's file gives ``rate`` (requests a second, fixed), ``frames``
([lowest, highest] valid length), the front end's ``max_batch``,
``max_wait_ms`` and ``pad_batch``, the ``corpus``, the padded widths set-up
warms (``warm_widths``), the ``sample`` of finished requests the
reference checks, and ``trace_seconds``. Every seed sends the same set of
lengths and inter-arrival gaps (evenly spaced quantiles of the uniform and
exponential laws) in another order; features are slices of one seeded
buffer. A request's latency runs from its scheduled send time to its
result on the host; one that never comes, or fails, counts from its send
time to the end of the wait that follows the window.
"""

import gc
import time

import numpy as np

from benchmark import devtrace, harness, training, weights as weights_mod
from benchmark.reference import common

# seconds past the window's close that the run waits for late answers
LATE_S = 60.0

# the mix's sizes in the CPU tests (benchmark/tests/tiny.py)
TINY = {"rate": 40.0, "frames": [30, 90], "max_batch": 4,
        "warm_widths": [128], "sample": 4, "trace_seconds": 0.2}


def arrivals(rate, count, rng):
    """``count`` send times (s): the gaps are evenly spaced quantiles of an
    exponential law of mean 1 / ``rate``, in a seeded order."""
    quantiles = (np.arange(count) + 0.5) / count
    gaps = rng.permutation(-np.log1p(-quantiles) / rate)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def requests(traffic, seconds, seed, feat_dim):
    """[(send time, features)] of a window of ``seconds`` s at the mix's
    rate."""
    rng = np.random.default_rng([seed % (1 << 63), 3])
    count = max(1, int(round(traffic["rate"] * seconds)))
    low, high = traffic["frames"]
    lengths = rng.permutation(np.round(np.linspace(low, high, count))
                              .astype(np.int64))
    buffer = rng.standard_normal((8 * high, feat_dim), dtype=np.float32)
    starts = rng.integers(0, len(buffer) - high, size=count)
    times = arrivals(traffic["rate"], count, rng)
    return [(float(t), buffer[s:s + n])
            for t, s, n in zip(times, starts, lengths)]


class Calls:
    """The benchmark's proxy around the Recognizer's batch call: times
    each call and notes its rows (for the per-layer metrics and for the
    padded width each request was served at)."""

    def __init__(self, rec):
        self.inner = rec.transcribe_batch_detailed
        self.log = []
        rec.transcribe_batch_detailed = self

    def __call__(self, feats_list, **kwargs):
        import torch

        start = time.perf_counter()
        with devtrace.annotate(torch, "bench.recognizer_call"):
            out = self.inner(feats_list, **kwargs)
        self.log.append((start, time.perf_counter(),
                         [f.shape[0] for f in feats_list],
                         [id(f) for f in feats_list]))
        return out


def send(frontend, traffic, plan):
    """Sends ``plan`` on its schedule; returns (start, futures, done times,
    how late the sender ran at most)."""
    done = [None] * len(plan)
    futures, late = [], 0.0
    start = time.perf_counter()
    for i, (due, feats) in enumerate(plan):
        wait = start + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - start - due)
        fut = frontend.submit(feats, corpus=traffic["corpus"], detailed=True)
        fut.add_done_callback(
            lambda _, i=i: done.__setitem__(i, time.perf_counter()))
        futures.append(fut)
    return start, futures, done, late


def settle(plan, start, futures, done, close):
    """Latencies (s) of every request, and how many failed or never came
    (those count to ``close``)."""
    latencies, failed = [], 0
    for i, ((due, _), fut) in enumerate(zip(plan, futures)):
        try:
            fut.result(timeout=max(0.0, close - time.perf_counter()))
            while done[i] is None:  # its callback runs just after
                time.sleep(1e-4)
            end = done[i]
        except Exception:  # a failed or missing answer counts as missing
            failed += 1
            end = close
        latencies.append(end - start - due)
    return latencies, failed


def warm_up(frontend, traffic, feat_dim, seed):
    """Every padded width the traffic can produce, through the front end,
    one request a batch (padded to its batch as the window's are). cuDNN's
    algorithm choices (``cudnn.benchmark``) are kept per thread, so the
    widths are warmed in the thread that serves the window, the front
    end's worker."""
    rng = np.random.default_rng([seed % (1 << 63), 4])
    for width in traffic["warm_widths"]:
        frontend.submit(rng.standard_normal((width, feat_dim),
                                            dtype=np.float32),
                        corpus=traffic["corpus"],
                        detailed=True).result(timeout=LATE_S)


def check(torch, ctx, plan, futures, calls, device):
    """The widest gap by which a served symbol's logit lies below the
    reference's best, over a seeded sample of the finished requests with
    the longest among them, each at the padded width it was served at; and
    the tokens checked."""
    cfg, traffic, family = ctx.model, ctx.traffic, ctx.family
    width_of = {}
    for _, _, lengths, ids in calls.log:
        width = -(-max(lengths) // 128) * 128
        for ident in ids:
            width_of[ident] = width
    finished = [i for i, fut in enumerate(futures)
                if fut.done() and fut.exception() is None]
    rng = np.random.default_rng([ctx.seed % (1 << 63), 5])
    longest = max(finished, key=lambda i: plan[i][1].shape[0])
    others = [i for i in finished if i != longest]
    picked = [longest] + list(rng.choice(
        others, size=min(traffic["sample"] - 1, len(others)), replace=False))
    params = weights_mod.make(family.param_shapes(cfg), ctx.seed, device)
    blank = cfg["class_n"] - 1
    widest, tokens = 0.0, 0
    by_width = {}
    for i in picked:
        by_width.setdefault(width_of[id(plan[i][1])], []).append(i)
    common.tf32(False)
    with torch.no_grad():
        for width, rows in sorted(by_width.items()):
            feats = np.zeros((len(rows), width, cfg["feat_dim"]), np.float32)
            lengths = []
            for r, i in enumerate(rows):
                utt = plan[i][1]
                feats[r, :len(utt)] = utt
                lengths.append(len(utt))
            x = torch.from_numpy(feats).to(device)
            n = torch.tensor(lengths)
            logits = family.forward(params, x, n, cfg).double().cpu()
            for r, i in enumerate(rows):
                frames = max(lengths[r] // family.subsample(cfg), 1)
                served = futures[i].result()
                ids, starts = served["ids"], served["frames"]
                gap = common.served_gaps(logits[r], ids, starts, frames,
                                         blank)
                widest = max(widest, float(gap.max()))
                tokens += len(ids)
    return widest, tokens


def run(ctx):
    import torch
    from srf_tpu_torch.serve import Recognizer
    from srf_tpu_torch.serve_daemon import BatchingFrontend

    device, traffic, cfg, family = (ctx.device, ctx.traffic, ctx.model,
                                    ctx.family)
    config = training.parse_config(ctx, device)
    params = weights_mod.make(family.param_shapes(cfg), ctx.seed, device)
    rec = Recognizer(config, state_dict=params, device=device)
    del params
    calls = Calls(rec)
    frontend = BatchingFrontend(rec, max_batch=traffic["max_batch"],
                                max_wait_ms=traffic["max_wait_ms"],
                                pad_batch=traffic["pad_batch"])
    plan = requests(traffic, ctx.seconds, ctx.seed, cfg["feat_dim"])
    traced_plan = (requests(traffic, traffic["trace_seconds"], ctx.seed + 1,
                            cfg["feat_dim"]) if ctx.trace else [])
    try:
        warm_up(frontend, traffic, cfg["feat_dim"], ctx.seed)
        calls.log.clear()
        frontend.stats["batch_sizes"].clear()
        setup_s = harness.end_setup(ctx)

        start, futures, done, late = send(frontend, traffic, plan)
        close = start + ctx.seconds + LATE_S
        latencies, failed = settle(plan, start, futures, done, close)
        window_calls = list(calls.log)
        sizes = list(frontend.stats["batch_sizes"])
        window = None
        if ctx.trace:
            window = devtrace.profiled(torch, lambda: _traced(
                frontend, traffic, traced_plan), device != "cpu")
        traced_calls = calls.log[len(window_calls):]
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device != "cpu" else 0)
    finally:
        frontend.close()
    record = {
        "cfg": cfg, "max_batch": traffic["max_batch"], "batch_sizes": sizes,
        "calls": window_calls, "profile": window,
        "profile_calls": traced_calls,
        "sender_late_s": late,
        "flops": sum(family.forward_flops(1, n, cfg)
                     for _, _, lengths, _ in window_calls
                     for n in lengths[:_real(lengths)]),
    }
    del rec.model
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    widest, tokens = check(torch, ctx, plan, futures, calls, device)
    ms = [1e3 * x for x in latencies]
    return {
        "e2e": {"serve_p95_ms": harness.percentile(ms, 95),
                "serve_p50_ms": harness.percentile(ms, 50),
                "setup_s": setup_s},
        "attempted": len(plan), "failed": failed,
        "numbers": {"token_gap": widest},
        "where": dict({"tokens_checked": tokens, "sender_late_s": late,
                       "p99_ms": harness.percentile(ms, 99),
                       "max_ms": max(ms),
                       "slowest_at_s": plan[int(np.argmax(ms))][0]},
                      **call_times(window_calls, start)),
        "record": record, "window": window, "memory_peak": memory_peak,
        "count": 1,
    }


def call_times(log, start):
    """Where a slow request's time went: the slowest call into the
    Recognizer (ms, its start in the window, its padded width) and the
    longest wait between the end of one call and the start of the next
    (ms)."""
    if not log:
        return {}
    slow = max(log, key=lambda call: call[1] - call[0])
    gaps = [b[0] - a[1] for a, b in zip(log, log[1:])]
    return {"slowest_call_ms": 1e3 * (slow[1] - slow[0]),
            "slowest_call_at_s": slow[0] - start,
            "slowest_call_width": -(-max(slow[2]) // 128) * 128,
            "widest_gap_ms": 1e3 * max(gaps, default=0.0)}


def _real(lengths):
    """Rows of a call that are requests (the front end pads its batch with
    16-frame dummies after them)."""
    real = len(lengths)
    while real > 1 and lengths[real - 1] == 16:
        real -= 1
    return real


def _traced(frontend, traffic, plan):
    """The traced window's own requests, on their schedule, all answered
    before it closes."""
    start, futures, done, _ = send(frontend, traffic, plan)
    for fut in futures:
        fut.result(timeout=LATE_S)
    return start

