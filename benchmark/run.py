"""The benchmark of srf_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, makes its weights and inputs
from ``--seed``, warms up every shape the cell's traffic uses (set-up),
measures for ``--seconds`` seconds, checks what the timed path produced
against the plain reference in ``benchmark/reference/``, and prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error). It needs a CUDA card (as many as the cell asks for) and
exits non-zero without one, or when a JAX module was loaded.
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

from benchmark import faults, harness  # noqa: E402


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def checks_of(ctx, numbers):
    """{name: {"value", "limit"}} of the compared numbers; a number with no
    limit in the cell's limits file is an error."""
    out = {}
    for name, value in numbers.items():
        out[name] = {"value": value, "limit": ctx.limits[name]["limit"]}
    return out


def result_line(ctx, outcome):
    """The result's JSON object (without ``device``) and its checks."""
    checks = checks_of(ctx, outcome["numbers"])
    correct = (outcome["failed"] == 0 and bool(checks) and all(
        harness.finite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    if ctx.trace:
        metrics = {}
        for metric, module in harness.per_layer_metrics(ctx):
            value = module.read(outcome["record"])
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    else:
        # "<quantity>.<suffix>" is the generator's <quantity>, split by
        # cell so that each regime keeps a bound of its own
        units = {m["name"]: m["unit"] for m in ctx.spec["end_to_end"]}
        metrics = {name: {"value": outcome["e2e"][name.split(".")[0]],
                          "unit": units[name]}
                   for name in harness.end_to_end_names(ctx)}
    line = {"correct": correct, "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics}
    return line, checks


def run(ctx):
    """Runs the cell; returns (result object, checks)."""
    import torch

    undo = faults.install(ctx.faults)
    try:
        outcome = harness.generator(ctx.traffic).run(ctx)
    finally:
        undo()
    line, checks = result_line(ctx, outcome)
    window = outcome.get("window")
    if ctx.device == "cpu":
        line["device"] = {"platform": "cpu", "count": 0,
                          "memory_peak_bytes": 0}
    else:
        line["device"] = harness.device_line(
            torch, outcome["count"], outcome["memory_peak"],
            outcome.get("busy_s", window.busy_s() if window else None),
            outcome.get("window_s", window.seconds if window else None))
    if ctx.trace and window is not None:
        line["breakdown"] = window.breakdown()
    line["where"] = outcome.get("where", {})
    line["checks"] = checks
    return line, checks


def main(argv=None):
    started = harness.process_start()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    harness.cache_dirs(harness.ROOT)
    ctx = harness.load_context(args.workload, args.seed, args.seconds,
                               bool(args.trace), started=started)
    import torch

    chips = ctx.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write("the cell needs %d CUDA card(s); this machine has "
                         "%d\n" % (chips, torch.cuda.device_count()
                                   if torch.cuda.is_available() else 0))
        return 2
    line, checks = run(ctx)
    found = harness.forbidden_loaded()
    if found:
        sys.stderr.write("forbidden modules loaded: %s\n" % ", ".join(found))
        return 3
    for name, check in checks.items():
        sys.stderr.write("check %s %.6g limit %.6g\n"
                         % (name, check["value"], check["limit"]))
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
