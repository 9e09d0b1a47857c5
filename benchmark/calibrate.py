"""The readings the limits in ``benchmark/limits/`` are set from: one line
of JSON a seed and kind, on the card at the cell's own sizes.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --kinds sound,control,half_batch

Training cells (the first three updates, as a run checks them):

- ``sound``: the program's checked updates against the reference (one
  card; a data-parallel cell's sound readings come from its runs);
- ``control``: the reference in TF32 in the program's place;
- ``half_batch``: the reference on the first half of each batch's rows,
  their mean, in the program's place;
- ``short_update``: the program with its updates a tenth short
  (``benchmark/faults.py``).

A state left unchanged reads 1 on ``grad`` and ``change`` by construction
and needs no run. Serving cells: ``control``, the widest gap below the
reference's best logit of the symbols greedy decoding of the reference in
TF32 puts first, over the seed's sample of requests at their own padded
widths. No benchmark run calls this.
"""

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):
    # run as a script: import the benchmark as a package from the checkout
    # (the script's own folder first on the path would shadow the standard
    # library's modules with the benchmark's)
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
    sys.path.insert(0, os.path.dirname(_HERE))

from benchmark import faults, harness, training  # noqa: E402
from benchmark import weights as weights_mod  # noqa: E402
from benchmark.reference import common  # noqa: E402
from benchmark.traffic import serve_open  # noqa: E402


def checked_steps(ctx):
    """The host batches of the first three updates."""
    batches = training.host_batches(
        training.make_pools(ctx.traffic, ctx.family, ctx.model, ctx.seed),
        training.schedule(ctx.traffic, ctx.seed))
    return [next(batches) for _ in range(training.CHECKED_STEPS)]


def halved(steps):
    keys = ("feats", "labels", "inp_len", "tar_len")
    return [{k: b[k][:b["feats"].shape[0] // 2] for k in keys}
            for b in steps]


def program_readings(torch, ctx, device):
    """The program's first three updates, as a run's set-up takes them."""
    cfg, family = ctx.model, ctx.family
    initial = weights_mod.make(family.param_shapes(cfg), ctx.seed, device)
    state, step, _ = training.build_program(ctx, device, initial)
    trained = set(family.trained_names(cfg))
    initial = {k: v for k, v in initial.items() if k in trained}
    feed = training.Feed(training.make_pools(ctx.traffic, family, cfg,
                                             ctx.seed),
                         training.schedule(ctx.traffic, ctx.seed), device)
    losses = []
    for i in range(training.CHECKED_STEPS):
        _, loss_sum, samples = training.take_step(state, step, feed,
                                                  ctx.seed)
        losses.append(float(loss_sum / samples))
        if i == 0:
            first = {k: float(v) for k, v in training.program_readings(
                state, initial, torch).items()}
    change = {k: float(v) for k, v in training.change_norms(
        state, initial, torch).items()}
    feed.close()
    del state, step, feed
    gc.collect()
    torch.cuda.empty_cache()
    return losses, first, change


def train_kinds(torch, ctx, kinds, device):
    steps = checked_steps(ctx)
    args = (torch, ctx.family, ctx.model, ctx.config["optimizer"],
            weights_mod.make(ctx.family.param_shapes(ctx.model), ctx.seed,
                             device))
    ref = training.reference_readings(*args, steps, ctx.seed, device)
    for kind in kinds:
        start = time.perf_counter()
        if kind == "sound":
            got = program_readings(torch, ctx, device)
        elif kind == "short_update":
            undo = faults.install(["short_update"])
            try:
                got = program_readings(torch, ctx, device)
            finally:
                undo()
        elif kind == "control":
            got = training.reference_readings(*args, steps, ctx.seed, device,
                                              control=True)
        elif kind == "half_batch":
            got = training.reference_readings(*args, halved(steps),
                                              ctx.seed, device)
        numbers, where = training.compare(*got, ref)
        yield kind, numbers, where, time.perf_counter() - start


def serve_control(torch, ctx, device):
    cfg, family = ctx.model, ctx.family
    plan = serve_open.requests(ctx.traffic, 1.0 * ctx.seconds, ctx.seed,
                               cfg["feat_dim"])
    rng = np.random.default_rng([ctx.seed, 5])
    longest = max(range(len(plan)), key=lambda i: len(plan[i][1]))
    picked = [longest] + list(rng.choice(len(plan), ctx.traffic["sample"]
                                         - 1, replace=False))
    params = weights_mod.make(family.param_shapes(cfg), ctx.seed, device)
    blank, widest, tokens = cfg["class_n"] - 1, 0.0, 0
    with torch.no_grad():
        for i in picked:
            utt = plan[i][1]
            width = -(-len(utt) // 128) * 128
            x = torch.zeros((1, width, cfg["feat_dim"]), device=device)
            x[0, :len(utt)] = torch.from_numpy(utt).to(device)
            n = torch.tensor([len(utt)])
            common.tf32(False)
            exact = family.forward(params, x, n, cfg)[0].double().cpu()
            common.tf32(True)
            low = family.forward(params, x, n, cfg)[0].cpu()
            common.tf32(False)
            frames = max(len(utt) // family.subsample(cfg), 1)
            ids, starts = common.greedy(low, frames, blank)
            gap = common.served_gaps(exact, ids, starts, frames, blank)
            widest, tokens = max(widest, float(gap.max())), tokens + len(ids)
    return {"token_gap": widest}, {"tokens_checked": tokens}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--kinds", default="sound,control,half_batch")
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)
    harness.cache_dirs(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("calibration needs a CUDA card\n")
        return 2
    kinds = args.kinds.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.load_context(args.workload, seed, args.seconds, False)
        if ctx.traffic["generator"] == "serve_open":
            numbers, where = serve_control(torch, ctx, "cuda")
            print(json.dumps({"seed": seed, "kind": "control",
                              "numbers": numbers, "where": where}),
                  flush=True)
            continue
        for kind, numbers, where, seconds in train_kinds(torch, ctx, kinds,
                                                         "cuda"):
            print(json.dumps({"seed": seed, "kind": kind,
                              "numbers": numbers, "where": where,
                              "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
