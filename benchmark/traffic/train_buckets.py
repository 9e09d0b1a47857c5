"""General generator of a bucketed training mix on one card.

The mix's file gives ``buckets`` ([batch, padded width, lowest, highest
valid length] each), ``pool`` (distinct host batches a bucket) and
``label_rate`` (labels a valid frame). Steps rotate over the buckets in a
seeded order; see ``benchmark/training.py``.
"""

import gc
import time

from benchmark import devtrace, harness, training, weights as weights_mod
from benchmark.reference import srf as reference


def run(ctx):
    import torch

    device = ctx.device
    cfg = ctx.model
    initial = weights_mod.make(cfg, ctx.seed, device)
    state, step, _ = training.build_program(ctx, device, initial)
    trained = set(reference.trained_names(cfg))
    initial = {k: v for k, v in initial.items() if k in trained}
    pools = training.make_pools(ctx.traffic, cfg, ctx.seed)
    order = training.schedule(ctx.traffic, ctx.seed)
    feed = training.Feed(pools, order, device)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    # set-up: the checked updates, then the rest of two rotations
    losses, checked = [], []
    for i in range(training.setup_steps(ctx.traffic)):
        batch, loss_sum, samples = training.take_step(state, step, feed,
                                                      ctx.seed)
        if i < training.CHECKED_STEPS:
            checked.append(batch)
            losses.append(loss_sum / samples)
        if i == 0:
            first = training.program_readings(state, initial, torch)
        if i == training.CHECKED_STEPS - 1:
            change = training.change_norms(state, initial, torch)
    sync()
    setup_s = harness.end_setup(ctx)

    deadline = time.perf_counter() + ctx.seconds
    seconds, steps, frames, flops, _, window_losses = training.run_window(
        torch, state, step, feed, ctx.seed,
        lambda: time.perf_counter() < deadline, device)
    record = {"window_s": seconds, "steps": steps, "frames": frames,
              "flops": flops, "cfg": cfg}
    window = None
    if ctx.trace:
        trace_end = [0.0]

        def traced():
            trace_end[0] = time.perf_counter() + ctx.traffic["trace_seconds"]
            return training.run_window(
                torch, state, step, feed, ctx.seed,
                lambda: time.perf_counter() < trace_end[0], device)

        window = devtrace.profiled(torch, traced, device != "cpu")
        record["profile"] = window
        record["profile_batches"] = window.info[4]
    failed = training.nonfinite(torch, window_losses)
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)

    prog_losses = [float(x) for x in torch.stack(losses).cpu()]
    prog_first = {k: float(v) for k, v in first.items()}
    prog_change = {k: float(v) for k, v in change.items()}
    feed.close()
    del state, step, feed, pools, first, change, losses, window_losses
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    ref = training.reference_readings(
        torch, cfg, ctx.config["optimizer"],
        weights_mod.make(cfg, ctx.seed, device), checked, ctx.seed, device)
    numbers, where = training.compare(prog_losses, prog_first, prog_change,
                                      ref)
    return {
        "e2e": {"train_frames_per_s": frames / seconds, "setup_s": setup_s},
        "attempted": steps, "failed": failed, "numbers": numbers,
        "where": where, "record": record, "window": window,
        "memory_peak": memory_peak, "count": 1,
    }
