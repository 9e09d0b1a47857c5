"""General generator of a bucketed training mix on one card.

The mix's file gives ``buckets`` ([batch, padded width, lowest, highest
valid length] each), ``pool`` (distinct host batches a bucket) and
``label_rate`` (labels a valid frame), and may give ``host_threads``, the
intra-op threads of the run's CPU operators (torch's default, a thread a
core, where it gives none). Steps rotate over the buckets in a seeded
order; see ``benchmark/training.py``.
"""

import gc
import time

from benchmark import devtrace, harness, training, weights as weights_mod

# the mix's sizes in the CPU tests (benchmark/tests/tiny.py)
TINY = {"buckets": [[3, 41, 24, 41], [2, 61, 42, 61]], "pool": 2,
        "trace_seconds": 0.2}


def run(ctx):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(ctx.traffic.get("host_threads", threads))
    try:
        return _run(ctx, torch)
    finally:
        torch.set_num_threads(threads)


def _run(ctx, torch):
    device, cfg, family = ctx.device, ctx.model, ctx.family
    shapes = family.param_shapes(cfg)
    initial = weights_mod.make(shapes, ctx.seed, device)
    state, step, _ = training.build_program(ctx, device, initial)
    trained = set(family.trained_names(cfg))
    initial = {k: v for k, v in initial.items() if k in trained}
    pools = training.make_pools(ctx.traffic, family, cfg, ctx.seed)
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
        torch, family, cfg, ctx.config["optimizer"],
        weights_mod.make(shapes, ctx.seed, device), checked, ctx.seed, device)
    numbers, where = training.compare(prog_losses, prog_first, prog_change,
                                      ref)
    return {
        "e2e": {"train_frames_per_s": frames / seconds, "setup_s": setup_s},
        "attempted": steps, "failed": failed, "numbers": numbers,
        "where": where, "record": record, "window": window,
        "memory_peak": memory_peak, "count": 1,
    }
