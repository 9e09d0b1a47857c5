"""The training cells' shared parts: the program's train step built as the
trainer builds it, the host batches of a bucketed traffic mix, the
measured window, and the check of the first three steps against the
reference.

The window drives host batches through the port's ``train/loop.py``
``device_prefetch`` into the step that ``train/step.py``
``make_train_step`` returns, as ``trainer_sr``'s loop does. Set-up drives
that same step through its first updates, on the window's feed: the first
three are the checked steps, the rest of two rotations over the buckets
warm every shape the window meets.
"""

import math
import time

import numpy as np

from benchmark.reference import common

CHECKED_STEPS = 3


def setup_steps(traffic):
    """Updates set-up takes: the checked ones, and at least two rotations
    over the buckets (a shape's first step searches cuDNN's algorithms, its
    second runs as the window's will)."""
    return max(CHECKED_STEPS, 2 * len(traffic["buckets"]))


def parse_config(ctx, device, logger_level=40):
    """The port's parsed configuration of the cell's argv on ``device``."""
    from srf_tpu_torch.config import Logger, ParseOption

    logger = Logger(name="benchmark", level=logger_level).logger
    argv = ["benchmark"] + list(ctx.config["argv"]) + [
        "--path-base=%s" % ctx.root, "--device=%s" % device]
    return ParseOption(argv, logger, is_print_opts=False).args


def build_program(ctx, device, weights, group=None):
    """(state, train_step, in_len_div): the program's model with
    ``weights``, its BatchNorm over ``group``, Adam under the Noam schedule
    resumed at the configuration's ``start_count``, and its train step."""
    from srf_tpu_torch.models.layers import set_batch_norm_group
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.train import step as step_mod
    from srf_tpu_torch.train.optimizer import get_optimizer
    from srf_tpu_torch.train.state import TrainState

    config = parse_config(ctx, device)
    model, in_len_div = build_model(config, ctx.model["class_n"])
    if group is not None:
        set_batch_norm_group(model, group)
    state = TrainState.create(model, None, None, device=device)
    state.model.load_state_dict(weights, strict=True)
    optimizer, scheduler = get_optimizer(config, state.model.parameters())
    start = ctx.config["optimizer"]["start_count"]
    scheduler.last_epoch = start
    for group_ in optimizer.param_groups:
        group_["lr"] = scheduler.lr_lambdas[0](start)
    state.optimizer, state.scheduler, state.step = optimizer, scheduler, start
    apply_fn = step_mod.make_apply_fn(state.model)
    train_step = step_mod.make_train_step(apply_fn, in_len_div, group=group)
    return state, train_step, in_len_div


def make_pools(traffic, family, cfg, seed):
    """[bucket][pool index] host batches of the mix: every seed gets the
    same valid lengths (evenly spaced over each bucket's range) in another
    order, random features and labels at the mix's label rate, kept
    feasible for CTC at the ``family``'s subsampling. Each batch is a dict
    of numpy arrays (``feats``, ``labels``, ``inp_len``, ``tar_len``) plus
    ``frames`` (valid frames) and ``flops`` (the family's model FLOPs of a
    train step over its valid frames)."""
    rng = np.random.default_rng([seed % (1 << 63), 0, 1])
    pool_n, rate = traffic["pool"], traffic["label_rate"]
    feat_dim, div = cfg["feat_dim"], family.subsample(cfg)
    pools = []
    for batch, width, low, high in traffic["buckets"]:
        lengths = np.round(np.linspace(low, high, batch * pool_n)).astype(
            np.int64)
        lengths = rng.permutation(lengths).reshape(pool_n, batch)
        pool = []
        for rows in lengths:
            feats = np.zeros((batch, width, feat_dim), np.float32)
            label_n = np.maximum(1, np.round(rows * rate)).astype(np.int64)
            labels = np.zeros((batch, int(label_n.max())), np.int32)
            for i, n in enumerate(rows):
                rng.standard_normal(out=feats[i, :n], dtype=np.float32)
                labels[i, :label_n[i]] = rng.integers(
                    1, cfg["class_n"] - 1, size=label_n[i])
                repeats = int((labels[i, 1:label_n[i]]
                               == labels[i, :label_n[i] - 1]).sum())
                if label_n[i] + repeats > math.ceil(n / div):
                    raise ValueError("infeasible labels for %d frames" % n)
            pool.append({
                "feats": feats, "labels": labels,
                "inp_len": rows.astype(np.int32),
                "tar_len": label_n.astype(np.int32),
                "frames": int(rows.sum()),
                "flops": sum(family.train_step_flops(1, int(n), cfg)
                             for n in rows),
            })
        pools.append(pool)
    return pools


def schedule(traffic, seed):
    """The bucket of every step: rotations over the buckets, each in a
    seeded order, so that the buckets take equal shares."""
    rng = np.random.default_rng([seed % (1 << 63), 2])
    count = len(traffic["buckets"])
    while True:
        yield from (int(b) for b in rng.permutation(count))


def host_batches(pools, order):
    """The host batch of every step: each bucket cycles through its
    pool."""
    used = [0] * len(pools)
    for bucket in order:
        batch = pools[bucket][used[bucket] % len(pools[bucket])]
        used[bucket] += 1
        yield batch


class Feed:
    """The window's feed: host batches through ``device_prefetch``; keeps
    each step's host batch for the counts."""

    def __init__(self, pools, order, device):
        import torch
        from srf_tpu_torch.train.loop import device_prefetch

        self.current = None
        self._prefetch = device_prefetch(self._host(pools, order),
                                         torch.device(device))

    def _host(self, pools, order):
        for batch in host_batches(pools, order):
            self.current = batch
            yield {k: batch[k] for k in ("feats", "labels", "inp_len",
                                         "tar_len")}

    def __next__(self):
        return next(self._prefetch)

    def close(self):
        self._prefetch.close()


def take_step(state, step, feed, seed):
    """One update on the feed's next batch; returns (host batch, loss sum,
    samples) with the two metrics still on the device."""
    batch = next(feed)
    _, metrics = step(state, batch, seed)
    return feed.current, metrics["loss_sum"], metrics["samples"]


def program_readings(state, initial, torch):
    """Device tensors of the program after its first update: the first
    gradient's norm per trained leaf as Adam got it (its first moment over
    1 - beta1; none where Adam holds no moment for it)."""
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, param in state.model.named_parameters():
        if name in initial:
            moment = state.optimizer.state[param].get("exp_avg")
            out[name] = (torch.zeros(()) if moment is None else
                         torch.linalg.vector_norm(moment) / (1 - beta1))
    return out


def change_norms(state, initial, torch):
    """Device tensors: each trained leaf's distance from its start."""
    return {name: torch.linalg.vector_norm(param.detach() - initial[name])
            for name, param in state.model.named_parameters()
            if name in initial}


def run_window(torch, state, step, feed, seed, keep_going, device):
    """Steps until ``keep_going()`` says stop, ending in a synchronize.
    Returns (seconds, steps, frames, flops, host batches, loss sums) with
    the sums still on the device."""
    from benchmark.devtrace import annotate

    batches, losses = [], []
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    start = time.perf_counter()
    while True:
        with annotate(torch, "bench.step"):
            batch, loss, _ = take_step(state, step, feed, seed)
        batches.append(batch)
        losses.append(loss)
        if not keep_going():
            break
    sync()
    seconds = time.perf_counter() - start
    return (seconds, len(batches), sum(b["frames"] for b in batches),
            sum(b["flops"] for b in batches), batches, losses)


def nonfinite(torch, losses):
    """How many of the loss sums are not finite (one read)."""
    if not losses:
        return 0
    values = torch.stack(losses).double().cpu()
    return int((~torch.isfinite(values)).sum())


def reference_readings(torch, family, cfg, opt, weights, steps, seed,
                       device, control=False):
    """The ``family``'s reference's three updates from ``weights`` over
    ``steps`` (host batches): (losses, first gradient norms, change norms
    after the three), as floats by leaf. ``control`` computes in TF32."""
    common.tf32(control)
    trained = family.trained_names(cfg)
    params = {k: v.detach().clone() for k, v in weights.items()}
    for name in trained:
        params[name].requires_grad_(True)
    adam = common.Adam({k: params[k] for k in trained}, opt,
                       opt["start_count"])
    losses, first = [], None
    for i, batch in enumerate(steps):
        feats = torch.from_numpy(batch["feats"]).to(device)
        lengths = torch.from_numpy(batch["inp_len"])
        labels = torch.from_numpy(batch["labels"]).to(device)
        tar_len = torch.from_numpy(batch["tar_len"])
        drop = common.Dropout(torch.Generator(device).manual_seed(
            common.dropout_seed(seed, opt["start_count"] + i)))
        logits = family.forward(params, feats, lengths, cfg, drop,
                                training=True)
        per_utt = common.ctc_losses(logits, lengths, labels, tar_len,
                                    family.subsample(cfg), cfg["class_n"] - 1)
        loss = per_utt.sum() / feats.shape[0]
        grads = torch.autograd.grad(loss, [params[k] for k in trained])
        del logits, per_utt
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g))
                     for k, g in zip(trained, grads)}
        adam.step(dict(zip(trained, grads)))
        losses.append(float(loss.detach()))
        del grads
    change = {k: float(torch.linalg.vector_norm(params[k].detach()
                                                - weights[k]))
              for k in trained}
    common.tf32(False)
    return losses, first, change


def gaps(program, reference_, exclude=()):
    """The worst leaf's gap between two {leaf: norm} readings, against the
    reference leaf's norm or the median leaf's, whichever is larger."""
    keys = [k for k in reference_ if k not in exclude]
    median = float(np.median([reference_[k] for k in keys]))
    worst, where = 0.0, None
    for key in keys:
        gap = abs(program[key] - reference_[key]) / max(reference_[key],
                                                        median)
        if gap > worst or where is None:
            worst, where = gap, key
    return worst, where


def compare(prog_losses, prog_first, prog_change, ref):
    """The four numbers the training cells compare: the first update's
    relative loss gap, the worst leaf's first-gradient gap, and the worst
    and the median leaf's change gaps after the three, leaving out of the
    change the leaves whose reference gradient is under a thousandth of the
    median leaf's (their Adam moves are round-off). The worst leaf holds a
    state left unchanged (it reads 1); the median leaf holds the update
    itself, which the worst leaf's round-off noise hides. The later
    updates' loss gaps are noise, not a reading: Adam with eps 1e-9 turns a
    round-off difference in a near-zero gradient into a full step of either
    sign, and the later losses carry it (PERF.md). Returns ({name: value},
    {what the readings rest on})."""
    ref_losses, ref_first, ref_change = ref
    steps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)]
    median = float(np.median(list(ref_first.values())))
    still = [k for k, v in ref_first.items() if v < 1e-3 * median]
    grad, grad_at = gaps(prog_first, ref_first)
    change, change_at = gaps(prog_change, ref_change, exclude=still)
    return ({"loss": steps[0], "grad": grad, "change": change,
             "change_median": _median_gap(prog_change, ref_change, still)},
            {"grad": grad_at, "change": change_at, "left_out": still,
             "loss_steps": steps,
             "grad_median": _median_gap(prog_first, ref_first)})


def _median_gap(program, reference_, exclude=()):
    """The median leaf's gap (the measure of :func:`gaps`)."""
    keys = [k for k in reference_ if k not in exclude]
    scale = float(np.median([reference_[k] for k in keys]))
    return float(np.median([abs(program[k] - reference_[k])
                            / max(reference_[k], scale) for k in keys]))
