#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (srf_tpu_torch), one GPU.

    python3 chip_smoke.py        # from the root of a checkout, no arguments

Imports nothing of JAX or srf_tpu. Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving and training paths from csrc/
   with nvcc (one process per source, all started together);
3. K1 (SDR forward) against its plain PyTorch version on the same CUDA
   tensors, at the three canonical SRF-TIMIT capsule-layer geometries, at
   the serving path's two shapes (B=29, T'=64: 29 x 241 frames padded to
   256; B=8, T'=128), at the unpadded bucket (T'=61) and at an odd B/T with
   2 routing iterations and the PAD mask flipped; kernel and plain times
   from CUDA events at B=29, T'=64;
4. K2 (the fused SDR backward) against its plain PyTorch version on the
   same CUDA tensors, at the three geometries at B=29 with T'=64 and T'=61
   (the training path's shape), and at an odd B/T with the PAD mask
   flipped; kernel and plain times from CUDA events at B=29, T'=61;
5. the serving path: a Recognizer at the canonical SRF-TIMIT width (L=7,
   PH=60, PD=8, CH=30, CD=8, VD=8, window 1+1+1, SDR, 1 iteration, naive,
   63 classes, 2 x 64-filter maxout convs) with random weights drawn from a
   numpy seed as the flax tree and carried across by convert.py, serving
   8 requests of 150-400 frames and 29 requests of 241 frames through
   transcribe_batch_detailed; K1 must launch 7 times per forward, and the
   same weights on the CPU must give the same ids and text, with logits
   within LOGIT_ATOL; then forward and end-to-end times, utt/s and the
   realtime factor, and a profile of one forward;
6. the training path: the same model and weights trained by
   train.step.make_train_step with Adam under Noam(0.5, 1, 1200) and
   timit.conf's betas and eps, on bench.py's workload (29 utterances of
   0.7*241..241 frames, tar_len = max(2, len // 8), labels in 1..61). One
   dropout-free step on the card must agree with the same step on the CPU
   (at a smaller batch) in loss, every gradient and the BatchNorm running
   statistics, and in the parameters' Adam update, taken at Noam's peak
   rate (count 1200) rather than at count 0 (rate 1.2e-14); then
   TRAIN_STEPS steps with dropout on, each calling K1 and K2 7 times (K2 is
   two kernels, so 14 K2 launches), with finite losses and every tensor on
   the card; then ms/step, utt/s, audio-seconds/s, the device time of a
   forward and of a backward, and a profile of one step (K1 and K2 device
   ms, K2's two kernels apart, idle share);
7. a "kernels" JSON line, then the card line, then the result line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version, both float32 on the card: only the order of the
# sums differs
RTOL, ATOL = 1e-4, 1e-5
# K2 vs its plain version: rtol 1e-4 and atol 1e-4 x max|plain| for each of
# du, dW and db; dW and db are sums over B x T' (~1800) terms per entry,
# taken in another order
K2_RTOL, K2_ATOL_REL = 1e-4, 1e-4
# card vs CPU logits (float32 both, TF32 off): sums in other orders through
# the front end, 7 routing layers and 9 LayerNorms; logits are O(1) and
# measured ~2e-6 apart on an H100
LOGIT_ATOL = 1e-4
# one dropout-free train step, card vs CPU (float32 both, TF32 off): the
# loss within LOSS_RTOL; each gradient within GRAD_ATOL_REL x its largest
# entry (the backward sums over the batch and time in other orders, through
# 7 routing layers and the CTC loss; measured 1.5e-5 on an H100, while TF32
# convolutions would be ~1e-3 off); the BatchNorm running statistics
# within STATS_ATOL
LOSS_RTOL, GRAD_ATOL_REL, STATS_ATOL = 1e-5, 1e-4, 1e-5
# the parity step's update is taken at this count of the Noam schedule, its
# peak (rate 0.0144 at k 0.5, warmup 1200), where Adam moves every parameter
# by ~rate: each update (after - before) must agree within UPDATE_ATOL_REL x
# rate wherever the gradient is at least UPDATE_GRAD_REL x its tensor's
# largest entry (there a gradient error of GRAD_ATOL_REL cannot flip its
# sign; float32 rounding of a parameter of magnitude ~1 is ~1e-5 x rate);
# elsewhere each update must stay within Adam's first-step bound, the rate
PARITY_COUNT, UPDATE_ATOL_REL, UPDATE_GRAD_REL = 1200, 1e-3, 1e-2
TRAIN_STEPS = 20
TRAIN_CHECK_BATCH = 8
# (name, (in_n, out_n, out_d, in_d), PAD mask, layers per forward)
TIMIT_LAYERS = [
    ("layer0", (180, 30, 8, 8), False, 1),
    ("middle", (90, 30, 8, 8), False, 5),
    ("last", (90, 63, 8, 8), True, 1),
]
TIMIT_FLAGS = [
    "--model-encoder-num=7", "--model-caps-primary-num=60",
    "--model-caps-primary-dim=8", "--model-caps-convolution-num=30",
    "--model-caps-convolution-dim=8", "--model-caps-class-dim=8",
    "--model-caps-type=naive", "--model-caps-window-lpad=1",
    "--model-caps-window-rpad=1", "--model-caps-context=True",
    "--model-caps-iter=1", "--decoding-beam-width=1",
]


class SmokeFailure(Exception):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def event_ms(torch, fn, reps):
    """Mean ms of ``fn`` on the card over ``reps`` launches after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(torch, fn, reps):
    """Host-clock ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronize (a request is done when its result is on the host)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return times


def sdr_bound_ms(batch, seq_len, geometry, num_iter):
    """Least time the card could take for one SDR forward call: the larger
    of its bytes (u, W, bias read once, out written once) over HBM bandwidth
    and its float32 operations over the f32 peak. Returns the two times in
    ms, (bytes_ms, operations_ms)."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    nbytes = 4 * (batch * seq_len * in_n * in_d + in_n * out_no * in_d
                  + in_n * out_no + batch * seq_len * out_no)
    per_step = 2 * in_d * in_n * out_no + num_iter * (
        4 * in_n * out_no      # agreement and s contractions
        + 6 * in_n * out_n     # logit update and softmax
        + 4 * out_no + 4 * out_n)  # squash
    flops = batch * seq_len * per_step
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS


def sdr_bwd_bound_ms(batch, seq_len, geometry):
    """Least time the card could take for one SDR backward call (one
    routing iteration): the larger of its bytes (u, W, bias, vs, dvs read
    once; du, dW, db written once) over HBM bandwidth and its float32
    operations, the recomputed forward step included, over the f32 peak.
    Returns (bytes_ms, operations_ms)."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    u_size, w_size = batch * seq_len * in_n * in_d, in_n * out_no * in_d
    v_size, b_size = batch * seq_len * out_no, in_n * out_no
    nbytes = 4 * 2 * (u_size + w_size + b_size + v_size)
    forward = (2 * in_d * in_n * out_no + 4 * in_n * out_no
               + 6 * in_n * out_n + 4 * out_no + 4 * out_n)
    backward = (4 * in_d * in_n * out_no   # dW and du contractions
                + 8 * in_n * out_no        # dc, carry, du_hat, db
                + 4 * in_n * out_n         # softmax backward
                + 4 * out_no + 12 * out_n)  # squash backward
    flops = batch * seq_len * (forward + backward)
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def kernel_phase(torch, device):
    """Phase 3: K1 against its plain version; returns its JSON entry."""
    from srf_tpu_torch.ops.routing import sequential_routing
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda

    rng = np.random.RandomState(SEED)
    max_err = 0.0
    per_layer = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
              "operations_ms": 0.0}
    for name, geometry, mask, count in TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * 0.1,
                         dtype=torch.float32, device=device)
        b = torch.tensor(rng.randn(in_n, out_n, out_d) * 0.1,
                         dtype=torch.float32, device=device)
        for batch, seq_len, num_iter, use_mask in (
                (29, 64, 1, mask), (8, 128, 1, mask), (29, 61, 1, mask),
                (7, 17, 2, not mask)):
            u = torch.tensor(rng.randn(batch, seq_len, in_n, in_d),
                             dtype=torch.float32, device=device)
            got = sequential_routing_cuda(u, w, b, num_iter, use_mask)
            torch.cuda.synchronize()
            want = sequential_routing(u, w, b, num_iter, use_mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K1 output not finite")
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            print("K1 %s %s B=%d T=%d iter=%d mask=%s max_abs_err=%.3e"
                  % (name, geometry, batch, seq_len, num_iter, use_mask, err))
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  "K1 disagrees with its plain version at %s B=%d T=%d"
                  % (geometry, batch, seq_len))
            if (batch, seq_len) != (29, 64):
                continue
            ms = event_ms(torch, lambda: sequential_routing_cuda(
                u, w, b, num_iter, use_mask), 20)
            plain_ms = event_ms(torch, lambda: sequential_routing(
                u, w, b, num_iter, use_mask), 3)
            bytes_ms, ops_ms = sdr_bound_ms(batch, seq_len, geometry,
                                            num_iter)
            bound = max(bytes_ms, ops_ms)
            print("K1 %s B=29 T=64: kernel %.4f ms, plain %.4f ms, bound "
                  "%.4f ms (bytes %.4f ms, operations %.4f ms)"
                  % (name, ms, plain_ms, bound, bytes_ms, ops_ms))
            per_layer.append({"layer": name, "geometry": list(geometry),
                              "per_forward": count, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound})
            totals["ms"] += count * ms
            totals["plain_ms"] += count * plain_ms
            totals["bound_ms"] += count * bound
            totals["bytes_ms"] += count * bytes_ms
            totals["operations_ms"] += count * ops_ms
    torch.cuda.synchronize()
    return {
        "name": "sdr_fwd", "route": "cuda",
        "source": "srf_tpu_torch/csrc/sdr_fwd.cu",
        "replaces": "srf_tpu/ops/routing_pallas.py:81",
        "launches": None, "max_abs_err": max_err,
        # one forward's 7 launches at the main path's B=29, T'=64
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["bytes_ms"] > totals["operations_ms"]
                     else "operations"),
        "library_ms": None,  # no single PyTorch call computes SDR
        "per_layer": per_layer,
    }


def k2_phase(torch, device):
    """Phase 4: K2 against its plain version; returns its JSON entry."""
    from srf_tpu_torch.ops.routing import sequential_routing_bwd
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    rng = np.random.RandomState(SEED + 2)
    max_err = 0.0
    per_layer = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
              "operations_ms": 0.0}
    for name, geometry, mask, count in TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * 0.1,
                         dtype=torch.float32, device=device)
        b = torch.tensor(rng.randn(in_n, out_n, out_d) * 0.1,
                         dtype=torch.float32, device=device)
        for batch, seq_len, use_mask in ((29, 64, mask), (29, 61, mask),
                                         (7, 17, not mask)):
            u = torch.tensor(rng.randn(batch, seq_len, in_n, in_d),
                             dtype=torch.float32, device=device)
            vs = sequential_routing_cuda(u, w, b, 1, use_mask)
            dvs = torch.tensor(rng.randn(batch, seq_len, out_n, out_d),
                               dtype=torch.float32, device=device)
            got = sequential_routing_bwd_cuda(u, w, b, vs, dvs, use_mask)
            torch.cuda.synchronize()
            want = sequential_routing_bwd(u, w, b, vs, dvs, use_mask)
            torch.cuda.synchronize()
            errs = []
            for label, g, x in zip(("du", "dW", "db"), got, want):
                check(bool(torch.isfinite(g).all()),
                      "K2 %s not finite" % label)
                scale = x.abs().max().item()
                err = (g - x).abs().max().item()
                errs.append("%s %.3e (max|plain| %.3e)" % (label, err, scale))
                max_err = max(max_err, err)
                check(torch.allclose(g, x, rtol=K2_RTOL,
                                     atol=K2_ATOL_REL * scale),
                      "K2 %s disagrees with its plain version at %s B=%d "
                      "T=%d mask=%s" % (label, geometry, batch, seq_len,
                                        use_mask))
            print("K2 %s %s B=%d T=%d mask=%s max_abs_err %s"
                  % (name, geometry, batch, seq_len, use_mask,
                     ", ".join(errs)))
            if (batch, seq_len) != (29, 61):
                continue
            ms = event_ms(torch, lambda: sequential_routing_bwd_cuda(
                u, w, b, vs, dvs, use_mask), 10)
            plain_ms = event_ms(torch, lambda: sequential_routing_bwd(
                u, w, b, vs, dvs, use_mask), 2)
            bytes_ms, ops_ms = sdr_bwd_bound_ms(batch, seq_len, geometry)
            bound = max(bytes_ms, ops_ms)
            print("K2 %s B=29 T=61: kernel %.4f ms, plain %.4f ms, bound "
                  "%.4f ms (bytes %.4f ms, operations %.4f ms)"
                  % (name, ms, plain_ms, bound, bytes_ms, ops_ms))
            per_layer.append({"layer": name, "geometry": list(geometry),
                              "per_step": count, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound})
            totals["ms"] += count * ms
            totals["plain_ms"] += count * plain_ms
            totals["bound_ms"] += count * bound
            totals["bytes_ms"] += count * bytes_ms
            totals["operations_ms"] += count * ops_ms
    torch.cuda.synchronize()
    return {
        "name": "sdr_bwd", "route": "cuda",
        "source": "srf_tpu_torch/csrc/sdr_bwd.cu",
        "replaces": "srf_tpu/ops/routing_pallas.py:159",
        "launches": None, "max_abs_err": max_err,
        # one train step's 7 calls (14 launches: each call's reverse-time
        # and weight-gradient kernels) at the training path's B=29, T'=61
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["bytes_ms"] > totals["operations_ms"]
                     else "operations"),
        "library_ms": None,  # no single PyTorch call computes the SDR VJP
        "per_layer": per_layer,
    }


def random_weights(model):
    """The flax variable tree at ``model``'s shapes, drawn from numpy, and
    carried into a state_dict by convert.py."""
    from srf_tpu_torch import convert

    rng = np.random.RandomState(SEED)
    tree = convert.state_dict_to_flax(model.state_dict())

    def fill(node):
        out = {}
        for name, leaf in sorted(node.items()):
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
            elif name == "kernel":
                fan_in = int(np.prod(leaf.shape[:-1]))
                out[name] = rng.randn(*leaf.shape) / np.sqrt(fan_in)
            elif name == "scale":
                out[name] = 1.0 + 0.1 * rng.randn(*leaf.shape)
            elif name == "var":
                out[name] = rng.uniform(0.5, 1.5, size=leaf.shape)
            else:  # bias, mean, routing W{i} / b{i}
                out[name] = 0.1 * rng.randn(*leaf.shape)
        return out

    return convert.flax_to_state_dict(fill(tree))


def profile_device(torch, fn):
    """Device time of one call of ``fn``: ({"K1": ms, "K2": ms, "K2 step":
    ms, "K2 wgrad": ms}, ms of all device ops (kernels and copies), their
    count, device busy ms, host wall ms), from torch.profiler (CUPTI). "K2"
    is the sum of its two kernels, "K2 step" the reverse-time one and
    "K2 wgrad" the weight-gradient one."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    spans = []
    kernels = {"K1": 0.0, "K2": 0.0, "K2 step": 0.0, "K2 wgrad": 0.0}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        spans.append(span)
        for name, symbol in (("K1", "sdr_fwd_kernel"), ("K2", "sdr_bwd_"),
                             ("K2 step", "sdr_bwd_step_kernel"),
                             ("K2 wgrad", "sdr_bwd_wgrad_kernel")):
            if symbol in evt.name:
                kernels[name] += (span[1] - span[0]) / 1e3
    total = sum(end - start for start, end in spans) / 1e3
    busy, last_end = 0.0, None
    for start, end in sorted(spans):
        if last_end is not None and start < last_end:
            start = last_end
        if end > start:
            busy += end - start
            last_end = end
    return kernels, total, len(spans), busy / 1e3, wall_ms


def timit_config(logger, device):
    """The canonical SRF-TIMIT configuration: timit.conf, the recipe's
    first stage (train_srf_timit.sh: k 0.5, warmup 1200) and the model
    flags."""
    from srf_tpu_torch.config import ParseOption

    return ParseOption(
        ["chip_smoke", "--config=egs/conf/timit.conf",
         "--path-base=%s" % REPO, "--path-ckpt=%s" % REPO,
         "--device=%s" % device, "--train-lr-param-k=0.5",
         "--train-warmup-n=1200", *TIMIT_FLAGS],
        logger, is_print_opts=False,
    ).args


def main_path_phase(torch, card):
    """Phase 5: serve two batches on the card; returns K1's launches and
    the random weights (a state_dict)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    model, _ = build_model(config, 63)
    state = random_weights(model)
    card_rec = Recognizer(config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=state, device="cpu",
                         logger=logger)
    check(card_rec.device.type == "cuda", "Recognizer is not on the card")

    rng = np.random.RandomState(SEED + 1)
    batches = {
        "8x150-400": [rng.randn(n, 123).astype(np.float32)
                      for n in rng.randint(150, 401, size=8)],
        "29x241": [rng.randn(241, 123).astype(np.float32) for _ in range(29)],
    }
    for feats_list in batches.values():  # warm-up (allocator, cuDNN)
        card_rec.transcribe_batch_detailed(feats_list)
    torch.cuda.synchronize()

    sequential_routing_cuda.launches = 0
    results = {}
    for name, feats_list in batches.items():
        before = sequential_routing_cuda.launches
        results[name] = card_rec.transcribe_batch_detailed(feats_list)
        torch.cuda.synchronize()
        check(sequential_routing_cuda.launches - before == 7,
              "%s: K1 launched %d times in one forward, expected 7"
              % (name, sequential_routing_cuda.launches - before))
    launches = sequential_routing_cuda.launches
    print("main path: K1 launches %d over %d forwards" % (launches,
                                                          len(batches)))

    for name, feats_list in batches.items():
        got = results[name]
        check(len(got) == len(feats_list), "%s: result count" % name)
        for i, res in enumerate(got):
            dec_len = max(feats_list[i].shape[0] // 4, 1)
            check(all(0 <= t < 62 for t in res["ids"]), "%s: ids" % name)
            check(all(0 <= f < dec_len for f in res["frames"]),
                  "%s: frames" % name)
            check(np.isfinite(res["score"]) and res["score"] <= 0,
                  "%s: score" % name)
        cpu = cpu_rec.transcribe_batch_detailed(feats_list)
        check([r["ids"] for r in got] == [r["ids"] for r in cpu],
              "%s: card ids differ from CPU ids" % name)
        check([r["text"] for r in got] == [r["text"] for r in cpu],
              "%s: card text differs from CPU text" % name)
        card_logits = card_rec.forward(*card_rec.pad(feats_list)).cpu()
        cpu_logits = cpu_rec.forward(*cpu_rec.pad(feats_list))
        check(bool(torch.isfinite(card_logits).all()), "%s: logits" % name)
        err = (card_logits - cpu_logits).abs().max().item()
        print("main path %s: %d utts, %d tokens, ids equal to CPU, logits "
              "shape %s max |card - cpu| %.3e (atol %.0e)"
              % (name, len(got), sum(len(r["ids"]) for r in got),
                 tuple(card_logits.shape), err, LOGIT_ATOL))
        check(err <= LOGIT_ATOL, "%s: card logits differ from CPU" % name)
    torch.cuda.synchronize()

    reps = 10
    for name, feats_list in batches.items():
        feats, lengths = card_rec.pad(feats_list)
        fwd_ms = timed_ms(torch, lambda: card_rec.forward(feats, lengths),
                          reps)
        e2e_ms = timed_ms(
            torch, lambda: card_rec.transcribe_batch_detailed(feats_list),
            reps)
        audio_s = 0.01 * float(lengths.sum())
        med = float(np.median(e2e_ms))
        print("serve %s (padded %s), %d runs: forward median %.3f ms/batch "
              "(max %.3f), end-to-end median %.3f ms/batch (max %.3f), "
              "%.1f utt/s, %.1fx realtime [%s]"
              % (name, tuple(feats.shape), reps, float(np.median(fwd_ms)),
                 max(fwd_ms), med, max(e2e_ms), 1e3 * len(feats_list) / med,
                 1e3 * audio_s / med, card))
        kernels, total, count, busy, wall = profile_device(
            torch, lambda: card_rec.forward(feats, lengths))
        print("profile %s forward: K1 %.3f ms, all %d device ops %.3f ms, "
              "device busy %.3f of %.3f ms wall (idle share %.3f) [%s]"
              % (name, kernels["K1"], count, total, busy, wall,
                 1.0 - busy / wall, card))
    torch.cuda.synchronize()
    return launches, state


def train_batch(torch, device, batch=29, frames=241, feat_dim=123,
                vocab=62):
    """bench.py's workload (bench.py:76-87): lengths in 0.7*frames..frames,
    tar_len = max(2, len // 8), labels in 1..vocab-1, randn features.
    Features and labels on ``device``, the lengths on the host, as the train
    step wants them (train/step.py)."""
    host = np.random.RandomState(0)
    lens = host.randint(int(frames * 0.7), frames + 1, size=batch)
    tar_lens = np.maximum(2, lens // 8)
    feats = host.randn(batch, frames, feat_dim).astype(np.float32)
    labels = host.randint(1, vocab, size=(batch, int(tar_lens.max())))
    return {
        "feats": torch.tensor(feats, device=device),
        "labels": torch.tensor(labels, dtype=torch.int32, device=device),
        "inp_len": torch.tensor(lens, dtype=torch.int32),
        "tar_len": torch.tensor(tar_lens, dtype=torch.int32),
    }


def train_setup(torch, config, state, device, dropout=True):
    """A model with ``state``'s weights, its optimizer and scheduler in a
    TrainState on ``device``, and its train step."""
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.train.optimizer import get_optimizer
    from srf_tpu_torch.train.state import TrainState
    from srf_tpu_torch.train.step import make_apply_fn, make_train_step

    model, in_len_div = build_model(config, 63)
    model.load_state_dict(state)
    if not dropout:
        for module in model.modules():
            if isinstance(module, torch.nn.Dropout):
                module.p = 0.0
    optimizer, scheduler = get_optimizer(config, model.parameters())
    train_state = TrainState.create(model, optimizer, scheduler,
                                    device=device)
    apply_fn = make_apply_fn(model)
    return train_state, apply_fn, make_train_step(apply_fn, in_len_div)


def train_parity(torch, config, state, batch):
    """One dropout-free step on the card and on the CPU from the same
    weights, its update taken at the schedule's count PARITY_COUNT: loss,
    every gradient, BatchNorm statistics and each parameter's update."""
    results = {}
    for device in ("cuda", "cpu"):
        train_state, _, step = train_setup(torch, config, state, device,
                                           dropout=False)
        rate = train_state.scheduler.lr_lambdas[0](PARITY_COUNT)
        for group in train_state.optimizer.param_groups:
            group["lr"] = rate
        _, metrics = step(train_state, {k: v.to(device) for k, v in
                                        batch.items()}, config.tpu_seed)
        model = train_state.model
        results[device] = (
            metrics["loss_sum"].item(),
            {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
        )
    (card_loss, card_grads, card_state), (cpu_loss, cpu_grads, cpu_state) = (
        results["cuda"], results["cpu"])
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(np.isfinite(card_loss) and loss_err <= LOSS_RTOL,
          "train step: card loss %r vs CPU %r" % (card_loss, cpu_loss))
    worst_grad = (0.0, "")
    for name, want in cpu_grads.items():
        got = card_grads[name]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        worst_grad = max(worst_grad, (err / max(scale, 1e-30), name))
        check(err <= GRAD_ATOL_REL * scale,
              "train step: gradient %s differs, card vs CPU %.3e (max %.3e)"
              % (name, err, scale))
    worst_stat, worst_update, checked, total = 0.0, 0.0, 0, 0
    for name, want in cpu_state.items():
        if name.endswith("num_batches_tracked"):
            check(int(card_state[name]) == int(want), "%s differs" % name)
            continue
        if "running_" in name:
            err = (card_state[name] - want).abs().max().item()
            worst_stat = max(worst_stat, err)
            check(err <= STATS_ATOL, "train step: %s differs by %.3e"
                  % (name, err))
            continue
        before = state[name].float()
        card_update, cpu_update = card_state[name] - before, want - before
        check(bool((cpu_update.abs() <= rate * (1 + UPDATE_ATOL_REL)).all()
                   and (card_update.abs()
                        <= rate * (1 + UPDATE_ATOL_REL)).all()),
              "train step: %s moved by more than the rate" % name)
        grad = cpu_grads[name].abs()
        sure = grad >= UPDATE_GRAD_REL * grad.max()
        err = (card_update - cpu_update)[sure].abs().max().item()
        worst_update = max(worst_update, err / rate)
        checked, total = checked + int(sure.sum()), total + want.numel()
        check(err <= UPDATE_ATOL_REL * rate,
              "train step: parameter %s's update differs by %.3e (rate %.3e)"
              % (name, err, rate))
    check(checked > total // 2, "too few parameters' updates compared")
    print("train parity (B=%d, dropout off, one step at count %d, rate "
          "%.4e): loss card %.6f cpu %.6f (rel %.2e, rtol %.0e); worst "
          "gradient %s rel err %.2e (atol %.0e x max); BatchNorm stats max "
          "err %.2e (atol %.0e); parameter updates: worst err %.2e x rate "
          "(atol %.0e x rate) over %d of %d entries, all within the rate"
          % (batch["feats"].shape[0], PARITY_COUNT, rate, card_loss,
             cpu_loss, loss_err, LOSS_RTOL, worst_grad[1], worst_grad[0],
             GRAD_ATOL_REL, worst_stat, STATS_ATOL, worst_update,
             UPDATE_ATOL_REL, checked, total))


def all_on_card(train_state, metrics):
    """Every parameter, gradient, buffer, optimizer moment and metric is a
    CUDA tensor (Adam's step count is a host scalar by torch's design; the
    batch's lengths are host inputs)."""
    tensors = list(train_state.model.state_dict().items())
    tensors += [("grad " + k, p.grad)
                for k, p in train_state.model.named_parameters()]
    for i, opt_state in enumerate(train_state.optimizer.state.values()):
        tensors += [("adam %d %s" % (i, k), v) for k, v in opt_state.items()
                    if k != "step"]
    tensors += list(metrics.items())
    off = [name for name, t in tensors if t is None or not t.is_cuda]
    check(not off, "tensors off the card: %s" % off[:5])


def train_phase(torch, card, state):
    """Phase 6: train the canonical model on the card; returns the K1 and
    K2 launches of the TRAIN_STEPS-step run."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    batch = train_batch(torch, "cuda")
    train_parity(torch, config, state,
                 {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()})

    train_state, apply_fn, step = train_setup(torch, config, state, "cuda")
    seed = config.tpu_seed
    torch.cuda.synchronize()
    sequential_routing_cuda.launches = 0
    sequential_routing_bwd_cuda.launches = 0
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        k1, k2 = (sequential_routing_cuda.launches,
                  sequential_routing_bwd_cuda.launches)
        start = time.perf_counter()
        train_state, metrics = step(train_state, batch, seed)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
        losses.append(metrics["loss_sum"])
        # 7 calls of each; a K2 call launches its two kernels
        check(sequential_routing_cuda.launches - k1 == 7
              and sequential_routing_bwd_cuda.launches - k2 == 14,
              "a train step launched K1 %d and K2 %d times, expected 7 and "
              "14" % (sequential_routing_cuda.launches - k1,
                      sequential_routing_bwd_cuda.launches - k2))
    launches = (sequential_routing_cuda.launches,
                sequential_routing_bwd_cuda.launches)
    all_on_card(train_state, metrics)
    losses = torch.stack(losses).cpu().numpy() / batch["feats"].shape[0]
    check(bool(np.isfinite(losses).all()), "non-finite train loss")
    med = float(np.median(step_ms))
    audio_s = 0.01 * float(batch["inp_len"].sum())
    print("train %d steps of 29 x 241 (dropout on): K1 %d launches, K2 %d "
          "launches (%d calls of its two kernels); "
          "loss per utterance first %.3f last %.3f; ms/step median %.3f max "
          "%.3f; %.1f utt/s, %.1f audio-s/s [%s]"
          % (TRAIN_STEPS, launches[0], launches[1], launches[1] // 2,
             losses[0], losses[-1],
             med, max(step_ms), 1e3 * 29 / med, 1e3 * audio_s / med, card))

    # device time of one step's forward (to the loss) and backward, each
    # profiled on its own
    held = {}

    def forward():
        logits = apply_fn(batch, True)
        held["loss"] = ctc_loss_from_frames(
            logits, batch["inp_len"], 4, batch["labels"],
            batch["tar_len"]).sum() / batch["feats"].shape[0]

    train_state.optimizer.zero_grad(set_to_none=True)
    for name, fn in (("forward", forward),
                     ("backward", lambda: held["loss"].backward())):
        kernels, total, count, busy, wall = profile_device(torch, fn)
        print("profile train %s: K1 %.3f ms, K2 %.3f ms (step kernel %.3f, "
              "wgrad kernel %.3f), all %d device ops %.3f ms, device busy "
              "%.3f of %.3f ms wall [%s]"
              % (name, kernels["K1"], kernels["K2"], kernels["K2 step"],
                 kernels["K2 wgrad"], count, total, busy, wall, card))

    kernels, total, count, busy, wall = profile_device(
        torch, lambda: step(train_state, batch, seed))
    print("profile train step: K1 %.3f ms, K2 %.3f ms (step kernel %.3f, "
          "wgrad kernel %.3f), all %d device ops %.3f ms, device busy %.3f "
          "of %.3f ms wall (idle share %.3f) [%s]"
          % (kernels["K1"], kernels["K2"], kernels["K2 step"],
             kernels["K2 wgrad"], count, total, busy, wall,
             1.0 - busy / wall, card))
    torch.cuda.synchronize()
    return launches


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "srf_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build

    card = card_line()
    print("card: %s" % card)
    device = resolve_device("cuda")
    torch.cuda.synchronize()

    start = time.perf_counter()
    paths = cuda_build.build(["sdr_fwd", "sdr_bwd"])
    print("build: %.2f s" % (time.perf_counter() - start))
    for name, path in paths.items():
        if os.path.isfile(path + ".log"):
            with open(path + ".log") as log:
                for line in log:
                    if "registers" in line or "spill" in line:
                        print("build %s: %s" % (name, line.strip()))

    k1 = kernel_phase(torch, device)
    k2 = k2_phase(torch, device)
    serve_k1, state = main_path_phase(torch, card)
    train_k1, train_k2 = train_phase(torch, card, state)
    check(serve_k1 > 0, "K1 was not launched on the serving path")
    check(train_k1 > 0 and train_k2 > 0,
          "K1 or K2 was not launched on the training path")
    k1["launches"] = serve_k1 + train_k1
    k1["launches_by_path"] = {"serve": serve_k1, "train": train_k1}
    k2["launches"] = train_k2
    k2["calls"] = train_k2 // 2  # two kernels per call
    k2["launches_by_path"] = {"train": train_k2}

    print(json.dumps({"kernels": [k1, k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except SmokeFailure as failure:
        print("chip_smoke FAILED: %s" % failure, file=sys.stderr)
        code = 1
    sys.exit(code)
