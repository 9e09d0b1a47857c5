#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (srf_tpu_torch), one GPU.

    python3 chip_smoke.py        # from the root of a checkout, no arguments

Imports nothing of JAX or srf_tpu. Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from csrc/ with nvcc;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the three canonical SRF-TIMIT capsule-layer geometries, at the main
   path's two shapes (B=29, T'=64: 29 x 241 frames padded to 256; B=8,
   T'=128), at the unpadded bucket (T'=61) and at an odd B/T with 2 routing
   iterations and the PAD mask flipped; kernel and plain times from CUDA
   events at B=29, T'=64;
4. the main path: a Recognizer at the canonical SRF-TIMIT width (L=7,
   PH=60, PD=8, CH=30, CD=8, VD=8, window 1+1+1, SDR, 1 iteration, naive,
   63 classes, 2 x 64-filter maxout convs) with random weights drawn from a
   numpy seed as the flax tree and carried across by convert.py, serving
   8 requests of 150-400 frames and 29 requests of 241 frames through
   transcribe_batch_detailed; K1 must launch 7 times per forward, and the
   same weights on the CPU must give the same ids and text, with logits
   within LOGIT_ATOL; then forward and end-to-end times, utt/s and the
   realtime factor, and a profile of one forward;
5. a "kernels" JSON line, then the card line, then the result line.
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
# card vs CPU logits (float32 both, TF32 off): sums in other orders through
# the front end, 7 routing layers and 9 LayerNorms; logits are O(1) and
# measured ~2e-6 apart on an H100
LOGIT_ATOL = 1e-4
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


def profile_forward(torch, recognizer, feats, lengths):
    """Device time of one forward: (K1 ms, ms of all device ops (kernels and
    copies), their count, device busy ms, host wall ms), from torch.profiler
    (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        recognizer.forward(feats, lengths)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    spans, k1 = [], 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        spans.append(span)
        if "sdr_fwd_kernel" in evt.name:
            k1 += (span[1] - span[0]) / 1e3
    total = sum(end - start for start, end in spans) / 1e3
    busy, last_end = 0.0, None
    for start, end in sorted(spans):
        if last_end is not None and start < last_end:
            start = last_end
        if end > start:
            busy += end - start
            last_end = end
    return k1, total, len(spans), busy / 1e3, wall_ms


def main_path_phase(torch, card):
    """Phase 4: serve two batches on the card; returns K1's launches."""
    from srf_tpu_torch.config import Logger, ParseOption
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = ParseOption(
        ["chip_smoke", "--config=egs/conf/timit.conf",
         "--path-base=%s" % REPO, "--path-ckpt=%s" % REPO, "--device=cuda",
         *TIMIT_FLAGS],
        logger, is_print_opts=False,
    ).args
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
        k1, kernels, count, busy, wall = profile_forward(
            torch, card_rec, feats, lengths)
        print("profile %s forward: K1 %.3f ms, all %d device ops %.3f ms, "
              "device busy %.3f of %.3f ms wall (idle share %.3f) [%s]"
              % (name, k1, count, kernels, busy, wall, 1.0 - busy / wall,
                 card))
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
    paths = cuda_build.build(["sdr_fwd"])
    print("build: %.2f s" % (time.perf_counter() - start))
    for name, path in paths.items():
        if os.path.isfile(path + ".log"):
            with open(path + ".log") as log:
                for line in log:
                    if "registers" in line or "spill" in line:
                        print("build %s: %s" % (name, line.strip()))

    k1 = kernel_phase(torch, device)
    k1["launches"] = main_path_phase(torch, card)
    check(k1["launches"] > 0, "K1 was not launched on the main path")

    print(json.dumps({"kernels": [k1]}))
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
