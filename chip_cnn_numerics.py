#!/usr/bin/env python3
"""CNN-TIMIT on one GPU: how far float32 (and TF32) is from float64, and
what cuDNN's algorithm choice costs at the shapes users send. The
measurements behind the CNN tolerances in chip_smoke.py and the cuDNN
setting in srf_tpu_torch/device.py (PERF.md).

    python3 chip_cnn_numerics.py        # from the root of a checkout

Imports nothing of JAX or srf_tpu. On chip_smoke.py's CNN-TIMIT model and
numpy-seeded weights:

1. precision: one pallas-mode train step at B=2 of chip_smoke's 29 x 241
   batch, dropout on at every K5 site and off, on the card in float32,
   TF32 and float64 and on the CPU in float32, each against the CPU in
   float64 (float64 from the input through the CTC loss): loss, logits and
   every gradient (the worst max-abs error over a tensor's largest entry,
   and the worst norm ratio). K5 is float32 only, so the float64 runs take
   its plain version, which draws the same mask bits;
2. the parity control: chip_smoke's CNN-TIMIT parity step (card vs CPU,
   dropout on, B=2) with the card in float32 and in TF32, its readings
   beside the CNN limits it is held to;
3. cuDNN's algorithms: in two child processes (PyTorch caches its choice
   per shape, so each setting starts clean) with cudnn.benchmark off
   (cuDNN's heuristics) and on (a timed search at each new shape), for
   CNN-TIMIT and for SRF-TIMIT (chip_smoke's canonical model): an eval
   forward at every serving shape (B 1, 8, 29 at widths 128-896, the
   Recognizer's multiples of 128) and a train step at each 7000-frame
   bucket of the TIMIT recipes that TIMIT fills, for the CNN also with the
   time axis padded to a multiple of 32 and of 128: for each shape the
   first call (with the search, where there is one), the median of the
   next three, and the ms of FFT kernels in a profiled call.
"""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SERVE_WIDTHS = (128, 256, 384, 512, 640, 768, 896)
SERVE_BATCHES = (1, 8, 29)
# (batch, boundary) of the train_cnn_timit.sh buckets (7000 frames; batch
# = 7000 // boundary at boundaries 241 + 150k, srf_tpu/data/bucketing.py)
# that hold TIMIT's utterances (up to ~780 frames)
TRAIN_BUCKETS = ((29, 241), (17, 391), (12, 541), (10, 691), (8, 841))


def _model_and_weights(torch, flags=None):
    """A TIMIT configuration (CNN-TIMIT's unless ``flags`` are given) and
    chip_smoke's numpy-seeded weights for it."""
    import chip_smoke as cs
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model

    logger = Logger(name="chip_cnn_numerics", level=Logger.WARN).logger
    config = cs.timit_config(logger, "cuda", flags or cs.CNN_FLAGS)
    return config, cs.random_weights(build_model(config, 63)[0])


def _set_tf32(torch, on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def precision(torch):
    import chip_smoke as cs
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import dropout, dropout_cuda
    from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
    from srf_tpu_torch.train.step import step_seed

    kernel_path = dropout_cuda._dispatch
    dropout_cuda._dispatch = lambda x, seed, rate: (
        kernel_path(x, seed, rate) if x.dtype == torch.float32
        else dropout.fused_dropout_plain(x.contiguous(), seed, rate))
    config, state = _model_and_weights(torch)
    batch = {k: v[:2] for k, v in cs.train_batch(torch, "cpu").items()}

    def step(device, dtype, dropout_on, tf32=False):
        model, in_len_div = build_model(config, 63)
        model.load_state_dict(state)
        if not dropout_on:
            for module in model.modules():
                if isinstance(module, torch.nn.Dropout):
                    module.p = 0.0
        model = model.to(device=device, dtype=dtype).train()
        generator = torch.Generator(device).manual_seed(
            step_seed(config.tpu_seed, 0))
        _set_tf32(torch, tf32)
        try:
            logits = model(batch["feats"].to(device, dtype),
                           batch["inp_len"].to(device), generator)
            loss = ctc_loss_from_frames(
                logits, batch["inp_len"], in_len_div,
                batch["labels"].to(device), batch["tar_len"]).sum() / 2
            loss.backward()
        finally:
            _set_tf32(torch, False)
        grads = {k: p.grad.double().cpu()
                 for k, p in model.named_parameters()}
        return loss.item(), logits.detach().double().cpu(), grads

    for dropout_on in (True, False):
        ref_loss, ref_logits, ref_grads = step("cpu", torch.float64,
                                               dropout_on)
        for device, dtype, tf32 in (("cuda", torch.float32, False),
                                    ("cuda", torch.float32, True),
                                    ("cpu", torch.float32, False),
                                    ("cuda", torch.float64, False)):
            loss, logits, grads = step(device, dtype, dropout_on, tf32)
            worst = max(((g - ref_grads[k]).abs().max().item()
                         / ref_grads[k].abs().max().item(), k)
                        for k, g in grads.items())
            worst_norm = max(((g - ref_grads[k]).norm().item()
                              / ref_grads[k].norm().item(), k)
                             for k, g in grads.items())
            print("precision, dropout %s, %s %s vs cpu float64: loss rel "
                  "%.2e, logits max abs %.2e, gradients worst %.2e x max "
                  "(%s), worst norm ratio %.2e (%s)"
                  % ("on" if dropout_on else "off", device,
                     "tf32" if tf32 else str(dtype)[6:],
                     abs(loss - ref_loss) / abs(ref_loss),
                     (logits - ref_logits).abs().max().item(), worst[0],
                     worst[1], worst_norm[0], worst_norm[1]), flush=True)
    dropout_cuda._dispatch = kernel_path


def parity_control(torch):
    """chip_smoke's CNN-TIMIT parity step with the card in float32 (what
    chip_smoke runs) and in TF32 (a lower precision the limits must
    refuse)."""
    import chip_smoke as cs

    config, state = _model_and_weights(torch)
    batch = {k: v[:cs.CNN_CHECK_BATCH]
             for k, v in cs.train_batch(torch, "cuda").items()}
    for tf32 in (False, True):
        r = cs.parity_readings(torch, config, state, batch, dropout="k5",
                               update_grad_rel=cs.CNN_UPDATE_GRAD_REL,
                               card_tf32=tf32)
        grad, update = cs.worst(r["grads"]), cs.worst(r["updates"])
        passes = (r["loss_err"] <= cs.LOSS_RTOL
                  and grad[0] <= cs.CNN_GRAD_ATOL_REL
                  and r["max_move"] <= 1 + cs.UPDATE_ATOL_REL
                  and update[0] <= cs.UPDATE_ATOL_REL
                  and r["checked"] > cs.CNN_MIN_COMPARED * r["total"])
        print("parity control, card %s: loss rel %.2e (limit %.0e); worst "
              "gradient %.3e x max (%s; limit %.0e); worst update %.3e x "
              "rate (%s; limit %.0e) over %d of %d entries; largest move "
              "%.4f x rate; %s"
              % ("tf32" if tf32 else "float32", r["loss_err"], cs.LOSS_RTOL,
                 grad[0], grad[1], cs.CNN_GRAD_ATOL_REL, update[0],
                 update[1], cs.UPDATE_ATOL_REL, r["checked"], r["total"],
                 r["max_move"], "passes" if passes else "FAILS the limits"),
              flush=True)


def _shape_times(torch, fn):
    """(first call ms, median ms of the next three, ms of FFT kernels and of
    all convolution kernels in one profiled call)."""
    import chip_smoke as cs

    first = cs.timed_ms(torch, fn, 1)[0]
    median = float(np.median(cs.timed_ms(torch, fn, 3)))
    by_name = cs.profile_device(torch, fn, ())[-1]
    fft = sum(ms for name, ms in by_name.items()
              if "fft" in name.lower() or "cf32" in name)
    return first, median, fft, cs.conv_ms(by_name)


def algorithms(torch, benchmark):
    import chip_smoke as cs
    from srf_tpu_torch.models.registry import build_model

    torch.backends.cudnn.benchmark = benchmark  # before any convolution
    label = "cudnn.benchmark %s" % ("on" if benchmark else "off")
    for name, flags, pads in (("CNN-TIMIT", cs.CNN_FLAGS, (1, 32, 128)),
                              ("SRF-TIMIT", cs.TIMIT_FLAGS, (1,))):
        config, state = _model_and_weights(torch, flags)
        model, _ = build_model(config, 63)
        model.load_state_dict(state)
        model = model.cuda().eval()
        firsts = {}
        for frames in SERVE_WIDTHS:
            for batch in SERVE_BATCHES:
                feats = torch.randn(batch, frames, 123, device="cuda")
                lengths = torch.full((batch,), frames, device="cuda")
                with torch.inference_mode():
                    first, med, fft, conv = _shape_times(
                        torch, lambda: model(feats, lengths))
                firsts["serve"] = firsts.get("serve", 0.0) + first
                print("%s, %s: serve forward %d x %d: first %.1f ms, then "
                      "median %.3f ms; profiled: conv %.3f ms, FFT %.3f ms"
                      % (label, name, batch, frames, first, med, conv, fft),
                      flush=True)
        del model
        train_state, _, step = cs.train_setup(torch, config, state, "cuda")
        # TrainState.create resolves the device, which turns the search on
        torch.backends.cudnn.benchmark = benchmark
        seed = config.tpu_seed
        measured = {}  # (batch, frames) -> its first call's ms
        for pad in pads:
            key = "train, padded to %d" % pad if pad > 1 else "train"
            for batch, boundary in TRAIN_BUCKETS:
                frames = -(-boundary // pad) * pad
                if (batch, frames) not in measured:
                    data = cs.train_batch(torch, "cuda", batch=batch,
                                          frames=frames)
                    first, med, fft, conv = _shape_times(
                        torch, lambda: step(train_state, data, seed))
                    measured[batch, frames] = first
                    print("%s, %s: train step %d x %d (bucket %d, padded to "
                          "%d): first %.1f ms, then median %.3f ms; "
                          "profiled: conv %.3f ms, FFT %.3f ms"
                          % (label, name, batch, frames, boundary, pad,
                             first, med, conv, fft), flush=True)
                firsts[key] = firsts.get(key, 0.0) + measured[batch, frames]
        for key, total in firsts.items():
            print("%s, %s: first calls, %s shapes: %.1f s in all"
                  % (label, name, key, total / 1e3), flush=True)
        del train_state, step
        torch.cuda.empty_cache()


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_cnn_numerics: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(REPO, "chip_smoke.py")):
        print("chip_cnn_numerics: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build

    resolve_device("cuda")
    cuda_build.build(["sdr_fwd", "sdr_bwd", "fused_dropout"])
    if argv[1:] in (["--cudnn-benchmark=on"], ["--cudnn-benchmark=off"]):
        algorithms(torch, argv[1].endswith("on"))
        return 0
    card = cs.card_line()
    print("card: %s" % card, flush=True)
    start = time.perf_counter()
    precision(torch)
    parity_control(torch)
    print("precision: %.1f s" % (time.perf_counter() - start), flush=True)
    for setting in ("off", "on"):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cudnn-benchmark=" + setting], check=True,
                       timeout=1800)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
