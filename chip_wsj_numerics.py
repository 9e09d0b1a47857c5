#!/usr/bin/env python3
"""The WSJ models on one GPU: how far each one's float32 train step is from
float64, and whether chip_smoke.py's gradient limit for it tells the
float32 card step from a lower-precision one. The measurements behind
WSJ_GRAD_ATOL_REL (SRF-WSJ, phase 12c) and STF_WSJ_GRAD_ATOL_REL
(STF-WSJ, phase 11c), and CNN-WSJ's step against CNN_GRAD_ATOL_REL
(phase 11b) (PERF.md).

    python3 chip_wsj_numerics.py [srf] [stf] [cnn]   # all three by default

STF-WSJ and CNN-WSJ take chip_smoke's parity steps (phases 11b-11c: the
STF at TRAIN_CHECK_BATCH rows, dropout off, with trainer_tf's padding bias
and penalty board; the CNN at CNN_WSJ_CHECK_ROWS rows with dropout on at
its K5 sites, the float64 step drawing the same masks), each reported as
the worst gradient over every tensor, card float32 and TF32 against the
CPU's float32 and each of them against the CPU's float64. SRF-WSJ:

Imports nothing of JAX or srf_tpu. On chip_smoke.py's SRF-WSJ model
(train_srf_wsj.sh widths) and numpy-seeded weights, phase 12c's parity
step: WSJ_CPU_ROWS utterances of its 8 x 300-1600 batch, dropout off. A
gradient's error is its max-abs error over its tensor's largest entry,
reported as the worst over the routing leaves (W*, b*: K2's dW and db, and
the ln_mid* LayerNorms between the routing layers) and the worst over the
front end (the convolutions, encaps*, flatten, ln_input, ln_output):

1. the parity control: chip_smoke's parity step (card vs CPU float32,
   ``parity_readings``) with the card in float32 (what chip_smoke runs),
   in TF32 (cuDNN's convolutions and cuBLAS's matmuls) and with bf16
   routing (K1-bf16 and K2-bf16), each group's worst beside
   WSJ_GRAD_ATOL_REL and whether the step passes chip_smoke's limits;
2. precision: each of those card steps and the CPU's float32 step against
   the CPU's float64 step (float64 from the input through the CTC loss).
"""

import os
import re
import sys
import time

ROUTING_LEAF = re.compile(r"^(W\d+|b\d+|ln_mid\d+\.(weight|bias))$")


def groups(errors):
    """{"routing": (worst, name), "front end": (worst, name)} of a {name:
    error} dict."""
    import chip_smoke as cs

    return {"routing": cs.worst({k: v for k, v in errors.items()
                                 if ROUTING_LEAF.match(k)}),
            "front end": cs.worst({k: v for k, v in errors.items()
                                   if not ROUTING_LEAF.match(k)})}


def describe(by_group):
    return "; ".join("%s worst %.3e (%s)" % (group, err, name)
                     for group, (err, name) in by_group.items())


def float64_grads(torch, config, state, batch, dropout=False):
    """{name: gradient} of one train step of ``config``'s model with
    ``state``'s weights on ``batch``, on the CPU in float64 (the train
    step's loss, sum(CTC) / B, without its update): dropout off, or
    ``dropout="k5"`` (``chip_smoke.train_setup``) with the first step's
    generator seed, so K5's sites draw the step's masks; the STF with its
    padding bias and penalty board."""
    import chip_smoke as cs
    from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
    from srf_tpu_torch.train.step import step_seed

    train_state, _, _ = cs.train_setup(torch, config, state, "cpu",
                                       dropout=dropout)
    model = train_state.model.double().train()
    cpu = {k: v.cpu() for k, v in batch.items()}
    in_len_div = config.model_conv_stride ** config.model_conv_layer_num
    extra = cs.extra_kwargs_fn(config, in_len_div)
    feats = cpu["feats"].double()
    kwargs = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
              else v for k, v in (extra({**cpu, "feats": feats})
                                  if extra else {}).items()}
    generator = torch.Generator().manual_seed(step_seed(config.tpu_seed, 0))
    logits = model(feats, cpu["inp_len"], generator, **kwargs)
    loss = ctc_loss_from_frames(logits, cpu["inp_len"], in_len_div,
                                cpu["labels"], cpu["tar_len"])
    (loss.sum() / cpu["feats"].shape[0]).backward()
    return {k: p.grad for k, p in model.named_parameters()
            if p.requires_grad}


def relative_errors(got, want):
    return {name: (got[name].double() - g).abs().max().item()
            / g.abs().max().item() for name, g in want.items()}


def served_logits(torch, config, cpu_config, state, feats_list):
    """{precision: [logits at each utterance's valid frames]} of the eval
    forward of ``feats_list`` (one padded batch) on the card in float32 and
    TF32 and on the CPU in float32 and float64."""
    from srf_tpu_torch.serve import Recognizer

    card = Recognizer(config, state_dict=state)
    cpu = Recognizer(cpu_config, state_dict=state, device="cpu")
    feats, lengths = card.pad(feats_list)
    out = {}
    with torch.inference_mode():
        for precision in ("card float32", "card tf32"):
            tf32 = precision == "card tf32"
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                out[precision] = card.forward(feats, lengths).double().cpu()
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
        out["cpu float32"] = cpu.forward(feats.cpu(), lengths).double()
        out["cpu float64"] = cpu.model.double().eval()(
            feats.cpu().double(), torch.as_tensor(lengths))
    return {k: [v[i, :len(f) // card.in_len_div]
                for i, f in enumerate(feats_list)] for k, v in out.items()}


def family_numerics(torch, card, label, flags, rows, limit, logit_limit,
                    serve_rows, **parity):
    """A chip_smoke family parity step (``rows`` of the first 24000-frame
    WSJ bucket, ``parity``: ``parity_readings``' keywords) with the card
    in float32 and TF32 against the CPU's float32, each beside ``limit``,
    then those card steps and the CPU's float32 step against the CPU's
    float64 step; and the served logits (the first ``serve_rows``
    utterances of the 8 x 300-1600 batch, at their valid frames) the same
    way, beside ``logit_limit``."""
    import chip_smoke as cs
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model

    start = time.perf_counter()
    logger = Logger(name="chip_wsj_numerics", level=Logger.WARN).logger
    config = cs.family_config(logger, "cuda", "wsj", flags)
    cpu_config = cs.family_config(logger, "cpu", "wsj", flags)
    state = cs.random_weights(build_model(config, cs.class_count(config))[0])
    logits = served_logits(
        torch, config, cpu_config, state,
        cs.wsj_serve_batches()["8x300-1600"][:serve_rows])
    for got, want in (("card float32", "cpu float32"),
                      ("card tf32", "cpu float32"),
                      ("card float32", "cpu float64"),
                      ("card tf32", "cpu float64"),
                      ("cpu float32", "cpu float64")):
        err = max((g - w).abs().max().item()
                  for g, w in zip(logits[got], logits[want]))
        print("%s served logits, %s vs %s: max %.3e (limit %.2g)"
              % (label, got, want, err, logit_limit), flush=True)
    b, t = cs.WSJ_BUCKET_SHAPES[0]
    batch = cs.train_batch(torch, "cuda", batch=b, frames=t,
                           vocab=cs.class_count(config) - 1)
    batch = {k: v[:rows] for k, v in batch.items()}
    card_grads = {}
    for precision, tf32 in (("float32", False), ("tf32", True)):
        r = cs.parity_readings(torch, config, state, batch, card_tf32=tf32,
                               count=config.train_warmup_n,
                               reference=(cpu_config, "cpu"), **parity)
        card_grads[precision], cpu_grads = r["card_grads"], r["cpu_grads"]
        grad, update = cs.worst(r["grads"]), cs.worst(r["updates"])
        print("%s parity control, card %s vs cpu float32: loss rel %.2e; "
              "worst gradient %.3e (%s; limit %.2g x max); worst update "
              "%.3e x rate (%s) over %d of %d entries [%s]"
              % (label, precision, r["loss_err"], grad[0], grad[1], limit,
                 update[0], update[1], r["checked"], r["total"], card),
              flush=True)
    exact = float64_grads(torch, cpu_config, state, batch,
                          dropout=parity.get("dropout", False))
    for name, grads in [("card " + k, v) for k, v in card_grads.items()] + [
            ("cpu float32", cpu_grads)]:
        errors = relative_errors(grads, exact)
        top = sorted(errors.items(), key=lambda item: -item[1])[:3]
        print("%s precision, %s vs cpu float64: worst gradients %s"
              % (label, name, ", ".join("%.3e (%s)" % (e, k)
                                         for k, e in top)), flush=True)
    print("%s numerics: %.1f s" % (label, time.perf_counter() - start))


def srf_numerics(torch, card):
    """SRF-WSJ's parity control and precision (the module docstring)."""
    import chip_smoke as cs
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model

    start = time.perf_counter()
    logger = Logger(name="chip_wsj_numerics", level=Logger.WARN).logger
    flags = cs.SRF_WSJ_FLAGS + ["--train-lr-param-k=0.6"]
    config = cs.family_config(logger, "cuda", "wsj", flags)
    state = cs.random_weights(build_model(config, cs.class_count(config))[0])
    batch = cs.train_batch(torch, "cuda", batch=8,
                           frames=cs.WSJ_TRAIN_FRAMES[1],
                           vocab=cs.class_count(config) - 1,
                           shortest=cs.WSJ_TRAIN_FRAMES[0])
    rows = {k: v[:cs.WSJ_CPU_ROWS] for k, v in batch.items()}
    bf16_config = cs.family_config(logger, "cuda", "wsj",
                                   flags + ["--tpu-routing-bf16=True"])
    cpu_config = cs.family_config(logger, "cpu", "wsj", flags)

    card_grads = {}
    for label, cfg, tf32 in (("float32", config, False),
                             ("tf32", config, True),
                             ("bf16 routing", bf16_config, False)):
        r = cs.parity_readings(torch, cfg, state, rows, card_tf32=tf32,
                               reference=(cpu_config, "cpu"))
        card_grads[label], cpu_grads = r["card_grads"], r["cpu_grads"]
        grad, update = cs.worst(r["grads"]), cs.worst(r["updates"])
        passes = (r["loss_err"] <= cs.LOSS_RTOL
                  and grad[0] <= cs.WSJ_GRAD_ATOL_REL
                  and r["max_move"] <= 1 + cs.UPDATE_ATOL_REL
                  and update[0] <= cs.UPDATE_ATOL_REL
                  and r["checked"] > 0.5 * r["total"])
        print("parity control, card %s vs cpu float32: loss rel %.2e (limit "
              "%.0e); gradients %s (limit %.0e x max); worst update %.3e x "
              "rate (%s; limit %.0e); %s"
              % (label, r["loss_err"], cs.LOSS_RTOL,
                 describe(groups(r["grads"])), cs.WSJ_GRAD_ATOL_REL,
                 update[0], update[1], cs.UPDATE_ATOL_REL,
                 "passes" if passes else "FAILS the limits"), flush=True)

    exact = float64_grads(torch, config, state, rows)
    for label, grads in [("card " + k, v) for k, v in card_grads.items()] + [
            ("cpu float32", cpu_grads)]:
        print("precision, %s vs cpu float64: gradients %s"
              % (label, describe(groups(relative_errors(grads, exact)))),
              flush=True)
    print("SRF-WSJ numerics: %.1f s" % (time.perf_counter() - start))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_wsj_numerics: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(repo, "chip_smoke.py")):
        print("chip_wsj_numerics: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build

    resolve_device("cuda")
    models = sys.argv[1:] or ["srf", "stf", "cnn"]
    cuda_build.build(["sdr_fwd", "sdr_bwd", "fused_dropout"])
    card = cs.card_line()
    print("card: %s" % card, flush=True)
    start = time.perf_counter()
    if "srf" in models:
        srf_numerics(torch, card)
    if "stf" in models:
        family_numerics(torch, card, "STF-WSJ", cs.STF_WSJ_FLAGS,
                        cs.TRAIN_CHECK_BATCH, cs.STF_WSJ_GRAD_ATOL_REL,
                        cs.STF_LOGIT_ATOL, 8,
                        update_grad_rel=cs.STF_WSJ_UPDATE_GRAD_REL)
    if "cnn" in models:
        family_numerics(torch, card, "CNN-WSJ", cs.CNN_WSJ_FLAGS,
                        cs.CNN_WSJ_CHECK_ROWS, cs.CNN_WSJ_GRAD_ATOL_REL,
                        cs.CNN_WSJ_LOGIT_ATOL, cs.CNN_WSJ_CPU_SUBSET,
                        dropout="k5",
                        update_grad_rel=cs.CNN_WSJ_UPDATE_GRAD_REL)
    print("chip_wsj_numerics: %.1f s" % (time.perf_counter() - start))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
