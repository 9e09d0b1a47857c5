#!/usr/bin/env python3
"""SRF-WSJ on one GPU: how far its float32 train step is from float64, and
whether chip_smoke.py's WSJ_GRAD_ATOL_REL tells the float32 card step from
a lower-precision one. The measurements behind that limit (PERF.md).

    python3 chip_wsj_numerics.py        # from the root of a checkout

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


def float64_grads(torch, config, state, batch):
    """{name: gradient} of one dropout-free train step of ``config``'s
    model with ``state``'s weights on ``batch``, on the CPU in float64
    (the train step's loss, sum(CTC) / B, without its update)."""
    import chip_smoke as cs
    from srf_tpu_torch.ops.ctc import ctc_loss_from_frames

    train_state, _, _ = cs.train_setup(torch, config, state, "cpu",
                                       dropout=False)
    model = train_state.model.double().train()
    cpu = {k: v.cpu() for k, v in batch.items()}
    logits = model(cpu["feats"].double(), cpu["inp_len"])
    loss = ctc_loss_from_frames(logits, cpu["inp_len"],
                                config.model_conv_stride
                                ** config.model_conv_layer_num,
                                cpu["labels"], cpu["tar_len"])
    (loss.sum() / cpu["feats"].shape[0]).backward()
    return {k: p.grad for k, p in model.named_parameters()
            if p.requires_grad}


def relative_errors(got, want):
    return {name: (got[name].double() - g).abs().max().item()
            / g.abs().max().item() for name, g in want.items()}


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
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import cuda_build

    resolve_device("cuda")
    cuda_build.build(["sdr_fwd", "sdr_bwd"])
    card = cs.card_line()
    print("card: %s" % card, flush=True)
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
    print("chip_wsj_numerics: %.1f s" % (time.perf_counter() - start))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
