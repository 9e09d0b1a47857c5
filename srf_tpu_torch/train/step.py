"""Train and valid steps on one device (port of ``srf_tpu/train/step.py``).

The step is the JAX package's: forward in training mode (BatchNorm on batch
statistics and moving its running statistics, dropout on) -> per-example
CTC loss over ``ceil(inp_len / in_len_div)`` frames -> ``sum(pe_loss) /
B_global`` (reference: trainer_sr.py:57-68, ``compute_average_loss`` with
the global batch) -> backward -> optimizer update -> schedule advance. On a
CUDA device every SDR layer's forward is the K1 kernel and its backward
the K2 kernel (``ops/routing_cuda.SDRFunction``).

Batches keep their padded shape; padding is handled by masks and lengths,
as in the JAX package. The metrics stay on the device: the step reads
nothing back, so the host does not wait for the card. Give the lengths
(``inp_len``, ``tar_len``) on the host, as a data layer has them: the CTC
loss reads them there (``ops/ctc.py``), and lengths on the card would be
copied back, waiting for the whole forward; the model gets its own copy on
the card.

Dropout masks come from a ``torch.Generator`` on the batch's device seeded
from ``seed`` and the state's step count (the JAX step folds the step into
its key); the JAX stream itself cannot be reproduced.

``make_apply_fn``'s ``extra_kwargs_fn(batch)`` gives a model keyword
arguments computed per batch (the STF's padding bias, penalty board and
``in_len_div``: ``trainer_tf.make_stf_extra_kwargs``); it sees the batch
with its lengths on the features' device.

Not ported yet, and refused: gradient accumulation, EMA, bf16 and
SpecAugment; there is no mesh (one card).
"""

import torch

from srf_tpu_torch.ops.ctc import ctc_loss_from_frames

_LATER = "%s is not ported yet: a later slice of the PyTorch port"


def make_apply_fn(model, extra_kwargs_fn=None, bf16=False, augment_fn=None):
    """Uniform apply adapter: (batch, training, generator) -> float32
    logits [B, T', K]. Sets the model's mode; in training mode the model
    moves its BatchNorm running statistics itself."""
    for name, value in (("bf16 (--tpu-bf16)", bf16),
                        ("augment_fn (SpecAugment)", augment_fn)):
        if value:
            raise NotImplementedError(_LATER % name)

    def apply_fn(batch, training, generator=None):
        model.train(training)
        feats = batch["feats"]
        lengths = batch["inp_len"].to(feats.device, non_blocking=True)
        kwargs = (extra_kwargs_fn({**batch, "inp_len": lengths})
                  if extra_kwargs_fn else {})
        return model(feats, lengths, generator, **kwargs).float()

    return apply_fn


def step_seed(seed, step):
    """The dropout seed of update ``step`` under ``seed`` (``--tpu-seed``)."""
    return (seed * 1_000_003 + step) % (1 << 63)


def make_train_step(apply_fn, in_len_div, accum_steps=1, ema_decay=0.0):
    """Returns ``train_step(state, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``feats`` [B, T, F] and ``labels`` [B, L] on one device
    and ``inp_len`` and ``tar_len`` [B] on the host (or that device);
    ``state`` is a ``TrainState`` on that device (``TrainState.create``
    puts the model there: the CUDA device unless the CPU is asked for),
    updated in place. The step's gradients stay in the parameters' ``.grad`` until the
    next step. ``metrics`` are device tensors: ``loss_sum`` (sum of the
    per-example losses), ``samples`` and ``frames``.
    """
    if accum_steps > 1:
        raise NotImplementedError(_LATER % "--tpu-grad-accum > 1")
    if ema_decay > 0.0:
        raise NotImplementedError(_LATER % "--tpu-ema-decay")
    generators = {}

    def train_step(state, batch, seed):
        feats = batch["feats"]
        if feats.device not in generators:
            generators[feats.device] = torch.Generator(feats.device)
        generator = generators[feats.device]
        generator.manual_seed(step_seed(seed, state.step))
        global_batch = feats.shape[0]

        logits = apply_fn(batch, True, generator)
        pe_loss = ctc_loss_from_frames(logits, batch["inp_len"], in_len_div,
                                       batch["labels"], batch["tar_len"])
        state.optimizer.zero_grad(set_to_none=True)
        (pe_loss.sum() / global_batch).backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        metrics = {
            "loss_sum": pe_loss.detach().sum(),
            "samples": torch.full((), float(global_batch),
                                  device=feats.device),
            "frames": batch["inp_len"].to(feats.device, non_blocking=True)
                      .sum().float(),
        }
        return state, metrics

    return train_step


def make_valid_step(apply_fn, in_len_div):
    """Returns ``valid_step(state, batch) -> metrics`` (eval mode, no
    gradients): ``loss_sum`` and ``samples`` as device tensors."""

    def valid_step(state, batch):
        with torch.no_grad():
            logits = apply_fn(batch, False)
            pe_loss = ctc_loss_from_frames(
                logits, batch["inp_len"], in_len_div, batch["labels"],
                batch["tar_len"])
        return {
            "loss_sum": pe_loss.sum(),
            "samples": torch.full((), float(batch["feats"].shape[0]),
                                  device=batch["feats"].device),
        }

    return valid_step


def make_logits_fn(apply_fn):
    """Inference logits for decoding: ``logits_fn(state, batch)`` with a
    numpy batch (``feats``, ``inp_len``) as ``EvalLoader`` yields it. The
    features go to the state's device, the lengths stay on the host; the
    float32 logits [B, T', K] stay on the device."""

    def logits_fn(state, batch):
        device = state.device
        feats = torch.as_tensor(batch["feats"]).to(device, non_blocking=True)
        inp_len = torch.as_tensor(batch["inp_len"])
        with torch.inference_mode():
            return apply_fn({"feats": feats, "inp_len": inp_len}, False)

    return logits_fn
