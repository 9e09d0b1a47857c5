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

The training extras (``srf_tpu/train/step.py:22-148``):

- ``--tpu-grad-accum`` k > 1: the batch goes through forward and backward
  in microbatches, k the largest divisor of its size that is at most the
  flag (JAX's rule), each loss scaled by the *global* batch, so the
  gradients summed in ``.grad`` are the full batch's; BatchNorm's running
  statistics move once per microbatch (JAX's carry); dropout continues
  the step's generator; one optimizer and one scheduler step per update.
- ``--tpu-ema-decay`` d > 0: after the update, ``ema += (1 - d) * (p -
  ema)`` over the state's EMA (``TrainState.update_ema``).
- SpecAugment (``augment_fn``, ``ops/specaugment.make_augment_fn``): the
  features are masked in training mode only, before any bf16 cast, from
  the step's generator.
- ``--tpu-bf16``: the forward runs on bf16 copies of the float32 master
  parameters (``torch.func.functional_call``; gradients reach the masters
  through the casts) and bf16 features; the model's layers follow flax's
  type promotion where a float32 activation meets bf16 parameters
  (``models/layers.Linear``, ``Conv2d``, ``LayerNorm``); BatchNorm's
  statistics stay float32; the logits are cast to float32 before the CTC
  (an FSDP model casts its gathered parameters itself, its mixed
  precision: ``parallel/sharding_rules.fsdp``). The SDR layers compute in
  float32 at ``SDRFunction``'s boundary (bf16 routing is the model's own
  flag, ``--tpu-routing-bf16``), and K5 runs its bf16 variant.

Data parallelism (``group``, the mesh's ``data`` process group,
``parallel/mesh.py``): each rank runs the step on its own rows, and the
step reduces what JAX's jitted step computes over its global array:

- the loss is ``sum(pe_loss) / B_global``, ``B_global`` the sum of the
  ranks' batch sizes (one all-reduce a step);
- the gradients are all-reduced as a *sum* (not DDP's mean) in one flat
  buffer after the last microbatch's backward, over ``grad_group``
  (``group`` by default; the STF pipeline reduces over the whole mesh).
  An FSDP model (``parallel/sharding_rules.fsdp``) reduce-scatters its
  own, summed as well, and syncs only on the last microbatch;
- BatchNorm normalises over the global batch
  (``models/layers.set_batch_norm_group``, set on the model by the
  trainer), so its statistics, their gradients and the running averages
  are JAX's;
- ``loss_sum``, ``samples`` and ``frames`` are all-reduced, so the loop's
  logs and ``metrics.jsonl`` show JAX's global numbers;
- F22: the dropout seed folds in the rank on ``group``, or every rank
  would draw the same masks for different rows;
- the ``model`` axis (``parallel/sharding_rules.apply_rules``,
  ``model_group`` the mesh's ``model`` group): the model ranks of one data
  index hold the same rows and split the class capsules, so every
  reduction above stays over ``group``, the ``data`` group, and never the
  world (a world group would count the batch, the metrics and the
  gradients ``num_model`` times): ``B_global``, the metrics, the
  gradients of the replicated parameters and of the shards (summed over
  the ranks that hold the same shard), BatchNorm's sums (the trainer sets
  the data group on the model), and the dropout seed's fold, the data
  index, so that the model ranks draw the same masks on their replicated
  activations. The step raises where ``group`` and ``model_group`` do not
  make up the world, and its first call checks that the model ranks hold
  the same batch (one small all-reduce of a fingerprint);
- ``--tpu-grad-accum``: microbatch i is every rank's local slice i. With
  the global BatchNorm that is JAX's step on the global batch permuted to
  ``[r0 mb0, r1 mb0, r0 mb1, ...]`` (JAX's microbatch i is the contiguous
  global rows i). F23: k is the largest divisor of the *local* batch at
  most the flag, where JAX takes the global batch's (``microbatches``).
"""

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.utils.profiler import span

def bf16_params(model):
    """{name: bf16 copy} of ``model``'s float32 parameters, differentiable
    into the float32 masters (frozen ones, such as the LSTM's zero
    ``bias_ih``, are cast too, so that a layer's weights share one dtype,
    and receive no gradient)."""
    return {name: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
            for name, p in model.named_parameters()}


def make_apply_fn(model, extra_kwargs_fn=None, bf16=False, augment_fn=None):
    """Uniform apply adapter: (batch, training, generator) -> float32
    logits [B, T', K]. Sets the model's mode; in training mode the model
    moves its BatchNorm running statistics itself. ``bf16`` and
    ``augment_fn``: the module docstring."""

    def apply_fn(batch, training, generator=None):
        model.train(training)
        feats = batch["feats"]
        lengths = batch["inp_len"].to(feats.device, non_blocking=True)
        if augment_fn is not None and training:
            feats = augment_fn(feats, lengths, generator)
        kwargs = (extra_kwargs_fn({**batch, "inp_len": lengths})
                  if extra_kwargs_fn else {})
        if not bf16:
            return model(feats, lengths, generator, **kwargs).float()
        if reduces_own_gradients(model):
            # FSDP all-gathers bf16 copies itself (its mixed precision)
            return model(feats.to(torch.bfloat16), lengths, generator,
                         **kwargs).float()
        out = torch.func.functional_call(
            model, bf16_params(model),
            (feats.to(torch.bfloat16), lengths, generator), kwargs)
        return out.float()

    return apply_fn


def step_seed(seed, step, rank=0):
    """The dropout seed of update ``step`` under ``seed`` (``--tpu-seed``)
    on data-parallel rank ``rank`` (F22: rank 0's is the one process's)."""
    base = (seed * 1_000_003 + step) % (1 << 63)
    if rank:
        base = (base * 1_000_033 + rank) % (1 << 63)
    return base


def global_count(count, device, group):
    """``count`` summed over ``group`` as a float32 tensor on ``device``
    (the global batch size; no host wait under NCCL)."""
    total = torch.full((), float(count), device=device)
    if group is not None:
        dist.all_reduce(total, group=group)
    return total


def reduces_own_gradients(model):
    """True for an FSDP model, whose backward reduce-scatters its
    gradients itself."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def all_reduce_gradients(model, group):
    """Sum every trained parameter's ``.grad`` over ``group`` in one flat
    buffer (a parameter that got no gradient on this rank, such as the
    pipeline's other stages' blocks, adds zeros)."""
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for p, grad in zip(params, _unflatten_dense_tensors(flat, grads)):
        p.grad = grad


def reduce_metrics(metrics, group, keys):
    """``metrics`` with ``keys`` summed over ``group`` (one all-reduce)."""
    if group is None:
        return metrics
    values = torch.stack([metrics[key] for key in keys])
    dist.all_reduce(values, group=group)
    return dict(metrics, **dict(zip(keys, values.unbind(0))))


def check_mesh_groups(group, model_group):
    """Raise unless the ``data`` group ``group`` and the ``model`` group
    ``model_group`` make up the world (each the mesh's, not the world):
    the step reduces over ``group`` only."""
    data_n, model_n = (1 if g is None else distributed.world_size(g)
                       for g in (group, model_group))
    if model_n > 1 and data_n * model_n != distributed.world_size():
        raise ValueError(
            "a step on a 'model' mesh axis reduces over the mesh's 'data' "
            "group: got a group of %d ranks and a model group of %d in a "
            "world of %d" % (data_n, model_n, distributed.world_size()))


def check_model_replicas(batch, model_group):
    """Raise unless every rank of ``model_group`` holds the same batch
    (its size, features' sum and lengths' sum, reduced by MAX and MIN)."""
    if model_group is None or distributed.world_size(model_group) <= 1:
        return
    feats = batch["feats"]
    fingerprint = torch.stack([
        torch.tensor(float(feats.shape[0]), dtype=torch.float64,
                     device=feats.device),
        feats.detach().double().sum(),
        batch["inp_len"].to(feats.device).double().sum()])
    high, low = fingerprint.clone(), fingerprint.clone()
    dist.all_reduce(high, op=dist.ReduceOp.MAX, group=model_group)
    dist.all_reduce(low, op=dist.ReduceOp.MIN, group=model_group)
    if not torch.equal(high, low):
        raise ValueError(
            "the 'model' ranks of one data index must hold the same rows "
            "(shard the batch over the mesh's 'data' axis only)")


def divisor_at_most(size, requested):
    """The largest divisor of ``size`` at most ``requested`` (JAX's rule
    for microbatch counts: bucket sizes vary, so an indivisible size takes
    a smaller count rather than an error)."""
    k = max(1, min(int(requested or 1), size))
    while size % k:
        k -= 1
    return k


def microbatches(batch, accum_steps):
    """The batch's k microbatches, k = ``divisor_at_most(size,
    accum_steps)``; each a dict of the same keys sliced along the batch
    axis (views)."""
    size = batch["feats"].shape[0]
    k = divisor_at_most(size, accum_steps)
    if k == 1:
        return [batch]
    mb = size // k
    return [{key: value[i * mb:(i + 1) * mb] for key, value in batch.items()}
            for i in range(k)]


def optimizer_update(state, ema_decay=0.0):
    """One optimizer and schedule step from the gradients in ``.grad``,
    the update count, and the EMA where ``ema_decay`` > 0 and the state
    keeps one."""
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    if ema_decay > 0.0 and state.ema is not None:
        state.update_ema(ema_decay)


def make_train_step(apply_fn, in_len_div, accum_steps=1, ema_decay=0.0,
                    group=None, grad_group=None, model_group=None):
    """Returns ``train_step(state, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``feats`` [B, T, F] and ``labels`` [B, L] on one device
    and ``inp_len`` and ``tar_len`` [B] on the host (or that device);
    ``state`` is a ``TrainState`` on that device (``TrainState.create``
    puts the model there: the CUDA device unless the CPU is asked for),
    updated in place. The step's gradients stay in the parameters' ``.grad`` until the
    next step. ``metrics`` are device tensors: ``loss_sum`` (sum of the
    per-example losses over the microbatches), ``samples`` and ``frames``.
    ``accum_steps`` and ``ema_decay``: the module docstring; the EMA moves
    only where the state keeps one (``TrainState.create(with_ema=True)``).
    ``group`` / ``grad_group``: data parallelism, ``model_group``: the
    ``model`` axis (the module docstring). Each step is a ``srf.step``
    span (``utils/profiler.py``) around ``srf.step.forward``,
    ``srf.step.loss`` and ``srf.step.backward`` a microbatch and one
    ``srf.step.optimizer`` (the gradients' reduction and the update).
    """
    generators = {}
    grad_group = grad_group if grad_group is not None else group
    check_mesh_groups(group, model_group)
    checked = []

    def train_step(state, batch, seed):
        with span("srf.step"):
            return step(state, batch, seed)

    def step(state, batch, seed):
        feats = batch["feats"]
        if not checked:
            check_model_replicas(batch, model_group)
            checked.append(True)
        if feats.device not in generators:
            generators[feats.device] = torch.Generator(feats.device)
        generator = generators[feats.device]
        generator.manual_seed(step_seed(
            seed, state.step, distributed.rank(group) if group else 0))
        global_batch = global_count(feats.shape[0], feats.device, group)
        fsdp = grad_group is not None and reduces_own_gradients(state.model)

        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        parts = microbatches(batch, accum_steps)
        for i, mb in enumerate(parts):
            if fsdp:
                state.model.set_requires_gradient_sync(i == len(parts) - 1)
            with span("srf.step.forward"):
                logits = apply_fn(mb, True, generator)
            with span("srf.step.loss"):
                pe_loss = ctc_loss_from_frames(logits, mb["inp_len"],
                                               in_len_div, mb["labels"],
                                               mb["tar_len"])
            # the global batch scales every microbatch's loss; the
            # backward frees the microbatch's activations before the next
            with span("srf.step.backward"):
                (pe_loss.sum() / global_batch).backward()
            part = pe_loss.detach().sum()
            loss_sum = part if loss_sum is None else loss_sum + part
        with span("srf.step.optimizer"):
            if grad_group is not None and not fsdp:
                all_reduce_gradients(state.model, grad_group)
            optimizer_update(state, ema_decay)
        metrics = {
            "loss_sum": loss_sum,
            "samples": global_batch,
            "frames": batch["inp_len"].to(feats.device, non_blocking=True)
                      .sum().float(),
        }
        return state, reduce_metrics(metrics, group, ("loss_sum", "frames"))

    return train_step


def make_valid_step(apply_fn, in_len_div, group=None, model_group=None):
    """Returns ``valid_step(state, batch) -> metrics`` (eval mode, no
    gradients): ``loss_sum`` and ``samples`` as device tensors, summed
    over ``group`` under data parallelism (the ``data`` group on a
    ``model`` axis, ``model_group`` the ``model`` group: the module
    docstring)."""
    check_mesh_groups(group, model_group)

    def valid_step(state, batch):
        with torch.no_grad():
            logits = apply_fn(batch, False)
            pe_loss = ctc_loss_from_frames(
                logits, batch["inp_len"], in_len_div, batch["labels"],
                batch["tar_len"])
        metrics = {
            "loss_sum": pe_loss.sum(),
            "samples": torch.full((), float(batch["feats"].shape[0]),
                                  device=batch["feats"].device),
        }
        return reduce_metrics(metrics, group, ("loss_sum", "samples"))

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
