"""Fully-sharded data parallelism, ``--tpu-fsdp`` (port of
``srf_tpu/parallel/sharding_rules.fsdp_sharding``).

JAX shards a whole TrainState over the mesh's ``data`` axis, so the Adam
moments shard as their parameters do, and XLA all-gathers at use and
reduce-scatters the gradients. The port applies FSDP2
(``torch.distributed.fsdp.fully_shard``) to the model over the ``data``
axis of the mesh (``parallel/mesh.py``) before the optimizer is built, so
Adam makes its moments as sharded DTensors beside their parameters:

- the forward all-gathers the parameters into whole, contiguous tensors
  (K1's and K2's ctypes wrappers, ``ops/routing_cuda.py``, receive those)
  and the backward reduce-scatters the gradients as a plain **sum**
  (divide factor 1, sum-only reductions, which gloo runs too): the step's
  loss is already divided by the global batch (``train/step.py``), as
  JAX's is;
- a checkpoint holds whole tensors (:func:`full_state`), the one-process
  file, and loads back into the sharded model (:func:`shard_like`).

Layout only differs from JAX's: FSDP2 shards dim 0 of every parameter
(``torch.chunk``'s split, padded inside FSDP), where JAX shards the
largest axis the data size divides, and only leaves of at least 1024
elements. The values and the update are the same.

Without a process group (one plain process) :func:`fsdp` shards nothing,
as JAX's rule leaves every leaf replicated on a mesh of 1; under a
process group of one rank (NCCL at world size 1) FSDP runs, with its
all-gather and reduce-scatter over that one rank.

The class-capsule rules of JAX's ``srf_rules`` / ``apply_rules`` (the
``model`` axis) wait for ROADMAP.md section 1 item 7b.
"""

import torch


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def fsdp(model, mesh, logger=None, bf16=False):
    """Shard ``model``'s parameters over ``mesh``'s ``data`` axis (in
    place; returns the model). Build the optimizer afterwards. ``bf16``
    (``--tpu-bf16``): the forward's all-gathered parameters are bf16
    copies of the float32 masters, and the gradients reduce in float32
    (what ``train/step.bf16_params`` does for an unsharded model)."""
    if mesh.device_mesh is None:
        if logger:
            logger.info("FSDP: one process, nothing to shard")
        return model
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    policy = (MixedPrecisionPolicy(param_dtype=torch.bfloat16,
                                   reduce_dtype=torch.float32,
                                   cast_forward_inputs=False)
              if bf16 else MixedPrecisionPolicy())
    fully_shard(model, mesh=mesh.device_mesh["data"], mp_policy=policy)
    # a plain SUM reduce-scatter (no divide, no NCCL-only PreMulSum)
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)
    if logger:
        logger.info("FSDP: params + optimizer state sharded over 'data' "
                    "(%d ranks)", mesh.shape["data"])
    return model


def _gather(tensor):
    """The whole tensor of a DTensor sharded on dim 0 (FSDP2's layout):
    each rank's ``torch.chunk`` shard padded to the chunk size, one
    ``all_gather_into_tensor``, the padding cut off. ``DTensor.full_tensor``
    would take the functional collectives, which crash on gloo with CUDA
    tensors (a segmentation fault in their wait, on torch 2.11)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    if tuple(tensor.placements) != (Shard(0),):
        raise ValueError("cannot gather a DTensor laid out as %s"
                         % (tensor.placements,))
    group = tensor.device_mesh.get_group()
    rows, ranks = tensor.shape[0], dist.get_world_size(group)
    chunk = -(-rows // ranks)
    local = tensor.to_local()
    padded = local.new_zeros((chunk,) + tuple(tensor.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((chunk * ranks,) + tuple(tensor.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:rows]


def full_state(tree):
    """``tree`` (dicts, lists, tensors) with every DTensor gathered into a
    whole tensor (a collective: every rank calls it)."""
    DTensor = _dtensor()
    if isinstance(tree, DTensor):
        return _gather(tree.detach())
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    return tree


def shard_like(value, live):
    """A whole tensor ``value`` laid out as ``live`` is: this rank's shard
    of it as a DTensor where ``live`` is one (no communication: every rank
    holds the whole tensor), else ``value`` itself."""
    DTensor = _dtensor()
    if not isinstance(live, DTensor):
        return value
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(live.device, live.dtype),
                             live.device_mesh, live.placements,
                             src_data_rank=None)


def local(tensor):
    """The local shard of a DTensor (a view that shares its storage), or
    the tensor itself."""
    return tensor.to_local() if isinstance(tensor, _dtensor()) else tensor


def shard_optimizer_state(opt_state, optimizer):
    """A one-process ``optimizer.state_dict()`` (whole tensors, states
    keyed by parameter index) with each state tensor of a parameter's
    shape laid out as that parameter is."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for index, values in opt_state["state"].items():
        param = params[int(index)]
        state[index] = {
            k: (shard_like(v, param) if torch.is_tensor(v)
                and tuple(v.shape) == tuple(param.shape) else v)
            for k, v in values.items()}
    return dict(opt_state, state=state)
