"""Parameter sharding over the mesh (port of
``srf_tpu/parallel/sharding_rules.py``): the ``model`` axis's rules
(:func:`srf_rules`, :func:`apply_rules`) and fully-sharded data
parallelism, ``--tpu-fsdp`` (:func:`fsdp`, JAX's ``fsdp_sharding``).

**The ``model`` axis.** JAX's ``apply_rules`` shards the class-capsule
layer's W and b on dim 1 (the out capsules) over ``model``, where the mesh
size divides it, and XLA partitions the routing softmax. The port's
:func:`apply_rules` replaces each matched parameter, in place and before
the optimizer is built, with this rank's contiguous shard ``W[:, o0:o1]``
(K1-tp's prediction kernel and K2-tp's weight-gradient kernel take
contiguous ``[in_n, O_local, out_d, in_d]``), so Adam makes shard-shaped
moments, as JAX shards ``mu`` and ``nu``. It records a
:class:`ModelShard` on the model (the spans, the ``model`` and ``data``
groups), which the model's forward (``models/srf.py``), the train step's
checks, ``mesh.broadcast_state`` and the checkpoints read. Plain tensors,
not DTensor: DTensor's functional collectives crash on gloo with CUDA
tensors (below). A checkpoint holds whole tensors (:func:`full_state`
gathers the shards and their moments over ``model``, a collective), the
one-process file; restoring slices it back (:func:`shard_like`,
:func:`shard_optimizer_state`), so a model trained on a ``model`` mesh
serves in one process. JAX never combines ``fsdp_sharding`` with
``apply_rules``; neither does the port (:func:`fsdp` raises on a
``model`` axis).

**FSDP.** JAX shards a whole TrainState over the mesh's ``data`` axis, so
the Adam moments shard as their parameters do, and XLA all-gathers at use
and reduce-scatters the gradients. The port applies FSDP2
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
"""

import dataclasses
import re
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass
class ModelShard:
    """What :func:`apply_rules` recorded on a model: ``spans`` {parameter
    name: (dim, start, length, whole size)} of this rank's shards, and the
    mesh's ``group`` (``model``) and ``data_group``."""

    spans: Dict[str, Tuple[int, int, int, int]]
    group: Any = None
    data_group: Any = None

    def layer(self, i):
        """(offset, whole out_n) of routing layer ``i``'s out capsules on
        this rank, or None where the layer is replicated."""
        span = self.spans.get("W%d" % i)
        return None if span is None else (span[1], span[3])


def model_shard(model):
    """The :class:`ModelShard` :func:`apply_rules` recorded on ``model``,
    or None."""
    return getattr(model, "model_shard", None)


def srf_rules():
    """[(parameter-name regex, sharded dim)], first match wins (JAX's
    ``PartitionSpec(None, "model", ...)``): the class-capsule layer's out
    capsules, dim 1 of W and of b."""
    return [(r"W\d+$", 1), (r"b\d+$", 1)]


def rule_specs(named_shapes, model_size):
    """{name: sharded dim or None} for ``named_shapes`` ({name: shape}) on
    a ``model`` axis of ``model_size``: JAX's ``apply_rules`` with
    :func:`srf_rules` on the port's names (``.`` read as ``/``). A rule
    applies only to the highest-numbered routing layer (the class
    capsules; the inner layers' out_n is small) and where the axis size
    divides the dim; on an axis of 1 nothing is sharded."""
    rules = srf_rules() if model_size > 1 else []
    layer_ids = [int(m.group(1)) for m in
                 (re.search(r"W(\d+)$", n) for n in named_shapes) if m]
    last = max(layer_ids) if layer_ids else None
    specs = {}
    for name, shape in named_shapes.items():
        specs[name] = None
        for pattern, dim in rules:
            if not re.search(pattern, name.replace(".", "/")):
                continue
            match = re.search(r"[Wb](\d+)", name)
            if match and int(match.group(1)) != last:
                continue
            if shape[dim] % model_size == 0:
                specs[name] = dim
                break
    return specs


def apply_rules(model, mesh):
    """Shard ``model``'s parameters over ``mesh``'s ``model`` axis in place
    (module docstring): each parameter :func:`rule_specs` names becomes
    this rank's contiguous shard of its sharded dim, and the model records
    a :class:`ModelShard`. Call it before the optimizer is built, and
    before ``mesh.broadcast_state``. Returns {name: sharded dim or None}
    for every parameter. Raises on an FSDP model."""
    if isinstance(model, _fsdp_module()):
        raise ValueError("--tpu-fsdp cannot be combined with a 'model' mesh "
                         "axis (JAX never combines fsdp_sharding with "
                         "apply_rules)")
    size = mesh.shape.get("model", 1)
    named = dict(model.named_parameters())
    specs = rule_specs({k: tuple(p.shape) for k, p in named.items()}, size)
    index = mesh.index("model")
    spans = {}
    with torch.no_grad():
        for name, dim in specs.items():
            if dim is None:
                continue
            param = named[name]
            whole = param.shape[dim]
            length = whole // size
            spans[name] = (dim, index * length, length, whole)
            param.data = param.data.narrow(dim, index * length,
                                           length).clone()
    if spans:
        model.model_shard = ModelShard(spans, mesh.group("model"),
                                       mesh.group("data"))
    return specs


def _fsdp_module():
    from torch.distributed.fsdp import FSDPModule

    return FSDPModule


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def fsdp(model, mesh, logger=None, bf16=False):
    """Shard ``model``'s parameters over ``mesh``'s ``data`` axis (in
    place; returns the model). Build the optimizer afterwards. ``bf16``
    (``--tpu-bf16``): the forward's all-gathered parameters are bf16
    copies of the float32 masters, and the gradients reduce in float32
    (what ``train/step.bf16_params`` does for an unsharded model)."""
    if mesh.shape.get("model", 1) > 1 or model_shard(model) is not None:
        raise ValueError("--tpu-fsdp cannot be combined with a 'model' mesh "
                         "axis (JAX never combines fsdp_sharding with "
                         "apply_rules)")
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


def gather_shard(tensor, span, group):
    """The whole tensor of this rank's ``model``-axis shard ``tensor``
    (``span`` its (dim, start, length, whole size)): every model rank's
    shard gathered over ``group`` in rank order (a collective)."""
    from srf_tpu_torch.parallel.distributed import world_size

    if group is None or world_size(group) == 1:
        return tensor
    import torch.distributed as dist

    parts = [torch.empty_like(tensor) for _ in range(world_size(group))]
    dist.all_gather(parts, tensor.detach().contiguous(), group=group)
    return torch.cat(parts, span[0])


def gather_named(named, model):
    """{name: tensor} with each of ``model``'s ``model``-axis shards (by
    name) gathered into its whole tensor (a collective: every rank calls
    it)."""
    shard = model_shard(model)
    if shard is None:
        return dict(named)
    return {k: (gather_shard(v, shard.spans[k], shard.group)
                if k in shard.spans and v is not None else v)
            for k, v in named.items()}


def _param_spans(model, params):
    """[span or None] of each of ``params`` (Parameter objects) in
    ``model``'s ModelShard."""
    shard = model_shard(model) if model is not None else None
    if shard is None:
        return [None] * len(params)
    names = {id(p): k for k, p in model.named_parameters()}
    return [shard.spans.get(names.get(id(p))) for p in params]


def full_state(tree, model=None):
    """``tree`` (dicts, lists, tensors) with every DTensor gathered into a
    whole tensor (a collective: every rank calls it). Given the ``model``
    whose checkpoint dict ``tree`` is (``trainer_sr.state_to_tree``), its
    ``model``-axis shards are gathered too: in ``"model"`` and ``"ema"``
    by name, and in ``"optimizer"`` each state tensor of a sharded
    parameter's shape (Adam's moments) by parameter index."""
    if model is not None and model_shard(model) is not None:
        shard = model_shard(model)
        tree = dict(tree)
        for part in ("model", "ema"):
            if tree.get(part) is not None:
                tree[part] = gather_named(tree[part], model)
        if tree.get("optimizer") is not None:
            opt = tree["optimizer"]
            order = [p for g in opt["param_groups"] for p in g["params"]]
            # the optimizer's parameters: the trained ones, in order
            # (train/optimizer.get_optimizer)
            params = {k: p for k, p in model.named_parameters()
                      if p.requires_grad}
            names = list(params)
            state = {}
            for index, values in opt["state"].items():
                name = names[order.index(index)]
                span = shard.spans.get(name)
                state[index] = {
                    k: (gather_shard(v, span, shard.group)
                        if span is not None and torch.is_tensor(v)
                        and tuple(v.shape) == tuple(params[name].shape)
                        else v)
                    for k, v in values.items()}
            tree["optimizer"] = dict(opt, state=state)
    return _full_dtensors(tree)


def _full_dtensors(tree):
    DTensor = _dtensor()
    if isinstance(tree, DTensor):
        return _gather(tree.detach())
    if isinstance(tree, dict):
        return {k: _full_dtensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_full_dtensors(v) for v in tree)
    return tree


def shard_like(value, live, span=None):
    """A whole tensor ``value`` laid out as ``live`` is: this rank's shard
    of it as a DTensor where ``live`` is one, or its ``model``-axis slice
    where a ``span`` (dim, start, length, whole size) is given (no
    communication: every rank holds the whole tensor), else ``value``
    itself."""
    if span is not None:
        dim, start, length, _ = span
        return value.narrow(dim, start, length).clone()
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


def shard_optimizer_state(opt_state, optimizer, model=None):
    """A one-process ``optimizer.state_dict()`` (whole tensors, states
    keyed by parameter index) with each state tensor of a parameter's
    whole shape laid out as that parameter is: a DTensor shard under FSDP,
    the ``model``-axis slice of a parameter that :func:`apply_rules`
    sharded on ``model``."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    spans = _param_spans(model, params)
    state = {}
    for index, values in opt_state["state"].items():
        param, span = params[int(index)], spans[int(index)]
        whole = (tuple(param.shape) if span is None else
                 tuple(span[3] if d == span[0] else n
                       for d, n in enumerate(param.shape)))
        state[index] = {
            k: (shard_like(v, param, span) if torch.is_tensor(v)
                and tuple(v.shape) == whole else v)
            for k, v in values.items()}
    return dict(opt_state, state=state)
