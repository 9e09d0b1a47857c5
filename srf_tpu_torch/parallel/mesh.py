"""The data-parallel mesh (port of ``srf_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``jax.sharding.Mesh`` over ``("data",
"model")`` and shards each batch on its leading axis; the jitted step sees
the global batch and XLA inserts the gradient psum. The port runs one
process per card (``parallel/distributed.py``), so a mesh axis is a
``torch.distributed`` process group over ranks:

- :func:`make_mesh` gives a :class:`Mesh` whose ``device_mesh`` is a
  ``torch.distributed.device_mesh.DeviceMesh`` with axes ``("data",
  "model")`` (``("data", "pipe")`` for the STF pipeline,
  :func:`make_pipeline_mesh`), or no ``device_mesh`` in one process;
- JAX's ``put_sharded`` / ``shard_batch``: each rank's local batch stays on
  its card, and the train step (``train/step.py``) reduces what JAX's
  global array reduces (the global batch size, the gradients, BatchNorm's
  sums, the metrics) over the ``data`` group;
- JAX's ``make_global_replicated``: :func:`broadcast_state` copies rank
  0's parameters, buffers and EMA to every rank, at the start and after a
  restore.

The ``model`` axis (``num_model`` > 1): ranks are laid out as JAX reshapes
its devices, row-major over ``(num_data, num_model)`` (global rank = data
index x num_model + model index), so the ``model`` group holds the ranks
of one data index, which see the same rows, and the ``data`` group the
ranks that hold the same class-capsule shard
(``parallel/sharding_rules.apply_rules``). No CLI flag builds one, as in
JAX: the library API does (``make_mesh(num_data, num_model)``).
"""

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.parallel.sharding_rules import model_shard


@dataclasses.dataclass
class Mesh:
    """``shape``: {axis: size} as JAX's ``mesh.shape``; ``device_mesh``:
    the DeviceMesh over the world's ranks (None in one process)."""

    shape: Dict[str, int]
    device_mesh: Any = None

    def group(self, axis="data"):
        """The process group of ``axis`` that holds this rank (None in one
        process)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis="data"):
        """This rank's coordinate on ``axis`` (0 in one process)."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)


def _build(axes, sizes, device):
    """The mesh of ``sizes`` (their product the world size) along
    ``axes``."""
    if not distributed.is_initialized():
        return Mesh(dict(zip(axes, sizes)))
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(dict(zip(axes, sizes)), init_device_mesh(
        torch.device(device or "cuda").type, tuple(sizes),
        mesh_dim_names=axes))


def make_mesh(num_data=-1, num_model=1, device=None):
    """A ``("data", "model")`` mesh of the world's ranks (``--tpu-mesh-data``
    is ``num_data``; -1 means world / ``num_model``). The world size must
    be ``num_data`` x ``num_model``, or it raises: each rank is one card,
    so a mesh of 2 x 2 needs 4 processes. ``device`` (``--device``) gives
    the DeviceMesh's type."""
    if num_model is None or num_model < 1:
        raise ValueError("num_model must be >= 1 (got %r)" % (num_model,))
    world = distributed.world_size()
    if num_data in (None, 0) or num_data < 0:
        num_data = max(1, world // num_model)
    if num_data * num_model != world:
        need = num_data * num_model
        raise ValueError(
            "a (data %d, model %d) mesh needs %d processes (one per card), "
            "but %d %s running: launch %d processes (SRF_COORDINATOR, "
            "SRF_NUM_PROCESSES and SRF_PROCESS_ID, or torchrun with "
            "SRF_MULTIHOST=1)" % (num_data, num_model, need, world,
                                  "is" if world == 1 else "are", need))
    return _build(("data", "model"), (num_data, num_model), device)


def make_pipeline_mesh(stages, num_data=-1, device=None):
    """The STF pipeline's ``("data", "pipe")`` mesh (JAX's trainer_tf: the
    devices reshaped to (data, stages), rank = data index x stages + stage).
    ``num_data`` -1 takes world / stages; the product must be the world
    size (a single process with ``stages`` > 1 raises)."""
    world = distributed.world_size()
    if num_data in (None, 0) or num_data < 0:
        num_data = max(1, world // stages)
    if num_data * stages != world:
        raise ValueError(
            "--tpu-pipeline-stages=%d with %d data shard(s) needs %d "
            "processes (one per card), but %d %s running: launch %d "
            "processes" % (stages, num_data, num_data * stages, world,
                           "is" if world == 1 else "are",
                           num_data * stages))
    return _build(("data", "pipe"), (num_data, stages), device)


def broadcast_state(state, group=None):
    """Copy rank 0's (of ``group``, the world by default) parameters,
    buffers and EMA into every rank's ``state`` in place (JAX's
    ``make_global_replicated``: a freshly built or restored state becomes
    the one replicated state). Nothing in one process. FSDP's sharded
    parameters are left as they are: they are sharded, not replicated. A
    ``model``-axis shard (``sharding_rules.apply_rules``) has the same
    shape on every model rank but other values, so it goes only over its
    ``data`` group, from that group's rank 0: each rank keeps its own
    shard of rank 0's weights."""
    if distributed.world_size(group) <= 1:
        return state
    shard = model_shard(state.model)
    sharded = set(shard.spans) if shard is not None else set()
    tensors = [(k, t) for k, t in state.model.state_dict().items()
               if not _is_dtensor(t)]
    if state.ema is not None:
        tensors += [(k, t) for k, t in state.ema.items()
                    if not _is_dtensor(t)]
    with torch.no_grad():
        for name, tensor in tensors:
            on = shard.data_group if name in sharded else group
            if distributed.world_size(on) > 1:
                dist.broadcast(tensor, distributed.global_rank(on, 0),
                               group=on)
    return state


def _is_dtensor(tensor):
    from torch.distributed.tensor import DTensor

    return isinstance(tensor, DTensor)
