"""Process groups and collectives (port of ``srf_tpu/parallel/distributed.py``).

JAX runs one process per host over that host's devices; the port runs
**one process per GPU** under ``torch.distributed``. :func:`maybe_initialize`
starts the default process group from the environment, the same variables
the JAX package reads:

- ``SRF_COORDINATOR`` (``host:port``), ``SRF_NUM_PROCESSES`` (world size)
  and ``SRF_PROCESS_ID`` (rank): ``init_method="tcp://<coordinator>"``;
- ``SRF_MULTIHOST=1``, the counterpart of JAX's TPU-metadata
  autodetection: torchrun's ``env://`` variables (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).

Without either it starts nothing, and the entry points run one process. It
is idempotent, as JAX's ``_already_initialized`` makes it. The backend is
NCCL for a CUDA device and gloo for the CPU, unless the caller passes one
(``backend``; no CLI flag chooses it). A missing NCCL, a failed start or a
failed collective raises: nothing switches backends on its own.

Rank ``r`` takes ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the environment,
else the rank itself), so ``"cuda"`` names the rank's own card
(``device.resolve_device``). NCCL refuses two ranks on one device
("Duplicate GPU detected"); two ranks share one card only over gloo.

The **host group** (:func:`host_group`, a gloo group over every rank) carries
the consensus that lives on the host: the loader's all-gather of example
lengths, the preemption flag, barriers. Under NCCL it never touches a card.

The collectives below are differentiable where the training paths need
them (torch has no differentiable point-to-point operation):
:func:`ppermute` (ring attention's rotation and the pipeline's stage
hops), :func:`split_along` / :func:`gather_along` (ring attention's
global-in, global-out shards; the ``model`` axis's class capsules),
:func:`copy_to_group` and :func:`all_reduce_sum` (the ``model`` axis's
split routing softmax, ``ops/routing.py``). Global BatchNorm has its own
(``models/layers.py``).
"""

import os

import numpy as np
import torch
import torch.distributed as dist

# the host group of each default process group (a gloo group over every
# rank); torch.distributed's own state is per process, and so is this
_HOST_GROUPS = {}


def default_backend(device=None):
    """NCCL for a CUDA device (``None`` means CUDA, as ``resolve_device``
    reads it), gloo for the CPU."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def rank(group=None):
    """This process's rank in ``group`` (the world by default); 0 without a
    process group."""
    return dist.get_rank(group) if is_initialized() else 0


def world_size(group=None):
    """The size of ``group`` (the world by default); 1 without a process
    group."""
    return dist.get_world_size(group) if is_initialized() else 1


def local_rank():
    """``LOCAL_RANK`` from the environment (torchrun sets it), else the
    rank: the index of this process's card on its host."""
    value = os.environ.get("LOCAL_RANK")
    return int(value) if value not in (None, "") else rank()


def local_device(index=None):
    """``cuda:<index>`` (``local_rank()`` by default); raises where the
    host has no such card (a bare rank with no free device)."""
    index = local_rank() if index is None else index
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(
            "rank %d wants cuda:%d but this host has %d CUDA device(s); "
            "start one process per card, or set LOCAL_RANK"
            % (rank(), index, count))
    return torch.device("cuda", index)


def maybe_initialize(logger=None, backend=None, device=None):
    """Start the default process group from the environment (module
    docstring). Returns True when one is up (started here or before),
    False when the environment asks for none. ``device`` (``--device``)
    picks the default backend; ``backend`` overrides it.

    Under NCCL the rank is bound to its card before the group starts:
    ``cuda:LOCAL_RANK`` (torchrun sets it), or, under ``SRF_COORDINATOR``
    with no ``LOCAL_RANK``, ``cuda:<global rank>``. The latter is right on
    one host only: a job across hosts sets ``LOCAL_RANK`` on each (or runs
    under torchrun), or its ranks past the first host's card count find no
    card and raise. The card is passed as ``device_id``, so the group's
    NCCL communicator, and those of the groups made from it (the mesh's
    axes), are set up eagerly, by every rank at the same call."""
    if is_initialized():
        return True
    coordinator = os.environ.get("SRF_COORDINATOR")
    multihost = os.environ.get("SRF_MULTIHOST") == "1"
    if not coordinator and not multihost:
        return False
    backend = backend or default_backend(device)
    kwargs = {}
    if coordinator:
        kwargs = dict(init_method="tcp://" + coordinator,
                      world_size=int(os.environ.get("SRF_NUM_PROCESSES", "1")),
                      rank=int(os.environ.get("SRF_PROCESS_ID", "0")))
    else:
        kwargs = dict(init_method="env://")
    if backend == "nccl":
        # NCCL binds each rank to its card before the group starts, when
        # the rank is known only from the environment
        card = local_device(int(os.environ.get("LOCAL_RANK") or kwargs.get(
            "rank", os.environ.get("RANK", "0"))))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(backend=backend, **kwargs)
    host_group()
    if logger:
        logger.info(
            "torch.distributed initialized: rank %d/%d, backend %s, via %s",
            rank(), world_size(), backend, kwargs["init_method"])
    return True


def host_group():
    """The gloo group over every rank (None without a process group). Its
    first call is collective: every rank makes it at the same point
    (``maybe_initialize`` does, right after the start)."""
    if not is_initialized():
        return None
    world = dist.group.WORLD
    if world not in _HOST_GROUPS:
        _HOST_GROUPS[world] = (world if dist.get_backend() == "gloo"
                               else dist.new_group(backend="gloo"))
    return _HOST_GROUPS[world]


def barrier():
    """Wait for every rank, over the host group; nothing in one process."""
    if world_size() > 1:
        dist.barrier(group=host_group())


def host_all_reduce(values, op="sum"):
    """``values`` (numbers) reduced over every rank on the host group:
    ``op`` "sum" or "max". Returns a float64 numpy array."""
    out = torch.as_tensor(np.asarray(values, np.float64).reshape(-1))
    if world_size() > 1:
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=host_group())
    return out.numpy()


def host_all_gather(obj):
    """[every rank's ``obj``] in rank order (picklable host objects), over
    the host group."""
    if world_size() <= 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def global_rank(group, group_rank):
    """The world rank of ``group``'s rank ``group_rank`` (the world's own
    where ``group`` is None)."""
    return (group_rank if group is None
            else dist.get_global_rank(group, group_rank))


def _exchange(send, dst, recv_like, src, group):
    """Post one send (``send`` to group rank ``dst``) and one receive (a
    tensor like ``recv_like`` from group rank ``src``) together and wait;
    either side may be None. Returns the received tensor or None.

    gloo's point-to-point operations read and write host memory only (a
    CUDA tensor fails in its TCP transport, "writev ... Bad address";
    ``tools/dist_probe.py``), so under gloo a CUDA tensor goes through a
    host copy, as gloo's own collectives stage it; NCCL sends it from the
    card."""
    staged = (dist.get_backend(group) == "gloo"
              and any(t is not None and t.is_cuda for t in (send, recv_like)))
    ops, received = [], None
    if send is not None:
        send = send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, send.cpu() if staged else send,
                              global_rank(group, dst), group))
    if recv_like is not None:
        received = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                               device="cpu" if staged else recv_like.device)
        ops.append(dist.P2POp(dist.irecv, received, global_rank(group, src),
                              group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if received is not None and staged:
        received = received.to(recv_like.device)
    return received


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dst, src, like):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        ctx.x_meta = (x.shape, x.dtype, x.device)
        received = _exchange(x if dst is not None else None, dst,
                             like if src is not None else None, src, group)
        return received if received is not None else x.new_zeros(0)

    @staticmethod
    def backward(ctx, grad):
        # the transpose: the received tensor's gradient goes back to its
        # sender, and x's gradient comes back from where x went
        shape, dtype, device = ctx.x_meta
        like = (torch.empty(shape, dtype=dtype, device=device)
                if ctx.dst is not None else None)
        grad_x = _exchange(grad if ctx.src is not None else None, ctx.src,
                           like, ctx.dst, ctx.group)
        return grad_x, None, None, None, None


def ppermute(x, group, dst=None, src=None, like=None):
    """Differentiable point-to-point shift inside ``group`` (JAX's
    ``lax.ppermute`` for one rank's pair): send ``x`` to group rank
    ``dst`` and receive a tensor shaped like ``like`` (``x`` by default)
    from group rank ``src``; either may be None. Returns the received
    tensor (an empty one where ``src`` is None). The backward sends the
    received tensor's gradient back to ``src`` and receives ``x``'s from
    ``dst``. The send and the receive are posted together, so a ring of
    shifts cannot deadlock."""
    return _PPermute.apply(x, group, dst, src, x if like is None else like)


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = world_size(group), rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        # every rank holds the same gradient of the gathered tensor (the
        # computation after the gather is replicated): each takes its own
        # part, where a reduce-scatter would count it n times
        n, r = world_size(ctx.group), rank(ctx.group)
        return grad.chunk(n, ctx.dim)[r].contiguous(), None, None


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def split_along(x, group, dim):
    """This rank's equal part of a replicated ``x`` along ``dim``; the
    backward all-gathers the parts' gradients, so every rank gets the
    replicated input's whole gradient."""
    return _SplitAlong.apply(x, group, dim)


def gather_along(x, group, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward takes this rank's part of the (replicated) gradient."""
    return _GatherAlong.apply(x, group, dim)


def _sums_over(group):
    return group is not None and world_size(group) > 1


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x, group):
    """``x``, replicated over ``group``, as the input of a computation
    that ``group``'s ranks split between them (Megatron's ``f``): the
    identity forward, and a SUM all-reduce of the gradient backward, so
    that each rank's gradient of ``x`` holds every rank's part. The
    identity where ``group`` has one rank or is None."""
    return _CopyToGroup.apply(x, group) if _sums_over(group) else x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # every rank's output depends on every rank's x: the gradient of
        # x is the sum of the ranks' output gradients
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group):
    """``x`` summed over ``group`` (differentiable: the backward sums the
    gradients over ``group`` too); ``x`` itself where ``group`` has one
    rank or is None."""
    return _AllReduceSum.apply(x, group) if _sums_over(group) else x


def all_reduce_max(x, group):
    """The elementwise max of ``x`` over ``group``, detached (a new tensor;
    ``x`` detached where ``group`` has one rank or is None)."""
    out = x.detach().clone()
    if _sums_over(group):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
