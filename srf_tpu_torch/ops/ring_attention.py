"""Ring (sequence-parallel) attention for the STF over a process group
(port of ``srf_tpu/ops/ring_attention.py``, in torch ops and
``torch.distributed`` point-to-point calls; no kernel lies on it, as JAX's
is XLA ops).

The time axis is split over the ranks of ``group``: each rank holds the
query, key and value shards [B, H, T/n, D], and the key and value shards,
with the key padding mask, rotate around the ring (rank i sends to i - 1
and receives from i + 1, :func:`parallel.distributed.ppermute`, whose
backward sends the gradients the inverse way) while the online softmax of
``ops/blockwise_attention.online_softmax_step`` accumulates, the rotating
shard being the key block. The [T, T] weights exist on no rank: a rank's
attention memory is O(T^2 / n). The distance penalty is the closed form
per (query shard, key shard) tile at *global* positions, so the result
equals blockwise attention's.

There is no attention dropout, as in JAX (the models refuse it).
"""

import math

import torch

from srf_tpu_torch.ops.blockwise_attention import online_softmax_step
from srf_tpu_torch.parallel.distributed import (
    gather_along, ppermute, rank, split_along, world_size,
)


def ring_attention_local(query, key, value, group, kv_mask=None,
                         penalty=None):
    """One rank's part: ``query``/``key``/``value`` its time shard [B, H,
    T/n, D] (shard i holds positions i·T/n ...), ``kv_mask`` its key
    padding-mask shard [B, 1, 1, T/n] (1 = padded), ``penalty`` the
    closed-form ``PenaltyParams`` or None. Returns [B, H, T/n, D]: this
    rank's queries against every key."""
    n, me = world_size(group), rank(group)
    batch, heads, t_local, depth = query.shape
    device = query.device
    q_pos = me * t_local + torch.arange(t_local, device=device)
    q_scaled = query.to(torch.float32) * (1.0 / math.sqrt(depth))
    if kv_mask is None:
        kv_mask = torch.zeros(batch, 1, 1, t_local, device=device)
    carry = (torch.full((batch, heads, t_local), float("-inf"),
                        device=device),
             torch.zeros(batch, heads, t_local, device=device),
             torch.zeros(batch, heads, t_local, depth, device=device))
    k_blk, v_blk, msk_blk = key, value, kv_mask.to(torch.float32)
    left, right = (me - 1) % n, (me + 1) % n
    for step in range(n):
        src = (me + step) % n
        k_pos = src * t_local + torch.arange(t_local, device=device)
        carry = online_softmax_step(carry, q_scaled, q_pos, k_blk, v_blk,
                                    msk_blk, k_pos, penalty)
        if step + 1 < n:
            # the next shard comes from the right neighbour
            k_blk = ppermute(k_blk, group, dst=left, src=right)
            v_blk = ppermute(v_blk, group, dst=left, src=right)
            msk_blk = ppermute(msk_blk, group, dst=left, src=right)
    _, l_run, acc = carry
    return (acc / l_run.clamp_min(1e-30)[..., None]).to(query.dtype)


def ring_attention(query, key, value, group, mask=None, penalty=None):
    """Sequence-parallel attention over ``group`` with global shapes in and
    out, as JAX's: ``query``/``key``/``value`` [B, H, T, D] and ``mask``
    [B, 1, 1, T] replicated on every rank; each rank takes its T/n shard,
    runs :func:`ring_attention_local` and gathers the output [B, H, T, D].
    The gradients of the replicated inputs are whole on every rank. T must
    divide by the group's size (pad and mask upstream otherwise)."""
    n = world_size(group)
    seq_len = query.shape[2]
    if seq_len % n:
        raise ValueError("ring_attention: T=%d not divisible by %d ranks"
                         % (seq_len, n))
    if mask is None:
        mask = torch.zeros(query.shape[0], 1, 1, seq_len,
                           device=query.device)
    shards = [split_along(t, group, 2) for t in (query, key, value)]
    out = ring_attention_local(*shards, group,
                               kv_mask=split_along(mask, group, 3),
                               penalty=penalty)
    return gather_along(out, group, 2)
