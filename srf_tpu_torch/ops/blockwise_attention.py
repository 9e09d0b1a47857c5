"""Blockwise (flash-style) attention for long STF sequences (port of
``srf_tpu/ops/blockwise_attention.py``, in torch ops).

Attention is computed with the online-softmax recurrence over key blocks
of ``block_k`` (256):

- live memory per block is [B, H, T, block_k] instead of [B, H, T, T];
  in training each block runs under ``torch.utils.checkpoint``, so the
  backward keeps only each block's carry and recomputes its scores, as
  JAX's ``jax.checkpoint`` around the scan body does;
- the distance penalty is applied in closed form per (query, key-block)
  tile (``-log1p(scale * clip(ceil((d - zero_width + 1)/stripe_width), 0,
  n_stripes))``, the board's values, ``ops/attention_penalty.py``);
- attention dropout drops tiles of unnormalized probabilities while the
  denominator accumulates the undropped sum, which equals dropping the
  normalized weights. Each block's mask comes from a generator seeded with
  ``site_seed(dropout_seed, block)``, a host integer, so the checkpoint's
  recomputation draws the same mask (an explicit ``torch.Generator``'s
  state is not restored by ``torch.utils.checkpoint``);
- the -1e9 additive padding mask matches the plain path. Keys padded past
  T to fill the last block are masked with 1, as in JAX, and also get a
  -inf score, so they carry no weight even in a row whose keys are all
  masked: such a row comes out as the plain path's uniform distribution
  over the T keys. (JAX's blockwise spreads such a row over the padded
  keys as well when T is not a multiple of ``block_k``.)
"""

from typing import NamedTuple

import torch
import torch.utils.checkpoint

from srf_tpu_torch.ops.dropout import site_seed


class PenaltyParams(NamedTuple):
    """Closed-form attention-penalty parameters (ops/attention_penalty.py)."""

    zero_width: int
    stripe_width: int
    scale: float
    n_stripes: int


def _tile_penalty(q_pos, k_pos, pen):
    d = (q_pos[:, None] - k_pos[None, :]).abs().to(torch.float32)
    count = torch.ceil((d - pen.zero_width + 1) / pen.stripe_width)
    count = count.clamp(0, pen.n_stripes)
    return torch.log1p(count * pen.scale) * -1.0  # additive score term


def online_softmax_step(carry, q_scaled, q_pos, k_blk, v_blk, msk_blk,
                        k_pos, penalty, past_end=None, dropout_rate=0.0,
                        generator=None):
    """One flash-attention accumulation step over a key block.

    carry: (m_run [B,H,Q], l_run [B,H,Q], acc [B,H,Q,D]) running max /
    denominator / numerator; ``past_end``: None, or a bool [block] of the
    keys padded past T. Returns the updated carry.
    """
    m_run, l_run, acc = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q_scaled, k_blk)
    if penalty is not None:
        s = s + _tile_penalty(q_pos, k_pos, penalty)[None, None]
    s = s + msk_blk * -1e9
    if past_end is not None:
        s = s.masked_fill(past_end, float("-inf"))
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    alpha = torch.exp(m_run - m_new)
    p = torch.exp(s - m_new[..., None])
    l_run = l_run * alpha + p.sum(dim=-1)
    if generator is not None and dropout_rate > 0.0:
        keep = torch.rand(p.shape, generator=generator, device=p.device,
                          dtype=p.dtype) >= dropout_rate
        p = p * keep / (1.0 - dropout_rate)
    acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
    return m_new, l_run, acc


def blockwise_attention(query, key, value, mask=None, penalty=None,
                        block_k=256, dropout_rate=0.0, dropout_seed=None):
    """Flash-style attention: softmax(QK^T/sqrt(d) + pen + mask*-1e9) V.

    Args:
        query/key/value: [B, H, T, D] (post head-split).
        mask: [B, 1, 1, T] additive padding mask (1 = padded).
        penalty: ``PenaltyParams`` or None.
        block_k: key-block size (T is padded up to a multiple).
        dropout_rate/dropout_seed: attention-weight dropout; the seed is a
            host integer (``models.layers.MultiHeadAttention`` derives it
            from the step's generator), None for no dropout.
    Returns [B, H, T, D].
    """
    batch, heads, seq_len, depth = query.shape
    device = query.device
    pad_k = (-seq_len) % block_k
    n_blocks = (seq_len + pad_k) // block_k

    kv_mask = (torch.zeros(batch, 1, 1, seq_len, device=device)
               if mask is None else mask.to(torch.float32))
    if pad_k:
        key = torch.nn.functional.pad(key, (0, 0, 0, pad_k))
        value = torch.nn.functional.pad(value, (0, 0, 0, pad_k))
        kv_mask = torch.nn.functional.pad(kv_mask, (0, pad_k), value=1.0)
    q_pos = torch.arange(seq_len, device=device)
    q_scaled = query.to(torch.float32) * depth ** -0.5
    drop = dropout_seed is not None and dropout_rate > 0.0

    def body(m_run, l_run, acc, q_scaled, k_blk, v_blk, msk_blk, blk_idx):
        k_pos = blk_idx * block_k + torch.arange(block_k, device=device)
        generator = None
        if drop:
            generator = torch.Generator(device).manual_seed(
                site_seed(dropout_seed, blk_idx))
        past_end = (k_pos >= seq_len
                    if (blk_idx + 1) * block_k > seq_len else None)
        return online_softmax_step(
            (m_run, l_run, acc), q_scaled, q_pos, k_blk, v_blk, msk_blk,
            k_pos, penalty, past_end, dropout_rate, generator)

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (query, key, value))
    m_run = torch.full((batch, heads, seq_len), float("-inf"), device=device)
    l_run = torch.zeros(batch, heads, seq_len, device=device)
    acc = torch.zeros(batch, heads, seq_len, depth, device=device)
    for blk in range(n_blocks):
        cols = slice(blk * block_k, (blk + 1) * block_k)
        args = (m_run, l_run, acc, q_scaled, key[:, :, cols],
                value[:, :, cols], kv_mask[..., cols], blk)
        if remat:
            m_run, l_run, acc = torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False)
        else:
            m_run, l_run, acc = body(*args)
    out = acc / l_run.clamp_min(1e-30)[..., None]
    return out.to(query.dtype)
