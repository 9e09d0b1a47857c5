"""The port's attention pieces against srf_tpu's on the same numpy inputs:
``ops/masking.py``'s attention masks (exact), ``ops/attention_penalty.py``'s
board (exact) and gate, ``models/layers.MultiHeadAttention`` on the plain
path with weights carried by ``convert.py`` (atol 2e-6; float32 sums in
another order), and ``ops/blockwise_attention.blockwise_attention`` against
JAX's ``blockwise_attention`` and the plain path, forward (atol 2e-5, JAX's
own blockwise-vs-plain tolerance) and gradients (atol 5e-5), at T=300,
which is not a multiple of the 256-key block, with and without the
penalty, and with an utterance whose keys are all masked.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.layers import MultiHeadAttention as FlaxMHA
from srf_tpu.ops import masking as jax_masking
from srf_tpu.ops.attention_penalty import AttentionPenalty as JaxPenalty
from srf_tpu.ops.blockwise_attention import PenaltyParams as JaxParams
from srf_tpu.ops.blockwise_attention import (
    blockwise_attention as jax_blockwise,
)
from srf_tpu_torch import convert
from srf_tpu_torch.models.layers import (
    MultiHeadAttention, scaled_dot_product_attention,
)
from srf_tpu_torch.ops import blockwise_attention as blockwise_mod
from srf_tpu_torch.ops import masking
from srf_tpu_torch.ops.attention_penalty import (
    AttentionPenalty, create_attention_penalty,
)
from srf_tpu_torch.ops.blockwise_attention import (
    PenaltyParams, blockwise_attention,
)

from _torch_parity import random_flax_variables

torch.set_num_threads(1)

LOGGER = types.SimpleNamespace(info=lambda *a: None)
SEQ = 300  # 256 + 44: two key blocks, the second padded


def test_masks_match_jax():
    lens = np.array([17, 9, 1], np.int32)
    got = masking.get_padding_bias(torch.from_numpy(lens), 5, 4)
    want = jax_masking.get_padding_bias(jnp.asarray(lens), 5, 4)
    assert got.shape == (3, 1, 1, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tokens = np.array([[3, 1, 2, 0, 0], [5, 0, 0, 0, 0]], np.int32)
    for name in ("create_padding_mask", "create_combined_mask"):
        got = getattr(masking, name)(torch.from_numpy(tokens))
        want = getattr(jax_masking, name)(jnp.asarray(tokens))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        masking.create_look_ahead_mask(4).numpy(),
        np.asarray(jax_masking.create_look_ahead_mask(4)))


@pytest.mark.parametrize("zero,stripe,scale", [(1, 1, 1.0), (3, 5, 0.5)])
def test_penalty_board_matches_jax(zero, stripe, scale):
    """(1, 1, 1.0) is the STF-TIMIT recipe's (train_stf_timit.sh)."""
    got = AttentionPenalty(2500, 4, zero, stripe, scale)
    want = JaxPenalty(2500, 4, zero, stripe, scale)
    assert got.n_stripes == want.n_stripes
    for length in (1, 61, 300):
        board = got.penalty(length)
        assert board.shape == (1, length, length)
        assert board.dtype == torch.float32
        np.testing.assert_array_equal(board.numpy(),
                                      np.asarray(want.penalty(length)))
        assert got.penalty(length) is board  # built once per length


def test_penalty_gate():
    def config(**kw):
        base = dict(model_ap_encoder=True, model_ap_decoder=False,
                    model_ap_encdec=False, model_ap_width_zero=1,
                    model_ap_width_stripe=1, model_ap_scale=1.0,
                    model_att_head_num=4)
        return types.SimpleNamespace(**dict(base, **kw))

    assert create_attention_penalty(config(), LOGGER).n_stripes == 2500
    for off in (dict(model_ap_encoder=False), dict(model_ap_scale=0.0),
                dict(model_ap_width_zero=None), dict(model_ap_width_stripe=0)):
        assert create_attention_penalty(config(**off), LOGGER) is None


def _qkv(seed, batch=2, heads=2, seq=SEQ, depth=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, heads, seq, depth).astype(np.float32)
            for _ in range(3)]


def _mask(lengths, seq=SEQ):
    return (np.arange(seq)[None] >= np.asarray(lengths)[:, None]).astype(
        np.float32)[:, None, None, :]


def test_mha_plain_matches_flax():
    d_model, heads = 16, 4
    flax_mha = FlaxMHA(d_model, heads)
    x = jnp.zeros((1, 5, d_model), jnp.float32)
    variables = random_flax_variables(
        flax_mha, init_args=(x, x, x, None, 0.0, None, False), seed=2)
    rng = np.random.RandomState(3)
    value, key, query = (rng.randn(2, 12, d_model).astype(np.float32)
                         for _ in range(3))
    mask = _mask([12, 7], seq=12)
    board = np.array(JaxPenalty(2500, heads, 2, 3, 0.5).penalty(12))
    want_out, want_w = flax_mha.apply(
        variables, jnp.asarray(value), jnp.asarray(key), jnp.asarray(query),
        jnp.asarray(mask), 0.0, jnp.asarray(board), False)
    mha = MultiHeadAttention(d_model, heads).eval()
    mha.load_state_dict(convert.flax_to_state_dict(variables))
    got_out, got_w = mha(*(torch.from_numpy(a) for a in
                           (value, key, query, mask, board)))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_w.detach().numpy(), np.asarray(want_w),
                               rtol=0, atol=2e-6)
    # ring attention needs the process group that splits the time axis
    # (tests/test_torch_ring_attention.py runs it), as JAX's needs a mesh
    with pytest.raises(ValueError, match="requires group="):
        mha(*(torch.from_numpy(a) for a in (value, key, query, mask, board)),
            impl="ring")


@pytest.mark.parametrize("with_penalty", [False, True])
def test_blockwise_matches_jax_and_plain(with_penalty):
    q, k, v = _qkv(0)
    mask = _mask([SEQ, 213])
    zero, stripe, scale = 1, 1, 1.0
    board = JaxPenalty(2500, 2, zero, stripe, scale)
    jax_pen = JaxParams(zero, stripe, scale, board.n_stripes)
    want = jax_blockwise(*(jnp.asarray(a) for a in (q, k, v, mask)),
                         penalty=jax_pen if with_penalty else None)
    got = blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask)),
        penalty=PenaltyParams(*jax_pen) if with_penalty else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    plain, _ = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask)),
        AttentionPenalty(2500, 2, zero, stripe, scale).penalty(SEQ)[None]
        if with_penalty else None)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=2e-5)


def test_blockwise_gradients_match_jax():
    q, k, v = _qkv(1)
    mask = _mask([SEQ, 150])
    pen = JaxParams(1, 1, 1.0, 2500)

    def jax_loss(q, k, v):
        out = jax_blockwise(q, k, v, jnp.asarray(mask), penalty=pen)
        return jnp.sum(out * out)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tensors = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = blockwise_attention(*tensors, torch.from_numpy(mask),
                              penalty=PenaltyParams(*pen))
    (out * out).sum().backward()
    for tensor, grad in zip(tensors, want):
        np.testing.assert_allclose(tensor.grad.numpy(), np.asarray(grad),
                                   rtol=0, atol=5e-5)


def test_fully_masked_utterance_is_plain_uniform():
    """Every key of utterance 1 masked: the plain path spreads its queries
    uniformly over the T keys, and so does the port's blockwise path at
    T=300. JAX's blockwise agrees where T fills its blocks (T=256) and at
    T=300 spreads them over the 212 block-padding keys too."""
    for seq in (SEQ, 256):
        q, k, v = _qkv(2, seq=seq)
        mask = _mask([seq, 0], seq=seq)
        args = [torch.from_numpy(a) for a in (q, k, v, mask)]
        got = blockwise_attention(*args)
        plain, weights = scaled_dot_product_attention(*args, None)
        assert torch.equal(weights[1], torch.full_like(weights[1], 1 / seq))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=2e-5)
        want = np.asarray(jax_blockwise(*(jnp.asarray(a) for a in
                                          (q, k, v, mask))))
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=2e-5)
        if seq == 256:
            np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0,
                                       atol=2e-5)
        else:
            assert np.abs(got[1].numpy() - want[1]).max() > 1e-2


def test_blockwise_dropout_recomputes_its_masks(monkeypatch):
    """In training each key block runs under torch.utils.checkpoint; the
    recomputed forward must draw the block's mask again (seeded per block
    from the host seed), so the gradients equal those of the same forward
    without the checkpoint. The same seed gives the same output, another
    seed another."""
    q, k, v = _qkv(4, seq=40)

    def run(seed):
        tensors = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = blockwise_attention(*tensors, block_k=16, dropout_rate=0.3,
                                  dropout_seed=seed)
        (out * out).sum().backward()
        return out.detach(), [t.grad for t in tensors]

    out, grads = run(7)
    assert torch.equal(run(7)[0], out)
    assert not torch.equal(run(8)[0], out)
    monkeypatch.setattr(blockwise_mod.torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    plain_out, plain_grads = run(7)
    assert torch.equal(plain_out, out)
    for got, want in zip(grads, plain_grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
