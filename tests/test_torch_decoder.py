"""The port's decoder-side pieces against srf_tpu's on the same numpy
inputs: ``train/prep.prep_process`` (exact), and ``models/decoder``'s
``DecoderBlock`` and ``EncoderMFBlock`` (D=16, 4 heads, FF 32, B=2) from
the same numpy weights, with and without their second stream, in eval and
in a dropout-free training forward, outputs and attention weights within
atol 2e-5 (float32 sums in another order through three LayerNorms); the
convert round trip is exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.models.decoder import DecoderBlock as FlaxDecoderBlock
from srf_tpu.models.decoder import EncoderMFBlock as FlaxEncoderMFBlock
from srf_tpu.ops.masking import create_combined_mask as jax_combined_mask
from srf_tpu.train.prep import prep_process as jax_prep_process
from srf_tpu_torch import convert
from srf_tpu_torch.models import DecoderBlock, EncoderMFBlock
from srf_tpu_torch.ops.masking import create_combined_mask
from srf_tpu_torch.train.prep import prep_process

from _torch_parity import (flatten_tree, no_dropout, patch_out_jax_dropout,
                           random_flax_variables)

torch.set_num_threads(1)

D_MODEL, HEADS, DFF = 16, 4, 32
BLOCK = dict(d_model=D_MODEL, num_heads=HEADS, dff=DFF, inner_dropout=0.1,
             residual_dropout=0.1, attention_dropout=0.1)


def test_prep_process_matches_jax():
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 22, 5).astype(np.float32)
    feat_len = np.array([22, 13], np.int32)
    labels = np.array([[6, 1, 2, 3, 5, 0], [6, 2, 5, 0, 0, 0]], np.int32)
    tar_len = np.array([5, 3], np.int32)
    got = prep_process(torch.from_numpy(labels), torch.from_numpy(feat_len),
                       torch.from_numpy(tar_len), torch.from_numpy(feats), 4)
    want = jax_prep_process(jnp.asarray(labels), jnp.asarray(feat_len),
                            jnp.asarray(tar_len), jnp.asarray(feats), 4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    feats_out, mask = prep_process(None, torch.from_numpy(feat_len), None,
                                   torch.from_numpy(feats), 4)
    assert mask.shape == (2, 1, 1, 6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[3]))


def _streams(seed, lengths=(9, 6)):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, n, D_MODEL).astype(np.float32) for n in lengths]


def _run(flax_block, block, variables, args, jax_args, training, monkeypatch):
    if training:
        patch_out_jax_dropout(monkeypatch)
        block = no_dropout(block)
    want = flax_block.apply(variables, *jax_args, training)
    got = block.train(training)(*args)
    return got, want


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("with_pre", [True, False])
def test_decoder_block_matches_flax(training, with_pre, monkeypatch):
    cur, enc = _streams(1)
    pre = _streams(2)[0] if with_pre else None
    tokens = np.array([[3, 1, 2, 5, 4, 1, 2, 0, 0], [2, 2, 1, 0, 0, 0, 0, 0,
                                                     0]], np.int32)
    look = np.array(jax_combined_mask(jnp.asarray(tokens)))
    assert np.array_equal(
        create_combined_mask(torch.from_numpy(tokens)).numpy(), look)
    pad = (np.arange(6)[None] >= np.array([[6], [4]])).astype(
        np.float32)[:, None, None, :]
    flax_block = FlaxDecoderBlock(**BLOCK)
    jax_args = [jnp.asarray(cur), None if pre is None else jnp.asarray(pre),
                jnp.asarray(enc), jnp.asarray(look), jnp.asarray(pad), None,
                None]
    variables = random_flax_variables(flax_block, init_args=(
        *jax_args, False), seed=3)
    block = DecoderBlock(**BLOCK, with_pre=with_pre)
    block.load_state_dict(convert.flax_to_state_dict(variables))
    args = [torch.from_numpy(cur),
            None if pre is None else torch.from_numpy(pre),
            torch.from_numpy(enc), torch.from_numpy(look),
            torch.from_numpy(pad), None, None]
    got, want = _run(flax_block, block, variables, args, jax_args, training,
                     monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5)
    back = flatten_tree(convert.state_dict_to_flax(block.state_dict()))
    assert sorted(back) == sorted(flatten_tree(variables))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("with_raw", [True, False])
def test_encoder_mf_block_matches_flax(training, with_raw, monkeypatch):
    feat, raw = _streams(4, lengths=(9, 9))
    raw = raw if with_raw else None
    mask = (np.arange(9)[None] >= np.array([[9], [5]])).astype(
        np.float32)[:, None, None, :]
    flax_block = FlaxEncoderMFBlock(**BLOCK)
    jax_args = [None if raw is None else jnp.asarray(raw), jnp.asarray(feat),
                jnp.asarray(mask), None]
    variables = random_flax_variables(flax_block, init_args=(
        *jax_args, False), seed=5)
    block = EncoderMFBlock(**BLOCK, with_raw=with_raw)
    block.load_state_dict(convert.flax_to_state_dict(variables))
    args = [None if raw is None else torch.from_numpy(raw),
            torch.from_numpy(feat), torch.from_numpy(mask), None]
    got, want = _run(flax_block, block, variables, args, jax_args, training,
                     monkeypatch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    back = flatten_tree(convert.state_dict_to_flax(block.state_dict()))
    want_tree = flatten_tree(variables)
    assert sorted(back) == sorted(want_tree)
    for key in want_tree:
        assert np.array_equal(back[key], want_tree[key]), key
