"""The PyTorch port's small ops against srf_tpu's on the same numpy inputs:
squash, capsule length, masks, positional encoding, windowing and greedy
CTC decoding. Tolerances are float32 rounding (rtol 1e-6, atol 1e-6); ids,
lengths and frames must be equal. Also: the port imports no JAX."""

import ast
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.ops import ctc_decode as jax_decode
from srf_tpu.ops import masking as jax_masking
from srf_tpu.ops import pos_enc as jax_pos_enc
from srf_tpu.ops import routing as jax_routing
from srf_tpu.ops import squash as jax_squash
from srf_tpu_torch.ops import ctc_decode, masking, pos_enc, routing, squash

torch.set_num_threads(1)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("eps", [1e-7, 1e-9])
def test_squash_and_capsule_length(eps):
    x = np.random.RandomState(0).randn(3, 5, 7, 4).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps path
    _close(squash.squash(torch.from_numpy(x), epsilon=eps),
           jax_squash.squash(jnp.asarray(x), epsilon=eps))
    _close(squash.capsule_length(torch.from_numpy(x), epsilon=eps),
           jax_squash.capsule_length(jnp.asarray(x), epsilon=eps))


def test_masks():
    lengths = np.array([37, 40, 1, 9], np.int32)
    for div in (1, 2, 4):
        sub = masking.subsampled_lengths(torch.from_numpy(lengths), div)
        want = jax_masking.subsampled_lengths(jnp.asarray(lengths), div)
        np.testing.assert_array_equal(sub.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            masking.sequence_mask(sub, 12).numpy(),
            np.asarray(jax_masking.sequence_mask(want, 12)))
    x = np.random.RandomState(1).randn(4, 10, 6, 3).astype(np.float32)
    want = jax_masking.feat_mask(jnp.asarray(x), jnp.asarray(lengths), 4)
    _close(masking.feat_mask(torch.from_numpy(x), torch.from_numpy(lengths), 4),
           want, rtol=0, atol=0)
    # the NCHW form used by the conv front end masks the same frames
    nchw = masking.feat_mask(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(lengths), 4, time_dim=2)
    _close(nchw.permute(0, 2, 3, 1), want, rtol=0, atol=0)


def test_pos_enc():
    _close(pos_enc.get_pos_enc(37, 12), jax_pos_enc.get_pos_enc(37, 12),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lpad,rpad", [(1, 1), (2, 0), (0, 0)])
def test_window_stack(lpad, rpad):
    x = np.random.RandomState(2).randn(2, 6, 5, 3).astype(np.float32)
    _close(routing.window_stack(torch.from_numpy(x), lpad, rpad),
           jax_routing.window_stack(jnp.asarray(x), lpad, rpad), rtol=0,
           atol=0)


def _decode_logits(seed=3, batch=5, maxlen=23, vocab=6):
    """Random logits whose argmax paths have runs, repeats and blanks."""
    rng = np.random.RandomState(seed)
    path = rng.randint(0, vocab, size=(batch, maxlen))
    path = np.repeat(path[:, : (maxlen + 1) // 2], 2, axis=1)[:, :maxlen]
    logits = rng.randn(batch, maxlen, vocab).astype(np.float32)
    np.put_along_axis(logits, path[..., None], 5.0, axis=-1)
    lengths = np.array([maxlen, 1, 0, 11, maxlen - 4], np.int32)[:batch]
    return logits, lengths


@pytest.mark.parametrize("blank_id", [None, 0])
def test_greedy_decode(blank_id):
    logits, lengths = _decode_logits()
    got = ctc_decode.greedy_decode_frames(
        torch.from_numpy(logits), torch.from_numpy(lengths), blank_id)
    want = jax_decode.greedy_decode_frames(
        jnp.asarray(logits), jnp.asarray(lengths), blank_id)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids, lens = ctc_decode.greedy_decode(
        torch.from_numpy(logits), torch.from_numpy(lengths), blank_id)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want[1]))


def test_port_imports_neither_jax_nor_srf_tpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sources = [os.path.join(repo, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(repo, "srf_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax", "srf_tpu"}
    for path in sources:
        with open(path) as src:
            tree = ast.parse(src.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in forbidden, (path, name)
