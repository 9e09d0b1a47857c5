"""The port's CTC beams against the JAX package on the same numpy logits.

- the device beam (``ops/ctc_beam.py``, torch on the CPU here) against
  ``ctc_beam_search_batch_jax`` / ``ctc_beam_search_nbest_jax``: ids and
  frames equal, scores within 1e-4, at V=8 and 63, W=16 and 100, ragged
  lengths, with and without a toy n-gram LM (``train_ngram``);
- its uint32 hash arithmetic (int64 with 16-bit halves) against numpy
  uint32, and exact ties ordered as ``lax.top_k`` orders them;
- streamed chunks (``beam_chunk_step``) equal the offline decode;
- the host beam (``ops/ctc_decode.py``: the C++ decoder built from
  ``srf_tpu_torch/csrc/host`` and the Python prefix search) against JAX's
  ``beam_search_batch`` and ``prefix_beam_search``;
- the n-gram LM copy against ``srf_tpu.ops.ngram_lm``.
"""

import numpy as np
import pytest
import torch

from srf_tpu.ops import ctc_decode as jax_decode
from srf_tpu.ops import ngram_lm as jax_lm
from srf_tpu.ops.ctc_beam_jax import (
    ctc_beam_search_batch_jax, ctc_beam_search_nbest_jax,
)
from srf_tpu_torch.ops import ctc_beam, ctc_decode, ngram_lm
from srf_tpu_torch.utils import native as host_native

torch.set_num_threads(1)

LENGTHS = (40, 31, 7, 22)


def _logits(V, seed, scale=3.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(len(LENGTHS), max(LENGTHS), V) * scale).astype(
        np.float32)


def _lms(V, seed=7, order=3):
    """The same toy LM in each package, from random label sequences."""
    rng = np.random.RandomState(seed)
    seqs = [list(rng.randint(0, V - 1, size=rng.randint(3, 12)))
            for _ in range(30)]
    return ((jax_lm.train_ngram(seqs, V - 1, order), 0.5, 0.2),
            (ngram_lm.train_ngram(seqs, V - 1, order), 0.5, 0.2))


def _same(want, got):
    assert [h[0] for h in got] == [h[0] for h in want]
    assert [h[2] for h in got] == [h[2] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_lm", [False, True], ids=["ctc", "lm"])
@pytest.mark.parametrize("V,W", [(8, 16), (8, 100), (63, 16), (63, 100)])
def test_device_beam_equals_jax(V, W, with_lm):
    logits = _logits(V, seed=V * 1000 + W)
    lens = np.asarray(LENGTHS)
    jax_lm_args, port_lm_args = _lms(V) if with_lm else (None, None)
    want = ctc_beam_search_batch_jax(logits, lens, W, lm=jax_lm_args,
                                     with_frames=True)
    got = ctc_beam.ctc_beam_search_batch(logits, lens, W, lm=port_lm_args,
                                         with_frames=True)
    _same(want, got)
    assert all(len(h[0]) > 0 for h in got)
    want_n = ctc_beam_search_nbest_jax(logits, lens, W, lm=jax_lm_args,
                                       top_paths=4)
    got_n = ctc_beam.ctc_beam_search_nbest(logits, lens, W,
                                           lm=port_lm_args, top_paths=4)
    for want_hyps, got_hyps in zip(want_n, got_n):
        assert len(got_hyps) == len(want_hyps) > 1
        _same(want_hyps, got_hyps)
    # the n-best list's first entry is the batch decode's result
    assert [h[0] for h in got] == [hyps[0][0] for hyps in got_n]
    # the LM's table moved to the device once decodes the same
    if with_lm:
        moved = ctc_beam.lm_on_device(port_lm_args, "cpu")
        assert isinstance(moved[0].table, torch.Tensor)
        assert ctc_beam.ctc_beam_search_batch(
            logits, lens, W, lm=moved, with_frames=True) == got


def test_hash_arithmetic_is_jax_uint32():
    rng = np.random.RandomState(0)
    h = np.concatenate([rng.randint(0, 2**32, size=10000, dtype=np.uint64),
                        [0, 1, 2**32 - 1, 2**31]]).astype(np.uint32)
    for m in (ctc_beam._HASH_MUL_INV, ctc_beam._HASH_MUL, 2**32 - 1):
        got = ctc_beam._mul_u32(torch.from_numpy(h.astype(np.int64)), m)
        want = h * np.uint32(m)  # wraps mod 2^32
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    # the inverse undoes the multiplier, as the merge needs
    x = torch.from_numpy(h.astype(np.int64))
    back = ctc_beam._mul_u32((x * ctc_beam._HASH_MUL) & ctc_beam.MASK32,
                             ctc_beam._HASH_MUL_INV)
    assert torch.equal(back, x)
    state = ctc_beam.beam_init(5, batch=2)
    want = (np.uint32(17) + np.arange(5, dtype=np.uint32)
            * np.uint32(2654435761))
    assert np.array_equal(state["hash"][1].numpy(), want.astype(np.int64))


def test_exact_ties_follow_jax_order():
    """Equal logits make exact score ties at every step (all extends of a
    beam tie, many beams tie); the port's stable sort keeps lax.top_k's
    lower-index-first order, so parents, syms and frames match."""
    V = 6
    logits = np.zeros((3, 12, V), np.float32)
    logits[1, ::3, 2] = 1.0  # ties broken at some frames only
    logits[2] = np.round(np.random.RandomState(1).randn(12, V))
    lens = np.array([12, 12, 9])
    for W in (4, 16):
        want = ctc_beam_search_batch_jax(logits, lens, W, with_frames=True)
        got = ctc_beam.ctc_beam_search_batch(logits, lens, W,
                                             with_frames=True)
        _same(want, got)
        want_n = ctc_beam_search_nbest_jax(logits, lens, W, top_paths=3)
        got_n = ctc_beam.ctc_beam_search_nbest(logits, lens, W, top_paths=3)
        for a, b in zip(want_n, got_n):
            _same(a, b)


@pytest.mark.parametrize("with_lm", [False, True], ids=["ctc", "lm"])
def test_streamed_chunks_equal_offline(with_lm):
    V, W = 8, 16
    logits = _logits(V, seed=3)
    lens = np.asarray(LENGTHS)
    _, lm_args = _lms(V) if with_lm else (None, None)
    kwargs = ctc_beam.lm_fusion_args(lm_args, V, "cpu")
    ctx0 = kwargs.pop("lm_ctx0", 0)
    offline = ctc_beam._beam_scan_batch(torch.from_numpy(logits),
                                        torch.from_numpy(lens), W, V - 1,
                                        **kwargs, lm_ctx0=ctx0)
    state = ctc_beam.beam_init(W, ctx0, with_lm=with_lm, batch=len(lens))
    parents, syms = [], []
    for t0 in range(0, logits.shape[1], 9):
        state, p, s, scores = ctc_beam.beam_chunk_step(
            state, torch.from_numpy(logits[:, t0:t0 + 9]), t0,
            torch.from_numpy(lens), V - 1, **kwargs)
        parents.append(p)
        syms.append(s)
    assert torch.equal(torch.cat(parents, 1), offline[0])
    assert torch.equal(torch.cat(syms, 1), offline[1])
    assert torch.equal(scores, offline[2])


def test_approximate_top_k_is_refused(monkeypatch):
    logits = _logits(8, seed=0)
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        ctc_beam.ctc_beam_search_batch(logits, LENGTHS, 8, topk_approx=True)
    monkeypatch.setenv("SRF_BEAM_TOPK", "approx")
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        ctc_beam.ctc_beam_search_nbest(logits, LENGTHS, 8)


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "python"])
def test_host_beam_equals_jax(native, monkeypatch):
    V, W = 63, 16
    logits = _logits(V, seed=11, scale=4.0)
    lens = np.asarray(LENGTHS)
    if not native:
        monkeypatch.setattr(host_native, "_lib", False)
        monkeypatch.setattr(jax_decode, "_native_lib", False)
    before = ctc_decode.beam_search_native.calls
    got = ctc_decode.beam_search_batch(logits, lens, W)
    want = jax_decode.beam_search_batch(logits, lens, W)
    assert got == want
    assert (ctc_decode.beam_search_native.calls - before
            == (len(lens) if native else 0))


def test_python_prefix_search_with_lm_equals_jax():
    V, W = 8, 16
    logits = _logits(V, seed=5)
    jax_args, port_args = _lms(V)
    for i, n in enumerate(LENGTHS):
        want = jax_decode.prefix_beam_search(logits[i], n, W, lm=jax_args,
                                             top_paths=3, return_frames=True)
        got = ctc_decode.prefix_beam_search(logits[i], n, W, lm=port_args,
                                            top_paths=3, return_frames=True)
        assert got == want


def test_ngram_lm_copy_equals_jax(tmp_path):
    jax_args, port_args = _lms(10, order=3)
    assert np.array_equal(port_args[0].table, jax_args[0].table)
    assert port_args[0].ctx0 == jax_args[0].ctx0 == ngram_lm.lm_ctx0(9, 3)
    port_args[0].save(str(tmp_path / "lm.npz"))
    loaded = jax_lm.NGramLM.load(str(tmp_path / "lm.npz"))
    assert np.array_equal(loaded.table, port_args[0].table)
    ctx = port_args[0].next_ctx(port_args[0].ctx0, 4)
    assert ctx == jax_args[0].next_ctx(jax_args[0].ctx0, 4)
    assert loaded.logp(ctx, 2) == port_args[0].logp(ctx, 2)
