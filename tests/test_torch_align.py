"""The port's CTC forced alignment (srf_tpu_torch.ops.ctc_align, on the
logits' device) and its CLI (tools.align) against srf_tpu's: token spans
equal and Viterbi scores within atol 1e-5 (float32 max-plus sums of up to
~30 log-probs, the same additions in the same order), infeasible
alignments reported alike, and the CLI's CTM equal to JAX's alignment of
the JAX model's logits on the same weights."""

import json
import os
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops.ctc_align import ctc_forced_align as jax_align
from srf_tpu.tools.align import write_ctm as jax_write_ctm
from srf_tpu_torch import convert
from srf_tpu_torch.ops.ctc_align import ctc_forced_align
from srf_tpu_torch.tools import align

from _torch_parity import random_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "egs", "data", "timit_62.vocab")


def _compare(logits, lengths, labels, label_lengths, blank):
    got = ctc_forced_align(logits, lengths, labels, label_lengths, blank)
    want = jax_align(logits, lengths, labels, label_lengths, blank)
    assert len(got) == len(want)
    for (g_spans, g_score), (w_spans, w_score) in zip(got, want):
        assert g_spans == w_spans
        if w_spans is None:
            assert g_score == w_score == float("-inf")
        else:
            np.testing.assert_allclose(g_score, w_score, atol=1e-5)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_logits_match_jax(seed):
    rng = np.random.RandomState(seed)
    batch, frames, vocab = 5, 31, 7
    logits = (rng.randn(batch, frames, vocab) * 3).astype(np.float32)
    lengths = np.array([31, 26, 9, 4, 12])
    labels = rng.randint(0, vocab - 1, size=(batch, 7))
    labels[:, 3] = labels[:, 2]  # a repeat: needs a blank between
    label_lengths = np.array([7, 5, 4, 2, 0])
    got = _compare(logits, lengths, labels, label_lengths, vocab - 1)
    assert sum(spans is not None for spans, _ in got) >= 3


def test_sharp_logits_and_infeasible_alignments():
    vocab, blank = 6, 5
    path = [blank, 1, 1, blank, 2, blank, blank, 3, 3, 3, blank]
    logits = np.full((2, len(path), vocab), -8.0, np.float32)
    logits[0, np.arange(len(path)), path] = 8.0
    logits[1] = logits[0]
    labels = np.array([[1, 2, 3], [1, 1, 1]])
    got = _compare(logits, [len(path), 3], labels, [3, 3], blank)
    assert got[0][0] == [{"id": 1, "start": 1, "end": 3},
                         {"id": 2, "start": 4, "end": 5},
                         {"id": 3, "start": 7, "end": 10}]
    assert got[1] == (None, float("-inf"))  # 1,1,1 needs 5 frames


def test_cli_writes_jax_alignment(tmp_path):
    kwargs = dict(feat_dim=123, class_n=63, enc_num=3, caps_primary_num=6,
                  caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
                  caps_class_dim=4, caps_iter=1, lpad=1, rpad=1,
                  is_context=True, conv_layer_num=2, conv_filter_num=8,
                  caps_type="naive")
    flax_model = FlaxSequenceRouter(**kwargs)
    variables = random_flax_variables(flax_model, 123, seed=8)
    torch.save(convert.flax_to_state_dict(variables), tmp_path / "model.pt")
    vocab = [line.strip() for line in open(VOCAB)]
    rng = np.random.RandomState(4)
    utts = []
    with open(tmp_path / "test.json", "w") as manifest:
        for i, frames in enumerate((150, 97, 61)):
            feats = rng.randn(frames, 123).astype(np.float32)
            np.save(tmp_path / ("u%d.npy" % i), feats)
            ids = rng.randint(1, 62, size=frames // 20)
            text = " ".join(vocab[j] for j in ids)
            manifest.write(json.dumps({"key": "u%d.npy" % i,
                                       "duration": frames / 100,
                                       "text": text}) + "\n")
            utts.append((feats, ids))
    out = tmp_path / "align.ctm"
    align.main([
        "align", "--path-base=%s" % tmp_path, "--path-vocab=%s" % VOCAB,
        "--path-ckpt=%s" % tmp_path, "--path-test-json=test.json",
        "--decoding-from-npy=True", "--prep-data-unit=phone",
        "--feat-dim=123",
        "--model-encoder-num=3", "--model-caps-primary-num=6",
        "--model-caps-primary-dim=4", "--model-caps-convolution-num=5",
        "--model-caps-convolution-dim=4", "--model-caps-class-dim=4",
        "--model-caps-type=naive", "--model-caps-context=True",
        "--model-caps-iter=1", "--model-caps-window-lpad=1",
        "--model-caps-window-rpad=1", "--model-conv-filter-num=8",
        "--device=cpu", "--tpu-align-out=%s" % out])
    # JAX: its model's logits on the same padded batch, its alignment, its
    # CTM writer
    padded = np.zeros((3, 256, 123), np.float32)
    for i, (feats, _) in enumerate(utts):
        padded[i, : feats.shape[0]] = feats
    lengths = np.array([f.shape[0] for f, _ in utts])
    logits = np.asarray(flax_model.apply(variables, jnp.asarray(padded),
                                         jnp.asarray(lengths), False))
    labels = np.zeros((3, max(len(y) for _, y in utts)), np.int32)
    for i, (_, ids) in enumerate(utts):
        labels[i, : len(ids)] = ids
    aligned = jax_align(logits, lengths // 4, labels,
                        [len(y) for _, y in utts], blank_id=62)
    results = [("u%d.npy" % i, spans, score)
               for i, (spans, score) in enumerate(aligned)]
    assert all(spans is not None for _, spans, _ in results)
    want = tmp_path / "want.ctm"
    with open(want, "w") as f:
        jax_write_ctm(f, results, types.SimpleNamespace(vocab=vocab,
                                                        in_len_div=4))
    assert out.read_text() == want.read_text()
    assert len(out.read_text().splitlines()) == sum(len(y) for _, y in utts)
