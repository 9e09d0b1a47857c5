"""The port's Recognizer (device="cpu") against the JAX pieces the JAX
Recognizer runs on the same padded batch: model.apply, greedy_decode_frames,
the Viterbi score over floor(len/4) frames and the per-token posterior
gather. Ids, frames and text must be equal; scores within atol 1e-4 (a sum
of ~60 per-frame log-probs whose logits agree to ~3e-6) and the 4-decimal
rounded confidences within 2e-4. Also the CLI, and the refusals."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops.ctc_decode import greedy_decode_frames
from srf_tpu.serve import _frame_max_logp, _token_logp_gather
from srf_tpu.utils.log2utt import ids_to_utt
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.device import resolve_device
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.serve import Recognizer, main

from _torch_parity import random_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "egs", "data", "timit_62.vocab")
MODEL_FLAGS = [
    "--feat-dim=123", "--model-encoder-num=3",
    "--model-caps-primary-num=12", "--model-caps-primary-dim=4",
    "--model-caps-convolution-num=6", "--model-caps-convolution-dim=4",
    "--model-caps-class-dim=4", "--model-caps-type=naive",
    "--model-caps-context=True", "--model-caps-iter=1",
    "--model-caps-window-lpad=1", "--model-caps-window-rpad=1",
    "--model-conv-filter-num=8", "--decoding-beam-width=1",
]
LENGTHS = (150, 97, 61)


def _argv(tmp_path, *extra):
    return ["serve", "--path-base=%s" % tmp_path, "--path-vocab=%s" % VOCAB,
            "--path-ckpt=%s" % tmp_path, *MODEL_FLAGS, *extra]


def _config(tmp_path, *extra):
    logger = Logger(name="test_torch_serve", level=Logger.WARN).logger
    return ParseOption(_argv(tmp_path, *extra), logger,
                       is_print_opts=False).args


def _flax_model():
    return FlaxSequenceRouter(
        feat_dim=123, class_n=63, enc_num=3, caps_primary_num=12,
        caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4,
        caps_class_dim=4, caps_iter=1, lpad=1, rpad=1, is_context=True,
        conv_layer_num=2, conv_filter_num=8, caps_type="naive",
    )


@pytest.fixture(scope="module")
def weights():
    model = _flax_model()
    return model, random_flax_variables(model, 123, seed=11)


def _feats():
    rng = np.random.RandomState(5)
    return [rng.randn(n, 123).astype(np.float32) for n in LENGTHS]


def _jax_reference(model, variables, feats_list):
    """What srf_tpu.serve.Recognizer.transcribe_batch_detailed computes
    (greedy branch), from its own jitted pieces."""
    lengths = np.array([f.shape[0] for f in feats_list], np.int32)
    width = -(-int(lengths.max()) // 128) * 128
    padded = np.zeros((len(feats_list), width, 123), np.float32)
    for i, f in enumerate(feats_list):
        padded[i, : f.shape[0]] = f
    logits = jax.jit(lambda v, f, l: model.apply(v, f, l, False))(
        variables, jnp.asarray(padded), jnp.asarray(lengths))
    dec_lens = np.maximum(lengths // 4, 1)
    out, lens, emit = (np.asarray(x) for x in greedy_decode_frames(
        logits, jnp.asarray(dec_lens), blank_id=62))
    ids = [[int(x) for x in out[i, : lens[i]]] for i in range(len(lengths))]
    frames = [[int(x) for x in emit[i, : lens[i]]]
              for i in range(len(lengths))]
    frame_max = np.asarray(_frame_max_logp(logits))
    pos = np.arange(frame_max.shape[1])[None, :]
    scores = (frame_max * (pos < dec_lens[:, None])).sum(axis=-1)
    max_tok = max(len(x) for x in ids)
    frame_idx = np.zeros((len(ids), max_tok), np.int32)
    sym_idx = np.zeros((len(ids), max_tok), np.int32)
    for i, x in enumerate(ids):
        frame_idx[i, : len(x)] = frames[i]
        sym_idx[i, : len(x)] = x
    tok_logp = np.asarray(_token_logp_gather(
        logits, jnp.asarray(frame_idx), jnp.asarray(sym_idx)))
    return ids, frames, scores, dec_lens, tok_logp


def test_recognizer_matches_jax_serving_path(tmp_path, weights):
    model, variables = weights
    recognizer = Recognizer(_config(tmp_path),
                            state_dict=convert.flax_to_state_dict(variables),
                            device="cpu")
    got = recognizer.transcribe_batch_detailed(_feats())
    ids, frames, scores, dec_lens, tok_logp = _jax_reference(
        model, variables, _feats())
    vocab = [line.strip() for line in open(VOCAB)]
    assert sum(len(x) for x in ids) > 0
    for i, result in enumerate(got):
        assert result["ids"] == ids[i]
        assert result["frames"] == frames[i]
        assert result["times"] == [round(f * 0.04, 4) for f in frames[i]]
        assert result["text"] == ids_to_utt(ids[i], vocab, "timit")
        np.testing.assert_allclose(result["score"], scores[i], atol=1e-4)
        np.testing.assert_allclose(result["avg_logp"],
                                   scores[i] / dec_lens[i], atol=1e-5)
        np.testing.assert_allclose(
            result["confidence"], np.exp(min(scores[i] / dec_lens[i], 0.0)),
            atol=1e-5)
        np.testing.assert_allclose(
            result["token_confidences"],
            np.exp(tok_logp[i, : len(ids[i])]), atol=2e-4)
    assert recognizer.transcribe_batch(_feats()) == [
        (r["ids"], r["text"]) for r in got]
    assert recognizer.transcribe(_feats()[1]) == (got[1]["ids"],
                                                  got[1]["text"])


def test_cli_prints_the_same_text(tmp_path, weights):
    _, variables = weights
    state = convert.flax_to_state_dict(variables)
    torch.save(state, tmp_path / "model.pt")
    feats = _feats()[0]
    np.save(tmp_path / "x.npy", feats)
    want = Recognizer(_config(tmp_path), state_dict=state,
                      device="cpu").transcribe(feats)[1]
    proc = subprocess.run(
        [sys.executable, "-m", "srf_tpu_torch.serve",
         *_argv(tmp_path, "--device=cpu")[1:],
         "--feats", str(tmp_path / "x.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "%s (%s)" % (want, tmp_path / "x.npy")


def test_beam_search_is_refused(tmp_path, weights):
    _, variables = weights
    recognizer = Recognizer(_config(tmp_path),
                            state_dict=convert.flax_to_state_dict(variables),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="device beam"):
        recognizer.transcribe_batch(_feats(), beam_width=100)


def test_cuda_is_the_default_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config(tmp_path)
    assert config.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(config)


def test_cuda_path_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.benchmark
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


@pytest.mark.parametrize("flag", ["--stream", "--long", "--wav=x.wav"])
def test_unported_cli_modes_are_refused(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="later slice"):
        main(_argv(tmp_path, "--device=cpu", flag))


@pytest.mark.parametrize("flag", [
    "--tpu-serve-quant=int8", "--tpu-routing-kernel=pallas",
    "--model-type=stf", "--tpu-routing-bf16=True",
])
def test_unported_options_are_refused(tmp_path, flag):
    config = _config(tmp_path, flag)
    with pytest.raises(NotImplementedError, match="later slice"):
        Recognizer(config, device="cpu")
    if flag != "--tpu-serve-quant=int8":
        with pytest.raises(NotImplementedError, match="later slice"):
            build_model(config, 63)
