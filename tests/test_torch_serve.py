"""The port's Recognizer (device="cpu") against the JAX pieces the JAX
Recognizer runs on the same padded batch: model.apply, greedy_decode_frames,
the Viterbi score over floor(len/4) frames and the per-token posterior
gather. Ids, frames and text must be equal; scores within atol 1e-4 (a sum
of ~60 per-frame log-probs whose logits agree to ~3e-6) and the 4-decimal
rounded confidences within 2e-4. The beam branch (beam 20, n-best, a toy
3-gram LM fused) is held to srf_tpu.serve.Recognizer itself, loaded from an
orbax checkpoint of the same weights, with the same limits. Also the CLI
(its --stream and --long output equal to the JAX CLI's, --wav equal to
--feats on extract_features' output), reload, and the refusals."""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.config import ParseOption as JaxParseOption
from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops.ctc_decode import greedy_decode_frames
from srf_tpu.serve import Recognizer as JaxRecognizer
from srf_tpu.serve import main as jax_serve_main
from srf_tpu.serve import _frame_max_logp, _token_logp_gather
from srf_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from srf_tpu.utils.log2utt import ids_to_utt
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.data.features import apply_cmvn, cmvn_stats
from srf_tpu_torch.device import resolve_device
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops.ngram_lm import train_ngram
from srf_tpu_torch.serve import Recognizer, main
from srf_tpu_torch.tools import extract_features
from srf_tpu_torch.utils.checkpoint import CheckpointManager

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


BEAM_WIDTH = 20


@pytest.fixture(scope="module")
def beam_recognizers(weights, tmp_path_factory):
    """{with_lm: (JAX Recognizer, port Recognizer)} on the same weights:
    the JAX one restores an orbax checkpoint of them, the port one takes
    their state_dict; with_lm fuses a toy 3-gram (weight 0.5, bonus 0.5)."""
    _, variables = weights
    base = tmp_path_factory.mktemp("beam")
    manager = JaxCheckpointManager(str(base / "ckpt"))
    manager.save(1, {"step": np.asarray(1, np.int32),
                     "params": variables["params"],
                     "batch_stats": variables.get("batch_stats", {})})
    manager.close()
    rng = np.random.RandomState(9)
    train_ngram([list(rng.randint(0, 62, size=12)) for _ in range(30)],
                62, 3).save(str(base / "lm.npz"))
    lm_flags = ("--tpu-lm-path=%s" % (base / "lm.npz"), "--tpu-lm-weight=0.5",
                "--tpu-lm-bonus=0.5")
    logger = Logger(name="test_torch_serve", level=Logger.WARN).logger
    out = {}
    for with_lm in (False, True):
        argv = _argv(base, "--path-ckpt=%s" % (base / "ckpt"),
                     *(lm_flags if with_lm else ()))
        out[with_lm] = (
            JaxRecognizer(JaxParseOption(argv, logger,
                                         is_print_opts=False).args,
                          logger=logger),
            Recognizer(ParseOption(argv, logger, is_print_opts=False).args,
                       state_dict=convert.flax_to_state_dict(variables),
                       device="cpu", logger=logger))
    return out


@pytest.mark.parametrize("n_best", [1, 3])
@pytest.mark.parametrize("with_lm", [False, True])
def test_recognizer_beam_matches_jax_recognizer(beam_recognizers, with_lm,
                                                n_best):
    jax_recognizer, recognizer = beam_recognizers[with_lm]
    assert (recognizer.lm is None) == (not with_lm)
    want = jax_recognizer.transcribe_batch_detailed(
        _feats(), beam_width=BEAM_WIDTH, n_best=n_best)
    got = recognizer.transcribe_batch_detailed(
        _feats(), beam_width=BEAM_WIDTH, n_best=n_best)
    assert sum(len(w["ids"]) for w in want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("ids", "text", "frames", "times"):
            assert g[key] == w[key], key
        for key in ("score", "avg_logp", "confidence"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)
        np.testing.assert_allclose(g["token_confidences"],
                                   w["token_confidences"], atol=2e-4)
        if n_best > 1:
            assert [h["ids"] for h in g["nbest"]] == \
                [h["ids"] for h in w["nbest"]]
            assert [h["text"] for h in g["nbest"]] == \
                [h["text"] for h in w["nbest"]]
            np.testing.assert_allclose([h["score"] for h in g["nbest"]],
                                       [h["score"] for h in w["nbest"]],
                                       atol=1e-4)


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


def test_approximate_top_k_is_refused(tmp_path, weights, monkeypatch):
    """TPU's approximate top-k (SRF_BEAM_TOPK=approx) is refused by the
    Recognizer's beam, never ignored."""
    _, variables = weights
    recognizer = Recognizer(_config(tmp_path),
                            state_dict=convert.flax_to_state_dict(variables),
                            device="cpu")
    monkeypatch.setenv("SRF_BEAM_TOPK", "approx")
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        recognizer.transcribe_batch(_feats(), beam_width=100)


def test_cuda_is_the_default_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config(tmp_path)
    assert config.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(config)


def test_cuda_path_turns_tf32_off(monkeypatch):
    """F8 and F14: TF32 off; cuDNN's search on for every convolution, and
    the CNN's (``ops/conv_choice.py``) time only the candidates the kept
    table holds for their problem on the H100: the CNN-TIMIT train
    buckets' 14 problems each."""
    from srf_tpu_torch.ops import conv_choice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.benchmark
    table = conv_choice.load_table(conv_choice.TABLE)
    assert table["device"] == "NVIDIA H100 80GB HBM3"
    limits = table["limits"]
    assert len(limits) == 5 * 14
    assert all(1 <= limits[key] <= 10 for key in limits)
    for rows, frames in ((29, 241), (17, 391), (12, 541), (10, 691),
                         (8, 841)):
        assert "fwd x%dx1x%dx123 w128x1x5x3 s1x1 p2x1 nchw float32" % (
            rows, frames) in limits
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def _write_wav(path, seconds=3.0, rate=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    signal = 3000 * np.sin(2 * np.pi * 300 * t) + 300 * rng.randn(t.size)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(signal.astype(np.int16).tobytes())


@pytest.mark.parametrize("flag", ["--stream", "--long", "--wav=x.wav"])
def test_unported_cli_modes_are_refused(tmp_path, weights, monkeypatch,
                                        capsys, flag):
    """These three CLI modes were refused before the port had streaming
    and the fbank front end: each now runs (printing a line per input);
    --tpu-decode-ema, refused before EMA was ported, raises JAX's
    ValueError in it for weights saved without an EMA."""
    _, variables = weights
    torch.save(convert.flax_to_state_dict(variables), tmp_path / "model.pt")
    monkeypatch.chdir(tmp_path)
    _write_wav(tmp_path / "x.wav")
    np.save(tmp_path / "x.npy", _feats()[0])
    inputs = [] if flag.startswith("--wav") else ["--feats", "x.npy"]
    main(_argv(tmp_path, "--device=cpu", flag, *inputs))
    printed = capsys.readouterr().out.splitlines()
    assert printed and printed[-1].endswith("(x.%s)" % (
        "wav" if flag.startswith("--wav") else "npy"))
    with pytest.raises(ValueError, match="holds no EMA params"):
        main(_argv(tmp_path, "--device=cpu", flag, *inputs,
                   "--tpu-decode-ema=True"))


@pytest.mark.parametrize("flag", [
    "--tpu-serve-quant=int8", "--tpu-routing-kernel=wavefront",
    "--tpu-routing-bf16=True",
])
def test_unported_options_are_refused(tmp_path, weights, flag):
    """--tpu-serve-quant=int8 was refused before the port had ops/quant.py,
    --tpu-routing-bf16 before the bf16 variants of K1 and K2, and
    --tpu-routing-kernel=wavefront before ops/routing.wavefront_sdr_stack:
    all three now serve (tests/test_torch_quant.py,
    test_torch_routing_bf16.py and test_torch_wavefront.py hold them to
    JAX); the wavefront's Recognizer gives the layered Recognizer's ids,
    and its logits within 2e-5 (JAX's wavefront-against-layered limit)."""
    config = _config(tmp_path, flag)
    _, variables = weights
    state = convert.flax_to_state_dict(variables)
    recognizer = Recognizer(config, state_dict=state, device="cpu")
    assert recognizer.quantized == (flag == "--tpu-serve-quant=int8")
    assert recognizer.model.routing_bf16 == (flag ==
                                             "--tpu-routing-bf16=True")
    assert recognizer.model.routing_impl == (
        "wavefront" if flag == "--tpu-routing-kernel=wavefront" else "auto")
    got = recognizer.transcribe_batch_detailed(_feats())
    assert len(got) == len(LENGTHS)
    if flag != "--tpu-routing-kernel=wavefront":
        return
    layered = Recognizer(_config(tmp_path), state_dict=state, device="cpu")
    assert [r["ids"] for r in got] == [
        r["ids"] for r in layered.transcribe_batch_detailed(_feats())]
    padded = recognizer.pad(_feats())
    with torch.inference_mode():
        np.testing.assert_allclose(recognizer.forward(*padded).numpy(),
                                   layered.forward(*padded).numpy(),
                                   atol=2e-5, rtol=0)


def test_cli_wav_prints_what_feats_prints(tmp_path, weights, capsys):
    """--wav runs the training front end (fbank-123 and utterance CMVN,
    data/features.py) on the audio: the same line as --feats on
    tools.extract_features' output normalised the same way."""
    _, variables = weights
    torch.save(convert.flax_to_state_dict(variables), tmp_path / "model.pt")
    wav = tmp_path / "utt.wav"
    _write_wav(wav, seed=3)
    scp = tmp_path / "wav.scp"
    scp.write_text("utt %s\n" % wav)
    extract_features.main([str(scp), str(tmp_path / "feats")])
    feats = np.load(tmp_path / "feats" / "utt.npy")
    assert feats.shape == (298, 123)
    feats = apply_cmvn(feats, *cmvn_stats([feats])).astype(np.float32)
    np.save(tmp_path / "utt.npy", feats)
    capsys.readouterr()
    main(_argv(tmp_path, "--device=cpu", "--wav", str(wav)))
    from_wav = capsys.readouterr().out.strip()
    main(_argv(tmp_path, "--device=cpu", "--feats", str(tmp_path / "utt.npy")))
    from_feats = capsys.readouterr().out.strip()
    assert from_wav.rsplit(" (", 1)[0] == from_feats.rsplit(" (", 1)[0]
    assert from_wav.endswith("(%s)" % wav)


@pytest.mark.parametrize("mode", ["--stream", "--long"])
def test_cli_stream_and_long_print_what_jax_prints(beam_recognizers,
                                                   weights, tmp_path,
                                                   capsys, mode):
    """The port's CLI against the JAX CLI on the same weights (JAX's from
    the orbax checkpoint of beam_recognizers, the port's from model.pt):
    every printed line equal (partials and the final text for --stream,
    timestamped segments for --long, whose 33 s of audio pass the 30 s a
    segment may stay open)."""
    _, variables = weights
    base = tmp_path / "port"
    base.mkdir()
    torch.save(convert.flax_to_state_dict(variables), base / "model.pt")
    rng = np.random.RandomState(12)
    feats = rng.randn(3300 if mode == "--long" else 700,
                      123).astype(np.float32)
    feats[250:400] = 0.0
    np.save(tmp_path / "long.npy", feats)
    jax_ckpt = beam_recognizers[False][0].config.path_ckpt
    capsys.readouterr()
    jax_serve_main([*_argv(base, "--path-ckpt=%s" % jax_ckpt)[0:1],
                    *_argv(base, "--path-ckpt=%s" % jax_ckpt)[1:],
                    mode, "--feats", str(tmp_path / "long.npy")])
    want = capsys.readouterr().out.splitlines()
    main(_argv(base, "--device=cpu", mode, "--feats",
               str(tmp_path / "long.npy")))
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) > 1


def test_reload_swaps_in_a_newer_checkpoint(tmp_path, weights):
    _, variables = weights
    state = convert.flax_to_state_dict(variables)
    other = {k: v + 0.05 if v.is_floating_point() else v
             for k, v in state.items()}
    manager = CheckpointManager(str(tmp_path))
    manager.save(1, {"step": 1, "model": state})
    recognizer = Recognizer(_config(tmp_path, "--device=cpu"))
    assert recognizer.step == 1
    assert recognizer.reload() is None
    first = recognizer.transcribe_batch(_feats())
    session = recognizer.streaming_session()
    manager.save(2, {"step": 2, "model": other})
    manager.close()
    assert recognizer.reload() == 2 and recognizer.step == 2
    assert session.model is not recognizer.model  # sessions keep theirs
    assert recognizer.transcribe_batch(_feats()) == Recognizer(
        _config(tmp_path), state_dict=other, device="cpu").transcribe_batch(
            _feats())
    assert recognizer.reload() is None
    assert recognizer.reload(step=1) == 1
    assert recognizer.transcribe_batch(_feats()) == first
