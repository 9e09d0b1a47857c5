"""The port's copy of the feature front end (srf_tpu_torch.data.features,
tools.extract_features) against srf_tpu's: fbank-123, deltas, the mel
bank, CMVN and the wav reader bit-equal on synthetic audio, and the CLI's
.npy and CMVN files byte-equal."""

import os
import wave

import numpy as np
import pytest

from srf_tpu.data import features as jax_features
from srf_tpu.tools import extract_features as jax_extract
from srf_tpu_torch.data import features
from srf_tpu_torch.tools import extract_features


def _signal(seconds, rate, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = 3000 * np.sin(2 * np.pi * 440 * t) * (t < seconds / 2)
    return (tone + 200 * rng.randn(t.size)).astype(np.float32)


def _write_wav(path, signal, rate, channels=1, width=2):
    data = np.clip(signal, -32768, 32767).astype(np.int16)
    if channels == 2:
        data = np.stack([data, data // 2], axis=1)
    if width == 4:
        data = data.astype(np.int32) * 65536
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("rate,seconds", [(16000, 1.3), (8000, 0.7),
                                          (16000, 0.01)])
def test_fbank123_is_bit_equal(rate, seconds):
    signal = _signal(seconds, rate, seed=1)
    got = features.extract_fbank123(signal, rate)
    want = jax_features.extract_fbank123(signal, rate)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape[1] == 123
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(features.mel_filterbank(40, 512, rate),
                                  jax_features.mel_filterbank(40, 512, rate))


def test_deltas_and_cmvn_are_bit_equal():
    rng = np.random.RandomState(2)
    feats = [rng.randn(n, 41).astype(np.float32) for n in (30, 7, 1)]
    for f in feats:
        np.testing.assert_array_equal(features.add_deltas(f),
                                      jax_features.add_deltas(f))
    got = features.cmvn_stats(feats)
    want = jax_features.cmvn_stats(feats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(features.apply_cmvn(feats[0], *got),
                                  jax_features.apply_cmvn(feats[0], *want))


@pytest.mark.parametrize("channels,width", [(1, 2), (2, 2), (1, 4)])
def test_read_wav_is_bit_equal(tmp_path, channels, width):
    path = tmp_path / "x.wav"
    _write_wav(path, _signal(0.5, 16000, seed=3), 16000, channels, width)
    got, rate = extract_features.read_wav(str(path))
    want, want_rate = jax_extract.read_wav(str(path))
    assert rate == want_rate == 16000
    np.testing.assert_array_equal(got, want)


def test_cli_files_are_byte_equal(tmp_path, capsys):
    scp, spk2utt = tmp_path / "wav.scp", tmp_path / "spk2utt"
    lines = []
    for i, seconds in enumerate((1.1, 0.6, 0.9)):
        path = tmp_path / ("u%d.wav" % i)
        _write_wav(path, _signal(seconds, 16000, seed=10 + i), 16000)
        lines.append("u%d %s" % (i, path))
    scp.write_text("\n".join(lines) + "\n")
    spk2utt.write_text("s0 u0 u1\ns1 u2\n")
    outs = {}
    for name, module in (("port", extract_features), ("jax", jax_extract)):
        out = tmp_path / name
        module.main([str(scp), str(out / "feats"), "--spk2utt", str(spk2utt),
                     "--cmvn-dir", str(out / "cmvn")])
        outs[name] = out
    assert capsys.readouterr().out.count("extracted 3 utterances") == 2
    for sub in ("feats", "cmvn"):
        names = sorted(os.listdir(outs["jax"] / sub))
        assert names == sorted(os.listdir(outs["port"] / sub))
        assert len(names) == (3 if sub == "feats" else 2)
        for file_name in names:
            assert ((outs["port"] / sub / file_name).read_bytes()
                    == (outs["jax"] / sub / file_name).read_bytes())
