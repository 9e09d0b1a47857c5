"""Speech feature extraction: 123-dim fbank+energy with deltas and CMVN
(the port's own copy of ``srf_tpu/data/features.py``, numpy only).

Self-contained replacement for the reference's Kaldi front-end
(reference: egs/script/fbank123.sh:9-22): 40 log-mel filterbanks + log
energy (``--num-mel-bins=40 --use-energy=True``), delta and delta-delta
appended (Kaldi ``add-deltas`` defaults: order 2, window 2) -> 123 dims,
then per-speaker CMVN. Kaldi-compatible defaults: 25 ms window, 10 ms
shift, povey window, preemphasis 0.97, snip-edges.

Implemented with numpy (host-side, one-shot corpus prep); the framing and
FFT vectorize fine and data prep is not the training hot path.
"""

import functools

import numpy as np

# Kaldi floors log/energy at float epsilon (feature-window.cc uses
# std::numeric_limits<float>::epsilon()), not a round 1e-10; matching it
# keeps silence frames bit-comparable.
_FLT_EPS = float(np.finfo(np.float32).eps)


def _povey_window(n):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def _mel(freq):
    return 1127.0 * np.log1p(freq / 700.0)


def _inv_mel(mel):
    return 700.0 * (np.expm1(mel / 1127.0))


@functools.lru_cache(maxsize=4)
def mel_filterbank(num_bins, fft_size, sample_rate, low_freq=20.0,
                   high_freq=None):
    """[num_bins, fft_size//2+1] triangular mel filters (Kaldi-style).

    The triangles are linear in the MEL domain, as Kaldi builds them
    (mel-computations.cc: weight = (mel(f)-left_mel)/(center_mel-left_mel))
    — a linear-in-Hz construction differs by several percent in the upper
    bins because mel is concave in Hz, silently shifting features under a
    reference-trained imported model. Cached: pure function of constant
    per-corpus arguments, previously rebuilt per utterance."""
    if high_freq is None:
        high_freq = sample_rate / 2.0
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_points = np.linspace(mel_low, mel_high, num_bins + 2)
    bin_mels = _mel(np.fft.rfftfreq(fft_size, 1.0 / sample_rate))
    fbank = np.zeros((num_bins, bin_mels.size), np.float32)
    for i in range(num_bins):
        left, center, right = mel_points[i : i + 3]
        up = (bin_mels - left) / max(center - left, 1e-10)
        down = (right - bin_mels) / max(right - center, 1e-10)
        fbank[i] = np.maximum(0.0, np.minimum(up, down))
    return fbank


def frame_signal(signal, frame_len, frame_shift, preemph=0.97,
                 remove_dc=True):
    """[T, frame_len] frames, snip-edges, preemphasized + windowed."""
    n = len(signal)
    if n < frame_len:
        return np.zeros((0, frame_len), np.float32), np.zeros((0,), np.float32)
    num_frames = 1 + (n - frame_len) // frame_shift
    idx = (np.arange(frame_len)[None, :]
           + frame_shift * np.arange(num_frames)[:, None])
    frames = np.asarray(signal, np.float32)[idx]
    if remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    energy = np.log(np.maximum(np.sum(frames**2, axis=1), _FLT_EPS))
    if preemph:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemph * shifted
    frames = frames * _povey_window(frame_len)[None, :]
    return frames, energy


def fbank_energy(signal, sample_rate=16000, num_bins=40, frame_ms=25.0,
                 shift_ms=10.0):
    """[T, num_bins+1] log-mel fbank with log-energy first (Kaldi layout)."""
    frame_len = int(sample_rate * frame_ms / 1000)
    frame_shift = int(sample_rate * shift_ms / 1000)
    frames, energy = frame_signal(signal, frame_len, frame_shift)
    fft_size = 1
    while fft_size < frame_len:
        fft_size *= 2
    spectrum = np.abs(np.fft.rfft(frames, fft_size)) ** 2
    mel = mel_filterbank(num_bins, fft_size, sample_rate)
    logmel = np.log(np.maximum(spectrum @ mel.T, _FLT_EPS))
    return np.concatenate([energy[:, None], logmel], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _delta_scales(order, window):
    """Kaldi's combined delta filters: order o's filter is the regression
    filter convolved with itself o times (delta-features.cc builds
    ``scales_`` exactly this way), each applied to the ORIGINAL feature
    sequence with index clamping. Applying the regression recursively to
    already-clamped lower-order deltas instead (the obvious formulation)
    diverges on the first/last ~2*window delta-delta frames:
    clamp(clamp(t+i)+j) != clamp(t+i+j) when i and j have mixed signs."""
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    filt = np.arange(-window, window + 1, dtype=np.float64) / denom
    scales = [np.asarray([1.0])]
    for _ in range(order):
        scales.append(np.convolve(scales[-1], filt))
    return tuple(scales)


def add_deltas(feats, order=2, window=2):
    """Append delta features (Kaldi add-deltas: regression over +-window,
    edge frames by clamping source indices into [0, T-1])."""
    t_idx = np.arange(feats.shape[0])
    out = []
    for sc in _delta_scales(order, window):
        half = (len(sc) - 1) // 2
        block = np.zeros(feats.shape, np.float64)
        for j, w in enumerate(sc):
            idx = np.clip(t_idx + (j - half), 0, feats.shape[0] - 1)
            block += w * feats[idx]
        out.append(block.astype(feats.dtype))
    return np.concatenate(out, axis=1)


def extract_fbank123(signal, sample_rate=16000):
    """The reference's 123-dim feature: (energy+40 fbank) x (static, d, dd)."""
    base = fbank_energy(signal, sample_rate)
    if base.shape[0] == 0:
        # signal shorter than one 25 ms frame: return an empty feature
        # matrix instead of crashing corpus prep in np.pad(mode="edge")
        return np.zeros((0, base.shape[1] * 3), np.float32)
    return add_deltas(base)


def cmvn_stats(feats_list):
    """Per-speaker (mean, std) rows over concatenated utterances."""
    stacked = np.concatenate(feats_list, axis=0)
    return stacked.mean(axis=0), stacked.std(axis=0)


def apply_cmvn(feats, mean, std):
    """(feats - mean + eps) / (std + eps), matching the writer's math
    (reference: save_speech_data.py:162-163)."""
    return (feats - mean + 1e-14) / (std + 1e-14)
