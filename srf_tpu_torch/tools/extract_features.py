"""CLI: self-contained fbank-123 feature extraction (replaces Kaldi); the
port's own copy of ``srf_tpu/tools/extract_features.py``, same flags and
outputs.

Replaces the reference's Kaldi front-end pipeline
(reference: egs/script/fbank123.sh: compute-fbank-feats + add-deltas +
per-speaker CMVN + parsing.py): reads wav files listed in an scp
(``utt_id path`` per line), writes one ``<utt_id>.npy`` per utterance with
123-dim features, and optionally per-speaker CMVN stats (``spk2utt`` map).

Usage:
    python -m srf_tpu_torch.tools.extract_features wav.scp outdir \
        [--spk2utt spk2utt] [--cmvn-dir cmvn]
"""

import argparse
import os
import wave

import numpy as np

from srf_tpu_torch.data.features import cmvn_stats, extract_fbank123


def read_wav(path):
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        signal = np.frombuffer(raw, np.int16).astype(np.float32)
    elif width == 4:
        signal = np.frombuffer(raw, np.int32).astype(np.float32) / 65536.0
    else:
        signal = np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0
    if w.getnchannels() > 1:
        signal = signal.reshape(-1, w.getnchannels()).mean(axis=1)
    return signal, rate


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("scp", help="lines: <utt_id> <wav path>")
    parser.add_argument("outdir")
    parser.add_argument("--spk2utt", default=None,
                        help="lines: <spk_id> <utt_id> [<utt_id> ...]")
    parser.add_argument("--cmvn-dir", default=None)
    args = parser.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    feats_by_utt = {}
    with open(args.scp) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            utt_id, path = parts[0], parts[1]
            signal, rate = read_wav(path)
            feats = extract_fbank123(signal, rate)
            np.save(os.path.join(args.outdir, utt_id + ".npy"), feats)
            feats_by_utt[utt_id] = feats

    if args.spk2utt and args.cmvn_dir:
        os.makedirs(args.cmvn_dir, exist_ok=True)
        with open(args.spk2utt) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                spk, utts = parts[0], parts[1:]
                stack = [feats_by_utt[u] for u in utts if u in feats_by_utt]
                if not stack:
                    continue
                mean, std = cmvn_stats(stack)
                np.savetxt(
                    os.path.join(args.cmvn_dir, "spk_%s.cmvn" % spk),
                    np.stack([mean, std]),
                )
    print("extracted %d utterances" % len(feats_by_utt))


if __name__ == "__main__":
    main()
