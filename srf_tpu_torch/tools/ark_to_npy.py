"""Kaldi text-ark -> per-utterance .npy converter (the port's own copy of
``srf_tpu/tools/ark_to_npy.py``).

The reference's published feature protocol extracts 123-dim fbank features
with Kaldi and dumps them through a text ark into one ``<utt_id>.npy`` per
utterance (reference: egs/script/fbank123.sh:21-22, egs/script/parsing.py:
1-26). Parity runs against Kaldi-extracted features need this import path;
the port's numpy extractor (tools/extract_features.py) is similar but not
bit-identical to Kaldi's.

Text-ark grammar (one or more entries):

    <utt_id>  [
      v v v ... v
      ...
      v v v ... v ]

This implementation streams rows directly into float32 buffers (the
reference round-trips every utterance through a temp text file).

Usage: python -m srf_tpu_torch.tools.ark_to_npy feats.txt [--outdir DIR]
"""

import argparse
import os
import sys

import numpy as np


def parse_ark(lines):
    """Yields (utt_id, feats float32 [T, D]) from text-ark lines."""
    utt_id = None
    rows = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if utt_id is None:
            if "[" not in line:
                raise ValueError("expected '<utt_id> [' header, got %r" % line)
            utt_id = line.split()[0]
            tail = line.split("[", 1)[1].strip()
            if tail:  # values on the header line (uncommon but legal)
                rows.append(np.asarray(tail.split(), dtype=np.float32))
            continue
        done = "]" in line
        line = line.replace("]", "").strip()
        if line:
            rows.append(np.asarray(line.split(), dtype=np.float32))
        if done:
            if rows:
                feats = np.stack(rows).astype(np.float32)
            else:  # legal zero-row matrix ('utt [ ]'): emit [0, 0]
                feats = np.zeros((0, 0), np.float32)
            yield utt_id, feats
            utt_id, rows = None, []
    if utt_id is not None:
        raise ValueError("ark ended inside utterance %r" % utt_id)


def convert(ark_path, outdir="."):
    os.makedirs(outdir, exist_ok=True)
    count = 0
    with open(ark_path) as fh:
        for utt_id, feats in parse_ark(fh):
            np.save(os.path.join(outdir, utt_id + ".npy"), feats)
            count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("ark", help="Kaldi text-ark file (copy-feats ark,t:)")
    parser.add_argument("--outdir", default=".",
                        help="directory for <utt_id>.npy files")
    args = parser.parse_args(argv)
    count = convert(args.ark, args.outdir)
    print("wrote %d utterances" % count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
