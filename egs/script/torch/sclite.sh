#!/bin/bash
# The PyTorch port's copy of egs/script/sclite.sh, its stages and flags
# on srf_tpu_torch.
# Score hypotheses against references with NIST sclite when available,
# falling back to the in-framework scorer (same word-level edit distance)
# when sclite is not installed (reference: egs/script/sclite.sh).
if command -v sclite >/dev/null 2>&1; then
  sclite -h "$2" -r "$1" -i wsj -o pralign -o sum
else
  echo "sclite not found; using in-framework scorer" >&2
  # mirror the reference's "-o pralign -o sum" outputs: S/D/I summary on
  # stdout, per-utterance alignments next to the hyp file
  python -m srf_tpu_torch.utils.score "$1" "$2" \
    --pralign "$2.pralign" --confusions 10
fi
