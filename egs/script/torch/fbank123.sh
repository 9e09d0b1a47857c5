#!/bin/bash
# The PyTorch port's copy of egs/script/fbank123.sh, its stages and flags
# on srf_tpu_torch.
# 123-dim fbank+energy+deltas feature extraction with per-speaker CMVN,
# self-contained (no Kaldi; reference: egs/script/fbank123.sh).
# Usage: fbank123.sh wav.scp spk2utt outdir
set -e
cd "$(dirname "$0")/../../.."
python -m srf_tpu_torch.tools.extract_features "$1" "$3" --spk2utt "$2" --cmvn-dir "$3/../cmvn"
# Kaldi-protocol alternative (the published parity pipeline): run Kaldi's
# compute-fbank-feats | add-deltas, per-speaker compute-cmvn-stats /
# apply-cmvn, dump with copy-feats ark,t:normed_feats.txt, then:
#   python -m srf_tpu_torch.tools.ark_to_npy normed_feats.txt --outdir $3
