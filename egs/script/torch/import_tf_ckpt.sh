#!/bin/bash
# The PyTorch port's copy of egs/script/import_tf_ckpt.sh, its stages and flags
# on srf_tpu_torch.
# Migrate a reference-trained (sephiroce/srf TensorFlow) checkpoint into a
# resumable srf_tpu_torch checkpoint. Defaults describe the canonical
# SRF-TIMIT recipe (train_srf_timit.sh L=7 PH=60 CH=30 D=8 window 1+1+1);
# pass the SAME model flags the checkpoint was trained with.
#
# Usage:
#   SRC=/path/to/ref/checkpoint-dir-or-ckpt-N DATA_BASE=/data/timit \
#     egs/script/torch/import_tf_ckpt.sh [extra --model-* overrides...]
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/timit}
SRC=${SRC:?set SRC=/path/to/reference/checkpoint (dir or ckpt-N prefix)}
OUT=${OUT:-./checkpoint/imported}

python -m srf_tpu_torch.tools.import_tf_ckpt \
  --path-base=${DATA_BASE} \
  --config=egs/conf/timit.conf \
  --path-ckpt=${OUT} \
  --model-type=srf \
  --model-caps-type=naive \
  --model-caps-context=True \
  --model-encoder-num=7 \
  --model-caps-primary-num=60 \
  --model-caps-primary-dim=8 \
  --model-caps-convolution-num=30 \
  --model-caps-convolution-dim=8 \
  --model-caps-class-dim=8 \
  --model-caps-iter=1 \
  --model-caps-window-lpad=1 \
  --model-caps-window-rpad=1 \
  --tpu-import-src=${SRC} \
  "$@"

echo "imported -> ${OUT}; resume/decode with --path-ckpt=${OUT}"
