#!/bin/bash
# The PyTorch port's copy of egs/script/save_tfr.sh, its stages and flags
# on srf_tpu_torch.
# Generic TFRecord build driver (reference: egs/script/save_tfr.sh).
# Point DATA_PATH at a directory with <key>.npy features and JSON-lines
# manifests (format: egs/data/sample.json), then adjust the flags.
set -e
cd "$(dirname "$0")/../../.."
DATA_PATH=${DATA_PATH:-.}

python -m srf_tpu_torch.tools.save_tfrecord \
  --path-base=$DATA_PATH \
  --prep-data-shard=10 \
  --prep-data-name=timit \
  --path-vocab=egs/data/timit_62.vocab \
  --feat-type=graves13 \
  --feat-dim=123 \
  --path-train-json=train_61.json \
  --path-valid-json=valid_61.json \
  --path-test-json=test_61.json \
  --path-wrt-tfrecord=tfrecord_graves \
  --prep-data-unit=word \
  --decoding-from-npy=True
