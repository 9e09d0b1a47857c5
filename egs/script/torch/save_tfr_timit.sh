#!/bin/bash
# The PyTorch port's copy of egs/script/save_tfr_timit.sh, its stages and flags
# on srf_tpu_torch.
# Build TIMIT TFRecords from npy features + JSON manifests
# (reference: egs/script/save_tfr_timit.sh).
set -e
cd "$(dirname "$0")/../../.."
DATA_PATH=${DATA_PATH:-/data/timit}
python -m srf_tpu_torch.tools.save_tfrecord \
  --path-base=${DATA_PATH} \
  --prep-data-shard=10 \
  --prep-data-name=timit \
  --path-vocab=egs/data/timit_62.vocab \
  --feat-type=graves13 \
  --feat-dim=123 \
  --path-train-json=${TRAIN_JSON:-train}.json \
  --path-valid-json=${VALID_JSON:-valid}.json \
  --path-test-json=${TEST_JSON:-test}.json \
  --path-wrt-tfrecord=tfrecord_graves13 \
  --prep-data-unit=word \
  --path-cmvn-ptrn="cmvn/spk_*.cmvn"
