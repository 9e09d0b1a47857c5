#!/bin/bash
# The PyTorch port's copy of egs/script/train_lstm_wsj.sh, its stages and flags
# on srf_tpu_torch (on the CUDA card, or on the CPU with
# EXTRA_FLAGS=--device=cpu).
# (B)LSTM WSJ recipe (reference: egs/script/train_lstm_wsj.sh — L=5 blstm,
# D=534, CNN-FE on, plain Adam lr=1e-4, 80 epochs).
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/wsj}
LAYER=${1:-5}
TYPE=${2:-blstm}
DIM=${3:-534}
CNNFE=${4:-True}
LR=${5:-1e-4}
FRAME=24000

E1=${E1:-80}
OUT_BASE=${OUT_BASE:-.}
CKPT_BASE=${CKPT_BASE:-./checkpoint}
REF_DIR=${REF_DIR:-.}

NAME=LSTM_L${LAYER}_${TYPE}_D${DIM}

run() {
  local MODULE=${1} K=${2} TOLERANCE=${3} AVG=${4} TC=${5} MAX_EPOCH=${6}
  local BATCH_FRAME=${FRAME}
  if [ "$AVG" = "/avg" ]; then MAX_EPOCH=0; BATCH_FRAME=1; else AVG=; fi
  local TEST_TFRD="tfrecord_graves13/wsj-test-graves13-123-*-of-*"
  if [ "$TC" = "dev" ]; then
    TEST_TFRD="tfrecord_graves13/wsj-valid-graves13-123-*-of-*"
  fi
  python -u -m ${MODULE} \
    --path-base=${DATA_BASE} \
    --config=egs/conf/wsj.conf \
    --path-ckpt=${CKPT_BASE}/${NAME}${AVG} \
    --train-inn-dropout=0.4 \
    --train-inp-dropout=0.3 \
    --model-type=${TYPE} \
    --model-dimension=${DIM} \
    --train-batch-frame=${BATCH_FRAME} \
    --train-lr-param-k=${K} \
    --train-opti-type=adam \
    --model-lstm-is-cnnfe=${CNNFE} \
    --train-es-tolerance=${TOLERANCE} \
    --train-max-epoch=${MAX_EPOCH} \
    --path-test-ptrn=${TEST_TFRD} \
    --model-encoder-num=${LAYER} \
    ${EXTRA_FLAGS}
}

run srf_tpu_torch.trainer_sr ${LR} ${E1} dummy dummy ${E1} &> ${OUT_BASE}/${NAME}.1train.out
rm -rf "${CKPT_BASE:?}/${NAME}/avg"
run srf_tpu_torch.tools.average_ckpt 1e-6 1 dummy dummy 0 &> ${OUT_BASE}/${NAME}.2avg.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg test 0 &> ${OUT_BASE}/${NAME}.3decode.test.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg dev  0 &> ${OUT_BASE}/${NAME}.3decode.valid.out

python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.test.out egs/data/wsj_31.vocab --corpus wsj > ${OUT_BASE}/${NAME}.test.utt
egs/script/torch/sclite.sh ${REF_DIR}/test_wsj.ref ${OUT_BASE}/${NAME}.test.utt
python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.valid.out egs/data/wsj_31.vocab --corpus wsj > ${OUT_BASE}/${NAME}.valid.utt
egs/script/torch/sclite.sh ${REF_DIR}/valid_wsj.ref ${OUT_BASE}/${NAME}.valid.utt
