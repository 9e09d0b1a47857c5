#!/bin/bash
# The PyTorch port's copy of egs/script/train_cnn_timit.sh, its stages and flags
# on srf_tpu_torch (on the CUDA card, or on the CPU with
# EXTRA_FLAGS=--device=cpu).
# Deep maxout CNN TIMIT recipe (reference: egs/script/train_cnn_timit.sh —
# L=10, filters 128/256, proj 3x1024, maxpool variant, stride 1).
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/timit}
LAYER=${1:-10}
FILT_INP=${2:-128}
FILT_INN=${3:-256}
PROJ_NUM=${4:-3}
PROJ_DIM=${5:-1024}
STRIDE=${6:-1}
IS_MP=${7:-True}

E1=${E1:-27}
E2=${E2:-200}
OUT_BASE=${OUT_BASE:-.}
CKPT_BASE=${CKPT_BASE:-./checkpoint}
REF_DIR=${REF_DIR:-.}

NAME=CNN_L${LAYER}_NFILT${FILT_INP}_${FILT_INN}_PROJ${PROJ_NUM}_${PROJ_DIM}

run() {
  local MODULE=${1} K=${2} TOLERANCE=${3} AVG=${4} TC=${5} MAX_EPOCH=${6}
  if [ "$AVG" = "/avg" ]; then MAX_EPOCH=0; else AVG=; fi
  local TEST_TFRD="tfrecord_graves13/timit-test-None-123-*-of-*"
  if [ "$TC" = "dev" ]; then
    TEST_TFRD="tfrecord_graves13/timit-valid-None-123-*-of-*"
  fi
  python -u -m ${MODULE} \
    --path-base=${DATA_BASE} \
    --config=egs/conf/timit.conf \
    --path-ckpt=${CKPT_BASE}/${NAME}${AVG} \
    --model-type=cnn \
    --model-conv-inp-nfilt=${FILT_INP} \
    --model-conv-inn-nfilt=${FILT_INN} \
    --model-conv-proj-num=${PROJ_NUM} \
    --model-conv-proj-dim=${PROJ_DIM} \
    --model-conv-stride=${STRIDE} \
    --train-batch-frame=7000 \
    --train-warmup-n=1200 \
    --model-conv-is-mp=${IS_MP} \
    --train-lr-param-k=${K} \
    --train-es-tolerance=${TOLERANCE} \
    --train-max-epoch=${MAX_EPOCH} \
    --path-test-ptrn=${TEST_TFRD} \
    --model-dimension=1 \
    --model-encoder-num=${LAYER} \
    ${EXTRA_FLAGS}
}

run srf_tpu_torch.trainer_sr 0.5 ${E1} dummy dummy ${E1} &>  ${OUT_BASE}/${NAME}.1train.out
run srf_tpu_torch.trainer_sr 0.1 ${E2} dummy dummy ${E2} &>> ${OUT_BASE}/${NAME}.1train.out
rm -rf "${CKPT_BASE:?}/${NAME}/avg"
run srf_tpu_torch.tools.average_ckpt 1e-6 1 dummy dummy 0 &> ${OUT_BASE}/${NAME}.2avg.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg test 0 &> ${OUT_BASE}/${NAME}.3decode.test.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg dev  0 &> ${OUT_BASE}/${NAME}.3decode.valid.out

python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.test.out egs/data/timit_62.vocab --corpus timit > ${OUT_BASE}/${NAME}.test.utt
egs/script/torch/sclite.sh ${REF_DIR}/test.ref ${OUT_BASE}/${NAME}.test.utt
python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.valid.out egs/data/timit_62.vocab --corpus timit > ${OUT_BASE}/${NAME}.valid.utt
egs/script/torch/sclite.sh ${REF_DIR}/valid.ref ${OUT_BASE}/${NAME}.valid.utt
