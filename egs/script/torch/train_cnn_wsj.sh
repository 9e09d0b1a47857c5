#!/bin/bash
# The PyTorch port's copy of egs/script/train_cnn_wsj.sh, its stages and flags
# on srf_tpu_torch (on the CUDA card, or on the CPU with
# EXTRA_FLAGS=--device=cpu).
# Deep maxout CNN WSJ recipe (reference: egs/script/train_cnn_wsj.sh —
# L=15, filters 200/430, proj 3x2048, stride variant).
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/wsj}
LAYER=${1:-15}
FILT_INP=${2:-200}
FILT_INN=${3:-430}
PROJ_NUM=${4:-3}
PROJ_DIM=${5:-2048}
STRIDE=${6:-2}
IS_MP=${7:-False}

E1=${E1:-27}
E2=${E2:-200}
OUT_BASE=${OUT_BASE:-.}
CKPT_BASE=${CKPT_BASE:-./checkpoint}
REF_DIR=${REF_DIR:-.}

NAME=CNN_L${LAYER}_NFILT${FILT_INP}_${FILT_INN}_PROJ${PROJ_NUM}_${PROJ_DIM}

run() {
  local MODULE=${1} K=${2} TOLERANCE=${3} AVG=${4} TC=${5} MAX_EPOCH=${6}
  if [ "$AVG" = "/avg" ]; then MAX_EPOCH=0; else AVG=; fi
  local TEST_TFRD="tfrecord_graves13/wsj-test-graves13-123-*-of-*"
  if [ "$TC" = "dev" ]; then
    TEST_TFRD="tfrecord_graves13/wsj-valid-graves13-123-*-of-*"
  fi
  python -u -m ${MODULE} \
    --path-base=${DATA_BASE} \
    --config=egs/conf/wsj.conf \
    --path-ckpt=${CKPT_BASE}/${NAME}${AVG} \
    --model-type=cnn \
    --model-conv-inp-nfilt=${FILT_INP} \
    --model-conv-inn-nfilt=${FILT_INN} \
    --model-conv-proj-num=${PROJ_NUM} \
    --model-conv-proj-dim=${PROJ_DIM} \
    --model-conv-stride=${STRIDE} \
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

python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.test.out egs/data/wsj_31.vocab --corpus wsj > ${OUT_BASE}/${NAME}.test.utt
egs/script/torch/sclite.sh ${REF_DIR}/test_wsj.ref ${OUT_BASE}/${NAME}.test.utt
python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.valid.out egs/data/wsj_31.vocab --corpus wsj > ${OUT_BASE}/${NAME}.valid.utt
egs/script/torch/sclite.sh ${REF_DIR}/valid_wsj.ref ${OUT_BASE}/${NAME}.valid.utt
