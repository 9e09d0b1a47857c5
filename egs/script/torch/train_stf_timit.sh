#!/bin/bash
# The PyTorch port's copy of egs/script/train_stf_timit.sh, its stages and flags
# on srf_tpu_torch (on the CUDA card, or on the CPU with
# EXTRA_FLAGS=--device=cpu).
# Speech-Transformer TIMIT recipe (reference: egs/script/train_stf_timit.sh
# — L=20, D=128, FF=1024, attention penalty on, staged k=1.5 then 0.5).
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/timit}
LAYER=${1:-20}
DIM=${2:-128}
INN=${3:-1024}

E1=${E1:-27}
E2=${E2:-200}
OUT_BASE=${OUT_BASE:-.}
CKPT_BASE=${CKPT_BASE:-./checkpoint}
REF_DIR=${REF_DIR:-.}

NAME=TF_L${LAYER}_D${DIM}_H${INN}

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
    --model-type=stf \
    --model-inner-dim=${INN} \
    --train-att-dropout=0.3 \
    --train-inn-dropout=0.4 \
    --train-inp-dropout=0.3 \
    --train-res-dropout=0.4 \
    --model-ap-scale=1 \
    --model-ap-width-zero=1 \
    --model-ap-width-stripe=1 \
    --model-ap-encoder=True \
    --model-ap-decoder=True \
    --model-ap-encdec=False \
    --model-dimension=${DIM} \
    --train-warmup-n=1000 \
    --train-batch-frame=20000 \
    --train-lr-param-k=${K} \
    --train-es-tolerance=${TOLERANCE} \
    --train-max-epoch=${MAX_EPOCH} \
    --path-test-ptrn=${TEST_TFRD} \
    --model-encoder-num=${LAYER} \
    ${EXTRA_FLAGS}
}

run srf_tpu_torch.trainer_tf 1.5 ${E1} dummy dummy ${E1} &>  ${OUT_BASE}/${NAME}.1train.out
run srf_tpu_torch.trainer_tf 0.5 ${E2} dummy dummy ${E2} &>> ${OUT_BASE}/${NAME}.1train.out
rm -rf "${CKPT_BASE:?}/${NAME}/avg"
run srf_tpu_torch.tools.average_ckpt 1e-6 1 dummy dummy 0 &> ${OUT_BASE}/${NAME}.2avg.out
run srf_tpu_torch.trainer_tf 1e-6 0 /avg test 0 &> ${OUT_BASE}/${NAME}.3decode.test.out
run srf_tpu_torch.trainer_tf 1e-6 0 /avg dev  0 &> ${OUT_BASE}/${NAME}.3decode.valid.out

python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.test.out egs/data/timit_62.vocab --corpus timit > ${OUT_BASE}/${NAME}.test.utt
egs/script/torch/sclite.sh ${REF_DIR}/test.ref ${OUT_BASE}/${NAME}.test.utt
python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.valid.out egs/data/timit_62.vocab --corpus timit > ${OUT_BASE}/${NAME}.valid.utt
egs/script/torch/sclite.sh ${REF_DIR}/valid.ref ${OUT_BASE}/${NAME}.valid.utt
