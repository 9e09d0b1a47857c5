#!/bin/bash
# The PyTorch port's copy of egs/script/train_srf_timit.sh, its stages and flags
# on srf_tpu_torch (on the CUDA card, or on the CPU with
# EXTRA_FLAGS=--device=cpu).
# SRF TIMIT recipe: staged-LR training -> checkpoint averaging -> decode ->
# score. Same stages and hyperparameters as the reference driver
# (reference: egs/script/train_srf_timit.sh), invoking the trainers.
#
# Usage: train_srf_timit.sh [LAYER PH CH DIM LPAD RPAD METHOD ITER]
#
# Env overrides (defaults are the canonical recipe):
#   DATA_BASE  corpus root        E1/E2       stage epoch budgets (27/200)
#   OUT_BASE   log/utt output dir CKPT_BASE   checkpoint root (./checkpoint)
#   REF_DIR    dir with {test,valid}.ref      EXTRA_FLAGS extra trainer flags
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/timit}
LAYER=${1:-7}
PH=${2:-60}
CH=${3:-30}
DIM=${4:-8}
LPAD=${5:-1}
RPAD=${6:-1}
METHOD=${7:-"SDR"}
ITER=${8:-1}
E1=${E1:-27}
E2=${E2:-200}
OUT_BASE=${OUT_BASE:-.}
CKPT_BASE=${CKPT_BASE:-./checkpoint}
REF_DIR=${REF_DIR:-.}

if [ "${METHOD}" = "DR" ]; then ROUTING="false"; else ROUTING="true"; fi

NAME=SRF_L${LAYER}_PH${PH}-PD${DIM}-CH${CH}-CD${DIM}-VD${DIM}_W-${LPAD}-${RPAD}_${METHOD}-I${ITER}

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
    --train-lr-param-k=${K} \
    --train-batch-frame=7000 \
    --train-warmup-n=1200 \
    --train-es-tolerance=${TOLERANCE} \
    --train-max-epoch=${MAX_EPOCH} \
    --path-test-ptrn=${TEST_TFRD} \
    --model-caps-primary-num=${PH} \
    --model-caps-convolution-num=${CH} \
    --model-caps-primary-dim=${DIM} \
    --model-caps-convolution-dim=${DIM} \
    --model-caps-class-dim=${DIM} \
    --model-caps-type=naive \
    --model-caps-window-lpad=${LPAD} \
    --model-caps-window-rpad=${RPAD} \
    --model-caps-context=${ROUTING} \
    --model-caps-iter=${ITER} \
    --model-encoder-num=${LAYER} \
    ${EXTRA_FLAGS}
}

run srf_tpu_torch.trainer_sr 0.5 ${E1} dummy dummy ${E1} &>  ${OUT_BASE}/${NAME}.1train.out
run srf_tpu_torch.trainer_sr 0.1 ${E2} dummy dummy ${E2} &>> ${OUT_BASE}/${NAME}.1train.out
rm -rf ${CKPT_BASE}/${NAME}/avg
run srf_tpu_torch.tools.average_ckpt 1e-6 1 dummy dummy 0 &> ${OUT_BASE}/${NAME}.2avg.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg test 0 &> ${OUT_BASE}/${NAME}.3decode.test.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg dev  0 &> ${OUT_BASE}/${NAME}.3decode.valid.out

python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.test.out egs/data/timit_62.vocab --corpus timit > ${OUT_BASE}/${NAME}.test.utt
egs/script/torch/sclite.sh ${REF_DIR}/test.ref ${OUT_BASE}/${NAME}.test.utt
python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.valid.out egs/data/timit_62.vocab --corpus timit > ${OUT_BASE}/${NAME}.valid.utt
egs/script/torch/sclite.sh ${REF_DIR}/valid.ref ${OUT_BASE}/${NAME}.valid.utt
