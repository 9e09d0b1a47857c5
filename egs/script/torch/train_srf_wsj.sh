#!/bin/bash
# The PyTorch port's copy of egs/script/train_srf_wsj.sh, its stages and flags
# on srf_tpu_torch (on the CUDA card, or on the CPU with
# EXTRA_FLAGS=--device=cpu).
# SRF WSJ recipe: 4-stage LR schedule (k=0.6/0.5/0.1/0.05 at epochs
# 15/50/70/80) -> average last 4 -> decode -> score
# (reference: egs/script/train_srf_wsj.sh).
#
# Env overrides (defaults are the canonical recipe):
#   DATA_BASE  corpus root        E1..E4      stage epoch budgets (15/50/70/80)
#   OUT_BASE   log/utt output dir CKPT_BASE   checkpoint root (./checkpoint)
#   REF_DIR    dir with {test,valid}_wsj.ref  EXTRA_FLAGS extra trainer flags
set -e
cd "$(dirname "$0")/../../.."

DATA_BASE=${DATA_BASE:-/data/wsj}
LAYER=${1:-10}
PH=${2:-60}
CH=${3:-30}
DIM=${4:-20}
LPAD=${5:-2}
RPAD=${6:-2}
E1=${E1:-15}
E2=${E2:-50}
E3=${E3:-70}
E4=${E4:-80}
OUT_BASE=${OUT_BASE:-.}
CKPT_BASE=${CKPT_BASE:-./checkpoint}
REF_DIR=${REF_DIR:-.}

NAME=SRF_L${LAYER}_PH${PH}-PD${DIM}-CH${CH}-CD${DIM}-VD${DIM}_W-${LPAD}-${RPAD}

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
    --train-lr-param-k=${K} \
    --train-es-tolerance=${TOLERANCE} \
    --train-max-epoch=${MAX_EPOCH} \
    --path-test-ptrn=${TEST_TFRD} \
    --model-caps-type=lowmemory \
    --model-caps-primary-num=${PH} \
    --model-caps-convolution-num=${CH} \
    --model-caps-primary-dim=${DIM} \
    --model-caps-convolution-dim=${DIM} \
    --model-caps-class-dim=${DIM} \
    --model-caps-window-lpad=${LPAD} \
    --model-caps-window-rpad=${RPAD} \
    --model-caps-context=True \
    --model-caps-iter=1 \
    --model-encoder-num=${LAYER} \
    ${EXTRA_FLAGS}
}

run srf_tpu_torch.trainer_sr 0.6  ${E1} dummy dummy ${E1} &>  ${OUT_BASE}/${NAME}.1train.out
run srf_tpu_torch.trainer_sr 0.5  ${E2} dummy dummy ${E2} &>> ${OUT_BASE}/${NAME}.1train.out
run srf_tpu_torch.trainer_sr 0.1  ${E3} dummy dummy ${E3} &>> ${OUT_BASE}/${NAME}.1train.out
run srf_tpu_torch.trainer_sr 0.05 ${E4} dummy dummy ${E4} &>> ${OUT_BASE}/${NAME}.1train.out
rm -rf ${CKPT_BASE}/${NAME}/avg
run srf_tpu_torch.tools.average_ckpt 1e-6 1 dummy dummy 0 &> ${OUT_BASE}/${NAME}.2avg.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg test 0 &> ${OUT_BASE}/${NAME}.3decode.test.out
run srf_tpu_torch.trainer_sr 1e-6 0 /avg dev  0 &> ${OUT_BASE}/${NAME}.3decode.valid.out

python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.test.out egs/data/wsj_31.vocab --corpus wsj > ${OUT_BASE}/${NAME}.test.utt
egs/script/torch/sclite.sh ${REF_DIR}/test_wsj.ref ${OUT_BASE}/${NAME}.test.utt
python -m srf_tpu_torch.utils.log2utt ${OUT_BASE}/${NAME}.3decode.valid.out egs/data/wsj_31.vocab --corpus wsj > ${OUT_BASE}/${NAME}.valid.utt
egs/script/torch/sclite.sh ${REF_DIR}/valid_wsj.ref ${OUT_BASE}/${NAME}.valid.utt
