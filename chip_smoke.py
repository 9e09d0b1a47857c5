#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (srf_tpu_torch), one GPU.

    python3 chip_smoke.py        # from the root of a checkout, no arguments

Imports nothing of JAX or srf_tpu. Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ with nvcc (one process
   per source, all started together): K1, K2, K3, K4, K5; print ptxas's
   registers and spills per kernel, and fail if the recurrence kernel of
   K1 or K2, or the cluster scan of K3 or K4, spills;
3. K1 (SDR forward: the prediction kernel and the recurrence) and K3 (the
   cluster-scan SDR forward: a thread-block cluster per batch tile, W's
   slice in shared memory) against their plain PyTorch
   version, and K3 against K1, on the same CUDA tensors, at the three
   canonical SRF-TIMIT capsule-layer geometries, at the serving path's two
   shapes (B=29, T'=64: 29 x 241 frames padded to 256; B=8, T'=128), at
   the unpadded bucket (T'=61), at an odd B/T with 2 routing iterations
   and the PAD mask flipped, and at the decode phase's other shapes
   (B=1, T'=64/96/128; B=8, T'=96) and the recipe's other four training
   buckets in phase 7b (B=17, T'=98; B=12, T'=136; B=10, T'=173; B=8,
   T'=211), K3 at time blocks 8, 1 and 5 (5 divides
   neither 61 nor 64), bit-equal across them; K1 and K3 (K3 against K1 as
   well) at EXTRA_LAYERS: the WSJ recipe's layer 0
   (300, 30, 20, 20) and (40, 5, 3, 4), its general path, at B=3, T'=17
   with 1 and 2 iterations, a W[n] taken in tiles and partial sums in
   global memory at B=3, T'=17 (and for K2 at (800, 64, 8, 4), B=2,
   T'=5), and large logits (most rows beyond
   +-SAFE_LOGIT) at the last TIMIT layer (B=8, T'=2) and the WSJ layer 0
   (B=3, T'=3);
   K1's and K3's times in turns on the same inputs, and the
   plain version's, from CUDA events at B=29, T'=64, and K1's two kernels'
   times apart (torch.profiler);
4. K2 (the fused SDR backward: prediction, reverse-time recurrence, weight
   gradient from du_hat's factors, reduction) and K4 (K3's backward on K3's
   clusters, dW and db summed in the CTA that owns the rows, one partial
   per cluster, then a fixed-order reduction) against their plain PyTorch
   version, and K4 against K2, on the same CUDA tensors, at phase 3's
   shapes with one iteration and time blocks (K4 bit-equal across them);
   K2 and K4 (K4 against K2 as well) at phase 3's EXTRA_LAYERS; K2
   and K4 each bit-equal across two calls; K2's and K4's times in turns,
   and the plain version's, at B=29, T'=61 (the training path's shape),
   and K2's parts' times apart;
5. K5 (the fused dropout) against its plain PyTorch version with
   torch.equal (the two draw the same Philox bits) at 1-5000 elements, a
   misaligned view, and each of the 25 dropout sites of a CNN-TIMIT train
   step at 29 x 241 (read off the model; up to 110,034,816 elements), at
   rates 0.1, 0.2 and 0.5; the keep fraction within 1e-3 of 1 - rate at
   the largest site; the backward through FusedDropoutFunction applying
   the forward's mask to a channels_last cotangent; rate 0 with no launch;
   per site the kernel's, the plain version's and F.dropout's times from
   CUDA events, and their sums over a step's 50 launches;
6. the SRF serving path: a Recognizer at the canonical SRF-TIMIT width
   (L=7, PH=60, PD=8, CH=30, CD=8, VD=8, window 1+1+1, SDR, 1 iteration,
   naive, 63 classes, 2 x 64-filter maxout convs) with random weights drawn
   from a numpy seed as the flax tree and carried across by convert.py,
   serving 8 requests of 150-400 frames and 29 requests of 241 frames
   through transcribe_batch_detailed; K1 must launch 14 times per forward
   (7 calls of its two kernels),
   and the same weights on the CPU must give the same ids and text, with
   logits within LOGIT_ATOL; then forward and end-to-end times, utt/s and
   the realtime factor, and a profile of one forward;
6b. the scan path (sequential_routing_scan, the counterpart of JAX's
   sequential_routing_pallas_scan, which no model calls): the inputs each
   of the 7 routing layers receives when the 29 x 241 batch is served
   (route_layer wrapped here, not in the package) go through the 7 layers'
   forward (7 K3 launches) and their backward for a fixed random cotangent
   (7 K4 calls, 14 launches, no plain backward), and each layer's output
   and gradients must agree with SDRFunction (K1, K2) on the same inputs;
   the 7-layer forward and backward times of K3/K1 and K4/K2 in turns, and
   each layer's cluster plan;
6c. the SRF-TIMIT recipe's decode stage (train_srf_timit.sh:68-73, stages
   2-4) through the port's entry points: 24 synthetic utterances of
   150-500 frames (fbank-123, labels 1..61, utt ids) written into 2
   TFRecord shards by the port's writer; three checkpoints of phase 6's
   weights, each perturbed, saved by utils/checkpoint and averaged by
   tools.average_ckpt (avg/1 within 1 float32 ulp of the float64 mean);
   the first forward per padded width (cuDNN's search); the card's logits
   within LOGIT_ATOL of the CPU's at every decode shape (batch 1 at each
   width, batch 8); trainer_sr.main in
   decode mode with timit.conf's beam 100: (a) the device beam at batch 1,
   (b) at batch 8 with pad_last, (c) the C++ host beam; each scraped with
   utils.log2utt. K1 must launch 14 times per batch forward; (c) must have
   run the C++ decoder on every utterance; (a) and (c) must give the same
   ids, except where the C++ hypothesis is among the device beam's 4-best
   within 1e-3 of its best score (float32 against float64; printed); the
   device beam on the card must equal it on the CPU for the same logits
   of 8 utterances in one batch (ids and frames equal, scores within
   1e-4) and batch 1's hypotheses;
   with a toy 3-gram LM (train_ngram over the split's labels) the device
   beam must give the Python prefix search's hypothesis on the 3 shortest
   utterances (the same near-tie rule); how many utterances (b) changes
   (F7) is printed; then per-batch forward, device-beam and host-beam
   times over every batch at batch 1 and at batch 8, in two passes back
   to back, decode wall per utterance and the realtime factor, and a
   profile of one batch-8 device beam (device ops per frame, idle share);
7. the SRF training path: the same model and weights trained by
   train.step.make_train_step with Adam under Noam(0.5, 1, 1200) and
   timit.conf's betas and eps, on bench.py's workload (29 utterances of
   0.7*241..241 frames, tar_len = max(2, len // 8), labels in 1..61). One
   dropout-free step on the card must agree with the same step on the CPU
   (at a smaller batch) in loss, every gradient and the BatchNorm running
   statistics, and in the parameters' Adam update, taken at Noam's peak
   rate (count 1200) rather than at count 0 (rate 1.2e-14); then
   TRAIN_STEPS steps with dropout on, each calling K1 and K2 7 times (K1
   is two kernels and K2 four, so 14 K1 and 28 K2 launches), with finite
   losses and every tensor on the card; then ms/step, utt/s,
   audio-seconds/s, the device time of a forward and of a backward, and a
   profile of one step (K1 and K2 device ms, their kernels apart, idle
   share);
7b. the SRF-TIMIT recipe's training stage and what follows it
   (train_srf_timit.sh, stages 0-4) through the port's CLIs at full
   width: synthetic fbank-123 npy features and JSON manifests (256 train
   utterances of 150-778 frames filling each of the 5 TIMIT buckets at
   least twice an epoch, 80 valid, phase 6c's 24 test; labels 1..61,
   tar_len = max(2, len // 8)) written to TFRecords by
   tools.save_tfrecord; trainer_sr.main with the recipe's flags at k 0.5
   for 2 epochs, then at k 0.1 to epoch 4 on the same checkpoint
   directory: it must resume at epoch offset 2 with its first update at
   noam(0.1, 1, 1200) of the restored count, save checkpoints 1-4 and 4
   train and 4 valid records in metrics.jsonl, with finite losses; every
   train step launches K1 14 and K2 28 times and every valid batch K1 14
   (trainer_sr's step factories wrapped in this script); then per bucket
   the first step (cuDNN's search) and the median step (CUDA events
   around each call), the epochs' wall, SRF_LOOP_TIMING's split, the idle
   share of the profiled epoch 3 (--tpu-profile-dir) and the CLI's step at
   29 x 241 beside phase 7's; stage 2 again in a subprocess on a copy of
   stage 1's checkpoints with --tpu-ckpt-every-steps=3 and
   --tpu-fault-at-step in the middle of epoch 3 must exit 42, and a rerun
   must resume mid-epoch and end within RESUME_REL of the uninterrupted
   run's epoch-4 weights (relative to how far stage 2 moved them), while
   the same rerun resumed one batch late (a planted fault) must not; every
   (B, T') of the recipe's train and valid steps must be among the shapes
   phases 3-4 held K1-K4 to their plain versions at;
   tools.average_ckpt, trainer_sr decode (device beam, batch 8, beam 100),
   utils.log2utt and utils.score give all 24 utterances; finally one
   epoch with --model-caps-iter=2 (finite losses; its backward is
   autograd through the plain loop, counted in plain_backwards, K2 0
   launches) and one dropout-free ITER=2 step on the card against the
   CPU, held as in 7;
8. the CNN serving path: a Recognizer at the CNN-TIMIT recipe's width
   (egs/script/train_cnn_timit.sh: maxpool maxout CNN, L=10, filters
   128/256, 3 x 1024 projections, time stride 1, --tpu-dropout-kernel=
   pallas) with numpy-seeded weights, serving the same two batches; K5
   launches 0 times (eval has no dropout); the CPU decodes the first
   CNN_CPU_SUBSET utterances of each batch to the same ids and text, with
   logits at their valid frames within CNN_LOGIT_ATOL (the CNN's logits
   there depend neither on the padded width nor on the other utterances);
   then times and a profile of one forward (convolution kernels, idle
   share);
9. the CNN training path: one pallas-mode step with dropout on at every
   K5 site on the card and on the CPU (the masks follow the step seed, so
   they are the same), compared as in 7, for CNN-TIMIT (B=2, with the
   CNN_* tolerances: float32 noise is larger there) and for the stride
   variant at a small width (B=4, its ConvFrontEnd's own dropout off: that
   one draws from the device's generator); then 1 + TRAIN_STEPS steps of
   CNN-TIMIT at 29 x 241 (the first, with cuDNN's algorithm search, timed
   apart), each launching K5 exactly 50 times, with finite losses and
   every tensor on the card; ms/step, utt/s, audio-seconds/s and a profile
   of one step (K5, convolution kernels, the rest, idle share);
10. the STF-TIMIT recipe's model (egs/script/train_stf_timit.sh with
   timit.conf: L=20, D=128, 4 heads, FF 1024, 2 x 64-filter maxout
   convs, penalty zero 1 / stripe 1 / scale 1, 63 classes) with
   numpy-seeded weights: a Recognizer serves phase 6's two batches on the
   card and the CPU (ids and text equal, logits within STF_LOGIT_ATOL; as
   JAX's Recognizer, no padding bias or penalty); one dropout-free step
   with trainer_tf's padding bias and penalty board on card and CPU, held
   as in 7 with its update at the Noam peak (count 1000); 1 + TRAIN_STEPS
   steps at 82 x 241, the 20000-frame bucket (dropout on), ms/step and a
   profile; blockwise_attention held to the plain path on the card,
   forward and gradients, at the STF-WSJ width (8 x 4 heads x 600 x 64,
   penalty and padding bias on) and both timed; then the recipe through
   the CLIs on synthetic TFRecords (266 train utterances filling the
   20000-frame buckets 82 x 241 and 51 x 391 twice, 133 valid, phase 6c's
   24 test): trainer_tf at k 1.5 for an epoch, at k 0.5 to epoch 2 (each
   run with its pre-training validation pass), tools.average_ckpt,
   trainer_tf decode with the device beam at width 100 (batch 8) and
   utils.log2utt over all 24 utterances;
11. the LSTM-WSJ recipe's model (egs/script/train_lstm_wsj.sh with
   wsj.conf: BLSTM, L=5, D=534, 'ave' merge, the CNN front end on, 32
   classes) the same way: serving 8 x 300-1600 and 1 x 1600 frames
   (LSTM_LOGIT_ATOL), one dropout-free step at plain Adam's 1e-4, 1 +
   TRAIN_STEPS steps over three 24000-frame buckets (44 x 541, 24 x 991,
   15 x 1591), and trainer_sr at Adam 1e-4 for 2 epochs (buckets 44 x 541
   and 21 x 1141), average_ckpt, decode at beam 100 and log2utt over 8
   test utterances of 300-1600 frames. Phases 10 and 11 must leave K1-K5's
   launch counters where they found them;
12. streaming SRF-TIMIT with phase 6's weights: K1 with an initial carry
   and a step mask (warm-up rows, one all warm-up) against its plain
   version at [1|4] x [8|10] at the TIMIT layers and the SRF-WSJ
   recipe's three; 4 utterances of 150-800 frames streamed greedily at
   chunk 8, a push of 32 raw frames at a time: logits within LOGIT_ATOL
   of each utterance's batch forward alone (padded past the layers' right
   context, padded_one), ids equal to its greedy decode, 14 K1 launches a
   step and no plain SDR loop on the card; push times (median, p95, the
   first step, RTF); the streamed beam (width 16, phase 6c's toy 3-gram)
   equal to the offline device beam on the same logits; a 4-slot and a
   16-slot StreamingPool equal to single sessions, with their tick times;
   transcribe_long over ~60 s with 3 silent gaps (the output LayerNorm
   set so that silence gives the blank, calibrate_blank): one segment
   closed in each gap, equal to the CPU's;
12b. the whole SRF-WSJ model (train_srf_wsj.sh with wsj.conf: L=10,
   PH=60, CH=30, dim 20, window 2+1+2, lowmemory, 32 classes) with
   numpy-seeded weights: 8 x 300-1600 frames (padded 1664) served on the
   card, 20 K1 launches a forward, two rows at the same width on the CPU
   (logits within LOGIT_ATOL, ids equal), forward times and peak memory;
   the 1600-frame utterance streamed and held to its batch forward;
13. the serving daemon through its CLI (python -m
   srf_tpu_torch.serve_daemon in a subprocess, a two-model fleet with
   phase 6's weights as the default, max batch 8, 10 ms, HTTP on): the
   first request at widths 256 and 384 (cuDNN's search), then 32 TCP
   requests of 150-250 frames from 16 threads, each reply's ids equal to
   the in-process Recognizer's on the utterance and 7 dummies and its
   score within 1e-4; requests/s and latency; 2 HTTP requests and
   /v1/health; 2 live streams over TCP equal to in-process sessions; a
   request to the fleet's other model; the daemon's own K1 count from its
   stats;
14. the other serving entry points: python -m srf_tpu_torch.serve with
   --feats (extract_features' output of a 3 s synthetic wav, with
   utterance CMVN) and --wav of that wav must print the same text;
   --tpu-serve-quant=int8 on the card against the CPU (logits within
   LOGIT_ATOL, ids equal), its resident bytes against float32 and its
   logits' distance from float32; tools.align over 8 utterances on card
   and CPU (spans equal, scores within 1e-4);
15. a "kernels" JSON line (K1, K2, K3, K4, K5), then the card line, then
   the result line.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version, both float32 on the card: only the order of the
# sums differs
RTOL, ATOL = 1e-4, 1e-5
# K2 vs its plain version: rtol 1e-4 and atol 1e-4 x max|plain| for each of
# du, dW and db; dW and db are sums over B x T' (~1800) terms per entry,
# taken in another order
K2_RTOL, K2_ATOL_REL = 1e-4, 1e-4
# card vs CPU logits (float32 both, TF32 off): sums in other orders through
# the front end, 7 routing layers and 9 LayerNorms; logits are O(1) and
# measured ~2e-6 apart on an H100
LOGIT_ATOL = 1e-4
# one dropout-free train step, card vs CPU (float32 both, TF32 off): the
# loss within LOSS_RTOL; each gradient within GRAD_ATOL_REL x its largest
# entry (the backward sums over the batch and time in other orders, through
# 7 routing layers and the CTC loss; measured 1.5e-5 on an H100, while TF32
# convolutions would be ~1e-3 off); the BatchNorm running statistics
# within STATS_ATOL
LOSS_RTOL, GRAD_ATOL_REL, STATS_ATOL = 1e-5, 1e-4, 1e-5
# the parity step's update is taken at this count of the Noam schedule, its
# peak (rate 0.0144 at k 0.5, warmup 1200), where Adam moves every parameter
# by ~rate: each update (after - before) must agree within UPDATE_ATOL_REL x
# rate wherever the gradient is at least UPDATE_GRAD_REL x its tensor's
# largest entry (there a gradient error of GRAD_ATOL_REL cannot flip its
# sign; float32 rounding of a parameter of magnitude ~1 is ~1e-5 x rate);
# elsewhere each update must stay within Adam's first-step bound, the rate
PARITY_COUNT, UPDATE_ATOL_REL, UPDATE_GRAD_REL = 1200, 1e-3, 1e-2
# CNN-TIMIT, card vs CPU (float32 both, TF32 off). Each side is ~5e-5 from
# a float64 run of the same weights in logits, and up to 1.5e-2 (card) and
# 7.9e-3 (CPU) of a tensor's largest entry in the gradients of the
# dropout-on step at B=2 (3.8e-2 on the CPU with dropout off), while the
# card's and the CPU's float64 runs agree to 5e-13 (chip_cnn_numerics.py):
# a conv weight's gradient sums ~2e4 positions that cancel, and the logits
# pass 10 convs and 13 LayerNorms with eps 1e-6. So logits within
# CNN_LOGIT_ATOL, gradients within CNN_GRAD_ATOL_REL x their largest entry,
# and updates compared where the gradient is >= CNN_UPDATE_GRAD_REL x its
# largest (an error of CNN_GRAD_ATOL_REL cannot flip its sign there), over
# at least CNN_MIN_COMPARED of the entries. The parity step reads 1.5e-2
# (gradient) and 2.1e-6 x rate (update) with the card in float32, and
# 1.6e-1 and 2.0 x rate with the card in TF32, which these limits refuse.
CNN_LOGIT_ATOL = 3e-4
CNN_GRAD_ATOL_REL, CNN_UPDATE_GRAD_REL, CNN_MIN_COMPARED = 5e-2, 1e-1, 0.1
TRAIN_STEPS = 20
TRAIN_CHECK_BATCH = 8
# the shapes every SDR kernel (K1-K4) is held to its plain version at, as
# (B, T', routing iterations, PAD mask flipped): the serving path's two
# (29 x 241 frames padded to 256, and B=8 T'=128), the unpadded training
# bucket, and an odd B/T (K2 and K4 take one iteration); the decode
# phase's other shapes (batch 1 at widths 256/384/512, batch 8 at 384);
# the recipe's other four training buckets (phase 7b: 17 x 391, 12 x 541,
# 10 x 691 and 8 x 841 frames, T' = ceil(ceil(T / 2) / 2) after the front
# end's two stride-2 convs), where it trains and validates; and K3's and
# K4's time blocks, 5 dividing neither 61 nor 64
SDR_SHAPES = ((29, 64, 1, False), (8, 128, 1, False), (29, 61, 1, False),
              (7, 17, 2, True), (1, 64, 1, False), (1, 96, 1, False),
              (1, 128, 1, False), (8, 96, 1, False), (17, 98, 1, False),
              (12, 136, 1, False), (10, 173, 1, False), (8, 211, 1, False))
SCAN_TIME_BLOCKS = (8, 1, 5)
# (name, (in_n, out_n, out_d, in_d), PAD mask, layers per forward)
TIMIT_LAYERS = [
    ("layer0", (180, 30, 8, 8), False, 1),
    ("middle", (90, 30, 8, 8), False, 5),
    ("last", (90, 63, 8, 8), True, 1),
]
# K1-K4 at other geometries, as (name, (in_n, out_n, out_d, in_d), PAD mask, W's
# std, (B, T', iterations) shapes): the WSJ recipe's layer 0
# (egs/script/train_srf_wsj.sh:14-19: window 2+2, 60 primary capsules of dim
# 20, 30 capsules of dim 20; u_hat_t 720 KB, more than a block's shared
# memory); geometries of no recipe: out_d 3, on the kernels' general path
# in place of the register path, a W[n] (256 KB) that the prediction and
# weight-gradient kernels take in tiles, 500 out capsules, whose per-warp
# partial sums the recurrence kernels keep in global memory, and 800 in
# capsules, whose c (K2 keeps it for every row) leaves the partial sums no
# room, so K2 takes the general path with them in global memory; and,
# with W 100x the others' (logits up to ~180-250, more than half of the
# rows beyond +-SAFE_LOGIT, where the register path's softmax takes its max
# first), the last TIMIT layer and the WSJ layer 0 over 2-3 steps: over
# more, float32's rounding of such logits flips near-ties between out
# capsules, and the plain version's own float32 run leaves the tolerance of
# its float64 run
EXTRA_LAYERS = (
    ("wsj_layer0", (300, 30, 20, 20), False, 0.1, ((3, 17, 1), (3, 17, 2))),
    ("general", (40, 5, 3, 4), True, 0.1, ((3, 17, 1), (3, 17, 2))),
    ("w_in_tiles", (10, 32, 32, 64), True, 0.1, ((3, 17, 1),)),
    ("partials_in_global", (3, 500, 10, 16), False, 0.1, ((3, 17, 1),)),
    ("c_crowds_partials", (800, 64, 8, 4), True, 0.1, ((2, 5, 1),)),
    ("last_large_logits", (90, 63, 8, 8), True, 10.0, ((8, 2, 1),)),
    ("wsj_large_logits", (300, 30, 20, 20), True, 10.0, ((3, 3, 1),)),
)
# the register path's softmax skips its max where every logit of a warp's
# rows is within this bound (csrc/sdr_stream.cuh kSafeLogit)
SAFE_LOGIT = 64.0
# kernel launches per call: K1 the prediction and the recurrence; K2 the
# prediction, the reverse-time recurrence, the weight gradient, the reduction
K1_LAUNCHES, K2_LAUNCHES = 2, 4
# K1's and K2's recurrence kernels and K3's and K4's cluster scans, which
# must not spill: their chain over time is what bounds them
RECURRENCE_KERNELS = ("sdr_fwd_kernel", "sdr_bwd_step_kernel",
                      "sdr_scan_fwd_kernel", "sdr_scan_bwd_kernel")
# the CNN-TIMIT recipe (egs/script/train_cnn_timit.sh:7-14,31-50 with
# timit.conf): the maxpool maxout CNN, L=10, filters 128/256, 3 x 1024
# projections, time stride 1, K5 at every dropout site, greedy decoding
CNN_FLAGS = [
    "--model-type=cnn", "--model-conv-is-mp=True", "--model-encoder-num=10",
    "--model-conv-inp-nfilt=128", "--model-conv-inn-nfilt=256",
    "--model-conv-proj-num=3", "--model-conv-proj-dim=1024",
    "--model-conv-stride=1", "--model-dimension=1",
    "--train-batch-frame=7000", "--tpu-dropout-kernel=pallas",
    "--decoding-beam-width=1",
]
# the stride variant (the WSJ recipe's IS_MP=False) at a small width
CNN_STRIDE_FLAGS = [
    "--model-type=cnn", "--model-conv-is-mp=False", "--model-encoder-num=6",
    "--model-conv-inp-nfilt=32", "--model-conv-inn-nfilt=64",
    "--model-conv-proj-num=3", "--model-conv-proj-dim=256",
    "--model-conv-filter-num=16", "--tpu-dropout-kernel=pallas",
    "--decoding-beam-width=1",
]
# K5 sites per CNN-TIMIT forward (20 in the convs, 4 in the projections, 1
# in projv); a train step launches K5 twice per site, forward and backward
CNN_SITES = 25
# card-vs-CPU step batches of the CNN (the CPU half runs the full-width
# model and K5's plain Philox in int64 tensor ops), and the utterances of
# each serving batch that the CPU also decodes
CNN_CHECK_BATCH, CNN_STRIDE_CHECK_BATCH, CNN_CPU_SUBSET = 2, 4, 3
K5_SIZES = (1, 3, 4, 1023, 1025, 5000)
K5_RATES = (0.1, 0.2, 0.5)
TIMIT_FLAGS = [
    "--model-encoder-num=7", "--model-caps-primary-num=60",
    "--model-caps-primary-dim=8", "--model-caps-convolution-num=30",
    "--model-caps-convolution-dim=8", "--model-caps-class-dim=8",
    "--model-caps-type=naive", "--model-caps-window-lpad=1",
    "--model-caps-window-rpad=1", "--model-caps-context=True",
    "--model-caps-iter=1", "--decoding-beam-width=1",
]


class SmokeFailure(Exception):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def event_ms(torch, fn, reps):
    """Mean ms of ``fn`` on the card over ``reps`` launches after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(torch, first, second, reps):
    """Mean ms of two functions on the same inputs, from CUDA events, each
    timed twice in the order first, second, second, first."""
    times = [event_ms(torch, fn, reps) for fn in (first, second, second,
                                                   first)]
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2


def timed_ms(torch, fn, reps):
    """Host-clock ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronize (a request is done when its result is on the host)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return times


def sdr_bound_ms(batch, seq_len, geometry, num_iter):
    """Least time the card could take for one SDR forward call: the larger
    of its bytes (u, W, bias read once, out written once) over HBM bandwidth
    and its float32 operations over the f32 peak. Returns the two times in
    ms, (bytes_ms, operations_ms)."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    nbytes = 4 * (batch * seq_len * in_n * in_d + in_n * out_no * in_d
                  + in_n * out_no + batch * seq_len * out_no)
    per_step = 2 * in_d * in_n * out_no + num_iter * (
        4 * in_n * out_no      # agreement and s contractions
        + 6 * in_n * out_n     # logit update and softmax
        + 4 * out_no + 4 * out_n)  # squash
    flops = batch * seq_len * per_step
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS


def sdr_bwd_bound_ms(batch, seq_len, geometry):
    """Least time the card could take for one SDR backward call (one
    routing iteration): the larger of its bytes (u, W, bias, vs, dvs read
    once; du, dW, db written once) over HBM bandwidth and its float32
    operations, the recomputed forward step included, over the f32 peak.
    Returns (bytes_ms, operations_ms)."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    u_size, w_size = batch * seq_len * in_n * in_d, in_n * out_no * in_d
    v_size, b_size = batch * seq_len * out_no, in_n * out_no
    nbytes = 4 * 2 * (u_size + w_size + b_size + v_size)
    forward = (2 * in_d * in_n * out_no + 4 * in_n * out_no
               + 6 * in_n * out_n + 4 * out_no + 4 * out_n)
    backward = (4 * in_d * in_n * out_no   # dW and du contractions
                + 8 * in_n * out_no        # dc, carry, du_hat, db
                + 4 * in_n * out_n         # softmax backward
                + 4 * out_no + 12 * out_n)  # squash backward
    flops = batch * seq_len * (forward + backward)
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS


K1_PARTS = (("prediction", "sdr_predict_kernel"),
            ("recurrence", "sdr_fwd_kernel"))
K2_PARTS = (("prediction", "sdr_predict_kernel"),
            ("reverse_time", "sdr_bwd_step_kernel"),
            ("weight_gradient", "sdr_bwd_wgrad_kernel"),
            ("reduction", "sdr_bwd_reduce_kernel"))


def parts_ms(torch, fn, parts, reps=5):
    """Device ms per call of each of a kernel's parts ((label, symbol)
    pairs), from torch.profiler over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    kernels = profile_device(torch, lambda: [fn() for _ in range(reps)],
                             parts)[0]
    return {label: ms / reps for label, ms in kernels.items()}


# a kernel's name in a mangled symbol, and its int or bool template
# arguments
_KERNEL_NAME = re.compile(r"\d+([a-z][a-z_]*?_kernel)((?:I(?:L[ib]\d+E)+E)?)")


def ptxas_entries(log):
    """{kernel: (registers, bytes of spill stores and loads)} from nvcc's
    -Xptxas=-v output; a template instance is named kernel<8,2> (ints) or
    kernel<1> (a bool)."""
    def readable(mangled):
        found = _KERNEL_NAME.search(mangled)
        if found is None:
            return mangled
        args = re.findall(r"L[ib](\d+)E", found.group(2))
        return found.group(1) + ("<%s>" % ",".join(args) if args else "")

    entries, entry, props = {}, None, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = readable(found.group(1))
            entries.setdefault(entry, [0, 0])
        found = re.search(r"Function properties for (\w+)", line)
        if found:
            props = readable(found.group(1))
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found and props in entries:
            entries[props][1] = int(found.group(1)) + int(found.group(2))
        found = re.search(r"Used (\d+) registers", line)
        if found and entry is not None:
            entries[entry][0] = int(found.group(1))
    return {k: tuple(v) for k, v in entries.items()}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def sdr_totals():
    return dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes_ms",
                          "operations_ms"), 0.0)


def add_layer(totals, per_layer, layer, count, ms, plain_ms, bound_ms_pair,
              **extra):
    """Adds one layer's times, ``count`` times over, to a kernel's totals,
    and its entry to ``per_layer``."""
    bytes_ms, ops_ms = bound_ms_pair
    bound = max(bytes_ms, ops_ms)
    per_layer.append(dict(layer=layer, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, **extra))
    for key, value in (("ms", ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound), ("bytes_ms", bytes_ms),
                       ("operations_ms", ops_ms)):
        totals[key] += count * value


def kernel_entry(name, replaces, max_err, totals, per_layer):
    """A kernel's entry of the "kernels" JSON line; ``launches`` is set once
    the main path has run."""
    return {
        "name": name, "route": "cuda",
        "source": "srf_tpu_torch/csrc/%s.cu" % name,
        "replaces": replaces, "launches": None, "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["bytes_ms"] > totals["operations_ms"]
                     else "operations"),
        "library_ms": None,  # no single PyTorch call computes SDR or its VJP
        "per_layer": per_layer,
    }


def extra_weights(torch, device, index, geometry, w_std):
    """W (std ``w_std``) and bias of EXTRA_LAYERS[index], drawn from a seed
    of its own, and that generator, which then draws the case's inputs (the
    same in phases 3 and 4)."""
    in_n, out_n, out_d, in_d = geometry
    rng = np.random.RandomState(SEED + 100 + index)
    return (torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * w_std,
                         dtype=torch.float32, device=device),
            torch.tensor(rng.randn(in_n, out_n, out_d) * 0.1,
                         dtype=torch.float32, device=device), rng)


def large_logits(torch, u, w, b, out, w_std):
    """For a large-weight case: text giving the largest first-iteration
    logit <u_hat[n,o,:], v_{t-1}[o,:]> and the share of (b, t >= 1, n) rows
    with one beyond +-SAFE_LOGIT, which must be at least a third; else ''."""
    if w_std < 1:
        return ""
    from srf_tpu_torch.ops.routing import predict_capsules

    v_prev = torch.cat([torch.zeros_like(out[:, :1]), out[:, :-1]], dim=1)
    logits = torch.einsum("btnoi,btoi->btno", predict_capsules(u, w, b),
                          v_prev)[:, 1:]
    share = (logits.abs() > SAFE_LOGIT).any(dim=-1).float().mean().item()
    check(share >= 1 / 3, "only %.3f of the rows' logits pass +-%g"
          % (share, SAFE_LOGIT))
    return "; max |logit| %.1f, rows beyond +-%g: %.3f" % (
        logits.abs().max().item(), SAFE_LOGIT, share)


def kernel_phase(torch, device):
    """Phase 3: K1 and K3 against their plain version, and K3 against K1,
    on the same CUDA tensors; returns their JSON entries."""
    from srf_tpu_torch.ops.routing import sequential_routing
    from srf_tpu_torch.ops.routing_cuda import (scan_plan,
                                                sequential_routing_cuda,
                                                sequential_routing_scan_cuda)

    rng = np.random.RandomState(SEED)
    max_err = {"K1": 0.0, "K3": 0.0, "K3 vs K1": 0.0}
    per_layer = {"K1": [], "K3": []}
    totals = {"K1": sdr_totals(), "K3": sdr_totals()}
    k1_parts = dict.fromkeys((label for label, _ in K1_PARTS), 0.0)
    for name, geometry, mask, count in TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * 0.1,
                         dtype=torch.float32, device=device)
        b = torch.tensor(rng.randn(in_n, out_n, out_d) * 0.1,
                         dtype=torch.float32, device=device)
        for batch, seq_len, num_iter, flip in SDR_SHAPES:
            use_mask = mask != flip
            u = torch.tensor(rng.randn(batch, seq_len, in_n, in_d),
                             dtype=torch.float32, device=device)
            got = sequential_routing_cuda(u, w, b, num_iter, use_mask)
            torch.cuda.synchronize()
            want = sequential_routing(u, w, b, num_iter, use_mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K1 output not finite")
            err = (got - want).abs().max().item()
            max_err["K1"] = max(max_err["K1"], err)
            print("K1 %s %s B=%d T=%d iter=%d mask=%s max_abs_err=%.3e"
                  % (name, geometry, batch, seq_len, num_iter, use_mask, err))
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  "K1 disagrees with its plain version at %s B=%d T=%d"
                  % (geometry, batch, seq_len))
            first_k3 = None
            for time_block in SCAN_TIME_BLOCKS:
                k3 = sequential_routing_scan_cuda(u, w, b, num_iter, use_mask,
                                                  time_block)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(k3).all()), "K3 output not finite")
                if first_k3 is None:
                    first_k3 = k3
                check(torch.equal(k3, first_k3),
                      "K3 at time_block %d is not bit-equal to time_block %d "
                      "at %s B=%d T=%d" % (time_block, SCAN_TIME_BLOCKS[0],
                                           geometry, batch, seq_len))
                err, err_k1 = ((k3 - want).abs().max().item(),
                               (k3 - got).abs().max().item())
                max_err["K3"] = max(max_err["K3"], err)
                max_err["K3 vs K1"] = max(max_err["K3 vs K1"], err_k1)
                print("K3 %s %s B=%d T=%d iter=%d mask=%s time_block=%d "
                      "max_abs_err=%.3e (vs K1 %.3e)%s"
                      % (name, geometry, batch, seq_len, num_iter, use_mask,
                         time_block, err, err_k1,
                         "" if time_block == SCAN_TIME_BLOCKS[0]
                         else "; bit-equal to time_block %d"
                         % SCAN_TIME_BLOCKS[0]))
                check(torch.allclose(k3, want, rtol=RTOL, atol=ATOL)
                      and torch.allclose(k3, got, rtol=RTOL, atol=ATOL),
                      "K3 disagrees with its plain version or K1 at %s B=%d "
                      "T=%d time_block=%d" % (geometry, batch, seq_len,
                                              time_block))
            if (batch, seq_len) != (29, 64):
                continue
            ms, k3_ms = paired_ms(
                torch, lambda: sequential_routing_cuda(u, w, b, num_iter,
                                                       use_mask),
                lambda: sequential_routing_scan_cuda(u, w, b, num_iter,
                                                     use_mask), 20)
            plain_ms = event_ms(torch, lambda: sequential_routing(
                u, w, b, num_iter, use_mask), 3)
            bound = sdr_bound_ms(batch, seq_len, geometry, num_iter)
            plan = scan_plan("sdr_scan_fwd", u, w)
            parts = parts_ms(torch, lambda: sequential_routing_cuda(
                u, w, b, num_iter, use_mask), K1_PARTS)
            for label, part in parts.items():
                k1_parts[label] += count * part
            print("K1 %s B=29 T=64: kernel %.4f ms (prediction %.4f ms, "
                  "recurrence %.4f ms), plain %.4f ms, bound %.4f ms (bytes "
                  "%.4f ms, operations %.4f ms)"
                  % (name, ms, parts["prediction"], parts["recurrence"],
                     plain_ms, max(bound), *bound))
            print("K3 %s B=29 T=64 (plan %s, time block 8): kernel %.4f ms, "
                  "K1 %.4f ms on the same inputs" % (name, plan, k3_ms, ms))
            for label, kernel_ms, extra in (
                    ("K1", ms, {"parts_ms": parts}),
                    ("K3", k3_ms, {"k1_ms": ms, "plan": plan})):
                add_layer(totals[label], per_layer[label], name, count,
                          kernel_ms, plain_ms, bound, geometry=list(geometry),
                          per_forward=count, **extra)
    # K1 and K3 at EXTRA_LAYERS
    for index, (name, geometry, mask, w_std, shapes) in enumerate(
            EXTRA_LAYERS):
        w, b, rng_case = extra_weights(torch, device, index, geometry,
                                       w_std)
        for batch, seq_len, num_iter in shapes:
            u = torch.tensor(rng_case.randn(batch, seq_len, geometry[0],
                                            geometry[3]),
                             dtype=torch.float32, device=device)
            got = sequential_routing_cuda(u, w, b, num_iter, mask)
            torch.cuda.synchronize()
            want = sequential_routing(u, w, b, num_iter, mask)
            check(bool(torch.isfinite(got).all()), "K1 output not finite")
            err = (got - want).abs().max().item()
            max_err["K1"] = max(max_err["K1"], err)
            print("K1 %s %s B=%d T=%d iter=%d mask=%s max_abs_err=%.3e%s"
                  % (name, geometry, batch, seq_len, num_iter, mask, err,
                     large_logits(torch, u, w, b, want, w_std)))
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  "K1 disagrees with its plain version at %s B=%d T=%d"
                  % (geometry, batch, seq_len))
            k3 = sequential_routing_scan_cuda(u, w, b, num_iter, mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(k3).all()), "K3 output not finite")
            err, err_k1 = ((k3 - want).abs().max().item(),
                           (k3 - got).abs().max().item())
            max_err["K3"] = max(max_err["K3"], err)
            max_err["K3 vs K1"] = max(max_err["K3 vs K1"], err_k1)
            print("K3 %s %s B=%d T=%d iter=%d mask=%s max_abs_err=%.3e (vs K1 "
                  "%.3e); plan %s" % (name, geometry, batch, seq_len,
                                      num_iter, mask, err, err_k1,
                                      scan_plan("sdr_scan_fwd", u, w)))
            check(torch.allclose(k3, want, rtol=RTOL, atol=ATOL)
                  and torch.allclose(k3, got, rtol=RTOL, atol=ATOL),
                  "K3 disagrees with its plain version or K1 at %s B=%d T=%d"
                  % (geometry, batch, seq_len))
    torch.cuda.synchronize()
    print("K3 one forward's 7 layers at B=29 T=64: kernel %.4f ms, K1 %.4f "
          "ms, plain %.4f ms, bound %.4f ms; max |K3 - plain| %.3e, max |K3 "
          "- K1| %.3e" % (totals["K3"]["ms"], totals["K1"]["ms"],
                          totals["K3"]["plain_ms"], totals["K3"]["bound_ms"],
                          max_err["K3"], max_err["K3 vs K1"]))
    # times: one forward's 7 calls at the main path's B=29, T'=64 (K3's
    # at time block 8), K1 and K3 timed in turns on the same inputs
    k1 = kernel_entry("sdr_fwd", "srf_tpu/ops/routing_pallas.py:81",
                      max_err["K1"], totals["K1"], per_layer["K1"])
    k1.update(launches_per_call=K1_LAUNCHES, parts_ms=k1_parts)
    print("K1 one forward's 7 calls at B=29 T=64: %.4f ms (prediction %.4f "
          "ms, recurrence %.4f ms), plain %.4f ms, bound %.4f ms; max |K1 - "
          "plain| %.3e" % (totals["K1"]["ms"], k1_parts["prediction"],
                           k1_parts["recurrence"], totals["K1"]["plain_ms"],
                           totals["K1"]["bound_ms"], max_err["K1"]))
    k3 = kernel_entry("sdr_scan_fwd", "srf_tpu/ops/routing_pallas.py:387",
                      max_err["K3"], totals["K3"], per_layer["K3"])
    k3.update(k1_ms=totals["K1"]["ms"], max_abs_err_vs_k1=max_err["K3 vs K1"])
    return k1, k3


def k2_phase(torch, device):
    """Phase 4: K2 and K4 against their plain version, K4 against K2 on the
    same CUDA tensors, each bit-equal across two calls; returns their JSON
    entries."""
    from srf_tpu_torch.ops.routing import sequential_routing_bwd
    from srf_tpu_torch.ops.routing_cuda import (
        scan_plan, sequential_routing_bwd_cuda, sequential_routing_cuda,
        sequential_routing_scan_bwd_cuda)

    rng = np.random.RandomState(SEED + 2)
    max_err = {"K2": 0.0, "K4": 0.0, "K4 vs K2": 0.0}
    per_layer = {"K2": [], "K4": []}
    totals = {"K2": sdr_totals(), "K4": sdr_totals()}
    k2_parts = dict.fromkeys((label for label, _ in K2_PARTS), 0.0)

    def held(label, got, want, tolerances_of, against):
        """Checks (du, dW, db) against ``want`` with K2's tolerances, each
        scaled by the largest entry of ``tolerances_of``; returns the
        errors as text and the largest."""
        errs, worst_err = [], 0.0
        for part, g, x, ref in zip(("du", "dW", "db"), got, want,
                                   tolerances_of):
            check(bool(torch.isfinite(g).all()), "%s %s not finite"
                  % (label, part))
            scale = ref.abs().max().item()
            err = (g - x).abs().max().item()
            worst_err = max(worst_err, err)
            errs.append("%s %.3e (max|plain| %.3e)" % (part, err, scale))
            check(torch.allclose(g, x, rtol=K2_RTOL, atol=K2_ATOL_REL * scale),
                  "%s %s disagrees with %s" % (label, part, against))
        return ", ".join(errs), worst_err

    def k2_held(u, w, b, vs, dvs, use_mask, where):
        """K2 twice, bit-equal, and held to its plain version; returns the
        first call's (du, dW, db)."""
        got = sequential_routing_bwd_cuda(u, w, b, vs, dvs, use_mask)
        again = sequential_routing_bwd_cuda(u, w, b, vs, dvs, use_mask)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              "K2 is not bit-equal across two calls at " + where)
        want = sequential_routing_bwd(u, w, b, vs, dvs, use_mask)
        torch.cuda.synchronize()
        text, err = held("K2", got, want, want,
                         "its plain version at " + where)
        max_err["K2"] = max(max_err["K2"], err)
        print("K2 %s bit-equal twice; max_abs_err %s" % (where, text))
        return got, want

    def k4_held(u, w, b, vs, dvs, use_mask, where, got, want, time_block=8,
                first=None):
        """K4 twice, bit-equal (and to ``first``, another time block's),
        held to its plain version ``want`` and to K2's ``got``; returns the
        first call's (du, dW, db)."""
        k4 = sequential_routing_scan_bwd_cuda(u, w, b, vs, dvs, use_mask,
                                              time_block)
        again = sequential_routing_scan_bwd_cuda(u, w, b, vs, dvs, use_mask,
                                                 time_block)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(k4, again)),
              "K4 is not bit-equal across two calls at " + where)
        if first is not None:
            check(all(torch.equal(x, y) for x, y in zip(k4, first)),
                  "K4 is not bit-equal across time blocks at " + where)
        text, err = held("K4", k4, want, want, "its plain version at " + where)
        text_k2, err_k2 = held("K4", k4, got, want, "K2 at " + where)
        max_err["K4"] = max(max_err["K4"], err)
        max_err["K4 vs K2"] = max(max_err["K4 vs K2"], err_k2)
        print("K4 %s bit-equal twice%s; max_abs_err %s; vs K2 %s"
              % (where, "" if first is None else " and to the first time block",
                 text, text_k2))
        return k4

    for name, geometry, mask, count in TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * 0.1,
                         dtype=torch.float32, device=device)
        b = torch.tensor(rng.randn(in_n, out_n, out_d) * 0.1,
                         dtype=torch.float32, device=device)
        for batch, seq_len, _, flip in SDR_SHAPES:  # one routing iteration
            use_mask = mask != flip
            where = "%s B=%d T=%d mask=%s" % (geometry, batch, seq_len,
                                              use_mask)
            u = torch.tensor(rng.randn(batch, seq_len, in_n, in_d),
                             dtype=torch.float32, device=device)
            vs = sequential_routing_cuda(u, w, b, 1, use_mask)
            dvs = torch.tensor(rng.randn(batch, seq_len, out_n, out_d),
                               dtype=torch.float32, device=device)
            got, want = k2_held(u, w, b, vs, dvs, use_mask,
                                "%s %s" % (name, where))
            first = None
            for time_block in SCAN_TIME_BLOCKS:
                k4 = k4_held(u, w, b, vs, dvs, use_mask, "%s %s time_block=%d"
                             % (name, where, time_block), got, want,
                             time_block, first)
                first = k4 if first is None else first
            if (batch, seq_len) != (29, 61):
                continue
            ms, k4_ms = paired_ms(
                torch, lambda: sequential_routing_bwd_cuda(u, w, b, vs, dvs,
                                                           use_mask),
                lambda: sequential_routing_scan_bwd_cuda(u, w, b, vs, dvs,
                                                         use_mask), 10)
            plain_ms = event_ms(torch, lambda: sequential_routing_bwd(
                u, w, b, vs, dvs, use_mask), 2)
            bound = sdr_bwd_bound_ms(batch, seq_len, geometry)
            plan = scan_plan("sdr_scan_bwd", u, w)
            parts = parts_ms(torch, lambda: sequential_routing_bwd_cuda(
                u, w, b, vs, dvs, use_mask), K2_PARTS)
            for label, part in parts.items():
                k2_parts[label] += count * part
            print("K2 %s B=29 T=61: kernel %.4f ms (prediction %.4f ms, "
                  "reverse-time %.4f ms, weight gradient %.4f ms, reduction "
                  "%.4f ms), plain %.4f ms, bound %.4f ms (bytes %.4f ms, "
                  "operations %.4f ms)"
                  % (name, ms, parts["prediction"], parts["reverse_time"],
                     parts["weight_gradient"], parts["reduction"], plain_ms,
                     max(bound), *bound))
            print("K4 %s B=29 T=61 (plan %s, time block 8): kernel %.4f ms, "
                  "K2 %.4f ms on the same inputs" % (name, plan, k4_ms, ms))
            for label, kernel_ms, extra in (
                    ("K2", ms, {"parts_ms": parts}),
                    ("K4", k4_ms, {"k2_ms": ms, "plan": plan})):
                add_layer(totals[label], per_layer[label], name, count,
                          kernel_ms, plain_ms, bound, geometry=list(geometry),
                          per_step=count, **extra)
    # K2 and K4 at EXTRA_LAYERS, one routing iteration
    for index, (name, geometry, mask, w_std, shapes) in enumerate(
            EXTRA_LAYERS):
        in_n, out_n, out_d, in_d = geometry
        w, b, rng_case = extra_weights(torch, device, index, geometry,
                                       w_std)
        for batch, seq_len, num_iter in shapes:
            u = torch.tensor(rng_case.randn(batch, seq_len, in_n, in_d),
                             dtype=torch.float32, device=device)
            if num_iter != 1:
                continue
            vs = sequential_routing_cuda(u, w, b, 1, mask)
            dvs = torch.tensor(rng_case.randn(batch, seq_len, out_n, out_d),
                               dtype=torch.float32, device=device)
            where = "%s %s B=%d T=%d mask=%s%s" % (
                name, geometry, batch, seq_len, mask,
                large_logits(torch, u, w, b, vs, w_std))
            got, want = k2_held(u, w, b, vs, dvs, mask, where)
            k4_held(u, w, b, vs, dvs, mask, "%s; plan %s" % (
                where, scan_plan("sdr_scan_bwd", u, w)), got, want)
    torch.cuda.synchronize()
    print("K4 one backward's 7 layers at B=29 T=61: kernel %.4f ms, K2 %.4f "
          "ms, plain %.4f ms, bound %.4f ms; max |K4 - plain| %.3e, max |K4 "
          "- K2| %.3e" % (totals["K4"]["ms"], totals["K2"]["ms"],
                          totals["K4"]["plain_ms"], totals["K4"]["bound_ms"],
                          max_err["K4"], max_err["K4 vs K2"]))
    # times: one train step's 7 calls (K2: 28 launches, each call's
    # prediction, reverse-time, weight-gradient and reduction kernels; K4:
    # 14, its scan and reduction) at the training path's B=29, T'=61, timed
    # in turns
    k2 = kernel_entry("sdr_bwd", "srf_tpu/ops/routing_pallas.py:159",
                      max_err["K2"], totals["K2"], per_layer["K2"])
    k2.update(launches_per_call=K2_LAUNCHES, parts_ms=k2_parts)
    print("K2 one train step's 7 calls at B=29 T=61: %.4f ms (prediction "
          "%.4f ms, reverse-time %.4f ms, weight gradient %.4f ms, reduction "
          "%.4f ms), plain %.4f ms, bound %.4f ms; max |K2 - plain| %.3e"
          % (totals["K2"]["ms"], k2_parts["prediction"],
             k2_parts["reverse_time"], k2_parts["weight_gradient"],
             k2_parts["reduction"], totals["K2"]["plain_ms"],
             totals["K2"]["bound_ms"], max_err["K2"]))
    k4 = kernel_entry("sdr_scan_bwd", "srf_tpu/ops/routing_pallas.py:473",
                      max_err["K4"], totals["K4"], per_layer["K4"])
    k4.update(k2_ms=totals["K2"]["ms"], max_abs_err_vs_k2=max_err["K4 vs K2"])
    return k2, k4


def random_weights(model):
    """The flax variable tree at ``model``'s shapes, drawn from numpy, and
    carried into a state_dict by convert.py."""
    from srf_tpu_torch import convert

    rng = np.random.RandomState(SEED)
    tree = convert.state_dict_to_flax(model.state_dict())

    def fill(node):
        out = {}
        for name, leaf in sorted(node.items()):
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
            elif name == "kernel":
                fan_in = int(np.prod(leaf.shape[:-1]))
                out[name] = rng.randn(*leaf.shape) / np.sqrt(fan_in)
            elif name == "scale":
                out[name] = 1.0 + 0.1 * rng.randn(*leaf.shape)
            elif name == "var":
                out[name] = rng.uniform(0.5, 1.5, size=leaf.shape)
            else:  # bias, mean, routing W{i} / b{i}
                out[name] = 0.1 * rng.randn(*leaf.shape)
        return out

    return convert.flax_to_state_dict(fill(tree))


# K1 is its recurrence and the prediction kernel it shares with K2: a
# forward's "prediction" is K1's, a backward's K2's
SRF_SYMBOLS = (("K1 recurrence", "sdr_fwd_kernel"),
               ("prediction", "sdr_predict_kernel"), ("K2", "sdr_bwd_"),
               ("K2 step", "sdr_bwd_step_kernel"),
               ("K2 wgrad", "sdr_bwd_wgrad_kernel"),
               ("K2 reduce", "sdr_bwd_reduce_kernel"))
# cuDNN's convolution kernels (forward, data and weight gradients, its FFT
# and layout-conversion kernels) and cuBLAS's GEMMs
CONV_PATTERNS = ("xmma", "gemm", "implicit_convolve", "cudnn", "fprop",
                 "dgrad", "wgrad", "winograd", "fft", "region_transform",
                 "nchwToNhwc", "nhwcToNchw")


def profile_device(torch, fn, symbols=SRF_SYMBOLS):
    """Device time of one call of ``fn``, from torch.profiler (CUPTI):
    ({label: ms of the device ops whose name holds the label's symbol},
    ms of all device ops (kernels and copies), their count, device busy
    ms, host wall ms, {op name: ms}). With the SRF symbols "K2" is the sum
    of its step, weight-gradient and reduction kernels (without the
    prediction), "K2 step" the reverse-time one, "K2 wgrad" the
    weight-gradient one."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    spans = []
    kernels = {label: 0.0 for label, _ in symbols}
    by_name = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        spans.append(span)
        ms = (span[1] - span[0]) / 1e3
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        for label, symbol in symbols:
            if symbol in evt.name:
                kernels[label] += ms
    total = sum(end - start for start, end in spans) / 1e3
    busy, last_end = 0.0, None
    for start, end in sorted(spans):
        if last_end is not None and start < last_end:
            start = last_end
        if end > start:
            busy += end - start
            last_end = end
    return kernels, total, len(spans), busy / 1e3, wall_ms, by_name


def conv_ms(by_name):
    """ms of the convolution and GEMM kernels among a profile's device
    ops (the CNN's Linear projections are ~1 % of its FLOPs)."""
    return sum(ms for name, ms in by_name.items()
               if any(p.lower() in name.lower() for p in CONV_PATTERNS))


def layout_ms(by_name):
    """ms of cuDNN's NCHW <-> NHWC conversions (inside ``conv_ms``)."""
    return sum(ms for name, ms in by_name.items()
               if "nchwToNhwc" in name or "nhwcToNchw" in name)


def top_ops(by_name, count=6):
    """The ``count`` device ops that took longest, as 'ms name' text."""
    top = sorted(by_name.items(), key=lambda item: -item[1])[:count]
    return "; ".join("%.3f %s" % (ms, name[:70]) for name, ms in top)


def timit_config(logger, device, flags=TIMIT_FLAGS):
    """A TIMIT configuration: timit.conf, the recipes' first stage
    (train_srf_timit.sh, train_cnn_timit.sh: k 0.5, warmup 1200) and the
    model flags (the canonical SRF-TIMIT model's by default)."""
    from srf_tpu_torch.config import ParseOption

    return ParseOption(
        ["chip_smoke", "--config=egs/conf/timit.conf",
         "--path-base=%s" % REPO, "--path-ckpt=%s" % REPO,
         "--device=%s" % device, "--train-lr-param-k=0.5",
         "--train-warmup-n=1200", *flags],
        logger, is_print_opts=False,
    ).args


def serve_batches():
    """The serving phases' two request batches: 8 utterances of 150-400
    frames and 29 of 241, fbank-123 features drawn from numpy."""
    rng = np.random.RandomState(SEED + 1)
    return {
        "8x150-400": [rng.randn(n, 123).astype(np.float32)
                      for n in rng.randint(150, 401, size=8)],
        "29x241": [rng.randn(241, 123).astype(np.float32) for _ in range(29)],
    }


def check_served(name, got, feats_list, in_len_div, blank=62):
    """One result per request; ids are symbols below the blank (TIMIT's
    phones 0..61 by default), each emission frame inside the
    floor(len / in_len_div) decoded frames, a finite Viterbi log-prob
    score."""
    check(len(got) == len(feats_list), "%s: result count" % name)
    for i, res in enumerate(got):
        dec_len = max(feats_list[i].shape[0] // in_len_div, 1)
        check(all(0 <= t < blank for t in res["ids"]), "%s: ids" % name)
        check(all(0 <= f < dec_len for f in res["frames"]),
              "%s: frames" % name)
        check(np.isfinite(res["score"]) and res["score"] <= 0,
              "%s: score" % name)


def main_path_phase(torch, card):
    """Phase 6: serve two batches on the card; returns K1's launches and
    the random weights (a state_dict)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    model, _ = build_model(config, 63)
    state = random_weights(model)
    card_rec = Recognizer(config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=state, device="cpu",
                         logger=logger)
    check(card_rec.device.type == "cuda", "Recognizer is not on the card")

    batches = serve_batches()
    for feats_list in batches.values():  # warm-up (allocator, cuDNN)
        card_rec.transcribe_batch_detailed(feats_list)
    torch.cuda.synchronize()

    sequential_routing_cuda.launches = 0
    results = {}
    for name, feats_list in batches.items():
        before = sequential_routing_cuda.launches
        results[name] = card_rec.transcribe_batch_detailed(feats_list)
        torch.cuda.synchronize()
        check(sequential_routing_cuda.launches - before == 7 * K1_LAUNCHES,
              "%s: K1 launched %d times in one forward, expected %d"
              % (name, sequential_routing_cuda.launches - before,
                 7 * K1_LAUNCHES))
    launches = sequential_routing_cuda.launches
    print("main path: K1 launches %d over %d forwards (%d calls of its two "
          "kernels)" % (launches, len(batches), launches // K1_LAUNCHES))

    for name, feats_list in batches.items():
        got = results[name]
        check_served(name, got, feats_list, card_rec.in_len_div)
        cpu = cpu_rec.transcribe_batch_detailed(feats_list)
        check([r["ids"] for r in got] == [r["ids"] for r in cpu],
              "%s: card ids differ from CPU ids" % name)
        check([r["text"] for r in got] == [r["text"] for r in cpu],
              "%s: card text differs from CPU text" % name)
        card_logits = card_rec.forward(*card_rec.pad(feats_list)).cpu()
        cpu_logits = cpu_rec.forward(*cpu_rec.pad(feats_list))
        check(bool(torch.isfinite(card_logits).all()), "%s: logits" % name)
        err = (card_logits - cpu_logits).abs().max().item()
        print("main path %s: %d utts, %d tokens, ids equal to CPU, logits "
              "shape %s max |card - cpu| %.3e (atol %.0e)"
              % (name, len(got), sum(len(r["ids"]) for r in got),
                 tuple(card_logits.shape), err, LOGIT_ATOL))
        check(err <= LOGIT_ATOL, "%s: card logits differ from CPU" % name)
    torch.cuda.synchronize()

    reps = 10
    for name, feats_list in batches.items():
        feats, lengths = card_rec.pad(feats_list)
        fwd_ms = timed_ms(torch, lambda: card_rec.forward(feats, lengths),
                          reps)
        e2e_ms = timed_ms(
            torch, lambda: card_rec.transcribe_batch_detailed(feats_list),
            reps)
        audio_s = 0.01 * float(lengths.sum())
        med = float(np.median(e2e_ms))
        print("serve %s (padded %s), %d runs: forward median %.3f ms/batch "
              "(max %.3f), end-to-end median %.3f ms/batch (max %.3f), "
              "%.1f utt/s, %.1fx realtime [%s]"
              % (name, tuple(feats.shape), reps, float(np.median(fwd_ms)),
                 max(fwd_ms), med, max(e2e_ms), 1e3 * len(feats_list) / med,
                 1e3 * audio_s / med, card))
        kernels, total, count, busy, wall, _ = profile_device(
            torch, lambda: card_rec.forward(feats, lengths))
        print("profile %s forward: K1 %.3f ms (prediction %.3f, recurrence "
              "%.3f), all %d device ops %.3f ms, device busy %.3f of %.3f ms "
              "wall (idle share %.3f) [%s]"
              % (name, kernels["prediction"] + kernels["K1 recurrence"],
                 kernels["prediction"], kernels["K1 recurrence"], count,
                 total, busy, wall, 1.0 - busy / wall, card))
    torch.cuda.synchronize()
    return launches, state


def scan_path_phase(torch, card, state):
    """Phase 6b: the counterpart of sequential_routing_pallas_scan at full
    width. Serves the 29 x 241 batch with the SRF-TIMIT weights, captures
    what each of the 7 routing layers receives, then drives the 7 layers'
    forward through sequential_routing_scan (SDRScanFunction: K3) and its
    backward for a fixed cotangent (K4), and holds each layer's output and
    gradients to SDRFunction (K1, K2) on the same inputs. Returns the K3 and
    K4 launches of that run and the 7-layer times."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models import srf
    from srf_tpu_torch.ops.routing_cuda import (
        SDRFunction, SDRScanFunction, scan_plan, sequential_routing_bwd_cuda,
        sequential_routing_cuda, sequential_routing_scan,
        sequential_routing_scan_bwd_cuda, sequential_routing_scan_cuda)
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    rec = Recognizer(timit_config(logger, "cuda"), state_dict=state,
                     logger=logger)
    captured, real = [], srf.route_layer

    def capture(u, wgt, bias, num_iter, is_context, is_last_layer):
        captured.append((u.detach().clone(), wgt.detach(), bias.detach(),
                         num_iter, is_context, is_last_layer))
        return real(u, wgt, bias, num_iter, is_context, is_last_layer)

    srf.route_layer = capture
    try:
        rec.transcribe_batch_detailed(serve_batches()["29x241"])
    finally:
        srf.route_layer = real
    torch.cuda.synchronize()
    check(len(captured) == 7, "captured %d routing layers, expected 7"
          % len(captured))
    check([c[5] for c in captured] == [False] * 6 + [True]
          and all(c[3] == 1 and c[4] for c in captured),
          "routing layers: not 7 SDR layers of 1 iteration, PAD mask last")
    layers = [(u, w, b, last) for u, w, b, _, _, last in captured]
    shapes = [tuple(u.shape) for u, _, _, _ in layers]
    check(all(s[:2] == (29, 64) for s in shapes),
          "captured inputs %s, expected B=29, T'=64" % shapes)
    rng = np.random.RandomState(SEED + 6)
    cotangents = [torch.tensor(rng.randn(29, 64, w.shape[1], w.shape[2]),
                               dtype=torch.float32, device=w.device)
                  for _, w, _, _ in layers]

    def run_stack(fn):
        """The 7 layers' forward through ``fn`` and their backward for the
        cotangents: (outputs, [(du, dW, db)] per layer)."""
        leaves = [[x.clone().requires_grad_() for x in (u, w, b)]
                  for u, w, b, _ in layers]
        outs = [fn(*leaf, last) for leaf, (_, _, _, last)
                in zip(leaves, layers)]
        torch.cuda.synchronize()
        forward_launches = sequential_routing_scan_cuda.launches
        torch.autograd.backward(outs, cotangents)
        torch.cuda.synchronize()
        return ([o.detach() for o in outs],
                [[x.grad for x in leaf] for leaf in leaves],
                forward_launches)

    sequential_routing_scan_cuda.launches = 0
    sequential_routing_scan_bwd_cuda.launches = 0
    SDRScanFunction.plain_backwards = 0
    outs, grads, k3_forward = run_stack(
        lambda u, w, b, last: sequential_routing_scan(u, w, b, 1, last))
    k3, k4 = (sequential_routing_scan_cuda.launches,
              sequential_routing_scan_bwd_cuda.launches)
    print("scan path: 7-layer forward and backward at B=29 T'=64: K3 %d "
          "launches in the forward, K4 %d launches in the backward (7 calls "
          "of its two kernels), plain backwards %d"
          % (k3_forward, k4, SDRScanFunction.plain_backwards))
    check(k3_forward == 7 and k3 == 7 and k4 == 14
          and SDRScanFunction.plain_backwards == 0,
          "scan path launched K3 %d and K4 %d times with %d plain backwards, "
          "expected 7, 14 and 0" % (k3, k4, SDRScanFunction.plain_backwards))

    ref_outs, ref_grads, _ = run_stack(
        lambda u, w, b, last: SDRFunction.apply(u, w, b, 1, last))
    for i, (out, ref, got_g, ref_g) in enumerate(zip(outs, ref_outs, grads,
                                                     ref_grads)):
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              "scan path layer %d output %s" % (i, tuple(out.shape)))
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
              "scan path layer %d: K3 output differs from K1's" % i)
        errs = []
        for label, g, x in zip(("du", "dW", "db"), got_g, ref_g):
            scale = x.abs().max().item()
            g_err = (g - x).abs().max().item()
            errs.append("%s %.3e (max %.3e)" % (label, g_err, scale))
            check(bool(torch.isfinite(g).all())
                  and torch.allclose(g, x, rtol=K2_RTOL,
                                     atol=K2_ATOL_REL * scale),
                  "scan path layer %d: K4 %s differs from K2's" % (i, label))
        print("scan path layer %d %s: |K3 - K1| %.3e; |K4 - K2| %s"
              % (i, shapes[i], err, ", ".join(errs)))

    backward = [(u, w, b, out, cot, last) for (u, w, b, last), out, cot
                in zip(layers, outs, cotangents)]
    k1_ms, k3_ms = paired_ms(
        torch, lambda: [sequential_routing_cuda(u, w, b, 1, last)
                        for u, w, b, last in layers],
        lambda: [sequential_routing_scan_cuda(u, w, b, 1, last)
                 for u, w, b, last in layers], 5)
    k2_ms, k4_ms = paired_ms(
        torch, lambda: [sequential_routing_bwd_cuda(*args)
                        for args in backward],
        lambda: [sequential_routing_scan_bwd_cuda(*args)
                 for args in backward], 3)
    print("scan path on the captured inputs (B=29 T'=64): 7-layer forward K3 "
          "%.4f ms, K1 %.4f ms; 7-layer backward K4 %.4f ms, K2 %.4f ms [%s]"
          % (k3_ms, k1_ms, k4_ms, k2_ms, card))
    for i, (u, w, _, _) in enumerate(layers):
        print("scan path layer %d plans: K3 %s; K4 %s"
              % (i, scan_plan("sdr_scan_fwd", u, w),
                 scan_plan("sdr_scan_bwd", u, w)))
    torch.cuda.synchronize()
    return k3, k4, {"forward_ms": k3_ms, "k1_forward_ms": k1_ms,
                    "backward_ms": k4_ms, "k2_backward_ms": k2_ms}


# the decode phase (6c): the recipe's stages 2-4 (train_srf_timit.sh:68-73)
# on a synthetic test split written by the port's own TFRecord writer
DECODE_UTTS, DECODE_SHARDS, DECODE_BEAM = 24, 2, 100
DECODE_FRAMES = (150, 500)  # padded widths 256/384/512 (F14: few shapes)
DECODE_BATCH = 8
# a device/C++ disagreement passes only if the C++ hypothesis is among the
# device beam's NEAR_TIE_PATHS best with a score within NEAR_TIE_SCORE of
# its best: the C++ beam sums in float64, the device beam in float32
NEAR_TIE_PATHS, NEAR_TIE_SCORE = 4, 1e-3
# device beam on the card against the same logits on the CPU: float32 both,
# the same ops; log-softmax and logaddexp round differently
BEAM_SCORE_ATOL = 1e-4
LM_UTTS, LM_ORDER = 3, 3
# utterances of the card-vs-CPU beam check (the first of the sorted ids;
# the CPU's beam at width 100 is slow), and the passes, back to back, over
# every batch of batch 1 and of batch 8 whose forward and beams are timed
# apart
CHECK_UTTS = 8
TIMING_PASSES = 2


def test_split_data():
    """DECODE_UTTS utterances of DECODE_FRAMES frames (fbank-123 features,
    labels 1..61) from a seed: {utt id: (features, labels)}."""
    rng = np.random.RandomState(SEED + 7)
    split = {}
    for i in range(DECODE_UTTS):
        n = int(rng.randint(DECODE_FRAMES[0], DECODE_FRAMES[1] + 1))
        feats = rng.randn(n, 123).astype(np.float32)
        labels = rng.randint(1, 62, size=max(2, n // 8)).astype(np.int64)
        split["synth%02d" % i] = (feats, labels)
    return split


def write_test_split(base):
    """``test_split_data`` as the JAX writer lays it out (data/writer.py),
    written by the port's writer into DECODE_SHARDS shards with utt ids;
    returns {utt id: (features, labels)}."""
    from srf_tpu_torch.data.example_proto import encode_example
    from srf_tpu_torch.data.tfrecord import TFRecordWriter

    os.makedirs(os.path.join(base, "tfrecord"))
    writers = [TFRecordWriter(os.path.join(
        base, "tfrecord", "synth-test-None-123-%d-of-%d" % (s, DECODE_SHARDS)))
        for s in range(DECODE_SHARDS)]
    split = test_split_data()
    for i, (utt, (feats, labels)) in enumerate(split.items()):
        writers[i % DECODE_SHARDS].write(encode_example({
            "target_label": labels,
            "input_speech": feats.flatten(),
            "input_length": np.asarray([feats.shape[0]], np.int64),
            "target_length": np.asarray([labels.size], np.int64),
            "utt_id": [utt.encode()],
        }))
    for writer in writers:
        writer.close()
    return split


def decode_argv(base, *extra, device="cuda"):
    """trainer_sr's flags for decode mode: timit.conf, the canonical
    SRF-TIMIT model, beam 100 (timit.conf's own), the synthetic split."""
    flags = [f for f in TIMIT_FLAGS if not f.startswith("--decoding-beam")]
    return ["trainer_sr", "--config=%s" % os.path.join(REPO, "egs", "conf",
                                                       "timit.conf"),
            "--path-base=%s" % base,
            "--path-vocab=%s" % os.path.join(REPO, "egs", "data",
                                             "timit_62.vocab"),
            "--path-test-ptrn=tfrecord/synth-test-None-123-*-of-*",
            "--prep-data-num-test=%d" % DECODE_UTTS,
            "--path-ckpt=%s" % os.path.join(base, "ckpt", "avg"),
            "--train-max-epoch=0", "--decoding-beam-width=%d" % DECODE_BEAM,
            "--device=%s" % device, *flags, *extra]


def run_trainer(argv):
    """trainer_sr.main in decode mode: (its stdout, wall seconds)."""
    import contextlib
    import io

    from srf_tpu_torch import trainer_sr

    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer_sr.main(argv)
    return out.getvalue(), time.perf_counter() - start


def decode_phase(torch, card, state, device="cuda"):
    """Phase 6c: the SRF-TIMIT recipe's stages 2-4 on the card. Writes a
    synthetic test split, saves three perturbed checkpoints of phase 6's
    weights, averages them with tools.average_ckpt, decodes with
    trainer_sr (device beam at batch 1 and at batch 8 with pad_last, the
    C++ host beam), scrapes stdout with utils.log2utt, and checks the
    hypotheses (see the module docstring). Returns K1's launches."""
    import shutil
    import tempfile

    from srf_tpu_torch.config import Logger, ParseOption
    from srf_tpu_torch.data.loader import EvalLoader, SpeechDataset
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import ctc_decode
    from srf_tpu_torch.ops.ctc_beam import (
        ctc_beam_search_batch, ctc_beam_search_nbest)
    from srf_tpu_torch.ops.ngram_lm import train_ngram
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.tools import average_ckpt
    from srf_tpu_torch.train.state import TrainState
    from srf_tpu_torch.train.step import make_apply_fn, make_logits_fn
    from srf_tpu_torch.utils import checkpoint
    from srf_tpu_torch.utils.log2utt import parse_decode_log
    from srf_tpu_torch.utils.native import load_host_lib

    phase_start = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_decode_")
    try:
        split = write_test_split(base)
        audio_s = 0.01 * sum(f.shape[0] for f, _ in split.values())
        logger = Logger(name="chip_smoke_decode", level=Logger.WARN).logger
        config = ParseOption(decode_argv(base, device=device), logger,
                             is_print_opts=False).args

        # stage 2: three checkpoints, averaged
        rng = np.random.RandomState(SEED + 8)
        manager = checkpoint.CheckpointManager(os.path.join(base, "ckpt"))
        saved = []
        for step in (1, 2, 3):
            model_state = {
                k: (v + torch.from_numpy(0.01 * rng.randn(*v.shape).astype(
                    np.float32)) if v.is_floating_point() else v)
                for k, v in state.items()}
            saved.append(model_state)
            manager.save(step, {"step": step, "model": model_state,
                                "optimizer": None, "scheduler": None})
        average_ckpt.main(decode_argv(base, "--path-ckpt=%s"
                                      % os.path.join(base, "ckpt"),
                                      "--model-average-num=3", device=device))
        avg = checkpoint.CheckpointManager(
            os.path.join(base, "ckpt", "avg")).restore(1)["model"]
        worst_ulps = 0.0
        for key, value in avg.items():
            if not value.is_floating_point():
                check(torch.equal(value, saved[-1][key]),
                      "avg/1 %s is not the last checkpoint's" % key)
                continue
            mean = sum(s[key].double() for s in saved) / 3.0
            ulp = np.spacing(np.abs(mean.float().numpy()))
            ulps = float(np.max(np.abs(value.double().numpy()
                                       - mean.numpy()) / ulp))
            worst_ulps = max(worst_ulps, ulps)
            check(ulps <= 1.0, "avg/1 %s is %.2f float32 ulp from the "
                  "float64 mean" % (key, ulps))
        print("decode: %d checkpoints averaged into avg/1, worst %.3f float32 "
              "ulp from the float64 mean over %d tensors"
              % (3, worst_ulps, len(avg)))

        # the logits every decode sees: the averaged model on the card,
        # batch 1 and batch 8 as EvalLoader pads them; first call per width
        model, in_len_div = build_model(config, 63)
        train_state = TrainState.create(model, None, device=device)
        checkpoint.restore_into(train_state, {"model": avg, "step": 3},
                                params_only=True)
        logits_fn = make_logits_fn(make_apply_fn(train_state.model))
        dataset = SpeechDataset(os.path.join(
            base, "tfrecord", "synth-test-None-123-*-of-*"), 123,
            with_utt_id=True)
        loaders = {1: list(EvalLoader(dataset, 1)),
                   DECODE_BATCH: list(EvalLoader(dataset, DECODE_BATCH,
                                                 pad_last=True))}
        firsts = {}
        for size, batches in loaders.items():
            for batch in batches:
                key = (size, batch["feats"].shape[1])
                if key not in firsts:
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    logits_fn(train_state, batch)
                    torch.cuda.synchronize()
                    firsts[key] = 1e3 * (time.perf_counter() - start)
        print("decode: first forward per (batch, padded width), ms (cuDNN's "
              "search included): %s" % ", ".join(
                  "%dx%d %.1f" % (b, w, ms)
                  for (b, w), ms in sorted(firsts.items())))

        # the card's logits against the CPU's, the same averaged weights,
        # at every decode shape: the first batch of each (batch, width)
        cpu_state = TrainState.create(build_model(config, 63)[0], None,
                                      device="cpu")
        checkpoint.restore_into(cpu_state, {"model": avg, "step": 3},
                                params_only=True)
        cpu_logits_fn = make_logits_fn(make_apply_fn(cpu_state.model))
        held = {}
        for size, batches in loaders.items():
            for batch in batches:
                key = (size, batch["feats"].shape[1])
                if key in held:
                    continue
                card_logits = logits_fn(train_state, batch).cpu()
                cpu_logits = cpu_logits_fn(cpu_state, batch)
                check(bool(torch.isfinite(card_logits).all())
                      and card_logits.shape == cpu_logits.shape,
                      "decode %dx%d: card logits" % key)
                held[key] = (card_logits - cpu_logits).abs().max().item()
                check(held[key] <= LOGIT_ATOL, "decode %dx%d: card logits "
                      "%.3e from the CPU's" % (*key, held[key]))
        print("decode: card logits = CPU logits (atol %.0e) at every decode "
              "shape, max |card - cpu|: %s" % (LOGIT_ATOL, ", ".join(
                  "%dx%d %.3e" % (b, w, err)
                  for (b, w), err in sorted(held.items()))))

        # stage 3: trainer_sr decode mode, three ways
        runs = {}
        for name, extra, batches in (
                ("device b1", (), len(loaders[1])),
                ("device b%d" % DECODE_BATCH,
                 ("--tpu-decode-batch=%d" % DECODE_BATCH,
                  "--tpu-decode-pad-last=True"), len(loaders[DECODE_BATCH])),
                ("host b1", ("--tpu-decode-impl=host",), len(loaders[1]))):
            native_before = ctc_decode.beam_search_native.calls
            sequential_routing_cuda.launches = 0
            out, wall = run_trainer(decode_argv(base, *extra, device=device))
            torch.cuda.synchronize()
            launches = sequential_routing_cuda.launches
            check(launches == batches * 7 * K1_LAUNCHES,
                  "%s: K1 launched %d times over %d batch forwards, expected "
                  "%d per forward" % (name, launches, batches,
                                      7 * K1_LAUNCHES))
            hyps = dict(parse_decode_log(out.splitlines()))
            check(sorted(hyps) == sorted(split),
                  "%s: decoded %d of %d utterances" % (name, len(hyps),
                                                       len(split)))
            check(all(all(0 <= t < 62 for t in ids) and ids
                      for ids in hyps.values()), "%s: ids" % name)
            runs[name] = (hyps, wall, launches,
                          ctc_decode.beam_search_native.calls - native_before)
            print("decode %s (stage 3, trainer_sr): %d utterances, %d batch "
                  "forwards, K1 %d launches, wall %.3f s, %.2f ms per "
                  "utterance, RTF %.4f [%s]"
                  % (name, len(hyps), batches, launches, wall,
                     1e3 * wall / len(hyps), wall / audio_s, card))
        check(bool(load_host_lib()) and runs["host b1"][3]
              == len(split), "host decode did not run the C++ decoder on "
              "every utterance (%d of %d)" % (runs["host b1"][3], len(split)))
        device_hyps, host_hyps = runs["device b1"][0], runs["host b1"][0]

        # the logits of (a): batch 1, as trainer_sr saw them
        logits = {}
        for batch in loaders[1]:
            out = logits_fn(train_state, batch)
            dec = np.minimum(np.maximum(batch["inp_len"] // in_len_div, 1),
                             out.shape[1])
            logits[batch["utt_ids"][0]] = (out[0], int(dec[0]))
        near_ties = 0
        for utt in sorted(split):
            if device_hyps[utt] == host_hyps[utt]:
                continue
            row, dec = logits[utt]
            nbest = ctc_beam_search_nbest(row[None], [dec], DECODE_BEAM,
                                          top_paths=NEAR_TIE_PATHS)[0]
            ids = [h[0] for h in nbest]
            ok = host_hyps[utt] in ids
            gap = nbest[0][1] - nbest[ids.index(host_hyps[utt])][1] if ok \
                else float("inf")
            print("decode: %s device and C++ beams differ; C++ hypothesis "
                  "%s the device's %d-best, score %.6f against best %.6f "
                  "(gap %.2e)" % (utt, "in" if ok else "NOT in",
                                  NEAR_TIE_PATHS,
                                  nbest[ids.index(host_hyps[utt])][1] if ok
                                  else float("nan"), nbest[0][1], gap))
            check(ok and gap <= NEAR_TIE_SCORE,
                  "%s: device and C++ beams differ beyond a near-tie" % utt)
            near_ties += 1
        print("decode: device beam (float32) and C++ beam (float64) give the "
              "same ids for %d of %d utterances, %d near-ties"
              % (len(split) - near_ties, len(split), near_ties))

        # the device beam on the card against the CPU, same logits, batched
        start = time.perf_counter()
        utts = sorted(split)[:CHECK_UTTS]
        width = max(logits[u][0].shape[0] for u in utts)
        stacked = torch.zeros((len(utts), width, 63), device=device)
        for i, utt in enumerate(utts):
            stacked[i, : logits[utt][0].shape[0]] = logits[utt][0]
        lens = [logits[u][1] for u in utts]
        card_beam = ctc_beam_search_batch(stacked, lens, DECODE_BEAM,
                                          with_frames=True)
        cpu_beam = ctc_beam_search_batch(stacked.cpu(), lens, DECODE_BEAM,
                                         with_frames=True)
        check([h[0] for h in card_beam] == [h[0] for h in cpu_beam]
              and [h[2] for h in card_beam] == [h[2] for h in cpu_beam],
              "device beam: card ids or frames differ from the CPU's")
        score_err = max(abs(a[1] - b[1]) for a, b in zip(card_beam,
                                                         cpu_beam))
        check(score_err <= BEAM_SCORE_ATOL,
              "device beam: card scores %.2e from the CPU's" % score_err)
        check([h[0] for h in card_beam] == [device_hyps[u] for u in utts],
              "device beam: the %d-utterance batch differs from batch 1"
              % len(utts))
        print("decode: device beam on the card = on the CPU for %d "
              "utterances (ids and frames equal, scores max |diff| %.2e, "
              "atol %.0e), and = batch 1; %.1f s"
              % (len(utts), score_err, BEAM_SCORE_ATOL,
                 time.perf_counter() - start))

        # shallow fusion: the device beam with a toy LM against the Python
        # prefix search with the same LM, on the LM_UTTS shortest
        lm = (train_ngram([split[u][1] for u in sorted(split)], 62,
                          LM_ORDER), 0.5, 0.5)
        shortest = sorted(split, key=lambda u: logits[u][1])[:LM_UTTS]
        start = time.perf_counter()
        for utt in shortest:
            row, dec = logits[utt]
            got = ctc_beam_search_nbest(row[None], [dec], DECODE_BEAM, lm=lm,
                                        top_paths=NEAR_TIE_PATHS)[0]
            want = ctc_decode.prefix_beam_search(
                row.cpu().numpy(), dec, DECODE_BEAM, lm=lm)[0]
            ids = [h[0] for h in got]
            gap = (got[0][1] - got[ids.index(want[0])][1]
                   if want[0] in ids else float("inf"))
            print("decode LM %s (%d frames): device %s Python prefix search "
                  "(score %.6f against %.6f)"
                  % (utt, dec, "=" if ids[0] == want[0] else "!=",
                     got[0][1], -want[1]))
            check(ids[0] == want[0] or gap <= NEAR_TIE_SCORE,
                  "%s: device beam with the LM differs from the Python "
                  "prefix search" % utt)
        print("decode LM: %d-gram over 62 phones, %d utterances, %.1f s"
              % (LM_ORDER, len(shortest), time.perf_counter() - start))

        batched = runs["device b%d" % DECODE_BATCH][0]
        print("decode: batch %d with pad_last differs from batch 1 in %d of "
              "%d utterances (padding changes valid frames, F7)"
              % (DECODE_BATCH, sum(batched[u] != device_hyps[u]
                                   for u in split), len(split)))

        # where a decode's time goes, per batch: forward, device beam, host
        # beam, over every batch of batch 1 and of batch 8, in
        # TIMING_PASSES passes back to back (the host clock's spread)
        for timing_pass in range(1, TIMING_PASSES + 1):
            for size, batches in loaders.items():
                fwd, dev, host = [], [], []
                for batch in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = logits_fn(train_state, batch)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    dec = np.minimum(np.maximum(
                        batch["inp_len"] // in_len_div, 1), out.shape[1])
                    ctc_beam_search_batch(out, dec, DECODE_BEAM)
                    t2 = time.perf_counter()
                    ctc_decode.beam_search_batch(out.cpu().numpy(), dec,
                                                 DECODE_BEAM)
                    t3 = time.perf_counter()
                    fwd.append(1e3 * (t1 - t0))
                    dev.append(1e3 * (t2 - t1))
                    host.append(1e3 * (t3 - t2))
                frames = sum(b["feats"].shape[1] // in_len_div
                             for b in batches)
                valid = sum(int(np.sum(np.minimum(np.maximum(
                    b["inp_len"][: b["valid"]] // in_len_div, 1),
                    b["feats"].shape[1] // in_len_div))) for b in batches)
                print("decode pass %d batch %d, all %d batches: forward "
                      "%.3f ms a batch (median), device beam %.3f ms a batch "
                      "(median; %.4f ms a padded frame step), C++ host beam "
                      "%.3f ms a batch (median; %.4f ms a valid "
                      "utterance-frame); C++ / device beam, summed: %.3f "
                      "[%s]" % (timing_pass, size, len(batches),
                                float(np.median(fwd)), float(np.median(dev)),
                                sum(dev) / frames, float(np.median(host)),
                                sum(host) / valid, sum(host) / sum(dev),
                                card))
        batch = loaders[DECODE_BATCH][0]
        out = logits_fn(train_state, batch)
        dec = np.minimum(np.maximum(batch["inp_len"] // in_len_div, 1),
                         out.shape[1])
        _, total, count, busy, wall, _ = profile_device(
            torch, lambda: ctc_beam_search_batch(out, dec, DECODE_BEAM))
        print("profile device beam, batch %d x %d frames: %d device ops "
              "(%.1f a frame), %.3f ms of device time, busy %.3f of %.3f ms "
              "wall (idle share %.3f) [%s]"
              % (DECODE_BATCH, out.shape[1], count, count / out.shape[1],
                 total, busy, wall, 1.0 - busy / wall, card))
        launches = sum(run[2] for run in runs.values())
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print("decode phase: %.1f s" % (time.perf_counter() - phase_start))
    return launches


def train_batch(torch, device, batch=29, frames=241, feat_dim=123,
                vocab=62):
    """bench.py's workload (bench.py:76-87): lengths in 0.7*frames..frames,
    tar_len = max(2, len // 8), labels in 1..vocab-1, randn features.
    Features and labels on ``device``, the lengths on the host, as the train
    step wants them (train/step.py)."""
    host = np.random.RandomState(0)
    lens = host.randint(int(frames * 0.7), frames + 1, size=batch)
    tar_lens = np.maximum(2, lens // 8)
    feats = host.randn(batch, frames, feat_dim).astype(np.float32)
    labels = host.randint(1, vocab, size=(batch, int(tar_lens.max())))
    return {
        "feats": torch.tensor(feats, device=device),
        "labels": torch.tensor(labels, dtype=torch.int32, device=device),
        "inp_len": torch.tensor(lens, dtype=torch.int32),
        "tar_len": torch.tensor(tar_lens, dtype=torch.int32),
    }


def class_count(config):
    """Output classes of ``config``'s vocabulary (its symbols and the
    blank): 63 for TIMIT, 32 for WSJ."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    return load_vocab(get_file_path(config.path_base, config.path_vocab),
                      logger)[2] + 1


def extra_kwargs_fn(config, in_len_div):
    """The apply adapter's per-batch keyword arguments of ``config``'s
    family: the STF's padding bias and penalty board, as trainer_tf
    computes them; None for the others."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.attention_penalty import create_attention_penalty
    from srf_tpu_torch.trainer_tf import make_stf_extra_kwargs

    if (config.model_type or "").lower() != "stf":
        return None
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    return make_stf_extra_kwargs(create_attention_penalty(config, logger),
                                 in_len_div)


def train_setup(torch, config, state, device, dropout=True):
    """A model with ``state``'s weights, its optimizer and scheduler in a
    TrainState on ``device``, and its train step. ``dropout`` False turns
    every dropout off; "k5" keeps only the sites that K5 runs in the CNN's
    pallas mode (their masks follow the step seed on every device) and
    turns off ConvFrontEnd's, which draw from the device's generator."""
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.train.optimizer import get_optimizer
    from srf_tpu_torch.train.state import TrainState
    from srf_tpu_torch.train.step import make_apply_fn, make_train_step

    model, in_len_div = build_model(config, class_count(config))
    model.load_state_dict(state)
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Dropout) and (
                not dropout
                or (dropout == "k5" and name.startswith("conv_feat."))):
            module.p = 0.0
    optimizer, scheduler = get_optimizer(config, model.parameters())
    train_state = TrainState.create(model, optimizer, scheduler,
                                    device=device)
    apply_fn = make_apply_fn(model, extra_kwargs_fn(config, in_len_div))
    return train_state, apply_fn, make_train_step(apply_fn, in_len_div)


def parity_readings(torch, config, state, batch, dropout=False,
                    update_grad_rel=UPDATE_GRAD_REL, card_tf32=False,
                    count=PARITY_COUNT):
    """One step on the card and on the CPU from the same weights, its
    update taken at the schedule's count ``count`` (a constant rate, plain
    Adam's, as it is), and how far the two are apart: a dict of the loss's
    relative error, each gradient's max error over its tensor's largest
    entry, each running statistic's max error, each parameter's update
    error over the rate where its gradient is at least ``update_grad_rel``
    x its largest (and how many entries that compares), and the largest
    update over the rate on either device; a parameter that is not trained
    (the LSTM's bias_ih) must not move. Dropout off, or ``dropout="k5"``
    (see ``train_setup``). ``card_tf32`` lets the card's step run its
    convolutions and matmuls in TF32."""
    results = {}
    for device in ("cuda", "cpu"):
        train_state, _, step = train_setup(torch, config, state, device,
                                           dropout=dropout)
        if train_state.scheduler is None:
            rate = train_state.optimizer.param_groups[0]["lr"]
        else:
            rate = train_state.scheduler.lr_lambdas[0](count)
        for group in train_state.optimizer.param_groups:
            group["lr"] = rate
        tf32 = device == "cuda" and card_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            _, metrics = step(train_state, {k: v.to(device) for k, v in
                                            batch.items()}, config.tpu_seed)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = train_state.model
        results[device] = (
            metrics["loss_sum"].item(),
            {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.requires_grad},
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
        )
    (card_loss, card_grads, card_state), (cpu_loss, cpu_grads, cpu_state) = (
        results["cuda"], results["cpu"])
    readings = {"rate": rate, "card_loss": card_loss, "cpu_loss": cpu_loss,
                "loss_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
                "grads": {}, "stats": {}, "counts_equal": True,
                "updates": {}, "max_move": 0.0, "checked": 0, "total": 0}
    for name, want in cpu_grads.items():
        err = (card_grads[name] - want).abs().max().item()
        readings["grads"][name] = err / max(want.abs().max().item(), 1e-30)
    for name, want in cpu_state.items():
        if name.endswith("num_batches_tracked"):
            readings["counts_equal"] &= int(card_state[name]) == int(want)
            continue
        if "running_" in name:
            readings["stats"][name] = (card_state[name]
                                       - want).abs().max().item()
            continue
        before = state[name].float()
        if name not in cpu_grads:  # not trained
            readings["frozen_moved"] = readings.get("frozen_moved", 0.0) + (
                (card_state[name] - before).abs().sum().item()
                + (want - before).abs().sum().item())
            continue
        card_update, cpu_update = card_state[name] - before, want - before
        readings["max_move"] = max(readings["max_move"],
                                   cpu_update.abs().max().item() / rate,
                                   card_update.abs().max().item() / rate)
        grad = cpu_grads[name].abs()
        sure = grad >= update_grad_rel * grad.max()
        readings["updates"][name] = (
            card_update - cpu_update)[sure].abs().max().item() / rate
        readings["checked"] += int(sure.sum())
        readings["total"] += want.numel()
    return readings


def worst(values):
    """(largest value, its name) of a {name: value} dict; (0, "") if empty."""
    return max(((v, k) for k, v in values.items()), default=(0.0, ""))


def train_parity(torch, config, state, batch, dropout=False, label="",
                 grad_atol_rel=GRAD_ATOL_REL, update_grad_rel=UPDATE_GRAD_REL,
                 min_compared=0.5, count=PARITY_COUNT):
    """``parity_readings`` held to the limits: the loss within LOSS_RTOL,
    every gradient within ``grad_atol_rel`` x its largest entry, BatchNorm
    statistics within STATS_ATOL, each parameter's update (where the
    gradient is at least ``update_grad_rel`` x its largest, over more than
    ``min_compared`` of the entries) within UPDATE_ATOL_REL x the rate,
    every update within the rate, and no untrained parameter moved."""
    r = parity_readings(torch, config, state, batch, dropout, update_grad_rel,
                        count=count)
    check(r.get("frozen_moved", 0.0) == 0.0,
          "train step: an untrained parameter moved")
    rate = r["rate"]
    check(np.isfinite(r["card_loss"]) and r["loss_err"] <= LOSS_RTOL,
          "train step: card loss %r vs CPU %r" % (r["card_loss"],
                                                  r["cpu_loss"]))
    worst_grad, worst_stat, worst_update = (
        worst(r[key]) for key in ("grads", "stats", "updates"))
    check(worst_grad[0] <= grad_atol_rel,
          "train step: gradient %s differs, card vs CPU %.3e x its max"
          % (worst_grad[1], worst_grad[0]))
    check(r["counts_equal"], "BatchNorm step counts differ")
    check(worst_stat[0] <= STATS_ATOL, "train step: %s differs by %.3e"
          % (worst_stat[1], worst_stat[0]))
    check(r["max_move"] <= 1 + UPDATE_ATOL_REL,
          "train step: a parameter moved by %.4f x the rate" % r["max_move"])
    check(worst_update[0] <= UPDATE_ATOL_REL,
          "train step: parameter %s's update differs by %.3e x the rate "
          "(rate %.3e)" % (worst_update[1], worst_update[0], rate))
    check(r["checked"] > min_compared * r["total"],
          "too few parameters' updates compared")
    print("%strain parity (B=%d, dropout %s, one step at count %s, rate "
          "%.4e): loss card %.6f cpu %.6f (rel %.2e, rtol %.0e); worst "
          "gradient %s rel err %.2e (atol %.0e x max); BatchNorm stats max "
          "err %.2e (atol %.0e); parameter updates: worst err %.2e x rate "
          "(atol %.0e x rate) over %d of %d entries, all within the rate"
          % (label, batch["feats"].shape[0],
             "on at the K5 sites" if dropout == "k5" else "off",
             count if config.train_opti_type not in ("adam", "sgd")
             else "- (constant rate)", rate, r["card_loss"], r["cpu_loss"],
             r["loss_err"], LOSS_RTOL, worst_grad[1], worst_grad[0],
             grad_atol_rel, worst_stat[0], STATS_ATOL, worst_update[0],
             UPDATE_ATOL_REL, r["checked"], r["total"]))


def all_on_card(train_state, metrics):
    """Every parameter, gradient, buffer, optimizer moment and metric is a
    CUDA tensor (Adam's step count is a host scalar by torch's design; the
    batch's lengths are host inputs)."""
    tensors = list(train_state.model.state_dict().items())
    tensors += [("grad " + k, p.grad)
                for k, p in train_state.model.named_parameters()
                if p.requires_grad]
    for i, opt_state in enumerate(train_state.optimizer.state.values()):
        tensors += [("adam %d %s" % (i, k), v) for k, v in opt_state.items()
                    if k != "step"]
    tensors += list(metrics.items())
    off = [name for name, t in tensors if t is None or not t.is_cuda]
    check(not off, "tensors off the card: %s" % off[:5])


def train_phase(torch, card, state):
    """Phase 7: train the canonical model on the card; returns the K1 and
    K2 launches of the TRAIN_STEPS-step run, and its median ms a step."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    batch = train_batch(torch, "cuda")
    train_parity(torch, config, state,
                 {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()})

    train_state, apply_fn, step = train_setup(torch, config, state, "cuda")
    seed = config.tpu_seed
    torch.cuda.synchronize()
    sequential_routing_cuda.launches = 0
    sequential_routing_bwd_cuda.launches = 0
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        k1, k2 = (sequential_routing_cuda.launches,
                  sequential_routing_bwd_cuda.launches)
        start = time.perf_counter()
        train_state, metrics = step(train_state, batch, seed)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
        losses.append(metrics["loss_sum"])
        # 7 calls of each; a K1 call launches its two kernels, a K2 call
        # its four
        check(sequential_routing_cuda.launches - k1 == 7 * K1_LAUNCHES
              and sequential_routing_bwd_cuda.launches - k2
              == 7 * K2_LAUNCHES,
              "a train step launched K1 %d and K2 %d times, expected %d and "
              "%d" % (sequential_routing_cuda.launches - k1,
                      sequential_routing_bwd_cuda.launches - k2,
                      7 * K1_LAUNCHES, 7 * K2_LAUNCHES))
    launches = (sequential_routing_cuda.launches,
                sequential_routing_bwd_cuda.launches)
    all_on_card(train_state, metrics)
    losses = torch.stack(losses).cpu().numpy() / batch["feats"].shape[0]
    check(bool(np.isfinite(losses).all()), "non-finite train loss")
    med = float(np.median(step_ms))
    audio_s = 0.01 * float(batch["inp_len"].sum())
    print("train %d steps of 29 x 241 (dropout on): K1 %d launches (%d "
          "calls of its two kernels), K2 %d launches (%d calls of its four); "
          "loss per utterance first %.3f last %.3f; ms/step median %.3f max "
          "%.3f; %.1f utt/s, %.1f audio-s/s [%s]"
          % (TRAIN_STEPS, launches[0], launches[0] // K1_LAUNCHES,
             launches[1], launches[1] // K2_LAUNCHES,
             losses[0], losses[-1],
             med, max(step_ms), 1e3 * 29 / med, 1e3 * audio_s / med, card))

    # device time of one step's forward (to the loss) and backward, each
    # profiled on its own
    held = {}

    def forward():
        logits = apply_fn(batch, True)
        held["loss"] = ctc_loss_from_frames(
            logits, batch["inp_len"], 4, batch["labels"],
            batch["tar_len"]).sum() / batch["feats"].shape[0]

    train_state.optimizer.zero_grad(set_to_none=True)
    for name, fn in (("forward", forward),
                     ("backward", lambda: held["loss"].backward())):
        kernels, total, count, busy, wall, _ = profile_device(torch, fn)
        print("profile train %s: K1 recurrence %.3f ms, prediction %.3f ms "
              "(K1's in the forward, K2's in the backward), K2 step kernel "
              "%.3f, wgrad kernel %.3f, reduce kernel %.3f, all %d device "
              "ops %.3f ms, device busy %.3f of %.3f ms wall [%s]"
              % (name, kernels["K1 recurrence"], kernels["prediction"],
                 kernels["K2 step"], kernels["K2 wgrad"],
                 kernels["K2 reduce"], count, total, busy, wall, card))

    kernels, total, count, busy, wall, _ = profile_device(
        torch, lambda: step(train_state, batch, seed))
    print("profile train step: K1 recurrence %.3f ms, prediction (K1 and "
          "K2) %.3f ms, K2 %.3f ms without its prediction (step kernel "
          "%.3f, wgrad kernel %.3f, reduce kernel %.3f), all %d device ops "
          "%.3f ms, device busy %.3f of %.3f ms wall (idle share %.3f) [%s]"
          % (kernels["K1 recurrence"], kernels["prediction"], kernels["K2"],
             kernels["K2 step"], kernels["K2 wgrad"], kernels["K2 reduce"],
             count, total, busy, wall, 1.0 - busy / wall, card))
    torch.cuda.synchronize()
    return launches, med


# the recipe's training stage (7b): train_srf_timit.sh's stages 0-4 through
# the port's CLIs on synthetic fbank-123 utterances. Utterances per TIMIT
# bucket (<= 241, 391, 541, 691, 841 frames; bucket batches 29/17/12/10/8
# at the 7000-frame budget): train fills each bucket at least twice an
# epoch (2 + 3 + 4 + 4 + 4 = 17 steps), valid fills buckets 0-2 once (3
# batches); the test split is phase 6c's 24 utterances
RECIPE_BUCKET_FRAMES = ((150, 241), (242, 391), (392, 541), (542, 691),
                        (692, 778))
RECIPE_TRAIN_UTTS = (70, 60, 48, 40, 38)
RECIPE_VALID_UTTS = (35, 20, 13, 6, 6)
RECIPE_BATCHES = (29, 17, 12, 10, 8)
RECIPE_E1, RECIPE_E2 = 2, 4  # the stages' epoch budgets (E1, E2)
RECIPE_MID_EVERY = 3
# a resumed run's weights against the uninterrupted run's: within this
# share of how far stage 2 moved them. cuDNN's and the CTC loss's backward
# are not bitwise deterministic on the card: sound resumes read 1.7e-05 on
# an H100. A planted fault, the same rerun resumed one batch late (its
# resume record's batch index raised by one), must read more than this, and
# the phase checks that it does
RESUME_REL = 1e-3


def recipe_corpus(base, vocab):
    """Writes the three splits as npy features and JSON manifests (the
    recipe's input to save_tfrecord) under ``base``; returns {split:
    {utt id: (features, labels)}}."""
    rng = np.random.RandomState(SEED + 20)
    splits = {"train": {}, "valid": {}, "test": test_split_data()}
    for split, counts in (("train", RECIPE_TRAIN_UTTS),
                          ("valid", RECIPE_VALID_UTTS)):
        for (low, high), count in zip(RECIPE_BUCKET_FRAMES, counts):
            for _ in range(count):
                n = int(rng.randint(low, high + 1))
                labels = rng.randint(1, 62, size=max(2, n // 8))
                splits[split]["%s%03d" % (split, len(splits[split]))] = (
                    rng.randn(n, 123).astype(np.float32), labels)
    for split, utts in splits.items():
        os.makedirs(os.path.join(base, split))
        with open(os.path.join(base, split + ".json"), "w") as manifest:
            for utt, (feats, labels) in utts.items():
                key = "%s/%s.npy" % (split, utt)
                np.save(os.path.join(base, key), feats)
                manifest.write(json.dumps({
                    "key": key, "duration": feats.shape[0] / 100.0,
                    "text": " ".join(vocab[i] for i in labels)}) + "\n")
    return splits


def recipe_argv(base, ckpt, *extra):
    """The recipe's trainer flags (train_srf_timit.sh:38-59 with
    timit.conf) on the synthetic splits."""
    return ["trainer_sr",
            "--config=%s" % os.path.join(REPO, "egs", "conf", "timit.conf"),
            "--path-base=%s" % base,
            "--path-vocab=%s" % os.path.join(REPO, "egs", "data",
                                             "timit_62.vocab"),
            "--path-ckpt=%s" % ckpt, "--train-batch-frame=7000",
            "--train-warmup-n=1200", "--feat-type=None",
            "--path-train-ptrn=tfrecord/synth-train-None-123-*-of-*",
            "--path-valid-ptrn=tfrecord/synth-valid-None-123-*-of-*",
            "--path-test-ptrn=tfrecord/synth-test-None-123-*-of-*",
            "--prep-data-num-train=%d" % sum(RECIPE_TRAIN_UTTS),
            "--prep-data-num-valid=%d" % sum(RECIPE_VALID_UTTS),
            "--prep-data-num-test=%d" % DECODE_UTTS, "--device=cuda",
            *[f for f in TIMIT_FLAGS if not f.startswith("--decoding-beam")],
            *extra]


def stage_argv(base, ckpt, k, epochs, *extra):
    """One of the recipe's training runs: ``run trainer_sr K TOLERANCE
    ... MAX_EPOCH`` with the tolerance equal to the epoch budget
    (train_srf_timit.sh:65-66)."""
    return recipe_argv(base, ckpt, "--train-lr-param-k=%s" % k,
                       "--train-es-tolerance=%d" % epochs,
                       "--train-max-epoch=%d" % epochs, *extra)


class StepRecorder:
    """Wraps trainer_sr's train and valid steps (in this script, not in the
    package): checks each call's K1/K2 launches and times it with CUDA
    events around the call (no synchronize inside the run, so the loop's
    pipelining is kept; an event pair spans the call's device work and any
    wait of the card for the host), except the first call at each shape,
    which cuDNN's algorithm search makes slow: that one is host-clocked
    between two synchronizes."""

    def __init__(self, torch):
        from srf_tpu_torch import trainer_sr
        from srf_tpu_torch.ops import routing_cuda

        self.torch, self.trainer_sr, self.routing = torch, trainer_sr, \
            routing_cuda
        self.steps, self.firsts, self.valid_batches = [], {}, 0
        self.make_train, self.make_valid = (trainer_sr.make_train_step,
                                            trainer_sr.make_valid_step)
        self.seen, self.valid_shapes = set(), set()

    def counts(self):
        return (self.routing.sequential_routing_cuda.launches,
                self.routing.sequential_routing_bwd_cuda.launches)

    def __enter__(self):
        torch, recorder = self.torch, self

        def make_train_step(*args, **kwargs):
            step = recorder.make_train(*args, **kwargs)

            def train_step(state, batch, seed):
                shape = tuple(batch["feats"].shape[:2])
                before, first = recorder.counts(), shape not in recorder.seen
                if first:
                    recorder.seen.add(shape)
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                else:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                out = step(state, batch, seed)
                after = recorder.counts()
                if first:
                    torch.cuda.synchronize()
                    recorder.firsts[shape] = 1e3 * (time.perf_counter()
                                                    - start)
                else:
                    events[1].record()
                    recorder.steps.append((shape, state.step, events))
                check(after[0] - before[0] == 7 * K1_LAUNCHES
                      and after[1] - before[1] == 7 * K2_LAUNCHES,
                      "trainer_sr train step at %s launched K1 %d and K2 %d "
                      "times, expected %d and %d" % (
                          shape, after[0] - before[0], after[1] - before[1],
                          7 * K1_LAUNCHES, 7 * K2_LAUNCHES))
                return out

            return train_step

        def make_valid_step(*args, **kwargs):
            step = recorder.make_valid(*args, **kwargs)

            def valid_step(state, batch):
                before = recorder.counts()
                out = step(state, batch)
                after = recorder.counts()
                check(after[0] - before[0] == 7 * K1_LAUNCHES
                      and after[1] == before[1],
                      "trainer_sr valid batch launched K1 %d and K2 %d "
                      "times, expected %d and 0" % (
                          after[0] - before[0], after[1] - before[1],
                          7 * K1_LAUNCHES))
                recorder.valid_batches += 1
                recorder.valid_shapes.add(tuple(batch["feats"].shape[:2]))
                return out

            return valid_step

        self.trainer_sr.make_train_step = make_train_step
        self.trainer_sr.make_valid_step = make_valid_step
        return self

    def __exit__(self, *exc):
        self.trainer_sr.make_train_step = self.make_train
        self.trainer_sr.make_valid_step = self.make_valid

    def step_ms(self, epochs, per_epoch):
        """{(B, T): [ms, ...]} of the timed steps of ``epochs`` (1-based)."""
        self.torch.cuda.synchronize()
        out = {}
        for shape, step, (start, end) in self.steps:
            if (step - 1) // per_epoch + 1 in epochs:
                out.setdefault(shape, []).append(start.elapsed_time(end))
        return out


class LogLines:
    """Collects the trainer's log lines that hold any of ``needles``."""

    def __init__(self, *needles):
        import logging

        self.needles, self.lines = needles, []
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger = logging.getLogger("srf_tpu_torch")

    def _emit(self, record):
        message = record.getMessage()
        if any(needle in message for needle in self.needles):
            self.lines.append(message)

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def trace_idle_share(path):
    """(device busy ms, wall ms) of a Chrome trace that
    utils/profiler.trace wrote: the union of the device's kernel, copy
    and set intervals against the span of every event."""
    with open(path) as trace:
        events = [e for e in json.load(trace)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset"))
    busy, last_end = 0.0, None
    for start, end in device:
        if last_end is not None and start < last_end:
            start = last_end
        if end > start:
            busy += end - start
            last_end = end
    wall = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    return busy / 1e3, wall / 1e3


def ckpt_weights(path, step):
    from srf_tpu_torch.utils import checkpoint

    return checkpoint.CheckpointManager(path).restore(step)


def recipe_train_phase(torch, card, state, direct_ms):
    """Phase 7b: the SRF-TIMIT recipe's stages 0-4 through the port's CLIs
    at full width (see the module docstring). ``direct_ms`` is phase 7's
    median step at 29 x 241. Returns the K1 and K2 launches of stages 1-4
    and the multi-iteration epoch."""
    import contextlib
    import io
    import shutil
    import tempfile

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from srf_tpu_torch import trainer_sr
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.routing_cuda import (
        SDRFunction, sequential_routing_bwd_cuda, sequential_routing_cuda)
    from srf_tpu_torch.tools import average_ckpt, save_tfrecord
    from srf_tpu_torch.train.optimizer import noam_schedule
    from srf_tpu_torch.utils import checkpoint, log2utt, score
    from srf_tpu_torch.utils.vocab import load_vocab

    phase_start = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    vocab_path = os.path.join(REPO, "egs", "data", "timit_62.vocab")
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    vocab = load_vocab(vocab_path, logger)[0]
    ckpt = os.path.join(base, "ckpt")
    saved_env = os.environ.get("SRF_LOOP_TIMING")
    os.environ["SRF_LOOP_TIMING"] = "1"
    try:
        # stage 0: npy + JSON -> TFRecords (save_tfr_timit.sh's flags)
        start = time.perf_counter()
        splits = recipe_corpus(base, vocab)
        save_tfrecord.main([
            "save_tfrecord", "--path-base=%s" % base,
            "--path-vocab=%s" % vocab_path, "--prep-data-shard=10",
            "--prep-data-name=synth", "--prep-data-unit=word",
            "--feat-type=None", "--feat-dim=123",
            "--path-train-json=train.json", "--path-valid-json=valid.json",
            "--path-test-json=test.json", "--path-wrt-tfrecord=tfrecord",
            "--decoding-from-npy=True"])
        shards = sorted(os.listdir(os.path.join(base, "tfrecord")))
        check(len(shards) == 12, "stage 0 wrote %s" % shards)
        print("recipe stage 0 (save_tfrecord): %d train, %d valid, %d test "
              "utterances into %d shards, %.1f s"
              % (len(splits["train"]), len(splits["valid"]),
                 len(splits["test"]), len(shards),
                 time.perf_counter() - start))

        # stage 1: two LR stages on one checkpoint directory, counted from 0
        sequential_routing_cuda.launches = 0
        sequential_routing_bwd_cuda.launches = 0
        plain_before = SDRFunction.plain_backwards
        first_rates = []

        def first_rate(optimizer, args, kwargs):
            if not first_rates:
                first_rates.append(optimizer.param_groups[0]["lr"])

        with StepRecorder(torch) as recorder, LogLines(
                "Loop timing", "Loaded ckpt", "Resuming") as log:
            walls = []
            for k, epochs, extra in (
                    (0.5, RECIPE_E1, ()),
                    (0.1, RECIPE_E2, ("--tpu-profile-dir=%s"
                                      % os.path.join(base, "profile"),))):
                if epochs == RECIPE_E2:
                    # a copy of stage 1's checkpoints for the preemption run
                    shutil.copytree(ckpt, os.path.join(base, "ckpt_cut"))
                    hook = register_optimizer_step_pre_hook(first_rate)
                start = time.perf_counter()
                try:
                    trainer_sr.main(stage_argv(base, ckpt, k, epochs, *extra))
                finally:
                    if epochs == RECIPE_E2:
                        hook.remove()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - start)
        train_k1 = sequential_routing_cuda.launches
        train_k2 = sequential_routing_bwd_cuda.launches
        check(SDRFunction.plain_backwards == plain_before,
              "stage 1 took the plain SDR backward")

        manager = checkpoint.CheckpointManager(ckpt)
        check(manager.all_steps() == [1, 2, 3, 4],
              "stage 1 saved checkpoints %s" % manager.all_steps())
        per_epoch = int(manager.restore(1)["step"])
        check(per_epoch == sum(b // s for b, s in zip(RECIPE_TRAIN_UTTS,
                                                      RECIPE_BATCHES)),
              "an epoch took %d steps" % per_epoch)
        with open(os.path.join(ckpt, "metrics.jsonl")) as lines:
            records = [json.loads(line) for line in lines]
        kinds = [r["kind"] for r in records]
        check(kinds.count("train_epoch") == 4
              and kinds.count("valid_epoch") == 4,
              "metrics.jsonl holds %s" % kinds)
        check([r["epoch"] for r in records if r["kind"] == "train_epoch"]
              == [1, 2, 3, 4], "stage 2 did not resume at epoch offset 2")
        check(any("Loaded ckpt: %s/2" % ckpt in line for line in log.lines),
              "stage 2 did not load checkpoint 2")
        check(all(np.isfinite(r["loss"]) for r in records),
              "a non-finite epoch loss: %s" % records)
        restored = 2 * per_epoch
        want_rate = noam_schedule(0.1, 1, 1200)(restored)
        check(first_rates and first_rates[0] == want_rate,
              "stage 2's first update ran at rate %r, not noam(0.1, 1, "
              "1200)(%d) = %r" % (first_rates[:1], restored, want_rate))
        steps = 4 * per_epoch
        valid_batches = 4 * sum(v // s for v, s in zip(RECIPE_VALID_UTTS,
                                                       RECIPE_BATCHES))
        check(recorder.valid_batches == valid_batches
              and train_k1 == 7 * K1_LAUNCHES * (steps + valid_batches)
              and train_k2 == 7 * K2_LAUNCHES * steps,
              "stage 1: K1 %d, K2 %d launches over %d steps and %d valid "
              "batches" % (train_k1, train_k2, steps,
                           recorder.valid_batches))
        # every (B, T') the recipe routed at was held to the plain versions
        # in phases 3-4
        held_at = {(b, t) for b, t, _, _ in SDR_SHAPES}
        routed = {(b, -(-(-(-t // 2)) // 2)): (b, t)
                  for b, t in recorder.seen | recorder.valid_shapes}
        check(set(routed) <= held_at,
              "the recipe routed at (B, T') %s (frames %s), which phases 3-4 "
              "do not check" % (sorted(set(routed) - held_at),
                                [routed[k] for k in sorted(set(routed)
                                                           - held_at)]))
        for r in records:
            print("recipe stage 1 epoch %d %s loss %.4f, %.3f s%s"
                  % (r["epoch"], r["kind"].split("_")[0], r["loss"],
                     r["secs"], " (%d steps)" % per_epoch
                     if r["kind"] == "train_epoch" else ""))
        print("recipe stage 1: k 0.5 for %d epochs, %.1f s; k 0.1 resumed at "
              "epoch offset 2 for %d more, %.1f s; stage 2's first update at "
              "rate %.6e = noam(0.1, 1, 1200)(%d); K1 %d launches (%d per "
              "step and per valid batch), K2 %d (%d per step) over %d steps "
              "and %d valid batches; 0 plain backwards [%s]"
              % (RECIPE_E1, walls[0], RECIPE_E2 - RECIPE_E1, walls[1],
                 first_rates[0], restored, train_k1, 7 * K1_LAUNCHES,
                 train_k2, 7 * K2_LAUNCHES, steps, valid_batches, card))
        for line in log.lines:
            if "Loop timing" in line:
                print("recipe stage 1 SRF_LOOP_TIMING: %s [%s]" % (line,
                                                                   card))
        firsts = sorted(recorder.firsts.items(), key=lambda kv: kv[0][1])
        print("recipe stage 1 first step per bucket (B x T), ms (cuDNN's "
              "search included, host clock): %s [%s]"
              % (", ".join("%dx%d %.1f" % (*shape, ms)
                           for shape, ms in firsts), card))
        # steady steps: stage 1's second epoch and stage 2's second epoch
        # (stage 2's first is under the profiler)
        timed = recorder.step_ms((2, 4), per_epoch)
        medians = {shape: float(np.median(ms)) for shape, ms in timed.items()}
        print("recipe stage 1 ms a step per bucket (median over epochs 2 "
              "and 4, CUDA events around each call): %s [%s]"
              % (", ".join("%dx%d %.3f (%d steps)" % (*shape, medians[shape],
                                                      len(timed[shape]))
                           for shape in sorted(medians, key=lambda s: s[1])),
                 card))
        check(len(medians) == 5, "steps were timed at %s" % sorted(medians))
        print("recipe stage 1 CLI step at 29 x 241: %.3f ms (median) "
              "against phase 7's direct step %.3f ms [%s]"
              % (medians[(29, 241)], direct_ms, card))
        traces = os.listdir(os.path.join(base, "profile"))
        check(len(traces) == 1, "profile dir holds %s" % traces)
        busy, wall = trace_idle_share(os.path.join(base, "profile",
                                                   traces[0]))
        print("recipe stage 1 profiled epoch 3 (torch.profiler, %d steps "
              "and the loop): device busy %.1f of %.1f ms wall, idle share "
              "%.3f [%s]" % (per_epoch, busy, wall, 1.0 - busy / wall, card))

        # preemption: stage 2 again on the copy, killed mid epoch 3
        fault_at = restored + per_epoch // 2
        cut = os.path.join(base, "ckpt_cut")
        argv = stage_argv(base, cut, 0.1, RECIPE_E2,
                          "--tpu-ckpt-every-steps=%d" % RECIPE_MID_EVERY)
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("SRF_LOOP_TIMING")
        late = os.path.join(base, "ckpt_late")
        runs = []
        for extra in (("--tpu-fault-at-step=%d" % fault_at,), ()):
            if not extra:
                # the killed run's checkpoints, for the planted fault below
                shutil.copytree(cut, late)
            start = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "srf_tpu_torch.trainer_sr",
                 *argv[1:], *extra], cwd=REPO, env=env, capture_output=True,
                text=True, timeout=600)
            runs.append((proc, time.perf_counter() - start))
        (killed, killed_s), (resumed, resumed_s) = runs
        check(killed.returncode == 42, "the preempted run exited %d: %s"
              % (killed.returncode, killed.stderr[-2000:]))
        check(resumed.returncode == 0 and "Resuming mid-epoch"
              in resumed.stderr, "the rerun exited %d without resuming "
              "mid-epoch: %s" % (resumed.returncode, resumed.stderr[-2000:]))
        mid = (fault_at - restored) // RECIPE_MID_EVERY * RECIPE_MID_EVERY
        check("epoch 2, batch %d" % mid in resumed.stderr,
              "the rerun did not resume at epoch 3's batch %d" % mid)
        before = ckpt_weights(ckpt, 2)["model"]
        whole, cut_model = (ckpt_weights(path, 4)["model"]
                            for path in (ckpt, cut))
        moved = max((whole[k] - before[k]).abs().max().item()
                    for k in whole if whole[k].is_floating_point())
        diff = max((whole[k] - cut_model[k]).abs().max().item()
                   for k in whole if whole[k].is_floating_point())
        print("recipe preemption: stage 2 on a copy, --tpu-fault-at-step=%d "
              "(epoch 3, batch %d) exited 42 after %.1f s; the rerun resumed "
              "from the mid checkpoint after batch %d and finished in %.1f s; "
              "epoch-4 weights max |resumed - uninterrupted| %.3e, stage 2 "
              "moved them by up to %.3e (ratio %.2e, limit %.0e)"
              % (fault_at, fault_at - restored, killed_s, mid, resumed_s,
                 diff, moved, diff / moved, RESUME_REL))
        check(diff <= RESUME_REL * moved,
              "the resumed run's weights are %.3e from the uninterrupted "
              "run's" % diff)
        # the planted fault: the same rerun, resumed one batch late, must
        # fail the check above
        mid_mgr = checkpoint.CheckpointManager(os.path.join(late, "mid"))
        tree = mid_mgr.restore(mid_mgr.latest_step())
        tree["resume"]["batch_index"] += 1
        mid_mgr.save(mid_mgr.latest_step(), tree)
        start = time.perf_counter()
        with LogLines("Resuming mid-epoch") as log:
            trainer_sr.main(stage_argv(
                base, late, 0.1, RECIPE_E2,
                "--tpu-ckpt-every-steps=%d" % RECIPE_MID_EVERY))
        check(any("epoch 2, batch %d" % (mid + 1) in line
                  for line in log.lines),
              "the planted rerun did not resume at epoch 3's batch %d: %s"
              % (mid + 1, log.lines))
        late_model = ckpt_weights(late, 4)["model"]
        diff_late = max((whole[k] - late_model[k]).abs().max().item()
                        for k in whole if whole[k].is_floating_point())
        print("recipe preemption, planted fault: the rerun resumed one batch "
              "late (batch %d) and finished in %.1f s; epoch-4 weights max "
              "|late - uninterrupted| %.3e (ratio %.2e, limit %.0e)"
              % (mid + 1, time.perf_counter() - start, diff_late,
                 diff_late / moved, RESUME_REL))
        check(diff_late > RESUME_REL * moved,
              "a rerun resumed one batch late is only %.3e from the "
              "uninterrupted run's weights: the resume check cannot see it"
              % diff_late)

        # stages 2-4: average, decode (device beam, batch 8, beam 100),
        # log2utt, score
        sequential_routing_cuda.launches = 0
        start = time.perf_counter()
        average_ckpt.main(recipe_argv(base, ckpt))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            trainer_sr.main(recipe_argv(
                base, os.path.join(ckpt, "avg"), "--train-max-epoch=0",
                "--decoding-beam-width=%d" % DECODE_BEAM,
                "--tpu-decode-batch=%d" % DECODE_BATCH,
                "--tpu-decode-pad-last=True"))
        decode_k1 = sequential_routing_cuda.launches
        log_path = os.path.join(base, "decode.log")
        with open(log_path, "w") as decode_log:
            decode_log.write(out.getvalue())
        hyps = dict(log2utt.parse_decode_log(out.getvalue().splitlines()))
        check(sorted(hyps) == sorted(splits["test"]),
              "the decode gave %d of %d utterances" % (len(hyps),
                                                      len(splits["test"])))
        batches = -(-len(hyps) // DECODE_BATCH)
        check(decode_k1 == batches * 7 * K1_LAUNCHES,
              "decode: K1 launched %d times over %d batches" % (decode_k1,
                                                                batches))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            log2utt.main([log_path, vocab_path, "--corpus", "timit"])
        with open(os.path.join(base, "hyp.trn"), "w") as trn:
            trn.write(text.getvalue())
        lines = [line.strip() for line in open(vocab_path)]
        with open(os.path.join(base, "ref.trn"), "w") as trn:
            for utt, (_, labels) in sorted(splits["test"].items()):
                trn.write("%s (%s)\n" % (log2utt.ids_to_utt(
                    labels, lines, "timit"), utt))
        report = io.StringIO()
        per = score.score(os.path.join(base, "ref.trn"),
                          os.path.join(base, "hyp.trn"), out=report)
        check("missing hyp: 0" in report.getvalue() and np.isfinite(per),
              "scoring: %s" % report.getvalue()[-500:])
        print("recipe stages 2-4: averaged checkpoints 1-4, decoded %d "
              "utterances at batch %d with the device beam at width %d (K1 "
              "%d launches, %d per batch), scraped by log2utt and scored: "
              "PER %.2f %% (random labels), %.1f s [%s]"
              % (len(hyps), DECODE_BATCH, DECODE_BEAM, decode_k1,
                 7 * K1_LAUNCHES, per, time.perf_counter() - start, card))

        # the multi-iteration backward (ITER=2): one stage-1 epoch on the
        # valid split, and one dropout-free step against the CPU
        plain_before = SDRFunction.plain_backwards
        sequential_routing_bwd_cuda.launches = 0
        start = time.perf_counter()
        iter_ckpt = os.path.join(base, "ckpt_iter2")
        trainer_sr.main(stage_argv(
            base, iter_ckpt, 0.5, 1, "--model-caps-iter=2",
            "--path-train-ptrn=tfrecord/synth-valid-None-123-*-of-*",
            "--prep-data-num-train=%d" % sum(RECIPE_VALID_UTTS)))
        with open(os.path.join(iter_ckpt, "metrics.jsonl")) as lines:
            iter_records = [json.loads(line) for line in lines]
        iter_steps = int(ckpt_weights(iter_ckpt, 1)["step"])
        plain = SDRFunction.plain_backwards - plain_before
        check(all(np.isfinite(r["loss"]) for r in iter_records)
              and len(iter_records) == 2, "ITER=2 epoch: %s" % iter_records)
        check(plain == 7 * iter_steps and iter_steps > 0
              and sequential_routing_bwd_cuda.launches == 0,
              "ITER=2: %d plain backwards over %d steps, K2 %d launches"
              % (plain, iter_steps, sequential_routing_bwd_cuda.launches))
        print("recipe ITER=2 epoch (train on the valid split): %d steps, "
              "train loss %.4f, valid loss %.4f, %d plain backwards (7 a "
              "step, autograd through the plain loop on the card), K2 0 "
              "launches, %.1f s [%s]"
              % (iter_steps, iter_records[0]["loss"], iter_records[1]["loss"],
                 plain, time.perf_counter() - start, card))
        config = timit_config(logger, "cuda", [
            f for f in TIMIT_FLAGS if f != "--model-caps-iter=1"] + [
                "--model-caps-iter=2"])
        batch = train_batch(torch, "cuda")
        train_parity(torch, config, state,
                     {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()},
                     label="ITER=2 ")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("SRF_LOOP_TIMING", None)
        else:
            os.environ["SRF_LOOP_TIMING"] = saved_env
    print("recipe phase: %.1f s" % (time.perf_counter() - phase_start))
    return train_k1 + decode_k1, train_k2


def cnn_site_shapes(torch, device):
    """(shape, rate) of each K5 site of one CNN-TIMIT training forward at
    29 x 241, in order, read off the model itself: one forward with the
    sites recorded instead of dropped."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models import cnn
    from srf_tpu_torch.models.registry import build_model

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    model, _ = build_model(timit_config(logger, "cuda", CNN_FLAGS), 63)
    model.to(device).train()
    batch = train_batch(torch, device)
    sites, real = [], cnn.fused_dropout
    cnn.fused_dropout = lambda x, seed, rate: sites.append(
        (tuple(x.shape), rate)) or x
    try:
        with torch.no_grad():
            model(batch["feats"], batch["inp_len"].to(device),
                  torch.Generator(device).manual_seed(SEED))
    finally:
        cnn.fused_dropout = real
    return sites


def k5_phase(torch, device):
    """Phase 5: the fused dropout against its plain version, bit for bit,
    and its times; returns its JSON entry."""
    import torch.nn.functional as F
    from srf_tpu_torch.ops.dropout import (fused_dropout,
                                           fused_dropout_plain)
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    gen = torch.Generator(device).manual_seed(SEED + 3)
    seeds = iter(np.random.RandomState(SEED + 3).randint(
        0, 2 ** 62, size=1000, dtype=np.int64).tolist())

    max_err = [0.0]

    def same(x, rate, label):
        seed = next(seeds)
        got = fused_dropout_cuda(x, seed, rate)
        want = fused_dropout_plain(x, seed, rate)
        torch.cuda.synchronize()
        max_err[0] = max(max_err[0], (got - want).abs().max().item())
        check(torch.equal(got, want), "K5 differs from its plain version at "
              "%s rate %s seed %d" % (label, rate, seed))
        return got

    for n in K5_SIZES:
        for rate in K5_RATES:
            same(torch.randn(n, generator=gen, device=device), rate, n)
    # 4 bytes off the 16-byte alignment: the kernel's scalar path
    misaligned = torch.randn(5001, generator=gen, device=device)[1:]
    for rate in K5_RATES:
        same(misaligned, rate, "5000 misaligned")
    print("K5 sizes %s (and 5000 misaligned) x rates %s: equal to the plain "
          "version" % (list(K5_SIZES), list(K5_RATES)))

    sites = cnn_site_shapes(torch, device)
    check(len(sites) == CNN_SITES, "CNN-TIMIT forward has %d K5 sites, "
          "expected %d" % (len(sites), CNN_SITES))
    per_site, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                            "library_ms": 0.0}
    for index, (shape, site_rate) in enumerate(sites):
        x = torch.randn(shape, generator=gen, device=device)
        for rate in K5_RATES:
            same(x, rate, "site %d %s" % (index, shape))
        seed = next(seeds)
        ms = event_ms(torch, lambda: fused_dropout_cuda(x, seed, site_rate),
                      10)
        plain_ms = event_ms(
            torch, lambda: fused_dropout_plain(x, seed, site_rate), 2)
        library_ms = event_ms(
            torch, lambda: F.dropout(x, site_rate, training=True), 10)
        bound = 1e3 * 8 * x.numel() / PEAK_BYTES_PER_S
        per_site.append({"site": index, "shape": list(shape),
                         "rate": site_rate, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound})
        # each site runs K5 twice a step: forward and backward
        for key, value in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound), ("library_ms", library_ms)):
            totals[key] += 2 * value
        print("K5 site %2d %s rate %.1f: kernel %.4f ms, plain %.4f ms, "
              "F.dropout %.4f ms, bound %.4f ms (bytes)"
              % (index, shape, site_rate, ms, plain_ms, library_ms, bound))
        del x

    # masks are read off values in [1, 2): randn on the card gives exact
    # zeros (about one in 2**24 draws), which would read as dropped
    shape = max((s for s, _ in sites), key=lambda s: int(np.prod(s)))
    x = 1 + torch.rand(shape, generator=gen, device=device)
    for rate in K5_RATES:
        kept = (same(x, rate, "largest") != 0).double().mean().item()
        check(abs(kept - (1 - rate)) <= 1e-3, "K5 keeps %.6f of %s at rate "
              "%s" % (kept, shape, rate))
        print("K5 %s rate %.1f: keeps %.6f" % (shape, rate, kept))
    # the backward regenerates the forward's mask, on a cotangent in
    # another memory layout too
    seed, rate = next(seeds), 0.2
    leaf = x.requires_grad_()
    out = fused_dropout(leaf, seed, rate)
    grad = (1 + torch.rand(shape, generator=gen, device=device)).to(
        memory_format=torch.channels_last)
    launches = fused_dropout_cuda.launches
    out.backward(grad)
    torch.cuda.synchronize()
    check(fused_dropout_cuda.launches == launches + 1,
          "K5's backward did not launch K5")
    check(torch.equal(leaf.grad != 0, out != 0)
          and torch.equal(leaf.grad, fused_dropout_plain(grad, seed, rate)),
          "K5's backward mask is not the forward's")
    launches = fused_dropout_cuda.launches
    check(fused_dropout(x, seed, 0.0) is x
          and fused_dropout_cuda.launches == launches,
          "K5 at rate 0 is not the identity without a launch")
    print("K5 backward: the forward's mask on a channels_last cotangent; "
          "rate 0: identity, no launch")
    del x, leaf, out, grad
    torch.cuda.synchronize()
    print("K5 one train step's %d launches at 29 x 241: kernel %.4f ms, "
          "plain %.4f ms, F.dropout %.4f ms, bound %.4f ms (bytes); max "
          "|kernel - plain| %.3e" % (2 * CNN_SITES, totals["ms"],
                                     totals["plain_ms"], totals["library_ms"],
                                     totals["bound_ms"], max_err[0]))
    return {
        "name": "fused_dropout", "route": "cuda",
        "source": "srf_tpu_torch/csrc/fused_dropout.cu",
        "replaces": "srf_tpu/ops/dropout_pallas.py:48",
        "launches": None,
        # the largest |kernel - plain| over every size, site and rate above
        "max_abs_err": max_err[0],
        # one CNN-TIMIT train step's 50 launches (each site forward and
        # backward) at 29 x 241
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "bytes",
        # F.dropout(x, p, training=True): the same function, another stream
        "library_ms": totals["library_ms"],
        "per_site": per_site,
    }


def cnn_serve_phase(torch, card):
    """Phase 8: serve CNN-TIMIT on the card; returns K5's launches (none:
    eval has no dropout) and the random weights (a state_dict)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda", CNN_FLAGS)
    model, _ = build_model(config, 63)
    state = random_weights(model)
    card_rec = Recognizer(config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=state, device="cpu",
                         logger=logger)
    check(card_rec.device.type == "cuda" and card_rec.in_len_div == 1,
          "CNN Recognizer: device %s, in_len_div %d"
          % (card_rec.device, card_rec.in_len_div))

    batches = serve_batches()
    for feats_list in batches.values():  # warm-up (allocator, cuDNN)
        card_rec.transcribe_batch_detailed(feats_list)
    torch.cuda.synchronize()
    fused_dropout_cuda.launches = 0
    results = {name: card_rec.transcribe_batch_detailed(feats_list)
               for name, feats_list in batches.items()}
    torch.cuda.synchronize()
    launches = fused_dropout_cuda.launches
    check(launches == 0, "K5 launched %d times in serving" % launches)

    for name, feats_list in batches.items():
        got = results[name]
        check_served(name, got, feats_list, card_rec.in_len_div)
        # logits at valid frames depend neither on the padded width nor on
        # the other utterances, so the CPU decodes a subset
        subset = feats_list[:CNN_CPU_SUBSET]
        cpu = cpu_rec.transcribe_batch_detailed(subset)
        check([r["ids"] for r in got[:len(subset)]]
              == [r["ids"] for r in cpu], "%s: CNN card ids differ from CPU "
              "ids" % name)
        check([r["text"] for r in got[:len(subset)]]
              == [r["text"] for r in cpu], "%s: CNN card text differs" % name)
        card_logits = card_rec.forward(*card_rec.pad(feats_list)).cpu()
        cpu_logits = cpu_rec.forward(*cpu_rec.pad(subset))
        check(bool(torch.isfinite(card_logits).all()), "%s: logits" % name)
        err = max((card_logits[i, :len(f)] - cpu_logits[i, :len(f)])
                  .abs().max().item() for i, f in enumerate(subset))
        print("CNN serve %s: %d utts, %d tokens, logits %s; first %d: ids "
              "equal to CPU, max |card - cpu| %.3e at valid frames (atol "
              "%.0e)" % (name, len(got), sum(len(r["ids"]) for r in got),
                         tuple(card_logits.shape), len(subset), err,
                         CNN_LOGIT_ATOL))
        check(err <= CNN_LOGIT_ATOL,
              "%s: CNN card logits differ from CPU" % name)

    reps = 10
    for name, feats_list in batches.items():
        feats, lengths = card_rec.pad(feats_list)
        fwd_ms = timed_ms(torch, lambda: card_rec.forward(feats, lengths),
                          reps)
        e2e_ms = timed_ms(
            torch, lambda: card_rec.transcribe_batch_detailed(feats_list),
            reps)
        audio_s = 0.01 * float(lengths.sum())
        med = float(np.median(e2e_ms))
        print("CNN serve %s (padded %s), %d runs: forward median %.3f "
              "ms/batch (max %.3f), end-to-end median %.3f ms/batch (max "
              "%.3f), %.1f utt/s, %.1fx realtime [%s]"
              % (name, tuple(feats.shape), reps, float(np.median(fwd_ms)),
                 max(fwd_ms), med, max(e2e_ms), 1e3 * len(feats_list) / med,
                 1e3 * audio_s / med, card))
        _, total, count, busy, wall, by_name = profile_device(
            torch, lambda: card_rec.forward(feats, lengths), ())
        print("profile CNN %s forward: conv + GEMM kernels %.3f ms (layout "
              "conversions %.3f), all %d device ops %.3f ms, device busy "
              "%.3f of %.3f ms wall (idle share %.3f); top: %s [%s]"
              % (name, conv_ms(by_name), layout_ms(by_name), count, total,
                 busy, wall, 1.0 - busy / wall, top_ops(by_name), card))
    torch.cuda.synchronize()
    return launches, state


def cnn_train_phase(torch, card, state):
    """Phase 9: train CNN-TIMIT on the card in pallas mode; returns K5's
    launches in the TRAIN_STEPS-step run."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda", CNN_FLAGS)
    batch = train_batch(torch, "cuda")
    # dropout on: K5's masks follow the step seed on both devices
    train_parity(torch, config, state,
                 {k: v[:CNN_CHECK_BATCH] for k, v in batch.items()},
                 dropout="k5", label="CNN-TIMIT ",
                 grad_atol_rel=CNN_GRAD_ATOL_REL,
                 update_grad_rel=CNN_UPDATE_GRAD_REL,
                 min_compared=CNN_MIN_COMPARED)
    stride_config = timit_config(logger, "cuda", CNN_STRIDE_FLAGS)
    stride_state = random_weights(build_model(stride_config, 63)[0])
    train_parity(torch, stride_config, stride_state,
                 {k: v[:CNN_STRIDE_CHECK_BATCH] for k, v in batch.items()},
                 dropout="k5", label="CNN stride variant ")

    train_state, _, step = train_setup(torch, config, state, "cuda")
    seed = config.tpu_seed
    torch.cuda.synchronize()
    fused_dropout_cuda.launches = 0
    step_ms, losses = [], []
    # the first step includes cuDNN's algorithm search at these shapes
    # (device.py); it is timed apart and not in the median
    for _ in range(1 + TRAIN_STEPS):
        before = fused_dropout_cuda.launches
        start = time.perf_counter()
        train_state, metrics = step(train_state, batch, seed)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
        losses.append(metrics["loss_sum"])
        check(fused_dropout_cuda.launches - before == 2 * CNN_SITES,
              "a CNN train step launched K5 %d times, expected %d"
              % (fused_dropout_cuda.launches - before, 2 * CNN_SITES))
    launches = fused_dropout_cuda.launches
    all_on_card(train_state, metrics)
    losses = torch.stack(losses).cpu().numpy() / batch["feats"].shape[0]
    check(bool(np.isfinite(losses).all()), "non-finite CNN train loss")
    first_ms, step_ms = step_ms[0], step_ms[1:]
    med = float(np.median(step_ms))
    audio_s = 0.01 * float(batch["inp_len"].sum())
    print("CNN train 1 + %d steps of 29 x 241 (pallas, dropout on): K5 %d "
          "launches; loss per utterance first %.3f last %.3f; first step "
          "(cuDNN algorithm search) %.1f ms; then ms/step median %.3f max "
          "%.3f; %.1f utt/s, %.1f audio-s/s [%s]"
          % (TRAIN_STEPS, launches, losses[0], losses[-1], first_ms, med,
             max(step_ms), 1e3 * 29 / med, 1e3 * audio_s / med, card))
    kernels, total, count, busy, wall, by_name = profile_device(
        torch, lambda: step(train_state, batch, seed),
        (("K5", "fused_dropout_kernel"),))
    conv = conv_ms(by_name)
    print("profile CNN train step: K5 %.3f ms, conv + GEMM kernels %.3f ms "
          "(layout conversions %.3f), everything else %.3f ms, all %d "
          "device ops %.3f ms, device busy %.3f of %.3f ms wall (idle share "
          "%.3f); top: %s [%s]"
          % (kernels["K5"], conv, layout_ms(by_name),
             total - kernels["K5"] - conv, count, total, busy, wall,
             1.0 - busy / wall, top_ops(by_name, 8), card))
    torch.cuda.synchronize()
    return launches


# phases 10-11: the STF-TIMIT and LSTM-WSJ recipes' models at full width
# egs/script/train_stf_timit.sh:26-50 with timit.conf: L=20, D=128, 4 heads,
# FF 1024, 2 x 64-filter maxout convs, penalty (1, 1, 1) on, Noam warmup
# 1000 at k 1.5 (then 0.5), 20000-frame buckets
STF_TIMIT_FLAGS = [
    "--model-type=stf", "--model-encoder-num=20", "--model-dimension=128",
    "--model-inner-dim=1024", "--train-att-dropout=0.3",
    "--train-inn-dropout=0.4", "--train-inp-dropout=0.3",
    "--train-res-dropout=0.4", "--model-ap-scale=1",
    "--model-ap-width-zero=1", "--model-ap-width-stripe=1",
    "--model-ap-encoder=True", "--model-ap-decoder=True",
    "--model-ap-encdec=False", "--train-warmup-n=1000",
    "--train-batch-frame=20000", "--train-lr-param-k=1.5",
]
# egs/script/train_lstm_wsj.sh:28-45 with wsj.conf: BLSTM, L=5, D=534,
# 'ave' merge, CNN front end on (31 x 64 = 1984 inputs), plain Adam at
# 1e-4, 24000-frame buckets, 32 classes
LSTM_WSJ_FLAGS = [
    "--model-type=blstm", "--model-encoder-num=5", "--model-dimension=534",
    "--model-lstm-is-cnnfe=True", "--train-inn-dropout=0.4",
    "--train-inp-dropout=0.3", "--train-opti-type=adam",
    "--train-lr-param-k=1e-4", "--train-batch-frame=24000",
]
# card vs CPU logits of the served models (float32 both, TF32 off): sums in
# other orders through 20 attention blocks (21 LayerNorms) or 5 BLSTM
# layers over up to 416 steps; the logits are O(1) and measured 4.8e-6
# (STF) and 1.2e-5 (LSTM) apart on an H100
STF_LOGIT_ATOL, LSTM_LOGIT_ATOL = 1e-4, 1e-4
# blockwise against plain attention on the card (float32): the online
# softmax sums the same terms in key blocks; outputs O(1)
BLOCKWISE_ATOL, BLOCKWISE_GRAD_REL = 1e-4, 1e-4
# the STF-WSJ recipe's width (train_stf_wsj.sh: D=256, FF 1488, 4 heads)
# at T' = 600 (2400 frames), batch 8, penalty (1, 1, 1) on
BLOCKWISE_SHAPE = (8, 4, 600, 64)
# the timed train shapes, (B, padded frames): the first of the 20000-frame
# TIMIT buckets, which every TIMIT utterance up to 241 frames falls in; and
# three 24000-frame buckets that WSJ's 300-1600-frame utterances fall in
STF_TRAIN_SHAPES = ((82, 241),)
LSTM_TRAIN_SHAPES = ((44, 541), (24, 991), (15, 1591))
# the CLI runs' corpora, {split: ((low, high) frames, utterances)}: every
# bucket filled twice in train (one step each), once in valid
STF_RECIPE = {"train": (((150, 241), 164), ((242, 391), 102)),
              "valid": (((150, 241), 82), ((242, 391), 51))}
LSTM_RECIPE = {"train": (((392, 541), 44), ((992, 1141), 21)),
               "valid": (((392, 541), 44), ((992, 1141), 21))}
LSTM_TEST_UTTS, LSTM_TEST_FRAMES = 8, (300, 1600)


def kernel_counts():
    """K1-K5's launch counters."""
    from srf_tpu_torch.ops import dropout_cuda, routing_cuda

    return (routing_cuda.sequential_routing_cuda.launches,
            routing_cuda.sequential_routing_bwd_cuda.launches,
            routing_cuda.sequential_routing_scan_cuda.launches,
            routing_cuda.sequential_routing_scan_bwd_cuda.launches,
            dropout_cuda.fused_dropout_cuda.launches)


def family_config(logger, device, conf, flags):
    """``conf`` (timit or wsj) with a recipe's model and training flags."""
    from srf_tpu_torch.config import ParseOption

    return ParseOption(
        ["chip_smoke", "--config=%s" % os.path.join(REPO, "egs", "conf",
                                                    conf + ".conf"),
         "--path-base=%s" % REPO, "--path-ckpt=%s" % REPO,
         "--device=%s" % device, *flags],
        logger, is_print_opts=False,
    ).args


def wsj_serve_batches():
    """Phase 11's request batches: 8 utterances of 300-1600 frames and one
    of 1600, fbank-123 features from numpy."""
    rng = np.random.RandomState(SEED + 11)
    return {
        "8x300-1600": [rng.randn(n, 123).astype(np.float32)
                       for n in rng.randint(300, 1601, size=8)],
        "1x1600": [rng.randn(1600, 123).astype(np.float32)],
    }


def family_serve(torch, card, label, config, batches, logit_atol):
    """Serve ``batches`` through a Recognizer at ``config`` on the card and
    on the CPU with numpy-seeded weights: ids and text equal, logits within
    ``logit_atol``; forward and end-to-end times and a profile of one
    forward per batch. Returns the weights (a state_dict)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    classes = class_count(config)
    state = random_weights(build_model(config, classes)[0])
    card_rec = Recognizer(config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=state, device="cpu",
                         logger=logger)
    check(card_rec.device.type == "cuda", "%s Recognizer is not on the card"
          % label)
    for feats_list in batches.values():  # warm-up (allocator, cuDNN)
        card_rec.transcribe_batch_detailed(feats_list)
    torch.cuda.synchronize()
    for name, feats_list in batches.items():
        got = card_rec.transcribe_batch_detailed(feats_list)
        check_served(name, got, feats_list, card_rec.in_len_div,
                     blank=classes - 1)
        cpu = cpu_rec.transcribe_batch_detailed(feats_list)
        check([r["ids"] for r in got] == [r["ids"] for r in cpu],
              "%s %s: card ids differ from CPU ids" % (label, name))
        check([r["text"] for r in got] == [r["text"] for r in cpu],
              "%s %s: card text differs from CPU text" % (label, name))
        card_logits = card_rec.forward(*card_rec.pad(feats_list)).cpu()
        cpu_logits = cpu_rec.forward(*cpu_rec.pad(feats_list))
        check(bool(torch.isfinite(card_logits).all()), "%s %s: logits"
              % (label, name))
        err = (card_logits - cpu_logits).abs().max().item()
        print("%s serve %s: %d utts, %d tokens, ids equal to CPU, logits "
              "%s max |card - cpu| %.3e (atol %.0e)"
              % (label, name, len(got), sum(len(r["ids"]) for r in got),
                 tuple(card_logits.shape), err, logit_atol))
        check(err <= logit_atol, "%s %s: card logits differ from CPU"
              % (label, name))
    reps = 10
    for name, feats_list in batches.items():
        feats, lengths = card_rec.pad(feats_list)
        fwd_ms = timed_ms(torch, lambda: card_rec.forward(feats, lengths),
                          reps)
        e2e_ms = timed_ms(
            torch, lambda: card_rec.transcribe_batch_detailed(feats_list),
            reps)
        audio_s = 0.01 * float(lengths.sum())
        med = float(np.median(e2e_ms))
        print("%s serve %s (padded %s), %d runs: forward median %.3f "
              "ms/batch (max %.3f), end-to-end median %.3f ms/batch (max "
              "%.3f), %.1f utt/s, %.1fx realtime [%s]"
              % (label, name, tuple(feats.shape), reps,
                 float(np.median(fwd_ms)), max(fwd_ms), med, max(e2e_ms),
                 1e3 * len(feats_list) / med, 1e3 * audio_s / med, card))
        _, total, count, busy, wall, by_name = profile_device(
            torch, lambda: card_rec.forward(feats, lengths), ())
        print("profile %s %s forward: all %d device ops %.3f ms, device "
              "busy %.3f of %.3f ms wall (idle share %.3f); top: %s [%s]"
              % (label, name, count, total, busy, wall, 1.0 - busy / wall,
                 top_ops(by_name), card))
    torch.cuda.synchronize()
    return state


def family_train(torch, card, label, config, state, shapes, vocab):
    """One dropout-free step on card and CPU held as phase 7's (its update
    at the schedule's peak, the warmup count, or at plain Adam's rate),
    then TRAIN_STEPS steps with dropout on over ``shapes`` (the first step
    at each shape, with cuDNN's algorithm search, timed apart), finite
    losses and every tensor on the card; ms per step per shape and a
    profile of one step at the first shape."""
    batches = [train_batch(torch, "cuda", batch=b, frames=t, vocab=vocab)
               for b, t in shapes]
    train_parity(torch, config, state,
                 {k: v[:TRAIN_CHECK_BATCH] for k, v in batches[0].items()},
                 label=label + " ", count=config.train_warmup_n)
    train_state, _, step = train_setup(torch, config, state, "cuda")
    seed = config.tpu_seed
    first_ms, step_ms, losses = [], {}, []
    for batch in batches:
        torch.cuda.synchronize()
        start = time.perf_counter()
        train_state, metrics = step(train_state, batch, seed)
        torch.cuda.synchronize()
        first_ms.append(1e3 * (time.perf_counter() - start))
    for i in range(TRAIN_STEPS):
        batch = batches[i % len(batches)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        train_state, metrics = step(train_state, batch, seed)
        torch.cuda.synchronize()
        step_ms.setdefault(tuple(batch["feats"].shape[:2]), []).append(
            1e3 * (time.perf_counter() - start))
        losses.append(metrics["loss_sum"] / batch["feats"].shape[0])
    all_on_card(train_state, metrics)
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite %s train loss"
          % label)
    for (b, t), first in zip(shapes, first_ms):
        times = step_ms[(b, t)]
        med = float(np.median(times))
        print("%s train %d x %d (dropout on): first step %.1f ms; %d steps "
              "ms/step median %.3f max %.3f; %.1f utt/s, %.1f padded "
              "frames/ms [%s]" % (label, b, t, first, len(times), med,
                                  max(times), 1e3 * b / med, b * t / med,
                                  card))
    print("%s train: loss per utterance first %.3f last %.3f"
          % (label, losses[0], losses[-1]))
    _, total, count, busy, wall, by_name = profile_device(
        torch, lambda: step(train_state, batches[0], seed), ())
    print("profile %s train step %d x %d: all %d device ops %.3f ms, device "
          "busy %.3f of %.3f ms wall (idle share %.3f); top: %s [%s]"
          % (label, shapes[0][0], shapes[0][1], count, total, busy, wall,
             1.0 - busy / wall, top_ops(by_name, 8), card))
    torch.cuda.synchronize()


def blockwise_check(torch, card):
    """blockwise_attention against the plain path on the card, forward and
    gradients, at BLOCKWISE_SHAPE with the padding bias and the penalty,
    and both paths' forward + backward times."""
    from srf_tpu_torch.models.layers import scaled_dot_product_attention
    from srf_tpu_torch.ops.attention_penalty import AttentionPenalty
    from srf_tpu_torch.ops.blockwise_attention import (PenaltyParams,
                                                       blockwise_attention)
    from srf_tpu_torch.ops.masking import get_padding_bias

    batch, heads, seq_len, depth = BLOCKWISE_SHAPE
    gen = torch.Generator("cuda").manual_seed(SEED)
    q, k, v, cot = (torch.randn(BLOCKWISE_SHAPE, generator=gen,
                                device="cuda") for _ in range(4))
    lengths = torch.linspace(seq_len // 2, seq_len, batch,
                             device="cuda").int()
    mask = get_padding_bias(lengths, seq_len, 1)
    board = AttentionPenalty(2500, heads, 1, 1, 1.0).penalty(seq_len,
                                                             "cuda")
    penalty = PenaltyParams(1, 1, 1.0, 2500)

    def run(blockwise):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if blockwise:
            out = blockwise_attention(*leaves, mask, penalty=penalty)
        else:
            out = scaled_dot_product_attention(*leaves, mask, board[None])[0]
        out.backward(cot)
        return out.detach(), [t.grad for t in leaves]

    (plain, plain_grads), (block, block_grads) = run(False), run(True)
    err = (block - plain).abs().max().item()
    grad_err = max(((b - p).abs().max() / p.abs().max()).item()
                   for b, p in zip(block_grads, plain_grads))
    times = paired_ms(torch, lambda: run(False), lambda: run(True), 3)
    print("blockwise attention on the card at %s (T' %d, penalty on, "
          "padding bias): max |blockwise - plain| %.3e (atol %.0e), "
          "gradients' worst error %.3e x their max (atol %.0e x max); "
          "forward + backward plain %.3f ms, blockwise %.3f ms [%s]"
          % (BLOCKWISE_SHAPE, seq_len, err, BLOCKWISE_ATOL, grad_err,
             BLOCKWISE_GRAD_REL, times[0], times[1], card))
    check(err <= BLOCKWISE_ATOL, "blockwise attention differs from plain")
    check(grad_err <= BLOCKWISE_GRAD_REL,
          "blockwise attention's gradients differ from plain")


def write_split(base, split_name, utts, shards):
    """{utt id: (features, labels)} into ``shards`` TFRecord shards
    synth-<split>-None-123-<s>-of-<shards> by the port's writer, with utt
    ids (data/writer.py's layout)."""
    from srf_tpu_torch.data.example_proto import encode_example
    from srf_tpu_torch.data.tfrecord import TFRecordWriter

    os.makedirs(os.path.join(base, "tfrecord"), exist_ok=True)
    writers = [TFRecordWriter(os.path.join(
        base, "tfrecord", "synth-%s-None-123-%d-of-%d"
        % (split_name, s, shards))) for s in range(shards)]
    for i, (utt, (feats, labels)) in enumerate(utts.items()):
        writers[i % shards].write(encode_example({
            "target_label": labels,
            "input_speech": feats.flatten(),
            "input_length": np.asarray([feats.shape[0]], np.int64),
            "target_length": np.asarray([labels.size], np.int64),
            "utt_id": [utt.encode()],
        }))
    for writer in writers:
        writer.close()


def family_corpus(base, recipe, test, vocab_n, seed):
    """Writes ``recipe``'s train and valid splits (fbank-123 features,
    labels 1..vocab_n-1, tar_len max(2, len // 8)) and ``test`` as
    TFRecords under ``base``; returns the utterance counts."""
    rng = np.random.RandomState(seed)
    counts = {}
    for split, buckets in recipe.items():
        utts = {}
        for (low, high), count in buckets:
            for _ in range(count):
                n = int(rng.randint(low, high + 1))
                utts["%s%03d" % (split, len(utts))] = (
                    rng.randn(n, 123).astype(np.float32),
                    rng.randint(1, vocab_n, size=max(2, n // 8)))
        write_split(base, split, utts, 2)
        counts[split] = len(utts)
    write_split(base, "test", test, 2)
    counts["test"] = len(test)
    return counts


def family_recipe(torch, card, label, main, conf, vocab_file, flags, stages,
                  recipe, test, corpus):
    """A recipe's stages 1-4 through the port's CLIs on synthetic
    TFRecords: ``main`` (trainer_tf's or trainer_sr's) once per (k,
    epochs) of ``stages`` on one checkpoint directory, tools.average_ckpt
    over the last stage's checkpoints, ``main`` in decode mode with the
    device beam at width 100 (batch 8), utils.log2utt; every test
    utterance decoded, finite losses."""
    import contextlib
    import io
    import shutil
    import tempfile

    from srf_tpu_torch.tools import average_ckpt
    from srf_tpu_torch.utils import checkpoint, log2utt
    from srf_tpu_torch.utils.vocab import load_vocab

    base = tempfile.mkdtemp(prefix="chip_smoke_%s_" % conf)
    vocab_path = os.path.join(REPO, "egs", "data", vocab_file)
    ckpt = os.path.join(base, "ckpt")
    try:
        start = time.perf_counter()
        vocab_n = len(load_vocab(vocab_path, None)[0])
        counts = family_corpus(base, recipe, test, vocab_n, SEED + 30)
        print("%s recipe corpus: %s utterances as TFRecords, %.1f s"
              % (label, counts, time.perf_counter() - start))
        model_flags = [f for f in flags if not f.startswith(
            ("--train-lr-param-k", "--decoding-beam"))]

        def argv(*extra):
            return ["chip_smoke",
                    "--config=%s" % os.path.join(REPO, "egs", "conf",
                                                 conf + ".conf"),
                    "--path-base=%s" % base, "--path-vocab=%s" % vocab_path,
                    "--path-ckpt=%s" % ckpt, "--feat-type=None",
                    "--path-train-ptrn=tfrecord/synth-train-None-123-*-of-*",
                    "--path-valid-ptrn=tfrecord/synth-valid-None-123-*-of-*",
                    "--path-test-ptrn=tfrecord/synth-test-None-123-*-of-*",
                    "--prep-data-num-train=%d" % counts["train"],
                    "--prep-data-num-valid=%d" % counts["valid"],
                    "--prep-data-num-test=%d" % counts["test"],
                    "--device=cuda", *model_flags, *extra]

        with LogLines("Pre-training Valid Loss") as log:
            for k, epochs in stages:
                start = time.perf_counter()
                main(argv("--train-lr-param-k=%s" % k,
                          "--train-es-tolerance=%d" % epochs,
                          "--train-max-epoch=%d" % epochs))
                torch.cuda.synchronize()
                print("%s recipe stage 1 (k %s, to epoch %d): %.1f s"
                      % (label, k, epochs, time.perf_counter() - start))
        steps = checkpoint.CheckpointManager(ckpt).all_steps()
        last = stages[-1][1]
        check(steps == list(range(1, last + 1)),
              "%s recipe: checkpoints %s" % (label, steps))
        with open(os.path.join(ckpt, "metrics.jsonl")) as records:
            losses = [json.loads(line)["loss"] for line in records]
        check(len(losses) == 2 * last and np.isfinite(losses).all()
              and min(losses) > 0, "%s recipe losses %s" % (label, losses))
        print("%s recipe: train/valid losses per epoch %s; %s"
              % (label, ", ".join("%.3f" % x for x in losses),
                 "; ".join(log.lines) or "no pre-training pass"))
        start = time.perf_counter()
        average_ckpt.main(argv("--model-average-num=%d" % last))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(argv("--path-ckpt=%s" % os.path.join(ckpt, "avg"),
                      "--train-max-epoch=0", "--decoding-beam-width=100",
                      "--tpu-decode-batch=8", "--tpu-decode-pad-last=True"))
        log_path = os.path.join(base, "decode.log")
        with open(log_path, "w") as f:
            f.write(out.getvalue())
        scraped = io.StringIO()
        with contextlib.redirect_stdout(scraped):
            log2utt.main([log_path, vocab_path, "--corpus", corpus])
        lines = [l for l in scraped.getvalue().splitlines() if l.strip()]
        check(len(lines) == counts["test"],
              "%s recipe: log2utt gave %d of %d utterances"
              % (label, len(lines), counts["test"]))
        print("%s recipe stages 2-4 (average %d, decode beam 100 on the "
              "card, log2utt): %d utterances, %.1f s; first: %s [%s]"
              % (label, last, len(lines), time.perf_counter() - start,
                 lines[0][:80], card))
    finally:
        shutil.rmtree(base, ignore_errors=True)


def stf_phase(torch, card):
    """Phase 10: STF-TIMIT at full width (see the module docstring)."""
    from srf_tpu_torch import trainer_tf
    from srf_tpu_torch.config import Logger

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "timit", STF_TIMIT_FLAGS)
    before = kernel_counts()
    state = family_serve(torch, card, "STF-TIMIT", config, serve_batches(),
                         STF_LOGIT_ATOL)
    family_train(torch, card, "STF-TIMIT", config, state, STF_TRAIN_SHAPES,
                 62)
    blockwise_check(torch, card)
    family_recipe(torch, card, "STF-TIMIT", trainer_tf.main, "timit",
                  "timit_62.vocab", STF_TIMIT_FLAGS, ((1.5, 1), (0.5, 2)),
                  STF_RECIPE, test_split_data(), "timit")
    check(kernel_counts() == before,
          "phase 10 moved K1-K5's counters: %s -> %s"
          % (before, kernel_counts()))
    print("STF-TIMIT phase: K1-K5 launches unmoved %s; %.1f s"
          % (before, time.perf_counter() - phase_start))


def lstm_phase(torch, card):
    """Phase 11: LSTM-WSJ at full width (see the module docstring)."""
    from srf_tpu_torch import trainer_sr
    from srf_tpu_torch.config import Logger

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "wsj", LSTM_WSJ_FLAGS)
    before = kernel_counts()
    state = family_serve(torch, card, "LSTM-WSJ", config,
                         wsj_serve_batches(), LSTM_LOGIT_ATOL)
    family_train(torch, card, "LSTM-WSJ", config, state, LSTM_TRAIN_SHAPES,
                 31)
    rng = np.random.RandomState(SEED + 12)
    test = {}
    for i in range(LSTM_TEST_UTTS):
        n = int(rng.randint(LSTM_TEST_FRAMES[0], LSTM_TEST_FRAMES[1] + 1))
        test["synth%02d" % i] = (rng.randn(n, 123).astype(np.float32),
                                 rng.randint(1, 31, size=max(2, n // 8)))
    family_recipe(torch, card, "LSTM-WSJ", trainer_sr.main, "wsj",
                  "wsj_31.vocab", LSTM_WSJ_FLAGS, ((1e-4, 2),), LSTM_RECIPE,
                  test, "wsj")
    check(kernel_counts() == before,
          "phase 11 moved K1-K5's counters: %s -> %s"
          % (before, kernel_counts()))
    print("LSTM-WSJ phase: K1-K5 launches unmoved %s; %.1f s"
          % (before, time.perf_counter() - phase_start))


# --------------------------------------------------------------------------
# phases 12-14: streaming, the serving daemon, the other serving entry points

# K1 with an initial carry and a step mask (streaming), as (B, T) shapes of
# a streaming step's routed block (chunk 8; 10 for a window's context) at
# the TIMIT layers and the WSJ recipe's three layer geometries (window
# 2+1+2: in_n 300 and 150, 32 classes last), each with a nonzero carry and
# rows whose first steps are warm-up (a pool's slots warm up apart; one
# row is all warm-up)
CARRY_SHAPES = ((1, 8), (1, 10), (4, 8), (4, 10))
CARRY_LAYERS = TIMIT_LAYERS + [
    ("wsj_layer0", (300, 30, 20, 20), False, 1),
    ("wsj_middle", (150, 30, 20, 20), False, 8),
    ("wsj_last", (150, 32, 20, 20), True, 1),
]
STREAM_CHUNK, STREAM_BEAM = 8, 16
STREAM_FRAMES = (150, 333, 517, 800)
# transcribe_long's recording: speech (random features) of these seconds
# with LONG_GAP_S of silence (zero features) between them, ~60 s in all;
# the output LayerNorm is set so that silence gives the blank
# (calibrate_blank: random weights have no reason to)
LONG_SPEECH_S, LONG_GAP_S = (12, 14, 13, 12), 3
LONG_GAIN, LONG_BLANK_MARGIN = 1000.0, 1.0
POOL_SLOTS = (4, 16)
# the SRF-WSJ recipe's model (egs/script/train_srf_wsj.sh:14-19,44-55 with
# egs/conf/wsj.conf): L=10, PH=60, CH=30, dim 20, window 2+1+2,
# lowmemory, SDR, 1 iteration, 32 classes (wsj_31.vocab + blank)
SRF_WSJ_FLAGS = [
    "--model-encoder-num=10", "--model-caps-primary-num=60",
    "--model-caps-primary-dim=20", "--model-caps-convolution-num=30",
    "--model-caps-convolution-dim=20", "--model-caps-class-dim=20",
    "--model-caps-type=lowmemory", "--model-caps-window-lpad=2",
    "--model-caps-window-rpad=2", "--model-caps-context=True",
    "--model-caps-iter=1", "--decoding-beam-width=1",
]
# WSJ's serving rows the CPU also serves (at the card's padded width)
WSJ_CPU_ROWS = 2
# phase 13: DAEMON_REQUESTS requests from DAEMON_THREADS client threads,
# 150-250 frames (all padded to 256: a reply does not depend on the batch
# it rode in), the daemon at max batch 8 and 10 ms
DAEMON_REQUESTS, DAEMON_THREADS, DAEMON_BATCH = 32, 16, 8
DAEMON_FRAMES = (150, 250)
DAEMON_TIMEOUT = 120.0
WAV_SECONDS = 3.0
ALIGN_UTTS = 8


def k1_carry_check(torch, device, card):
    """Phase 12a: K1 with an initial carry and a step mask against its
    plain version on the same CUDA tensors, and its time at a streaming
    step's shape (B=1, T=8) summed over the SRF-TIMIT layers. Returns
    (the largest error, the step's times)."""
    from srf_tpu_torch.ops.routing import sequential_routing
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda

    rng = np.random.RandomState(SEED + 12)
    worst = 0.0
    step = sdr_totals()
    for name, geometry, mask, count in CARRY_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * 0.1,
                         dtype=torch.float32, device=device)
        b = torch.tensor(rng.randn(in_n, out_n, out_d) * 0.1,
                         dtype=torch.float32, device=device)
        for batch, seq_len in CARRY_SHAPES:
            for num_iter in ((1, 2) if batch == 4 else (1,)):
                u = torch.tensor(rng.randn(batch, seq_len, in_n, in_d),
                                 dtype=torch.float32, device=device)
                v_init = torch.tensor(rng.randn(batch, out_n, out_d) * 0.3,
                                      dtype=torch.float32, device=device)
                warm = [3, 0, seq_len, 1][:batch]
                valid = (torch.arange(seq_len, device=device)[None]
                         >= torch.tensor(warm, device=device)[:, None])
                got = sequential_routing_cuda(u, w, b, num_iter, mask,
                                              v_init, valid)
                torch.cuda.synchronize()
                want = sequential_routing(u, w, b, num_iter, mask, v_init,
                                          valid)
                err = (got - want).abs().max().item()
                worst = max(worst, err)
                check(bool(torch.isfinite(got).all()), "K1 carry not finite")
                check(not got[~valid].any(),
                      "K1 wrote a masked step at %s" % (geometry,))
                check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                      "K1 with a carry and a mask disagrees at %s B=%d T=%d "
                      "iter=%d (max err %.3e)" % (geometry, batch, seq_len,
                                                  num_iter, err))
                if (batch, seq_len, num_iter) != (1, STREAM_CHUNK, 1) or (
                        not name.startswith(("layer0", "middle", "last"))):
                    continue
                ms = event_ms(torch, lambda: sequential_routing_cuda(
                    u, w, b, 1, mask, v_init, valid), 50)
                plain_ms = event_ms(torch, lambda: sequential_routing(
                    u, w, b, 1, mask, v_init, valid), 3)
                add_layer(step, [], name, count, ms, plain_ms,
                          sdr_bound_ms(1, STREAM_CHUNK, geometry, 1))
        print("K1 carry %s %s: B x T %s, warm-up rows %s, carry nonzero: "
              "max |K1 - plain| %.3e" % (name, geometry, CARRY_SHAPES,
                                         [3, 0, "T", 1], worst))
    print("K1 per streaming step (7 calls at B=1 T=%d, a carry and a mask): "
          "kernel %.4f ms, plain %.4f ms, bound %.5f ms [%s]" % (
              STREAM_CHUNK, step["ms"], step["plain_ms"], step["bound_ms"],
              card))
    return worst, step


def padded_one(feats, model):
    """One utterance zero-padded to a multiple of the subsampling, past
    the last valid frame by the capsule layers' right context and more
    (at least 64 frames, as the streaming tests pad the batch forward
    they hold streaming to): its valid frames then do not depend on where
    the array ends."""
    div = model.stride ** model.conv_layer_num
    extra = max(64, div * (model.enc_num * model.rpad + 2))
    width = -(-(feats.shape[0] + extra) // div) * div
    out = np.zeros((1, width, feats.shape[1]), np.float32)
    out[0, : feats.shape[0]] = feats
    return out


def greedy_ids(logits, frames):
    """The offline greedy decode of [T', V] numpy logits over ``frames``."""
    blank = logits.shape[-1] - 1
    ids = np.argmax(logits[:frames], axis=-1)
    return [int(x) for i, x in enumerate(ids)
            if x != blank and (i == 0 or x != ids[i - 1])]


def stream_and_check(torch, rec, feats, label, chunk=STREAM_CHUNK,
                     atol=LOGIT_ATOL):
    """Stream ``feats`` through a greedy session of ``rec`` a chunk of raw
    frames a push (host clock per push that runs a step, each ending in a
    synchronize), hold its logits to the batch forward of the utterance
    alone and its ids to that forward's greedy decode. Returns (push ms, stream steps,
    max error, K1 launches while streaming)."""
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda

    before = sequential_routing_cuda.launches
    session = rec.streaming_session(chunk=chunk)
    push = chunk * session.div
    tokens, push_ms = [], []
    for lo in range(0, feats.shape[0], push):
        blocks = session._fe_blocks
        torch.cuda.synchronize()
        start = time.perf_counter()
        tokens += session.push(feats[lo : lo + push])
        torch.cuda.synchronize()
        if session._fe_blocks > blocks:
            push_ms.append(1e3 * (time.perf_counter() - start))
    tokens += session.flush()
    launches = sequential_routing_cuda.launches - before
    batch = padded_one(feats, rec.model)
    want = rec.forward(torch.from_numpy(batch).to(rec.device),
                       np.array([feats.shape[0]]))[0].cpu().numpy()
    t_ceil = -(-feats.shape[0] // session.div)
    got = session.logits
    check(got.shape[0] >= t_ceil and np.isfinite(got).all(),
          "%s: streamed logits" % label)
    err = float(np.abs(got[:t_ceil] - want[:t_ceil]).max())
    check(err <= atol, "%s: streamed logits differ from the batch forward "
          "by %.3e" % (label, err))
    check(tokens == greedy_ids(want, feats.shape[0] // session.div),
          "%s: streamed ids differ from the batch forward's" % label)
    return push_ms, session._fe_blocks, err, launches


def calibrate_blank(torch, rec, state):
    """A copy of ``state`` with the output LayerNorm's affine set so that
    silence (zero features) gives the blank and speech does not: random
    weights give nearly the same logits everywhere, so each class's
    logit becomes LONG_GAIN x its deviation from its value on a silent
    utterance, plus LONG_BLANK_MARGIN for the blank. On silence every
    deviation is ~0 and the blank wins; on speech the largest of 62
    amplified deviations wins."""
    silent = np.zeros((1, 512, 123), np.float32)
    logits = rec.forward(torch.from_numpy(silent).to(rec.device),
                         np.array([512]))[0].cpu().numpy().astype(np.float64)
    weight = state["ln_output.weight"].numpy().astype(np.float64)
    bias = state["ln_output.bias"].numpy().astype(np.float64)
    # the normalised value of each class on silence (the middle frames,
    # where the SDR carry has settled)
    z_silent = ((logits - bias) / weight)[32:96].mean(axis=0)
    new_weight = LONG_GAIN * weight
    new_bias = -new_weight * z_silent
    new_bias[rec.blank_id] += LONG_BLANK_MARGIN
    out = dict(state)
    out["ln_output.weight"] = torch.tensor(new_weight, dtype=torch.float32)
    out["ln_output.bias"] = torch.tensor(new_bias, dtype=torch.float32)
    return out


def long_recording():
    """~60 s: speech segments of LONG_SPEECH_S seconds (random fbank-123
    rows) with LONG_GAP_S of silence between them; returns (features,
    [(gap start, gap end) frames])."""
    rng = np.random.RandomState(SEED + 13)
    parts, gaps, at = [], [], 0
    for i, seconds in enumerate(LONG_SPEECH_S):
        if i:
            parts.append(np.zeros((100 * LONG_GAP_S, 123), np.float32))
            gaps.append((at, at + 100 * LONG_GAP_S))
            at += 100 * LONG_GAP_S
        parts.append(rng.randn(100 * seconds, 123).astype(np.float32))
        at += 100 * seconds
    return np.concatenate(parts), gaps


def stream_phase(torch, card, state):
    """Phase 12: streaming SRF-TIMIT on the card. Returns K1's launches on
    the streaming path and the readings."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops import routing
    from srf_tpu_torch.ops.ctc_beam import ctc_beam_search_batch
    from srf_tpu_torch.ops.ngram_lm import train_ngram
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.serve import Recognizer
    from srf_tpu_torch.streaming import StreamingTranscriber

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    rec = Recognizer(config, state_dict=state, logger=logger)
    carry_err, step_times = k1_carry_check(torch, rec.device, card)
    rng = np.random.RandomState(SEED + 12)
    utts = [rng.randn(n, 123).astype(np.float32) for n in STREAM_FRAMES]

    # greedy sessions, one utterance each: the main path of streaming
    routing.sequential_routing_from_uhat.cuda_calls = 0
    sequential_routing_cuda.launches = 0
    push_ms, steps, errs, launches = [], 0, [], 0
    for n, feats in zip(STREAM_FRAMES, utts):
        ms, blocks, err, count = stream_and_check(torch, rec, feats,
                                                  "stream %d frames" % n)
        push_ms += ms
        steps += blocks
        errs.append(err)
        launches += count
    plain_loops = routing.sequential_routing_from_uhat.cuda_calls
    check(launches == 7 * K1_LAUNCHES * steps,
          "streaming: K1 launched %d times over %d steps, expected %d"
          % (launches, steps, 7 * K1_LAUNCHES * steps))
    check(plain_loops == 0, "streaming ran the plain SDR loop %d times on "
          "the card" % plain_loops)
    audio_s = 0.01 * sum(STREAM_FRAMES)
    steady = push_ms[1:]
    print("stream SRF-TIMIT chunk %d: %d utterances (%s frames), %d steps, "
          "K1 launches %d (%d a step), plain SDR loops on the card %d; "
          "logits vs batch forward max %.3e (atol %.0e), ids equal" % (
              STREAM_CHUNK, len(utts), STREAM_FRAMES, steps, launches,
              launches // steps, plain_loops, max(errs), LOGIT_ATOL))
    print("stream push (%d raw frames, one step): first %.3f ms, median "
          "%.3f ms, p95 %.3f ms over %d pushes; RTF %.4f (%.3f s of pushes "
          "for %.2f s of audio) [%s]" % (
              STREAM_CHUNK * 4, push_ms[0], float(np.median(steady)),
              float(np.percentile(steady, 95)), len(push_ms),
              1e-3 * sum(push_ms) / audio_s, 1e-3 * sum(push_ms), audio_s,
              card))

    # the streamed beam with phase 6c's toy LM against the offline device
    # beam on the same logits
    lm = (train_ngram([lab for _, lab in test_split_data().values()], 62,
                      LM_ORDER), 0.5, 0.5)
    beam_ms = []
    for n, feats in zip(STREAM_FRAMES[:2], utts[:2]):
        session = StreamingTranscriber(rec.model, rec.blank_id,
                                       chunk=STREAM_CHUNK,
                                       beam_width=STREAM_BEAM, lm=lm)
        start = time.perf_counter()
        for lo in range(0, n, STREAM_CHUNK * 4):
            session.push(feats[lo : lo + STREAM_CHUNK * 4])
        ids, score = session.flush()
        torch.cuda.synchronize()
        beam_ms.append(1e3 * (time.perf_counter() - start))
        t_dec = n // 4
        logits = torch.from_numpy(session.logits[None, :t_dec]).to(rec.device)
        (want_ids, want_score), = ctc_beam_search_batch(
            logits, [t_dec], STREAM_BEAM, rec.blank_id, lm=lm)
        check(ids == want_ids and abs(score - want_score) <= BEAM_SCORE_ATOL,
              "streamed beam differs from the offline beam at %d frames" % n)
    print("stream beam %d with the toy 3-gram: = the offline device beam on "
          "the same logits (ids, score within %.0e) at %s frames; %.1f / "
          "%.1f ms a whole stream [%s]" % (STREAM_BEAM, BEAM_SCORE_ATOL,
                                          STREAM_FRAMES[:2], *beam_ms, card))

    # the pool: 4 slots = 4 single sessions; tick times at 4 and 16 slots
    singles = []
    for feats in utts:
        session = rec.streaming_session(chunk=STREAM_CHUNK)
        singles.append(session.push(feats) + session.flush())
    tick_ms = {}
    for slots in POOL_SLOTS:
        pool = rec.streaming_pool(slots, chunk=STREAM_CHUNK)
        streams = [utts[i % len(utts)] for i in range(slots)]
        tokens = [[] for _ in range(slots)]
        at, ticks = 0, []
        while any(at < s.shape[0] for s in streams):
            for slot, feats in enumerate(streams):
                if at < feats.shape[0]:
                    pool.push(slot, feats[at : at + 4 * STREAM_CHUNK])
            at += 4 * STREAM_CHUNK
            torch.cuda.synchronize()
            start = time.perf_counter()
            got = pool.step()
            torch.cuda.synchronize()
            if len(got) == slots:
                ticks.append(1e3 * (time.perf_counter() - start))
            for slot, new in got.items():
                tokens[slot] += new
        for slot in range(slots):
            tokens[slot] += pool.flush(slot)
        check(tokens == [singles[i % len(utts)] for i in range(slots)],
              "a %d-slot pool differs from single sessions" % slots)
        tick_ms[slots] = float(np.median(ticks[1:]))
    print("stream pool: = single sessions at %s slots; median full tick %s "
          "ms [%s]" % (POOL_SLOTS, ", ".join("%.3f (%d slots)" % (ms, n)
                                              for n, ms in tick_ms.items()),
                      card))

    # long-form: one segment between each two silent gaps, as on the CPU
    long_state = calibrate_blank(torch, rec, state)
    long_rec = Recognizer(config, state_dict=long_state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=long_state, device="cpu",
                         logger=logger)
    feats, gaps = long_recording()
    start = time.perf_counter()
    segments = long_rec.transcribe_long(feats)
    long_ms = 1e3 * (time.perf_counter() - start)
    cpu_segments = cpu_rec.transcribe_long(feats)
    check([s["ids"] for s in segments] == [s["ids"] for s in cpu_segments]
          and [s["end_s"] for s in segments]
          == [s["end_s"] for s in cpu_segments],
          "transcribe_long: card and CPU segments differ")
    check(len(segments) == len(gaps) + 1,
          "transcribe_long: %d segments for %d gaps" % (len(segments),
                                                         len(gaps)))
    for seg, (lo, hi) in zip(segments, gaps):
        check(lo / 100.0 <= seg["end_s"] <= hi / 100.0,
              "transcribe_long: a segment ends at %.2f s, outside the gap "
              "%.2f-%.2f s" % (seg["end_s"], lo / 100.0, hi / 100.0))
    print("stream long-form %.1f s, %d gaps: %d segments, each closed in "
          "its gap (%s s), = the CPU's; %.1f ms (RTF %.4f) [%s]" % (
              feats.shape[0] / 100.0, len(gaps), len(segments),
              ", ".join("%.2f" % s["end_s"] for s in segments[:-1]),
              long_ms, 1e-3 * long_ms / (feats.shape[0] / 100.0), card))
    print("stream phase: %.1f s" % (time.perf_counter() - phase_start))
    return launches, {"carry_max_abs_err": carry_err, "steps": steps,
                      "step_ms": step_times["ms"],
                      "step_plain_ms": step_times["plain_ms"],
                      "step_bound_ms": step_times["bound_ms"],
                      "push_median_ms": float(np.median(steady))}


def wsj_phase(torch, card):
    """Phase 12b: the whole SRF-WSJ model served and streamed on the card,
    its serving rows held to the CPU's. Returns K1's launches per forward."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.serve import Recognizer

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "wsj", SRF_WSJ_FLAGS)
    classes = class_count(config)
    state = random_weights(build_model(config, classes)[0])
    rec = Recognizer(config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=state, device="cpu",
                         logger=logger)
    batches = wsj_serve_batches()
    feats_list = batches["8x300-1600"]
    longest = int(np.argmax([f.shape[0] for f in feats_list]))
    feats_list[longest] = batches["1x1600"][0]
    feats, lengths = rec.pad(feats_list)
    check(feats.shape[1] == 1664, "WSJ batch padded to %d" % feats.shape[1])
    rec.transcribe_batch_detailed(feats_list)  # warm-up (cuDNN's search)
    torch.cuda.synchronize()
    before = sequential_routing_cuda.launches
    torch.cuda.reset_peak_memory_stats()
    got = rec.transcribe_batch_detailed(feats_list)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_forward = sequential_routing_cuda.launches - before
    check(per_forward == 10 * K1_LAUNCHES, "SRF-WSJ: K1 launched %d times "
          "in one forward, expected %d" % (per_forward, 10 * K1_LAUNCHES))
    check_served("SRF-WSJ", got, feats_list, rec.in_len_div,
                 blank=classes - 1)
    card_logits = rec.forward(feats, lengths).cpu()
    rows = [longest] + [i for i in range(len(feats_list))
                        if i != longest][: WSJ_CPU_ROWS - 1]
    cpu_logits = cpu_rec.forward(feats[rows].cpu(), lengths[rows])
    err = (card_logits[rows] - cpu_logits).abs().max().item()
    check(err <= LOGIT_ATOL, "SRF-WSJ: card logits differ from the CPU's "
          "by %.3e" % err)
    cpu_ids = [greedy_ids(cpu_logits[k].numpy(), int(lengths[i]) // 4)
               for k, i in enumerate(rows)]
    check([got[i]["ids"] for i in rows] == cpu_ids,
          "SRF-WSJ: card ids differ from the CPU's")
    fwd_ms = timed_ms(torch, lambda: rec.forward(feats, lengths), 5)
    print("SRF-WSJ serve 8 x 300-1600 (padded %s): K1 %d launches a "
          "forward, rows %s = the CPU's (logits max %.3e, atol %.0e; ids "
          "equal); forward median %.3f ms (max %.3f), peak memory %.1f MB "
          "[%s]" % (tuple(feats.shape), per_forward, rows, err, LOGIT_ATOL,
                    float(np.median(fwd_ms)), max(fwd_ms), peak / 2**20,
                    card))
    push_ms, steps, serr, count = stream_and_check(
        torch, rec, feats_list[longest], "SRF-WSJ stream 1600 frames")
    check(count == 10 * K1_LAUNCHES * steps, "SRF-WSJ stream: K1 launched "
          "%d times over %d steps" % (count, steps))
    print("SRF-WSJ stream 1600 frames chunk %d: %d steps, K1 %d launches, "
          "logits vs batch forward max %.3e, ids equal; push median %.3f "
          "ms; %.1f s" % (STREAM_CHUNK, steps, count, serr,
                          float(np.median(push_ms[1:])),
                          time.perf_counter() - phase_start))
    return per_forward


def daemon_argv(ckpt, *extra):
    return ["--config=%s" % os.path.join(REPO, "egs", "conf", "timit.conf"),
            "--path-base=%s" % REPO, "--path-ckpt=%s" % ckpt, *TIMIT_FLAGS,
            *extra]


def start_daemon(torch, args):
    """``python -m srf_tpu_torch.serve_daemon`` with ``args`` on port 0 and
    its HTTP gateway on port 0; returns (process, TCP port, HTTP port)
    once it logs that it serves."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "srf_tpu_torch.serve_daemon", *args,
         "--daemon-port=0", "--daemon-http-port=0"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    ports, lines = {}, []
    deadline = time.monotonic() + DAEMON_TIMEOUT
    while "tcp" not in ports and time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        found = re.search(r"HTTP gateway on [\d.]+:(\d+)", line)
        if found:
            ports["http"] = int(found.group(1))
        found = re.search(r"serving \d+ model\(s\).* on [\d.]+:(\d+)", line)
        if found:
            ports["tcp"] = int(found.group(1))
    if "tcp" not in ports:
        proc.kill()
        proc.wait(timeout=60)
        raise SmokeFailure("the daemon did not start:\n%s"
                           % "".join(lines[-30:]))
    # drain its log so that it never blocks on a full pipe
    import threading

    threading.Thread(target=lambda: [None for _ in proc.stderr],
                     daemon=True).start()
    return proc, ports["tcp"], ports.get("http")


def stop_daemon(proc):
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)


def daemon_phase(torch, card, state):
    """Phase 13: the serving daemon through its CLI on the card, in a
    subprocess. Returns the daemon's K1 launches (from its stats)."""
    import concurrent.futures
    import http.client
    import shutil
    import tempfile

    from srf_tpu_torch import serve_daemon as sd
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.serve import Recognizer

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    rec = Recognizer(config, state_dict=state, logger=logger)
    base = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    rng = np.random.RandomState(SEED + 14)
    try:
        for name, weights in (("a", state), ("b", {
                k: v + 0.05 if v.is_floating_point() else v
                for k, v in state.items()})):
            os.makedirs(os.path.join(base, name))
            torch.save(weights, os.path.join(base, name, "model.pt"))
        spec = os.path.join(base, "fleet.json")
        with open(spec, "w") as f:
            json.dump({"default": "a", "models": {
                name: {"args": ["--path-ckpt=%s" % os.path.join(base, name)]}
                for name in ("a", "b")}}, f)
        proc, port, http_port = start_daemon(torch, daemon_argv(
            os.path.join(base, "a"), "--daemon-fleet=%s" % spec,
            "--daemon-max-batch=%d" % DAEMON_BATCH,
            "--daemon-max-wait-ms=10", "--daemon-stream-slots=2"))
        try:
            readings = daemon_requests(torch, card, sd, rec, port, rng)
            # HTTP: two requests and the health snapshot
            conn = http.client.HTTPConnection("127.0.0.1", http_port,
                                              timeout=DAEMON_TIMEOUT)
            feats = rng.randn(200, 123).astype(np.float32)
            want = sd._response_body(rec.transcribe_batch_detailed(
                [feats] + [np.zeros((16, 123), np.float32)]
                * (DAEMON_BATCH - 1))[0])
            for _ in range(2):
                conn.request("POST", "/v1/transcribe",
                             body=json.dumps({"feats": feats.tolist()}),
                             headers={"Content-Type": "application/json"})
                body = json.loads(conn.getresponse().read())
                check(body["ids"] == want["ids"]
                      and abs(body["score"] - want["score"]) <= 1e-4,
                      "HTTP reply differs from the in-process Recognizer")
            conn.request("GET", "/v1/health")
            health = json.loads(conn.getresponse().read())
            conn.close()
            check(health["status"] == "ok", "HTTP health")
            # two live streams over TCP = in-process sessions
            utts = [rng.randn(n, 123).astype(np.float32) for n in (333, 517)]
            sids = [sd.stream_open("127.0.0.1", port,
                                   timeout=DAEMON_TIMEOUT) for _ in utts]
            got = [[], []]
            for lo in range(0, 517, 50):
                for k, (sid, feats) in enumerate(zip(sids, utts)):
                    if lo < feats.shape[0]:
                        got[k] += sd.stream_push(
                            "127.0.0.1", port, sid, feats[lo : lo + 50],
                            timeout=DAEMON_TIMEOUT)[0]
            for k, (sid, feats) in enumerate(zip(sids, utts)):
                got[k] += sd.stream_flush("127.0.0.1", port, sid,
                                          timeout=DAEMON_TIMEOUT)["ids"]
                session = rec.streaming_session()
                check(got[k] == session.push(feats) + session.flush(),
                      "a TCP stream differs from the in-process session")
            # the fleet's other model
            other = Recognizer(config, state_dict=torch.load(
                os.path.join(base, "b", "model.pt")), logger=logger)
            feats = rng.randn(180, 123).astype(np.float32)
            ids, _ = sd.request("127.0.0.1", port, feats, model="b",
                                timeout=DAEMON_TIMEOUT)
            want_b = other.transcribe_batch_detailed(
                [feats] + [np.zeros((16, 123), np.float32)]
                * (DAEMON_BATCH - 1))[0]["ids"]
            check(ids == want_b, "fleet model b's reply differs")
            stats = sd.stats_request("127.0.0.1", port,
                                     timeout=DAEMON_TIMEOUT)
        finally:
            stop_daemon(proc)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    launches = stats["sdr_fwd_launches"]
    check(launches > 0 and launches % (7 * K1_LAUNCHES) == 0,
          "the daemon's K1 launches: %d" % launches)
    print("daemon: HTTP 2 requests and /health = in-process; 2 TCP streams "
          "= in-process sessions; fleet model b = its Recognizer; stats: "
          "%d requests in %d batches (mean %.2f), K1 launches %d (its own "
          "count, from the daemon's stats); %.1f s" % (
              stats["models"]["a"]["requests"],
              stats["models"]["a"]["batches"],
              stats["models"]["a"]["mean_batch"], launches,
              time.perf_counter() - phase_start))
    return launches, readings


def daemon_requests(torch, card, sd, rec, port, rng):
    """Phase 13's TCP load: first requests at widths 256 and 384 (cuDNN's
    search at each new width), then DAEMON_REQUESTS requests from
    DAEMON_THREADS threads, each reply held to the in-process Recognizer's
    batch of that utterance and DAEMON_BATCH - 1 dummies."""
    import concurrent.futures

    stall = {}
    for frames in (200, 300):
        feats = rng.randn(frames, 123).astype(np.float32)
        start = time.perf_counter()
        sd.request("127.0.0.1", port, feats, timeout=DAEMON_TIMEOUT)
        stall[-(-frames // 128) * 128] = 1e3 * (time.perf_counter() - start)
    utts = [rng.randn(n, 123).astype(np.float32) for n in rng.randint(
        DAEMON_FRAMES[0], DAEMON_FRAMES[1] + 1, size=DAEMON_REQUESTS)]
    latency = [None] * len(utts)

    def one(i):
        start = time.perf_counter()
        body = sd.request("127.0.0.1", port, utts[i], detailed=True,
                          timeout=DAEMON_TIMEOUT)
        latency[i] = 1e3 * (time.perf_counter() - start)
        return body

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(DAEMON_THREADS) as pool:
        replies = list(pool.map(one, range(len(utts))))
    wall = time.perf_counter() - start
    dummy = np.zeros((16, 123), np.float32)
    for feats, body in zip(utts, replies):
        want = rec.transcribe_batch_detailed(
            [feats] + [dummy] * (DAEMON_BATCH - 1))[0]
        check(body["ids"] == want["ids"], "a daemon reply's ids differ from "
              "the in-process Recognizer's")
        check(abs(body["score"] - want["score"]) <= 1e-4,
              "a daemon reply's score differs by %.3e"
              % abs(body["score"] - want["score"]))
    print("daemon TCP: %d requests from %d threads in %.3f s (%.1f "
          "requests/s), latency p50 %.1f ms p95 %.1f ms; ids = in-process, "
          "scores within 1e-4; first request at width %s: %s ms [%s]" % (
              len(utts), DAEMON_THREADS, wall, len(utts) / wall,
              float(np.median(latency)), float(np.percentile(latency, 95)),
              "/".join(str(w) for w in stall),
              " / ".join("%.1f" % ms for ms in stall.values()), card))
    return {"requests_per_s": len(utts) / wall, "stall_ms": stall}


def write_wav(path, seconds, seed):
    """A synthetic 16 kHz 16-bit mono wav: a tone and noise."""
    import wave

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    signal = 3000 * np.sin(2 * np.pi * 300 * t) + 300 * rng.randn(t.size)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(signal.astype(np.int16).tobytes())


def serving_extras_phase(torch, card, state):
    """Phase 14: --wav through the CLI, int8 weights and forced alignment,
    each on the card against --feats or the CPU. Returns K1's launches."""
    import shutil
    import tempfile

    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.data.features import apply_cmvn, cmvn_stats
    from srf_tpu_torch.ops.quant import quantized_bytes
    from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
    from srf_tpu_torch.serve import Recognizer
    from srf_tpu_torch.tools import align, extract_features

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    base = tempfile.mkdtemp(prefix="chip_smoke_extras_")
    try:
        torch.save(state, os.path.join(base, "model.pt"))
        wav = os.path.join(base, "utt.wav")
        write_wav(wav, WAV_SECONDS, SEED + 15)
        with open(os.path.join(base, "wav.scp"), "w") as f:
            f.write("utt %s\n" % wav)
        extract_features.main([os.path.join(base, "wav.scp"),
                               os.path.join(base, "feats")])
        feats = np.load(os.path.join(base, "feats", "utt.npy"))
        feats = apply_cmvn(feats, *cmvn_stats([feats])).astype(np.float32)
        npy = os.path.join(base, "utt.npy")
        np.save(npy, feats)
        out = subprocess.run(
            [sys.executable, "-m", "srf_tpu_torch.serve",
             *daemon_argv(base), "--feats", npy, "--wav", wav],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, "serve --wav failed:\n%s"
              % out.stderr[-3000:])
        lines = out.stdout.strip().splitlines()
        check(len(lines) == 2 and lines[0].endswith("(%s)" % npy)
              and lines[1].endswith("(%s)" % wav)
              and lines[0].rsplit(" (", 1)[0] == lines[1].rsplit(" (", 1)[0],
              "serve --wav printed other text than --feats: %s" % lines)
        print("serve --wav (%.1f s, %d frames): the same text as --feats on "
              "extract_features' output, through the CLI on the card"
              % (WAV_SECONDS, feats.shape[0]))
    finally:
        shutil.rmtree(base, ignore_errors=True)

    # int8 weights: card against CPU, and against float32
    config = timit_config(logger, "cuda", TIMIT_FLAGS
                          + ["--tpu-serve-quant=int8"])
    rec = Recognizer(config, state_dict=state, logger=logger)
    cpu = Recognizer(config, state_dict=state, device="cpu", logger=logger)
    f32 = Recognizer(timit_config(logger, "cuda"), state_dict=state,
                     logger=logger)
    feats_list = serve_batches()["8x150-400"]
    sequential_routing_cuda.launches = 0
    got = rec.transcribe_batch_detailed(feats_list)
    launches = sequential_routing_cuda.launches
    check(launches == 7 * K1_LAUNCHES, "int8: K1 launched %d times" % launches)
    check([r["ids"] for r in got]
          == [r["ids"] for r in cpu.transcribe_batch_detailed(feats_list)],
          "int8: card ids differ from the CPU's")
    feats, lengths = rec.pad(feats_list)
    card_logits = rec.forward(feats, lengths).cpu()
    err = (card_logits - cpu.forward(feats.cpu(), lengths)).abs().max().item()
    check(err <= LOGIT_ATOL, "int8: card logits differ from the CPU's by "
          "%.3e" % err)
    gap = (card_logits - f32.forward(feats, lengths).cpu()).abs().max().item()
    q_bytes, f_bytes = quantized_bytes(rec.model)
    fwd_ms = timed_ms(torch, lambda: rec.forward(feats, lengths), 10)
    f32_ms = timed_ms(torch, lambda: f32.forward(feats, lengths), 10)
    print("int8 serve 8 x 150-400: card = CPU (logits max %.3e, atol %.0e; "
          "ids equal); resident weights %d bytes int8 + scales against %d "
          "float32 (%.3f); int8 - f32 logits max %.3e (a reading); forward "
          "median %.3f ms int8, %.3f ms f32 [%s]" % (
              err, LOGIT_ATOL, q_bytes, f_bytes, q_bytes / f_bytes, gap,
              float(np.median(fwd_ms)), float(np.median(f32_ms)), card))

    # forced alignment: card against CPU
    rng = np.random.RandomState(SEED + 16)
    utts = [("u%d" % i, rng.randn(n, 123).astype(np.float32),
             " ".join(f32.vocab[j] for j in rng.randint(1, 62, size=n // 12)))
            for i, n in enumerate(rng.randint(150, 401, size=ALIGN_UTTS))]
    align_config = timit_config(logger, "cuda", TIMIT_FLAGS
                                + ["--prep-data-unit=phone"])
    card_rec = Recognizer(align_config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(align_config, state_dict=state, device="cpu",
                         logger=logger)
    start = time.perf_counter()
    card_out = align.align_utts(card_rec, utts, batch=ALIGN_UTTS)
    torch.cuda.synchronize()
    align_ms = 1e3 * (time.perf_counter() - start)
    cpu_out = align.align_utts(cpu_rec, utts, batch=ALIGN_UTTS)
    score_err = 0.0
    for (u, spans, score), (_, cpu_spans, cpu_score) in zip(card_out,
                                                             cpu_out):
        check(spans is not None and spans == cpu_spans,
              "alignment of %s: card spans differ from the CPU's" % u)
        score_err = max(score_err, abs(score - cpu_score))
    check(score_err <= 1e-4, "alignment scores differ by %.3e" % score_err)
    print("align %d utterances: card spans = CPU spans, scores within %.3e "
          "(limit 1e-4); %.1f ms on the card; %.1f s" % (
              ALIGN_UTTS, score_err, align_ms,
              time.perf_counter() - phase_start))
    return launches


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "srf_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build

    card = card_line()
    print("card: %s" % card)
    device = resolve_device("cuda")
    torch.cuda.synchronize()

    start = time.perf_counter()
    paths = cuda_build.build(["sdr_fwd", "sdr_bwd", "sdr_scan_fwd",
                              "sdr_scan_bwd", "fused_dropout"])
    print("build: %.2f s" % (time.perf_counter() - start))
    spilled = []
    for name, path in paths.items():
        with open(path + ".log") as log:
            entries = ptxas_entries(log.read())
        for kernel, (registers, spill) in sorted(entries.items()):
            print("build %s: %s %d registers, %d bytes spilled"
                  % (name, kernel, registers, spill))
            if spill and kernel.startswith(RECURRENCE_KERNELS):
                spilled.append(kernel)
    check(not spilled, "ptxas spills %s" % ", ".join(spilled))

    k1, k3 = kernel_phase(torch, device)
    k2, k4 = k2_phase(torch, device)
    k5 = k5_phase(torch, device)
    serve_k1, state = main_path_phase(torch, card)
    scan_k3, scan_k4, scan_times = scan_path_phase(torch, card, state)
    check(scan_k3 > 0 and scan_k4 > 0,
          "K3 or K4 was not launched on the scan path")
    decode_k1 = decode_phase(torch, card, state)
    check(decode_k1 > 0, "K1 was not launched on the decode path")
    (train_k1, train_k2), direct_ms = train_phase(torch, card, state)
    check(serve_k1 > 0, "K1 was not launched on the serving path")
    check(train_k1 > 0 and train_k2 > 0,
          "K1 or K2 was not launched on the training path")
    recipe_k1, recipe_k2 = recipe_train_phase(torch, card, state, direct_ms)
    check(recipe_k1 > 0 and recipe_k2 > 0,
          "K1 or K2 was not launched on the recipe's training path")
    serve_k5, cnn_state = cnn_serve_phase(torch, card)
    train_k5 = cnn_train_phase(torch, card, cnn_state)
    check(train_k5 > 0, "K5 was not launched on the CNN training path")
    stf_phase(torch, card)
    lstm_phase(torch, card)
    stream_k1, stream_readings = stream_phase(torch, card, state)
    check(stream_k1 > 0, "K1 was not launched on the streaming path")
    wsj_k1 = wsj_phase(torch, card)
    daemon_k1, daemon_readings = daemon_phase(torch, card, state)
    int8_k1 = serving_extras_phase(torch, card, state)
    # the daemon's launches are counted in its own process (its stats),
    # the rest in this one
    k1["launches_by_path"] = {"serve": serve_k1, "decode": decode_k1,
                              "train": train_k1, "recipe": recipe_k1,
                              "stream": stream_k1, "wsj_serve": wsj_k1,
                              "int8_serve": int8_k1, "daemon": daemon_k1}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            stream_readings["carry_max_abs_err"])
    k1["stream"] = dict(stream_readings, launches_per_step=7 * K1_LAUNCHES)
    k1["daemon"] = daemon_readings
    k2["launches"] = train_k2 + recipe_k2
    k1["calls"] = k1["launches"] // K1_LAUNCHES
    k2["calls"] = k2["launches"] // K2_LAUNCHES
    k2["launches_by_path"] = {"train": train_k2, "recipe": recipe_k2}
    k3["launches"] = scan_k3
    k3["launches_by_path"] = {"scan": scan_k3}
    k3["stack_ms"] = {key: scan_times[key] for key in ("forward_ms",
                                                       "k1_forward_ms")}
    k4["launches"] = scan_k4
    k4["calls"] = scan_k4 // 2  # two kernels per call
    k4["launches_by_path"] = {"scan": scan_k4}
    k4["stack_ms"] = {key: scan_times[key] for key in ("backward_ms",
                                                       "k2_backward_ms")}
    k5["launches"] = serve_k5 + train_k5
    k5["launches_by_path"] = {"cnn_serve": serve_k5, "cnn_train": train_k5}

    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except SmokeFailure as failure:
        print("chip_smoke FAILED: %s" % failure, file=sys.stderr)
        code = 1
    sys.exit(code)
