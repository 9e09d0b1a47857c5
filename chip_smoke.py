#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (srf_tpu_torch), one GPU.

    python3 chip_smoke.py          # from the root of a checkout, no arguments
    python3 chip_smoke.py --cards  # phase 18 alone, on 2 cards or more

Imports nothing of JAX or srf_tpu. Phases (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ with nvcc (one process
   per source, all started together): K1, K2, K3, K4, K5, K1-tp, K2-tp;
   print ptxas's registers and spills per kernel, and fail if the
   recurrence kernel of K1 or K2, the cluster scan of K3 or K4, or the
   persistent kernel of K1-tp or K2-tp spills;
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
   K2 and K4 (K4 against K2 as well) at phase 3's EXTRA_LAYERS; K2 at
   the SRF-WSJ layers 1-8 (150, 30, 20, 20) at a training bucket's B=24,
   T'=248, with its parts' times, and at odd offsets (K2_LAYERS); K2 and
   K4 each bit-equal across two calls; K2's weight gradient and the
   prediction on their tiled paths at every recipe geometry
   (routing_cuda.wgrad_launches, predict_launches); the prediction alone
   at the SRF-WSJ layers 1-8 at B=24, T'=248 (PREDICT_LAYER), float32 and
   bf16, against predict_capsules_rows and timed against its byte bound;
   K2's and K4's times in turns, and the plain version's, at B=29, T'=61
   (the training path's shape), and K2's parts' times apart;
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
   times over every batch at batch 1 and at batch 8 (TIMING_PASSES
   passes), decode wall per utterance and the realtime factor, and a
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
   is two kernels and K2 four, so 14 K1 and 28 K2 launches; every weight
   gradient and prediction on its tiled path), with finite
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
   tools.save_tfrecord (the port's host library must load, its C++
   CRC-32C equal to the Python loop's on the written records, which read
   back with their CRCs verified; stage 0's seconds printed);
   trainer_sr.main with the recipe's flags at k 0.5
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
   every tensor on the card; ms/step, utt/s, peak memory and a profile
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
11b. the CNN-WSJ recipe's model (egs/script/torch/train_cnn_wsj.sh with
   wsj.conf: the stride variant, L=15, filters 200/430, 3 x 2048
   projections, stride 2, --model-conv-is-mp=False, 32 classes) with
   --tpu-dropout-kernel=pallas: its 36 K5 sites read off the model at 44
   x 541 (the input dropout, 2 a conv, 2 a projection, projv) and K5 held
   to its plain version with torch.equal at each site's size at rates 0.2
   and the recipe's inner rate, with per site the kernel's, the plain
   version's and F.dropout's times beside the bound; phase 11's two WSJ
   batches served on the card (K5 0 launches), the CPU decoding 2
   utterances of each (ids and text equal, logits at valid frames within
   CNN_LOGIT_ATOL); one pallas-mode step with dropout on at every K5 site
   on card and CPU at CNN_WSJ_CHECK_ROWS rows of 541 frames (the front
   end's own dropout off), held as phase 9 holds CNN-TIMIT at the Noam
   peak (count 25000); 1 + TRAIN_STEPS steps over the three 24000-frame
   buckets (44 x 541, 24 x 991, 15 x 1591), each launching K5 exactly 72
   times, with finite losses and every tensor on the card: the first step
   per bucket (cuDNN's search) apart, the median step, peak memory and a
   primed profile (K5, convolutions, the rest, idle share); then the
   recipe through the CLIs on synthetic TFRecords (44 x 541 and 24 x 991
   filled once in train and valid): trainer_sr at k 0.5 to epoch 1, at k
   0.1 to epoch 2 (72 K5 launches a train step), average_ckpt, decode
   with the device beam at width 100 and log2utt --corpus wsj over the 8
   x 300-1600 batch's utterances;
11c. the STF-WSJ recipe's model (train_stf_wsj.sh with wsj.conf: L=20,
   D=256, 4 heads, FF 1488, dropouts 0.3/0.4/0.3/0.4, penalty (1, 1, 1))
   as phase 10 runs STF-TIMIT: the two WSJ batches served on card and
   CPU (STF_LOGIT_ATOL; no padding bias or penalty), one dropout-free
   step with trainer_tf's padding bias and penalty board held to the
   CPU's at the Noam peak (count 25000), 1 + TRAIN_STEPS steps over the
   three WSJ buckets (dropout on) with peak memory and a primed profile,
   and trainer_tf at k 1.5, then 0.5, average_ckpt, decode at beam 100
   and log2utt over the same corpus. Phase 11b must leave K1-K4's
   counters where it found them, 11c K1-K5's;
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
12c. the SRF-WSJ model's train step (layered, dropout off) on the card:
   one step on 2 of 8 utterances of 300-1600 frames held to the CPU's as
   in 7 (gradients within WSJ_GRAD_ATOL_REL, set by chip_wsj_numerics.py),
   then the 8-utterance step (padded 1600) with 20 K1 and 40 K2 launches
   (its 10 weight gradients and 20 predictions on their tiled paths),
   timed, with its peak memory;
12d. --tpu-routing-kernel=wavefront (ops/routing.wavefront_sdr_stack, the
   whole capsule stack as one loop over time in plain PyTorch, as JAX runs
   it in XLA ops) at full width: SRF-TIMIT with phase 6's weights serving
   29 x 241 (ids equal to the layered path's, logits within LOGIT_ATOL of
   its and of the CPU wavefront's first rows), a dropout-free step held to
   the layered step on the card as 7 holds the CPU's, forward and step
   times beside the layered path's, peak memory with remat on and off, a
   profile of the forward; SRF-WSJ's 8 x 1664 forward against the layered
   one (LOGIT_ATOL), time and peak memory; the wavefront launches K1 and K2
   0 times and runs no plain SDR loop; with one capsule layer it is that
   layer's SDR, one K1 call, equal to the layered path;
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
   logits' distance from float32; the same for phase 11's LSTM-WSJ model
   and weights on its two batches (ids equal, logits within
   LSTM_LOGIT_ATOL), its int8 and float32 forwards' times and what
   dequantizing every quantized weight once costs (each forward does);
   tools.align over 8 utterances on card and CPU (spans equal, scores
   within 1e-4);
15. the training extras and the bf16 variants of K1, K2 and K5: K1-bf16
   and K2-bf16 against their plain versions (``sequential_routing(...,
   bf16=True)`` and autograd through it) at SDR_SHAPES x TIMIT_LAYERS and
   EXTRA_LAYERS' wsj_layer0 and general (limits BF16_K1_ATOL_REL,
   BF16_K2_ATOL_REL of the largest entry; the mean distance a small share
   of the controls', BF16_K1_SHARE and BF16_K2_SHARE, on the same rows cut
   into 2-step sequences: the float32 recurrence on the same inputs and on
   the bf16 u_hat, and the float32 K2's gradients rounded to bf16; the
   prediction kernel's u_hat = ``predict_capsules_bf16``'s bit for bit),
   K1 and K2 at the accumulated
   steps' microbatch shapes, K5-bf16 bit for bit at the CNN's 25 sites with
   K5's mask, and the three variants' times, plain times and bounds; the
   SRF-TIMIT recipe through trainer_sr's CLI with --tpu-grad-accum=4
   --tpu-ema-decay=0.999 --tpu-specaug=True (2 epochs of 4 updates, each
   launching K1 14 x 4 and K2 28 x 4 times), tools.average_ckpt (the EMA
   averaged), a decode with --tpu-decode-ema (device beam) and the
   Recognizer serving the averaged EMA weights, card = CPU; an accumulated
   step (accum 4) held to the CPU's as phase 7 holds its step; 28 x 241 at
   accum 1 and 4 (ms/step, peak memory); SRF-TIMIT steps at 29 x 241 in
   float32, --tpu-bf16 (K1 and K2 in float32) and --tpu-bf16
   --tpu-routing-bf16 (K1-bf16 and K2-bf16, float32 K1/K2 0 times, no
   plain SDR loop), each loss within BF16_LOSS_RTOL of float32's and at
   least BF16_LOSS_GAP from it, and the float32 and bf16 steps' model
   FLOPs (utils/flops.py) and MFU against the H100's float32 and bf16
   peaks; the
   CNN-TIMIT step in float32 and --tpu-bf16 (K5-bf16 50 launches a step,
   K5 0); SRF-WSJ's forward at 8 x 1664 in float32 and bf16 routing (peak
   memory); 3 MWER updates at SRF-TIMIT width (B 8, n-best 4, beam 16),
   the n-best equal to the CPU's, each update's host n-best timed apart;
16. parallelism on torch.distributed (one card: NCCL refuses two ranks on
   one device, so the multi-rank paths run as 2 processes sharing cuda:0
   over gloo, which stages CUDA tensors through the host: their times are
   no scaling result): (a) NCCL at world size 1, here: the SRF-TIMIT
   data-parallel step at 29 x 241 and the FSDP step against the plain
   step on the same weights and batch, dropout off, at phase 7's limits
   (the distance printed); (b) 2 ranks (``chip_smoke.py --parallel-worker
   DIR``, the SRF_* variables, LOCAL_RANK 0): the DP step at 28 x 241
   global (14 rows a rank) against one process on the 28 rows at phase
   7's limits, BatchNorm statistics equal on both ranks, K1 14 and K2 28
   launches a rank; (c) FSDP on the 2 ranks held the same way, K1 seeing
   whole contiguous weights; (d) ring attention at STF-TIMIT width (B 8,
   4 heads, T' 600, depth 32) against blockwise on the card, values and
   gradients, with each one's peak memory; (e) a 2-stage pipelined
   STF-TIMIT step (20 blocks, 4 microbatches, B 8) against the sequential
   step; (f) trainer_sr's epoch on 2 ranks (``--parallel-cli DIR``: the
   gloo group started first, then the CLI's main) on a synthetic corpus,
   both ranks' valid losses equal, rank 0's checkpoint and metrics; every
   rank's step times and peak memory;
17. the 'model' mesh axis (the class capsules sharded over ranks, the
   routing softmax split across them): (a) in this process, the
   persistent K1-tp and K2-tp (csrc/sdr_tp.cu, one kernel a call that
   walks time and exchanges through flags in device memory) as a
   co-launch of every rank's shard on the card: one forward and backward
   at SRF-WSJ's last layer driven with the launch counts at 0, then each
   case held to the plain split version at K1's and K2's tolerances, at
   SRF-WSJ's last layer on 2 ranks (150 -> 16 of 32 capsules of dim 20,
   B 8, T' 400) and SRF-TIMIT's on 3 (90 -> 21 of 63 of dim 8, 29 x 61),
   1 and 2 iterations, with median times, plain times, bounds and the
   parts' device times, and the co-launch of one shard; then,
   as processes sharing cuda:0 over gloo like phase 16
   (``chip_smoke.py --model-axis-worker DIR``), where the transport is the
   host loop (their ranks share a card), the host loop's K1-tp and K2-tp
   against the plain split version at the same cases and ranks, the PAD
   capsule's owner and the others, with their median times with and
   without the exchange, plain times and bounds, and K2-tp's refusal of a
   two-iteration forward's stats, and, on 2 ranks, transport 2's set-up
   (CUDA IPC buffers: rank 1 reads rank 0's pattern through the mapping,
   both release them); (b) the SRF-WSJ train step at full width on a
   (data 1, model 2) mesh, phase 12c's weights and 8 x 1600 batch,
   dropout off, held to the one-process step on the card within phase
   12c's limits, the transport the host loop, K1 18, K2 36, K1-tp 801 and
   K2-tp 803 launches a rank (none persistent), ms a step, peak memory and
   the sharded layer's scratch beside the one process's; (c) with two
   cards or more only, the same step with its 2 ranks on cuda:0 and cuda:1
   under NCCL, the transport CUDA IPC (the persistent kernels, 2 and 4
   launches a rank, their wait bounded by the model group's timeout),
   held to the same limits, and 17a's worker checks on that transport;
   (a) also holds ROADMAP item 7c's kernels, at each case's one-iteration
   shape, on the co-launch and on the host loop over gloo: K1-tp-bf16 and
   K2-tp-bf16 (the BF instances on bf16 u, W and b) to the plain split
   bf16 version at K1-bf16's and K2-bf16's limits, and K1-tp-stream (each
   shard's carry before step 0, warm-up steps on every other row) to the
   plain split version with v_init and step_valid at K1's, v_last too,
   with median times, plain times and bounds; its co-launch drive runs
   each once more with the counts at 0; (d) item 7c's drives at the
   SRF-WSJ recipe's widths cut to 3 layers, 8 utterances of 300-400
   frames, 2 ranks over gloo (``--model-axis-7c-worker``): the
   bf16-routing step on (data 1, model 2) held to one process's bf16 step
   (201 K1-tp-bf16 and 203 K2-tp-bf16 launches a rank), the last layer's
   route_block with a carry and warm-up steps and a streamed utterance
   through the sharded model held to the unsharded model's (K1-tp-stream
   launched), and the sharded wavefront forward held to the unsharded
   wavefront;
18. (``--cards`` alone; the whole run prints "18: skipped") a rank a
   card over NCCL (two cards or more), the cards, their power limits and
   each pair's peer access printed, 4 ranks where the host has 4 cards,
   else 2, each on its own card (``--cards-worker`` /
   ``--cards-model-worker DIR``, or the
   trainers under ``torch.distributed.run``): (a) the SRF-TIMIT DP step
   at 28 x 241 global against one process at phase 7's limits, BatchNorm
   statistics equal on every rank, ms a step a rank and samples/s over
   the ranks against one process's, and the CNN-TIMIT DP step with
   dropout on at the K5 sites (50 launches a rank) against one process
   that runs every rank's rows with that rank's seed, at phase 9's
   limits; (b) the FSDP step against DP, K1 seeing whole contiguous
   weights, ms and peak memory a rank; (c) ring attention over the ranks
   against blockwise on one card; (d) the pipelined STF-TIMIT step at as
   many stages as ranks (and at 2 stages x 2 data shards on 4 cards),
   float64 to PIPE64_GRAD_REL and float32 at phase 7's limits, the
   bubble, ms and peak memory by stage; each rank's K1, K2 and K5 times
   on its own card; (e) trainer_sr's epoch under torchrun with
   --tpu-data-shard=example (valid losses and steps equal on every rank,
   K1 and K2 launches those of the steps), then with batch sharding and
   --tpu-async-ckpt, 2 epochs uninterrupted, a SIGTERM to rank 1 (every
   rank saves the same mid checkpoint and exits), that checkpoint
   resumed on 2 cards and on one process within JAX's elastic tolerance
   of the uninterrupted run (F26), trainer_tf's STF-TIMIT epoch, each
   epoch's wall against one process's; (f) the 'model' axis over CUDA IPC
   between cards: 17a's kernel checks and 17b's SRF-WSJ step at (data 1,
   model 2), the step at (2, 1) (the data split alone), item 7c's drives
   there (K1-tp-bf16, K2-tp-bf16,
   K1-tp-stream), and on 4 cards the step at (2, 2) and (1, 4) with the
   kernel checks at model 4 (8 of SRF-WSJ's 32 classes a rank), every
   status word read clean after each call; (g) a (data 1, model 2)
   SRF-WSJ epoch of 20 steps through the library API (wsj.conf's
   schedule warmed up over the epoch to par_step's rate) against one
   process's epoch: each step's loss, each trained parameter's change;
19. the profiler's line (every trace is primed with one-cycle kernels,
   since torch.profiler drops some of a trace's first device records: how
   many of those it lost, trace by trace), a "kernels" JSON line (K1, K2,
   K3, K4, K5 (with its CNN-WSJ paths and a CNN-WSJ step's sites), the variants K1-bf16, K2-bf16, K5-bf16, K1-tp and K2-tp's
   host loop, their persistent kernels, and K1-tp-bf16, K2-tp-bf16 and
   K1-tp-stream), then the card line, then the result line.
"""

import collections
import json
import math
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
# K2 alone, as (name, (in_n, out_n, out_d, in_d), PAD mask, W's std, B, T'):
# at the SRF-WSJ recipe's layers 1-8 (egs/script/train_srf_wsj.sh: 30
# capsules of dim 20 over a 2+1+2 window) at the 24 x 991 bucket's T' =
# 248, and at odd B * T', in_n and out_n, whose c and da leave ds at an
# odd offset unless the scratch aligns it (the weight gradient's tiled
# path bulk-copies its rows)
K2_LAYERS = (("wsj_layer1", (150, 30, 20, 20), False, 0.1, 24, 248),
             ("odd_offsets", (3, 5, 4, 4), True, 0.3, 3, 5))
# the prediction kernel alone at the SRF-WSJ recipe's layers 1-8, B x T' of
# the 24 x 991 bucket, float32 and bf16: timed against its byte bound (u,
# W and b read once, u_hat written once), which it must reach at least
# PREDICT_MIN_SHARE of (its tiled path measured 72 % on an H100; the kernel
# that read W and u from shared memory for each FMA, 33 %); its u_hat held
# to the plain predict_capsules_rows, float32 within RTOL and ATOL (the
# card's einsum sums the in entries in another order: measured up to 7.2e-7
# apart on an H100), bf16 bit for bit (measured so)
PREDICT_LAYER = ("wsj_layer1", (150, 30, 20, 20), 24, 248)
PREDICT_MIN_SHARE = 0.5
# the register path's softmax skips its max where every logit of a warp's
# rows is within this bound (csrc/sdr_stream.cuh kSafeLogit)
SAFE_LOGIT = 64.0
# kernel launches per call: K1 the prediction and the recurrence; K2 the
# prediction, the reverse-time recurrence, the weight gradient, the reduction
K1_LAUNCHES, K2_LAUNCHES = 2, 4
# K1's and K2's recurrence kernels and K3's and K4's cluster scans, which
# must not spill: their chain over time is what bounds them
RECURRENCE_KERNELS = ("sdr_fwd_kernel", "sdr_bwd_step_kernel",
                      "sdr_scan_fwd_kernel", "sdr_scan_bwd_kernel",
                      "sdr_tp_fwd_persistent_kernel",
                      "sdr_tp_bwd_persistent_kernel")
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


def synchronize(torch, device="cuda"):
    """Wait for the card (nothing on the CPU: phase 18's rehearsal)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_ms(torch, fn, reps, device="cuda"):
    """Host-clock ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronize (a request is done when its result is on the host)."""
    times = []
    for _ in range(reps):
        synchronize(torch, device)
        start = time.perf_counter()
        fn()
        synchronize(torch, device)
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


# a kernel's parts: (label, symbol, launches of the symbol a call)
K1_PARTS = (("prediction", "sdr_predict_kernel", 1),
            ("recurrence", "sdr_fwd_kernel", 1))
K2_PARTS = (("prediction", "sdr_predict_kernel", 1),
            ("reverse_time", "sdr_bwd_step_kernel", 1),
            ("weight_gradient", "sdr_bwd_wgrad_kernel", 1),
            ("reduction", "sdr_bwd_reduce_kernel", 1))
# traces parts_ms takes before it gives up on a complete one
PARTS_TRACES = 5
# torch.profiler on the card drops device records: in some process states
# the first ~11 of every trace (after phase 17, 9-15 traces of 20 lost
# some; in a fresh process 0-1 of 20), now and then one further in. A
# trace starts with this many one-cycle sleep kernels, which take the loss
# and are left out of every reading
PROFILER_PRIMING = 64
PRIMING_SYMBOL = "spin_kernel"
# the priming records each trace of this run lost
PRIMING_LOST = []


def prime_profiler(torch):
    """Inside a trace, before what it measures: PROFILER_PRIMING one-cycle
    sleep kernels, then a synchronize."""
    for _ in range(PROFILER_PRIMING):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def device_events(torch, prof):
    """A primed trace's device events without the priming's; records in
    PRIMING_LOST how many of the priming's it lost."""
    events, primed = [], 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if PRIMING_SYMBOL in evt.name:
            primed += 1
        else:
            events.append(evt)
    PRIMING_LOST.append(PROFILER_PRIMING - primed)
    return events


def parts_ms(torch, fn, parts, reps=5):
    """Device ms per call of each of a kernel's parts ((label, symbol,
    launches a call) triples), from torch.profiler over ``reps`` calls
    after a warm-up, the trace primed (``prime_profiler``). A trace that
    still holds fewer device events of a part than its launches (a lost
    event would read as a short part) is discarded and taken again, up to
    PARTS_TRACES traces; fails if none is complete. Returns ({label: ms},
    the traces discarded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for discarded in range(PARTS_TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime_profiler(torch)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = {label: 0.0 for label, _, _ in parts}
        seen = {label: 0 for label, _, _ in parts}
        for evt in device_events(torch, prof):
            for label, symbol, _ in parts:
                if symbol in evt.name:
                    ms[label] += (evt.time_range.end
                                  - evt.time_range.start) / 1e3
                    seen[label] += 1
        if all(seen[label] == reps * launches
               for label, _, launches in parts):
            return {label: ms[label] / reps for label in ms}, discarded
        print("parts_ms: a trace of %d calls holds %s device events of the "
              "parts, not %s; taken again"
              % (reps, seen, {label: reps * launches
                              for label, _, launches in parts}))
    check(False, "parts_ms: %d traces in a row lost device events of %s"
          % (PARTS_TRACES, [symbol for _, symbol, _ in parts]))


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
    k1_parts = dict.fromkeys((label for label, _, _ in K1_PARTS), 0.0)
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
            parts, _ = parts_ms(torch, lambda: sequential_routing_cuda(
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


def prediction_check(torch, device, rng):
    """Phase 4's prediction kernel alone at PREDICT_LAYER, float32 and
    bf16 (the path K1-tp's first launch takes): its u_hat against the
    plain predict_capsules_rows (float32 within RTOL and ATOL, bf16 bit for
    bit), two calls bit-equal, and its time against its byte bound, which
    it must reach PREDICT_MIN_SHARE of; returns the readings."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing import predict_capsules_rows

    name, (in_n, out_n, out_d, in_d), batch, seq_len = PREDICT_LAYER
    fwd = routing_cuda._tp_libs()[1]
    stream = torch.cuda.current_stream(device).cuda_stream
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        w, b, u = (torch.tensor(rng.randn(*shape) * std, dtype=torch.float32,
                                device=device).to(dtype)
                   for shape, std in (((in_n, out_n, out_d, in_d), 0.1),
                                      ((in_n, out_n, out_d), 0.1),
                                      ((batch, seq_len, in_n, in_d), 1.0)))
        label = "%s %s" % (name, str(dtype).replace("torch.", ""))
        before = dict(routing_cuda.predict_launches)
        got = routing_cuda._predict_rows(fwd, u, w, b, stream)
        again = routing_cuda._predict_rows(fwd, u, w, b, stream)
        torch.cuda.synchronize()
        check(routing_cuda.predict_launches == dict(
            before, tiled=before["tiled"] + 2),
            "the prediction left its tiled path at %s: %s"
            % (label, routing_cuda.predict_launches))
        check(torch.equal(got, again), "the prediction is not bit-equal "
              "across two calls at %s" % label)
        want = predict_capsules_rows(u, w, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  "the bf16 prediction is %.3e from predict_capsules_rows at "
                  "%s, not bit-equal" % (err, label))
        else:
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  "the prediction is %.3e from predict_capsules_rows at %s"
                  % (err, label))
        ms = event_ms(torch, lambda: routing_cuda._predict_rows(
            fwd, u, w, b, stream), 20)
        esize = got.element_size()
        nbytes = esize * (got.numel() + u.numel() + w.numel() + b.numel())
        bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
        share = bound_ms / ms
        print("prediction %s (%d, %d, %d, %d) B=%d T=%d: %.4f ms, byte bound "
              "%.4f ms (%.1f %%); max |kernel - plain| %.3e%s"
              % (label, in_n, out_n, out_d, in_d, batch, seq_len, ms,
                 bound_ms, 100 * share, err,
                 " (bit-equal)" if err == 0 else ""))
        if dtype == torch.float32:
            check(share >= PREDICT_MIN_SHARE, "the prediction at %s reaches "
                  "%.1f %% of its byte bound, under %.0f %%"
                  % (label, 100 * share, 100 * PREDICT_MIN_SHARE))
        readings[label] = {"ms": ms, "bound_ms": bound_ms,
                           "max_abs_err": err}
        del u, w, b, got, again, want
    return readings


def k2_phase(torch, device):
    """Phase 4: K2 and K4 against their plain version, K4 against K2 on the
    same CUDA tensors, each bit-equal across two calls; returns their JSON
    entries."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing import sequential_routing_bwd
    from srf_tpu_torch.ops.routing_cuda import (
        scan_plan, sequential_routing_bwd_cuda, sequential_routing_cuda,
        sequential_routing_scan_bwd_cuda)

    rng = np.random.RandomState(SEED + 2)
    paths = dict(routing_cuda.wgrad_launches)
    predict_paths = dict(routing_cuda.predict_launches)
    max_err = {"K2": 0.0, "K4": 0.0, "K4 vs K2": 0.0}
    per_layer = {"K2": [], "K4": []}
    totals = {"K2": sdr_totals(), "K4": sdr_totals()}
    k2_parts = dict.fromkeys((label for label, _, _ in K2_PARTS), 0.0)

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
            parts, _ = parts_ms(torch, lambda: sequential_routing_bwd_cuda(
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
    # every recipe geometry so far took the weight gradient's and the
    # prediction's tiled paths
    tiled = routing_cuda.wgrad_launches["tiled"] - paths["tiled"]
    check(tiled > 0 and routing_cuda.wgrad_launches == dict(
        paths, tiled=paths["tiled"] + tiled),
        "K2's weight gradient left its tiled path at a SRF-TIMIT geometry: "
        "%s (before %s)" % (routing_cuda.wgrad_launches, paths))
    tiled = routing_cuda.predict_launches["tiled"] - predict_paths["tiled"]
    check(tiled > 0 and routing_cuda.predict_launches == dict(
        predict_paths, tiled=predict_paths["tiled"] + tiled),
        "the prediction left its tiled path at a SRF-TIMIT geometry: %s "
        "(before %s)" % (routing_cuda.predict_launches, predict_paths))
    print("phase 4 at SRF-TIMIT's layers: the weight gradient's launches by "
          "path %s, the prediction's %s" % (routing_cuda.wgrad_launches,
                                            routing_cuda.predict_launches))
    # K2 alone at K2_LAYERS
    wsj_parts = {}
    for name, geometry, mask, w_std, batch, seq_len in K2_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = torch.tensor(rng.randn(in_n, out_n, out_d, in_d) * w_std,
                         dtype=torch.float32, device=device)
        b = torch.tensor(rng.randn(in_n, out_n, out_d) * w_std,
                         dtype=torch.float32, device=device)
        u = torch.tensor(rng.randn(batch, seq_len, in_n, in_d),
                         dtype=torch.float32, device=device)
        vs = sequential_routing_cuda(u, w, b, 1, mask)
        dvs = torch.tensor(rng.randn(batch, seq_len, out_n, out_d),
                           dtype=torch.float32, device=device)
        before = dict(routing_cuda.wgrad_launches)
        predict_before = dict(routing_cuda.predict_launches)
        k2_held(u, w, b, vs, dvs, mask, "%s %s B=%d T=%d mask=%s" % (
            name, geometry, batch, seq_len, mask))
        check(routing_cuda.wgrad_launches["tiled"] == before["tiled"] + 2,
              "K2's weight gradient left its tiled path at %s: %s"
              % (name, routing_cuda.wgrad_launches))
        check(routing_cuda.predict_launches["tiled"]
              == predict_before["tiled"] + 2,
              "the prediction left its tiled path at %s: %s"
              % (name, routing_cuda.predict_launches))
        parts, _ = parts_ms(torch, lambda: sequential_routing_bwd_cuda(
            u, w, b, vs, dvs, mask), K2_PARTS)
        wsj_parts[name] = parts
        flops = 4.0 * batch * seq_len * in_n * out_n * out_d * in_d
        print("K2 %s B=%d T=%d: weight gradient %.4f ms (%.1f %% of the "
              "float32 peak on its %.1f GFLOP), prediction %.4f ms, "
              "reverse-time %.4f ms, reduction %.4f ms"
              % (name, batch, seq_len, parts["weight_gradient"],
                 100 * flops / (parts["weight_gradient"] * 1e-3)
                 / PEAK_F32_FLOPS, flops / 1e9, parts["prediction"],
                 parts["reverse_time"], parts["reduction"]))
        del u, w, b, vs, dvs
    predict = prediction_check(torch, device, rng)
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
    k2.update(launches_per_call=K2_LAUNCHES, parts_ms=k2_parts,
              wsj_parts_ms=wsj_parts,
              wgrad_launches=dict(routing_cuda.wgrad_launches),
              predict_launches=dict(routing_cuda.predict_launches),
              predict_wsj=predict)
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
    weight-gradient one. The trace is primed (``prime_profiler``) before
    the wall clock starts; the priming's kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_profiler(torch)
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    spans = []
    kernels = {label: 0.0 for label, _ in symbols}
    by_name = {}
    for evt in device_events(torch, prof):
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

    def capture(u, wgt, bias, num_iter, is_context, is_last_layer,
                bf16=False, shard=None):
        captured.append((u.detach().clone(), wgt.detach(), bias.detach(),
                         num_iter, is_context, is_last_layer))
        return real(u, wgt, bias, num_iter, is_context, is_last_layer, bf16,
                    shard)

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
# the CPU's beam at width 100 is slow), and the passes over every batch of
# batch 1 and of batch 8 whose forward and beams are timed apart (one, for
# the run's time: two passes back to back read 17-27 % apart on the host
# clock)
CHECK_UTTS = 8
TIMING_PASSES = 1


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
        # TIMING_PASSES passes
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
                vocab=62, shortest=None):
    """bench.py's workload (bench.py:76-87): lengths in 0.7*frames..frames
    (``shortest``..frames where given), tar_len = max(2, len // 8), labels
    in 1..vocab-1, randn features. Features and labels on ``device``, the
    lengths on the host, as the train step wants them (train/step.py)."""
    host = np.random.RandomState(0)
    lens = host.randint(int(frames * 0.7) if shortest is None else shortest,
                        frames + 1, size=batch)
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


def train_setup(torch, config, state, device, dropout=True, accum_steps=1):
    """A model with ``state``'s weights, its optimizer and scheduler in a
    TrainState on ``device``, and its train step (``config``'s
    ``--tpu-bf16``; ``accum_steps`` microbatches). ``dropout`` False turns
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
    apply_fn = make_apply_fn(model, extra_kwargs_fn(config, in_len_div),
                             bf16=config.tpu_bf16)
    return train_state, apply_fn, make_train_step(apply_fn, in_len_div,
                                                  accum_steps=accum_steps)


def parity_readings(torch, config, state, batch, dropout=False,
                    update_grad_rel=UPDATE_GRAD_REL, card_tf32=False,
                    count=PARITY_COUNT, accum_steps=1, reference=None):
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
    convolutions and matmuls in TF32; ``accum_steps`` microbatches both
    steps. ``reference``: the (config, device) of the step the card's is
    held to, ``config`` on the CPU by default."""
    results = {}
    for key, (cfg, device) in (("cuda", (config, "cuda")),
                               ("cpu", reference or (config, "cpu"))):
        train_state, _, step = train_setup(torch, cfg, state, device,
                                           dropout=dropout,
                                           accum_steps=accum_steps)
        if train_state.scheduler is None:
            rate = train_state.optimizer.param_groups[0]["lr"]
        else:
            rate = train_state.scheduler.lr_lambdas[0](count)
        for group in train_state.optimizer.param_groups:
            group["lr"] = rate
        tf32 = key == "cuda" and card_tf32
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
        results[key] = (
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
                "updates": {}, "max_move": 0.0, "checked": 0, "total": 0,
                "card_grads": card_grads, "cpu_grads": cpu_grads}
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
                 min_compared=0.5, count=PARITY_COUNT, accum_steps=1,
                 reference=None, reference_name="cpu"):
    """``parity_readings`` held to the limits: the loss within LOSS_RTOL,
    every gradient within ``grad_atol_rel`` x its largest entry, BatchNorm
    statistics within STATS_ATOL, each parameter's update (where the
    gradient is at least ``update_grad_rel`` x its largest, over more than
    ``min_compared`` of the entries) within UPDATE_ATOL_REL x the rate,
    every update within the rate, and no untrained parameter moved.
    ``reference`` and ``reference_name``: the step held to (``config`` on
    the CPU by default) and its name in the messages. Returns the
    readings."""
    r = parity_readings(torch, config, state, batch, dropout, update_grad_rel,
                        count=count, accum_steps=accum_steps,
                        reference=reference)
    check(r.get("frozen_moved", 0.0) == 0.0,
          "train step: an untrained parameter moved")
    rate = r["rate"]
    check(np.isfinite(r["card_loss"]) and r["loss_err"] <= LOSS_RTOL,
          "train step: card loss %r vs %s %r" % (
              r["card_loss"], reference_name, r["cpu_loss"]))
    worst_grad, worst_stat, worst_update = (
        worst(r[key]) for key in ("grads", "stats", "updates"))
    check(worst_grad[0] <= grad_atol_rel,
          "train step: gradient %s differs, card vs %s %.3e x its max"
          % (worst_grad[1], reference_name, worst_grad[0]))
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
          "%.4e): loss card %.6f %s %.6f (rel %.2e, rtol %.0e); worst "
          "gradient %s rel err %.2e (atol %.2g x max); BatchNorm stats max "
          "err %.2e (atol %.0e); parameter updates: worst err %.2e x rate "
          "(atol %.0e x rate) over %d of %d entries, all within the rate"
          % (label, batch["feats"].shape[0],
             "on at the K5 sites" if dropout == "k5" else "off",
             count if config.train_opti_type not in ("adam", "sgd")
             else "- (constant rate)", rate, r["card_loss"], reference_name,
             r["cpu_loss"],
             r["loss_err"], LOSS_RTOL, worst_grad[1], worst_grad[0],
             grad_atol_rel, worst_stat[0], STATS_ATOL, worst_update[0],
             UPDATE_ATOL_REL, r["checked"], r["total"]))
    return r


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
    from srf_tpu_torch.ops import routing_cuda
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
    paths = dict(routing_cuda.wgrad_launches)
    predict_paths = dict(routing_cuda.predict_launches)
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
    check(routing_cuda.wgrad_launches == dict(
        paths, tiled=paths["tiled"] + 7 * TRAIN_STEPS),
        "the train steps' weight gradients by path: %s, expected %d more "
        "tiled than %s" % (routing_cuda.wgrad_launches, 7 * TRAIN_STEPS,
                           paths))
    # a K1 and a K2 call each launch the prediction once
    check(routing_cuda.predict_launches == dict(
        predict_paths, tiled=predict_paths["tiled"] + 14 * TRAIN_STEPS),
        "the train steps' predictions by path: %s, expected %d more tiled "
        "than %s" % (routing_cuda.predict_launches, 14 * TRAIN_STEPS,
                     predict_paths))
    print("train steps' launches by path: weight gradient %s, prediction %s"
          % (routing_cuda.wgrad_launches, routing_cuda.predict_launches))
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
        # the host library's CRC-32C writes stage 0's records: it must load
        # here (no silent fallback to the Python loop)
        from srf_tpu_torch.data import tfrecord
        from srf_tpu_torch.utils import native

        host_lib = native.load_host_lib()
        check(bool(host_lib), "the port's host library (%s) did not load on "
              "the card's host: stage 0 would take the Python CRC-32C"
              % native.library_path())
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
        stage0_s = time.perf_counter() - start
        shards = sorted(os.listdir(os.path.join(base, "tfrecord")))
        check(len(shards) == 12, "stage 0 wrote %s" % shards)
        records = [r for shard in shards for r in tfrecord.read_records(
            os.path.join(base, "tfrecord", shard), verify_crc=True)]
        check(all(host_lib.srf_crc32c(r, len(r)) == tfrecord.crc32c_py(r)
                  for r in records[:8]),
              "the host library's CRC-32C differs from the Python loop's")
        print("recipe stage 0 (save_tfrecord): %d train, %d valid, %d test "
              "utterances into %d shards, %.1f s, the C++ CRC-32C (%s; %d "
              "records read back with their CRCs verified)"
              % (len(splits["train"]), len(splits["valid"]),
                 len(splits["test"]), len(shards), stage0_s,
                 os.path.basename(native.library_path()), len(records)))

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


def cnn_site_shapes(torch, device, config=None, batch=None):
    """(shape, rate) of each K5 site of one CNN training forward, in
    order, read off the model itself: one forward with the sites recorded
    instead of dropped. CNN-TIMIT at 29 x 241 by default."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models import cnn
    from srf_tpu_torch.models.registry import build_model

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = config or timit_config(logger, "cuda", CNN_FLAGS)
    model, _ = build_model(config, class_count(config))
    model.to(device).train()
    batch = batch or train_batch(torch, device)
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


def k5_sites(torch, device, label, sites, rates, same, seeds, gen):
    """K5 against its plain version (``same``) at each of ``sites``' shapes
    and ``rates``, and per site the kernel's, the plain version's and
    F.dropout's times at the site's own rate (CUDA events) beside the
    bound (8 bytes an element over the memory rate); returns (per site
    readings, their sums over a step's launches: each site twice, forward
    and backward)."""
    import torch.nn.functional as F
    from srf_tpu_torch.ops.dropout import fused_dropout_plain
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    per_site, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                            "library_ms": 0.0}
    for index, (shape, site_rate) in enumerate(sites):
        x = torch.randn(shape, generator=gen, device=device)
        for rate in rates:
            same(x, rate, "%s site %d %s" % (label, index, shape))
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
        print("K5 %s site %2d %s rate %.1f: kernel %.4f ms, plain %.4f ms, "
              "F.dropout %.4f ms, bound %.4f ms (bytes)"
              % (label, index, shape, site_rate, ms, plain_ms, library_ms,
                 bound))
        del x
    return per_site, totals


def k5_checker(torch, seed):
    """(same, max_err, seeds, generator): ``same(x, rate, label)`` holds K5
    to its plain version on ``x`` bit for bit at the next host seed and
    returns K5's output; ``max_err[0]`` is the largest |kernel - plain|
    so far."""
    from srf_tpu_torch.ops.dropout import fused_dropout_plain
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    gen = torch.Generator("cuda").manual_seed(seed)
    seeds = iter(np.random.RandomState(seed).randint(
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

    return same, max_err, seeds, gen


def k5_phase(torch, device):
    """Phase 5: the fused dropout against its plain version, bit for bit,
    and its times; returns its JSON entry."""
    from srf_tpu_torch.ops.dropout import (fused_dropout,
                                           fused_dropout_plain)
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    same, max_err, seeds, gen = k5_checker(torch, SEED + 3)
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
    per_site, totals = k5_sites(torch, device, "CNN-TIMIT", sites, K5_RATES,
                                same, seeds, gen)

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
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda", CNN_FLAGS)
    fused_dropout_cuda.launches = 0
    state = family_serve(torch, card, "CNN", config, serve_batches(),
                         CNN_LOGIT_ATOL, cpu_subset=CNN_CPU_SUBSET)
    return fused_dropout_cuda.launches, state


def cnn_train_phase(torch, card, state):
    """Phase 9: train CNN-TIMIT on the card in pallas mode; returns K5's
    launches in the 1 + TRAIN_STEPS-step run."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    # dropout on: K5's masks follow the step seed on both devices
    stride_config = timit_config(logger, "cuda", CNN_STRIDE_FLAGS)
    stride_state = random_weights(build_model(stride_config, 63)[0])
    train_parity(torch, stride_config, stride_state,
                 {k: v[:CNN_STRIDE_CHECK_BATCH]
                  for k, v in train_batch(torch, "cuda").items()},
                 dropout="k5", label="CNN stride variant ")
    launches, _ = family_train(
        torch, card, "CNN-TIMIT", timit_config(logger, "cuda", CNN_FLAGS),
        state, ((29, 241),), 62,
        parity=dict(rows=CNN_CHECK_BATCH, dropout="k5",
                    grad_atol_rel=CNN_GRAD_ATOL_REL,
                    update_grad_rel=CNN_UPDATE_GRAD_REL,
                    min_compared=CNN_MIN_COMPARED),
        k5_per_step=2 * CNN_SITES)
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
# STF-WSJ's parity step, card vs CPU (float32 both, TF32 off), measured by
# chip_wsj_numerics.py on an H100: float32 itself sits ~1e-2 of the
# largest entry from float64 in the feed-forward blocks' first weights
# (enc19.ffn.ff1: the card 9.9e-3, the CPU 1.07e-2), and the card and the
# CPU read 1.07e-2 apart, against 1e-4 at STF-TIMIT's width; with the card
# in TF32 the step reads 4.8e-2 (and its loss 1.1e-5 apart, past
# LOSS_RTOL). So each gradient within STF_WSJ_GRAD_ATOL_REL x its largest
# entry, and updates compared where the gradient is >=
# STF_WSJ_UPDATE_GRAD_REL x its largest (32 % of the entries), over at
# least STF_WSJ_MIN_COMPARED of them
STF_WSJ_GRAD_ATOL_REL = 2.5e-2
STF_WSJ_UPDATE_GRAD_REL, STF_WSJ_MIN_COMPARED = 1e-1, 0.1
# blockwise against plain attention on the card (float32): the online
# softmax sums the same terms in key blocks; outputs O(1)
BLOCKWISE_ATOL, BLOCKWISE_GRAD_REL = 1e-4, 1e-4
# the STF-WSJ recipe's width (train_stf_wsj.sh: D=256, FF 1488, 4 heads)
# at T' = 600 (2400 frames), batch 8, penalty (1, 1, 1) on
BLOCKWISE_SHAPE = (8, 4, 600, 64)
# the timed train shapes, (B, padded frames): the first of the 20000-frame
# TIMIT buckets, which every TIMIT utterance up to 241 frames falls in; and
# three 24000-frame buckets that WSJ's 300-1600-frame utterances fall in
# (phases 11-11c)
STF_TRAIN_SHAPES = ((82, 241),)
WSJ_BUCKET_SHAPES = ((44, 541), (24, 991), (15, 1591))
# the CLI runs' corpora, {split: ((low, high) frames, utterances)}: every
# bucket filled twice in train (one step each), once in valid
STF_RECIPE = {"train": (((150, 241), 164), ((242, 391), 102)),
              "valid": (((150, 241), 82), ((242, 391), 51))}
LSTM_RECIPE = {"train": (((392, 541), 44), ((992, 1141), 21)),
               "valid": (((392, 541), 44), ((992, 1141), 21))}
LSTM_TEST_UTTS, LSTM_TEST_FRAMES = 8, (300, 1600)
# phases 11b-11c: the CNN-WSJ and STF-WSJ recipes' models at full width.
# egs/script/torch/train_cnn_wsj.sh:10-16,32-49 with wsj.conf: the stride
# variant (ConvFrontEnd, then the maxout body), L=15, filters 200/430, 3 x
# 2048 projections, stride 2, Noam at k 0.5 (then 0.1) with warmup 25000,
# 24000-frame buckets, 32 classes; K5 at every dropout site
# (--tpu-dropout-kernel=pallas, as CNN_FLAGS runs CNN-TIMIT)
CNN_WSJ_FLAGS = [
    "--model-type=cnn", "--model-conv-inp-nfilt=200",
    "--model-conv-inn-nfilt=430", "--model-conv-proj-num=3",
    "--model-conv-proj-dim=2048", "--model-conv-stride=2",
    "--model-conv-is-mp=False", "--model-dimension=1",
    "--model-encoder-num=15", "--train-lr-param-k=0.5",
    "--tpu-dropout-kernel=pallas",
]
# K5 sites of a CNN-WSJ forward: the input dropout, 2 a conv (15), 2 a
# projection (2) and projv; a train step launches K5 twice per site
CNN_WSJ_SITES = 1 + 2 * 15 + 2 * 2 + 1
# egs/script/torch/train_stf_wsj.sh:31-49 with wsj.conf: L=20, D=256, 4
# heads, FF 1488, dropouts 0.3/0.4/0.3/0.4, penalty (1, 1, 1) on, Noam at
# k 1.5 (then 0.5) with warmup 25000
STF_WSJ_FLAGS = [
    "--model-type=stf", "--model-encoder-num=20", "--model-dimension=256",
    "--model-inner-dim=1488", "--train-att-dropout=0.3",
    "--train-inn-dropout=0.4", "--train-inp-dropout=0.3",
    "--train-res-dropout=0.4", "--model-ap-scale=1",
    "--model-ap-width-zero=1", "--model-ap-width-stripe=1",
    "--model-ap-encoder=True", "--model-ap-decoder=True",
    "--model-ap-encdec=False", "--train-lr-param-k=1.5",
]
# CNN-WSJ, card vs CPU (float32 both, TF32 off), measured by
# chip_wsj_numerics.py on an H100: at 15 layers float32 itself is far from
# float64 on both devices, 1.09e-1 of the largest entry in the parity
# step's gradients (body.proj0's weight, card and CPU alike) and 2.0e-4
# (card) and 1.8e-4 (CPU) in the served logits, while the card and the CPU
# read 7.8e-2 and 3.5e-4 apart; with the card in TF32 the step reads
# 3.3e-1 to 4.0e-1 (its updates 2 x the rate) and the logits 8.6e-2. So
# the CNN-TIMIT limits do not hold here: the gradients within
# CNN_WSJ_GRAD_ATOL_REL x their largest entry, the updates compared where
# the gradient is >= CNN_WSJ_UPDATE_GRAD_REL x its largest (19 % of the
# entries; an error within the gradient limit cannot flip a sign there),
# and the served logits within CNN_WSJ_LOGIT_ATOL at valid frames
CNN_WSJ_GRAD_ATOL_REL, CNN_WSJ_UPDATE_GRAD_REL = 1.5e-1, 2e-1
CNN_WSJ_LOGIT_ATOL = 1e-3
# the CNN-WSJ parity step's rows: 2 of the 44 x 541 bucket. The CPU half
# runs the full-width model in float32, forward and backward, ~4.5e11
# FLOPs a row at 541 frames (136 frames after the front end, x 31 x 430
# channels through ten (5, 3) convs), and K5's plain Philox at 36 sites;
# 2 rows keep it near half a minute on the card's host, and more than one
# row holds the batch's sums
CNN_WSJ_CHECK_ROWS = 2
# utterances of each serving batch the CPU also decodes (a 1600-frame one
# is ~4e11 FLOPs on the CPU)
CNN_WSJ_CPU_SUBSET = 2
# the CLI runs' corpora: two of the timed 24000-frame buckets (44 x 541 and
# 24 x 991), each filled once in train and in valid, so the CLI's steps
# and valid batches take shapes cuDNN has already searched
WSJ_RECIPE = {"train": (((392, 541), 44), ((842, 991), 24)),
              "valid": (((392, 541), 44), ((842, 991), 24))}


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


def family_serve(torch, card, label, config, batches, logit_atol,
                 cpu_subset=None):
    """Serve ``batches`` through a Recognizer at ``config`` on the card and
    on the CPU with numpy-seeded weights: ids and text equal, logits within
    ``logit_atol``; forward and end-to-end times and a profile of one
    forward per batch. With ``cpu_subset`` the CPU decodes only the first
    so many utterances of each batch and the logits are compared at their
    valid frames (a model whose logits there depend neither on the padded
    width nor on the other utterances: the CNN). Returns the weights (a
    state_dict)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    classes = class_count(config)
    state = random_weights(build_model(config, classes)[0])
    card_rec = Recognizer(config, state_dict=state, logger=logger)
    cpu_rec = Recognizer(config, state_dict=state, device="cpu",
                         logger=logger)
    check(card_rec.device.type == "cuda", "%s Recognizer is not on the card"
          % label)
    start = time.perf_counter()
    for feats_list in batches.values():  # warm-up (allocator, cuDNN)
        card_rec.transcribe_batch_detailed(feats_list)
    torch.cuda.synchronize()
    print("%s serve: first call of each batch shape (cuDNN's search) %.1f "
          "s" % (label, time.perf_counter() - start))
    k5_before = fused_dropout_cuda.launches
    for name, feats_list in batches.items():
        got = card_rec.transcribe_batch_detailed(feats_list)
        check_served(name, got, feats_list, card_rec.in_len_div,
                     blank=classes - 1)
        subset = feats_list[:cpu_subset]
        cpu = cpu_rec.transcribe_batch_detailed(subset)
        check([r["ids"] for r in got[:len(subset)]]
              == [r["ids"] for r in cpu],
              "%s %s: card ids differ from CPU ids" % (label, name))
        check([r["text"] for r in got[:len(subset)]]
              == [r["text"] for r in cpu],
              "%s %s: card text differs from CPU text" % (label, name))
        card_logits = card_rec.forward(*card_rec.pad(feats_list)).cpu()
        cpu_logits = cpu_rec.forward(*cpu_rec.pad(subset))
        check(bool(torch.isfinite(card_logits).all()), "%s %s: logits"
              % (label, name))
        if cpu_subset is None:
            err = (card_logits - cpu_logits).abs().max().item()
        else:
            err = max((card_logits[i, :len(f) // card_rec.in_len_div]
                       - cpu_logits[i, :len(f) // card_rec.in_len_div])
                      .abs().max().item() for i, f in enumerate(subset))
        print("%s serve %s: %d utts, %d tokens, logits %s; %d on the CPU: "
              "ids equal, max |card - cpu| %.3e%s (atol %.0e)"
              % (label, name, len(got), sum(len(r["ids"]) for r in got),
                 tuple(card_logits.shape), len(subset), err,
                 "" if cpu_subset is None else " at valid frames",
                 logit_atol))
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
        print("profile %s %s forward: all %d device ops %.3f ms (conv + "
              "GEMM kernels %.3f, layout conversions %.3f), device busy "
              "%.3f of %.3f ms wall (idle share %.3f); top: %s [%s]"
              % (label, name, count, total, conv_ms(by_name),
                 layout_ms(by_name), busy, wall, 1.0 - busy / wall,
                 top_ops(by_name), card))
    torch.cuda.synchronize()
    check(fused_dropout_cuda.launches == k5_before,
          "%s serving launched K5 %d times" % (
              label, fused_dropout_cuda.launches - k5_before))
    return state


def family_train(torch, card, label, config, state, shapes, vocab,
                 parity=None, k5_per_step=None):
    """One dropout-free step on card and CPU held as phase 7's (its update
    at the schedule's peak, the warmup count, or at plain Adam's rate),
    then TRAIN_STEPS steps with dropout on over ``shapes`` (the first step
    at each shape, with cuDNN's algorithm search, timed apart), finite
    losses and every tensor on the card; ms per step and peak memory per
    shape and a profile of one step at the first shape. ``parity``:
    ``train_parity``'s keyword arguments for the parity step, with "rows"
    (TRAIN_CHECK_BATCH by default) the rows of the first shape's batch it
    takes. ``k5_per_step``: K5's launches each step must make, counted
    from 0 over the timed steps and returned (None: none checked, 0
    returned)."""
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    parity = dict(parity or {})
    rows = parity.pop("rows", TRAIN_CHECK_BATCH)
    parity.setdefault("count", config.train_warmup_n)
    batches = [train_batch(torch, "cuda", batch=b, frames=t, vocab=vocab)
               for b, t in shapes]
    start = time.perf_counter()
    train_parity(torch, config, state,
                 {k: v[:rows] for k, v in batches[0].items()},
                 label=label + " ", **parity)
    print("%s train parity step: %.1f s (card and CPU)"
          % (label, time.perf_counter() - start))
    train_state, _, step = train_setup(torch, config, state, "cuda")
    seed = config.tpu_seed
    first_ms, step_ms, losses, peak = [], {}, [], {}
    torch.cuda.synchronize()
    if k5_per_step is not None:
        fused_dropout_cuda.launches = 0  # the path's drive starts here

    def timed_step(batch):
        before = fused_dropout_cuda.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = step(train_state, batch, seed)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start)
        if k5_per_step is not None:
            check(fused_dropout_cuda.launches - before == k5_per_step,
                  "a %s train step launched K5 %d times, expected %d"
                  % (label, fused_dropout_cuda.launches - before,
                     k5_per_step))
        return out, ms

    for batch in batches:
        (train_state, metrics), ms = timed_step(batch)
        first_ms.append(ms)
    for i in range(TRAIN_STEPS):
        batch = batches[i % len(batches)]
        (train_state, metrics), ms = timed_step(batch)
        shape = tuple(batch["feats"].shape[:2])
        step_ms.setdefault(shape, []).append(ms)
        peak[shape] = max(peak.get(shape, 0),
                          torch.cuda.max_memory_allocated())
        losses.append(metrics["loss_sum"] / batch["feats"].shape[0])
    launches = fused_dropout_cuda.launches
    all_on_card(train_state, metrics)
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite %s train loss"
          % label)
    readings = {"first_ms": {}, "median_ms": {}, "peak_gib": {}}
    for (b, t), first in zip(shapes, first_ms):
        times = step_ms[(b, t)]
        med = float(np.median(times))
        key = "%dx%d" % (b, t)
        readings["first_ms"][key] = first
        readings["median_ms"][key] = med
        readings["peak_gib"][key] = peak[(b, t)] / 2 ** 30
        print("%s train %d x %d (dropout on): first step %.1f ms; %d steps "
              "ms/step median %.3f max %.3f; peak memory %.2f GiB; %.1f "
              "utt/s, %.1f padded frames/ms [%s]"
              % (label, b, t, first, len(times), med, max(times),
                 peak[(b, t)] / 2 ** 30, 1e3 * b / med, b * t / med, card))
    print("%s train: loss per utterance first %.3f last %.3f%s"
          % (label, losses[0], losses[-1],
             "" if k5_per_step is None else "; K5 %d launches over %d "
             "steps (%d each)" % (launches, len(shapes) + TRAIN_STEPS,
                                  k5_per_step)))
    kernels, total, count, busy, wall, by_name = profile_device(
        torch, lambda: step(train_state, batches[0], seed),
        (("K5", "fused_dropout_kernel"),))
    conv = conv_ms(by_name)
    print("profile %s train step %d x %d: K5 %.3f ms, conv + GEMM kernels "
          "%.3f ms (layout conversions %.3f), everything else %.3f ms, all "
          "%d device ops %.3f ms, device busy %.3f of %.3f ms wall (idle "
          "share %.3f); top: %s [%s]"
          % (label, shapes[0][0], shapes[0][1], kernels["K5"], conv,
             layout_ms(by_name), total - kernels["K5"] - conv, count, total,
             busy, wall, 1.0 - busy / wall, top_ops(by_name, 8), card))
    del train_state, step, batches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches if k5_per_step is not None else 0, readings


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
    utterance decoded, finite losses. Returns the train steps the stages
    took (the last checkpoint's step)."""
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
        train_steps = int(checkpoint.CheckpointManager(ckpt).restore(
            last)["step"])
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
    return train_steps


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
    family_train(torch, card, "LSTM-WSJ", config, state, WSJ_BUCKET_SHAPES,
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
    return state


def wsj_test_split():
    """The WSJ phases' test split: the 8 x 300-1600 serving batch's
    utterances with labels 1..30 (max(2, len // 8)), so the CLI's decode
    batch (8, padded 1664) is a shape the card has served."""
    rng = np.random.RandomState(SEED + 13)
    return {"synth%02d" % i: (feats, rng.randint(1, 31,
                                                 size=max(2, len(feats) // 8)))
            for i, feats in enumerate(wsj_serve_batches()["8x300-1600"])}


def cnn_wsj_phase(torch, card):
    """Phase 11b: CNN-WSJ at full width (see the module docstring).
    Returns K5's launches on the timed steps and on the recipe's training
    steps, and K5's readings at the 36 sites (a step's sums, the largest
    |kernel - plain|, each site's)."""
    from srf_tpu_torch import trainer_sr
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "wsj", CNN_WSJ_FLAGS)
    before = kernel_counts()[:4]
    # K5 against its plain version at the 36 sites of a step at the first
    # timed bucket, at 0.2 (the fixed rate after each conv and projection)
    # and the recipe's inner rate
    b, t = WSJ_BUCKET_SHAPES[0]
    sites = cnn_site_shapes(torch, "cuda", config,
                            train_batch(torch, "cuda", b, t, vocab=31))
    check(len(sites) == CNN_WSJ_SITES, "CNN-WSJ forward has %d K5 sites, "
          "expected %d" % (len(sites), CNN_WSJ_SITES))
    same, max_err, seeds, gen = k5_checker(torch, SEED + 17)
    rates = sorted({0.2, config.train_inn_dropout})
    per_site, totals = k5_sites(torch, "cuda", "CNN-WSJ", sites, rates,
                                same, seeds, gen)
    print("K5 CNN-WSJ: equal to the plain version at the %d sites of a %d "
          "x %d step (up to %d elements) at rates %s; one step's %d "
          "launches: kernel %.4f ms, plain %.4f ms, F.dropout %.4f ms, "
          "bound %.4f ms (bytes) [%s]"
          % (len(sites), b, t, max(int(np.prod(s)) for s, _ in sites), rates,
             2 * len(sites), totals["ms"], totals["plain_ms"],
             totals["library_ms"], totals["bound_ms"], card))
    torch.cuda.empty_cache()

    state = family_serve(torch, card, "CNN-WSJ", config, wsj_serve_batches(),
                         CNN_WSJ_LOGIT_ATOL, cpu_subset=CNN_WSJ_CPU_SUBSET)
    # dropout on at every K5 site in the parity step (the masks follow the
    # step seed on both devices; the front end's own dropout off: it draws
    # from the device's generator), held as phase 9 holds CNN-TIMIT
    train_launches, readings = family_train(
        torch, card, "CNN-WSJ", config, state, WSJ_BUCKET_SHAPES, 31,
        parity=dict(rows=CNN_WSJ_CHECK_ROWS, dropout="k5",
                    grad_atol_rel=CNN_WSJ_GRAD_ATOL_REL,
                    update_grad_rel=CNN_WSJ_UPDATE_GRAD_REL,
                    min_compared=CNN_MIN_COMPARED),
        k5_per_step=2 * CNN_WSJ_SITES)
    fused_dropout_cuda.launches = 0  # the recipe's drive starts here
    steps = family_recipe(torch, card, "CNN-WSJ", trainer_sr.main, "wsj",
                          "wsj_31.vocab", CNN_WSJ_FLAGS, ((0.5, 1), (0.1, 2)),
                          WSJ_RECIPE, wsj_test_split(), "wsj")
    recipe_launches = fused_dropout_cuda.launches
    check(recipe_launches == 2 * CNN_WSJ_SITES * steps,
          "the CNN-WSJ recipe's %d train steps launched K5 %d times"
          % (steps, recipe_launches))
    check(kernel_counts()[:4] == before,
          "phase 11b moved K1-K4's counters: %s -> %s"
          % (before, kernel_counts()[:4]))
    print("CNN-WSJ phase: K5 %d launches over the timed steps and %d over "
          "the recipe's %d train steps; K1-K4 launches unmoved %s; %.1f s"
          % (train_launches, recipe_launches, steps, before,
             time.perf_counter() - phase_start))
    torch.cuda.empty_cache()
    return train_launches, recipe_launches, dict(
        totals, sites=len(sites), shape=[b, t], max_abs_err=max_err[0],
        step=readings, per_site=per_site)


def stf_wsj_phase(torch, card):
    """Phase 11c: STF-WSJ at full width (see the module docstring)."""
    from srf_tpu_torch import trainer_tf
    from srf_tpu_torch.config import Logger

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "wsj", STF_WSJ_FLAGS)
    before = kernel_counts()
    state = family_serve(torch, card, "STF-WSJ", config, wsj_serve_batches(),
                         STF_LOGIT_ATOL)
    family_train(torch, card, "STF-WSJ", config, state, WSJ_BUCKET_SHAPES,
                 31, parity=dict(grad_atol_rel=STF_WSJ_GRAD_ATOL_REL,
                                 update_grad_rel=STF_WSJ_UPDATE_GRAD_REL,
                                 min_compared=STF_WSJ_MIN_COMPARED))
    family_recipe(torch, card, "STF-WSJ", trainer_tf.main, "wsj",
                  "wsj_31.vocab", STF_WSJ_FLAGS, ((1.5, 1), (0.5, 2)),
                  WSJ_RECIPE, wsj_test_split(), "wsj")
    check(kernel_counts() == before,
          "phase 11c moved K1-K5's counters: %s -> %s"
          % (before, kernel_counts()))
    print("STF-WSJ phase: K1-K5 launches unmoved %s; %.1f s"
          % (before, time.perf_counter() - phase_start))
    torch.cuda.empty_cache()


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


# phase 12c: the SRF-WSJ recipe's layered train step, 8 utterances of
# 300-1600 frames (padded to 1600) at its first stage's k 0.6; the CPU
# takes WSJ_CPU_ROWS of them; WSJ_TRAIN_STEPS timed steps after one
WSJ_TRAIN_FRAMES = (300, 1600)
WSJ_TRAIN_STEPS = 3
# card vs CPU gradients of that step, each within WSJ_GRAD_ATOL_REL x its
# largest entry. The SRF-TIMIT step's GRAD_ATOL_REL does not carry over:
# through 10 routing layers over 400 frames the two float32 steps read
# 1.5e-4 apart on the routing leaves (W*, b*, ln_mid*) and 1.8e-4 on the
# front end's conv biases, whose gradients sum ~5e4 cancelling terms (each
# float32 step is 1.2e-2 from float64 there). A card step in TF32 reads
# 3.5e-3 (routing leaves) and 5.2e-2 (front end), one with bf16 routing
# (K1-bf16, K2-bf16) 5.9e-2 on the routing leaves: both fail this limit
# (chip_wsj_numerics.py on an H100)
WSJ_GRAD_ATOL_REL = 1e-3


def wsj_train_phase(torch, card):
    """Phase 12c: the whole SRF-WSJ model's train step on the card, dropout
    off: held to the CPU's step on WSJ_CPU_ROWS utterances as phase 7
    holds SRF-TIMIT's (gradients within WSJ_GRAD_ATOL_REL); then the
    8-utterance step, K1 launched 20 and K2 40 times a step (10 calls
    each), timed with its peak memory. Returns
    K1's and K2's launches in one step, counted from 0."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "wsj",
                           SRF_WSJ_FLAGS + ["--train-lr-param-k=0.6"])
    classes = class_count(config)
    state = random_weights(build_model(config, classes)[0])
    batch = train_batch(torch, "cuda", batch=8, frames=WSJ_TRAIN_FRAMES[1],
                        vocab=classes - 1, shortest=WSJ_TRAIN_FRAMES[0])
    rows = {k: v[:WSJ_CPU_ROWS] for k, v in batch.items()}
    train_parity(torch, config, state, rows, label="SRF-WSJ ",
                 grad_atol_rel=WSJ_GRAD_ATOL_REL)

    train_state, _, step = train_setup(torch, config, state, "cuda",
                                       dropout=False)
    seed = config.tpu_seed
    torch.cuda.synchronize()
    sequential_routing_cuda.launches = 0
    sequential_routing_bwd_cuda.launches = 0
    paths = dict(routing_cuda.wgrad_launches)
    predict_paths = dict(routing_cuda.predict_launches)
    train_state, metrics = step(train_state, batch, seed)
    torch.cuda.synchronize()
    launches = (sequential_routing_cuda.launches,
                sequential_routing_bwd_cuda.launches)
    # the 10 layers' weight gradients and 20 predictions (K1's and K2's),
    # each on its tiled path
    check(routing_cuda.wgrad_launches == dict(paths,
                                              tiled=paths["tiled"] + 10),
          "an SRF-WSJ step's weight gradients by path: %s (before %s)"
          % (routing_cuda.wgrad_launches, paths))
    check(routing_cuda.predict_launches == dict(
        predict_paths, tiled=predict_paths["tiled"] + 20),
        "an SRF-WSJ step's predictions by path: %s (before %s)"
        % (routing_cuda.predict_launches, predict_paths))
    print("SRF-WSJ step's launches by path: weight gradient %s, prediction "
          "%s" % (routing_cuda.wgrad_launches, routing_cuda.predict_launches))
    check(launches == (10 * K1_LAUNCHES, 10 * K2_LAUNCHES),
          "an SRF-WSJ step launched K1 %d and K2 %d times, expected %d and "
          "%d" % (*launches, 10 * K1_LAUNCHES, 10 * K2_LAUNCHES))
    all_on_card(train_state, metrics)
    losses, times, peak = timed_steps(torch, step, train_state, batch, seed,
                                      reps=WSJ_TRAIN_STEPS)
    check(bool(np.isfinite(losses).all()), "non-finite SRF-WSJ loss")
    check(sequential_routing_cuda.launches
          == 10 * K1_LAUNCHES * (2 + WSJ_TRAIN_STEPS),
          "SRF-WSJ steps: K1 launched %d times"
          % sequential_routing_cuda.launches)
    print("SRF-WSJ train step 8 x %d-%d frames (padded %d, dropout off): K1 "
          "%d and K2 %d launches a step; loss per utterance %.3f; ms/step "
          "median %.3f (max %.3f) of %d; peak %.1f MB above the state; %.1f "
          "s [%s]" % (*WSJ_TRAIN_FRAMES, batch["feats"].shape[1], *launches,
                      losses[0] / 8, float(np.median(times)), max(times),
                      WSJ_TRAIN_STEPS, peak / 2**20,
                      time.perf_counter() - start, card))
    return launches


# phase 12d: --tpu-routing-kernel=wavefront; the CPU's wavefront serves
# WAVEFRONT_CPU_ROWS rows of the 29 x 241 batch; times are medians of
# WAVEFRONT_REPS calls after a first one
WAVEFRONT = "--tpu-routing-kernel=wavefront"
WAVEFRONT_CPU_ROWS = 3
WAVEFRONT_REPS = 3


def loop_steps(model, logits):
    """Steps of the wavefront's loop over time: T' + (L - 1)(rpad + 1)."""
    return logits.shape[1] + (model.enc_num - 1) * (model.rpad + 1)


def wavefront_phase(torch, card, state):
    """Phase 12d: the wavefront SDR stack (ops/routing.wavefront_sdr_stack,
    plain PyTorch: JAX runs it as XLA ops) on the card at full width.
    SRF-TIMIT with phase 6's weights: the 29 x 241 batch served, ids equal
    to the layered (K1) Recognizer's, logits within LOGIT_ATOL of its and
    of the CPU wavefront's rows; a dropout-free step held to the layered
    step on the card as phase 7 holds the CPU's; forward and step times
    beside the layered path's, peak memory with remat on and off, a profile
    of the forward. SRF-WSJ (numpy-seeded weights): the 8 x 1664 forward
    against the layered one, time and peak memory. The wavefront must
    launch K1 and K2 0 times and run no plain SDR loop; with one capsule
    layer (--model-encoder-num=1) it is that layer's SDR, one K1 call a
    forward, equal to the layered path's. Returns K1's launches in that
    one-layer forward."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import routing
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)
    from srf_tpu_torch.serve import Recognizer

    start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger

    def counts():
        return (sequential_routing_cuda.launches,
                sequential_routing_bwd_cuda.launches,
                routing.sequential_routing_from_uhat.cuda_calls)

    def no_sdr(before, what):
        got = tuple(a - b for a, b in zip(counts(), before))
        check(got == (0, 0, 0), "%s launched K1 %d and K2 %d times and ran "
              "the plain SDR loop %d times" % (what, *got))

    config = timit_config(logger, "cuda", TIMIT_FLAGS + [WAVEFRONT])
    layered_config = timit_config(logger, "cuda")
    wave = Recognizer(config, state_dict=state, logger=logger)
    check(wave.model.routing_impl == "wavefront",
          "the wavefront flag built the layered model")
    layered = Recognizer(layered_config, state_dict=state, logger=logger)
    cpu = Recognizer(timit_config(logger, "cpu", TIMIT_FLAGS + [WAVEFRONT]),
                     state_dict=state, device="cpu", logger=logger)
    feats_list = serve_batches()["29x241"]
    feats, lengths = wave.pad(feats_list)
    wave.transcribe_batch_detailed(feats_list)  # warm-up
    torch.cuda.synchronize()
    before = counts()
    got = wave.transcribe_batch_detailed(feats_list)
    logits = wave.forward(feats, lengths)
    torch.cuda.synchronize()
    no_sdr(before, "the wavefront's serving")
    check_served("wavefront", got, feats_list, wave.in_len_div)
    want = layered.transcribe_batch_detailed(feats_list)
    check([r["ids"] for r in got] == [r["ids"] for r in want],
          "wavefront ids differ from the layered path's")
    err = (logits - layered.forward(feats, lengths)).abs().max().item()
    check(err <= LOGIT_ATOL, "wavefront logits differ from the layered "
          "path's by %.3e" % err)
    rows = list(range(WAVEFRONT_CPU_ROWS))
    cpu_err = (logits[rows].cpu() - cpu.forward(feats[rows].cpu(),
                                                lengths[rows])).abs().max()
    check(cpu_err.item() <= LOGIT_ATOL, "wavefront logits differ from the "
          "CPU's by %.3e" % cpu_err.item())
    fwd_ms = {name: float(np.median(timed_ms(
        torch, lambda: rec.forward(feats, lengths), WAVEFRONT_REPS)))
        for name, rec in (("wavefront", wave), ("layered", layered))}
    _, total, count, busy, wall, _ = profile_device(
        torch, lambda: wave.forward(feats, lengths))
    print("wavefront SRF-TIMIT serve 29 x 241 (padded %s, a loop of %d "
          "steps): ids equal to the layered path's, logits max %.3e from it "
          "and %.3e from the CPU's rows %s (atol %.0e); K1 0, K2 0 launches; "
          "forward median %.3f ms against the layered path's %.3f (of %d); "
          "profile: %d device ops %.3f ms, busy %.3f of %.3f ms wall (idle "
          "share %.3f) [%s]"
          % (tuple(feats.shape), loop_steps(wave.model, logits), err,
             cpu_err.item(), rows, LOGIT_ATOL,
             fwd_ms["wavefront"], fwd_ms["layered"], WAVEFRONT_REPS, count,
             total, busy, wall, 1.0 - busy / wall, card))

    # one capsule layer: the stack is that layer's SDR, one call of K1
    one = TIMIT_FLAGS + ["--model-encoder-num=1"]
    one_state = random_weights(build_model(timit_config(logger, "cuda",
                                                        one), 63)[0])
    one_wave, one_layered = (Recognizer(timit_config(logger, "cuda",
                                                     one + extra),
                                        state_dict=one_state, logger=logger)
                             for extra in ([WAVEFRONT], []))
    one_wave.forward(feats, lengths)  # warm-up
    torch.cuda.synchronize()
    before = counts()
    one_logits = one_wave.forward(feats, lengths)
    torch.cuda.synchronize()
    got_one = tuple(a - b for a, b in zip(counts(), before))
    check(got_one == (K1_LAUNCHES, 0, 0), "the one-layer wavefront "
          "launched K1 %d and K2 %d times and ran the plain SDR loop %d "
          "times, expected K1 %d, K2 0, loop 0" % (*got_one, K1_LAUNCHES))
    one_err = (one_logits - one_layered.forward(feats, lengths)).abs().max()
    check(bool(torch.isfinite(one_logits).all())
          and one_err.item() <= LOGIT_ATOL, "the one-layer wavefront's "
          "logits differ from the layered path's by %.3e" % one_err.item())
    print("wavefront SRF-TIMIT with one capsule layer, 29 x 241: K1 %d "
          "launches a forward (its one layer), K2 0, no plain SDR loop; "
          "logits max %.3e from the layered path's (atol %.0e)"
          % (got_one[0], one_err.item(), LOGIT_ATOL))
    del one_wave, one_layered

    batch = train_batch(torch, "cuda")
    train_parity(torch, config, state, batch,
                 label="wavefront against the layered step on the card: ",
                 reference=(layered_config, "cuda"),
                 reference_name="layered")
    readings = {}
    for name, cfg, remat in (("wavefront", config, True),
                             ("wavefront, remat off", config, False),
                             ("layered", layered_config, None)):
        train_state, _, step = train_setup(torch, cfg, state, "cuda")
        if cfg is config:
            train_state.model.routing_remat = remat
        before = counts()
        losses, times, peak = timed_steps(torch, step, train_state, batch,
                                          cfg.tpu_seed, reps=WAVEFRONT_REPS)
        if name.startswith("wavefront"):
            no_sdr(before, "a wavefront train step")
        check(bool(np.isfinite(losses).all()), "%s: non-finite loss" % name)
        readings[name] = (float(np.median(times)), max(times), peak)
        del train_state, step
    print("wavefront SRF-TIMIT train step 29 x 241 (dropout on): %s [%s]"
          % ("; ".join("%s %.3f ms/step (max %.3f), peak %.1f MB above the "
                       "state" % (name, med, top, peak / 2**20)
                       for name, (med, top, peak) in readings.items()),
             card))

    wsj_config = family_config(logger, "cuda", "wsj",
                               SRF_WSJ_FLAGS + [WAVEFRONT])
    wsj_state = random_weights(build_model(wsj_config,
                                           class_count(wsj_config))[0])
    wsj = {"wavefront": Recognizer(wsj_config, state_dict=wsj_state,
                                   logger=logger),
           "layered": Recognizer(family_config(logger, "cuda", "wsj",
                                               SRF_WSJ_FLAGS),
                                 state_dict=wsj_state, logger=logger)}
    batches = wsj_serve_batches()
    feats_list = batches["8x300-1600"]
    feats_list[int(np.argmax([f.shape[0] for f in feats_list]))] = (
        batches["1x1600"][0])
    feats, lengths = wsj["wavefront"].pad(feats_list)
    out = {}
    for name, rec in wsj.items():
        rec.forward(feats, lengths)  # warm-up (cuDNN's search)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        logits = rec.forward(feats, lengths)
        torch.cuda.synchronize()
        if name == "wavefront":
            no_sdr(before, "the SRF-WSJ wavefront forward")
        out[name] = (logits, torch.cuda.max_memory_allocated() - base,
                     float(np.median(timed_ms(
                         torch, lambda: rec.forward(feats, lengths),
                         WAVEFRONT_REPS))))
    err = (out["wavefront"][0] - out["layered"][0]).abs().max().item()
    check(bool(torch.isfinite(out["wavefront"][0]).all()),
          "SRF-WSJ wavefront logits")
    check(err <= LOGIT_ATOL, "SRF-WSJ wavefront logits differ from the "
          "layered path's by %.3e" % err)
    print("wavefront SRF-WSJ serve 8 x 300-1600 (padded %s, a loop of %d "
          "steps): logits max %.3e from the layered path's (atol %.0e); K1 "
          "0, K2 0 launches; forward median %.3f ms against the layered "
          "path's %.3f (of %d); peak %.1f MB above the weights against %.1f; "
          "%.1f s [%s]" % (tuple(feats.shape),
                           loop_steps(wsj["wavefront"].model,
                                      out["wavefront"][0]), err, LOGIT_ATOL,
                           out["wavefront"][2], out["layered"][2],
                           WAVEFRONT_REPS, out["wavefront"][1] / 2**20,
                           out["layered"][1] / 2**20,
                           time.perf_counter() - start, card))
    return got_one[0]


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


def lstm_int8_check(torch, card, state):
    """Phase 14's LSTM-WSJ part: phase 11's model and weights served with
    --tpu-serve-quant=int8 on the card and the CPU (ids equal, logits
    within LSTM_LOGIT_ATOL) and beside float32: the forwards' times, and
    what reading every quantized weight once costs (ops/quant.py
    dequantizes each into a temporary, nn.LSTM's included, at every
    forward)."""
    from torch.nn.utils import parametrize

    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.quant import quantized_bytes
    from srf_tpu_torch.serve import Recognizer

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, "cuda", "wsj",
                           LSTM_WSJ_FLAGS + ["--tpu-serve-quant=int8"])
    rec = Recognizer(config, state_dict=state, logger=logger)
    cpu = Recognizer(config, state_dict=state, device="cpu", logger=logger)
    f32 = Recognizer(family_config(logger, "cuda", "wsj", LSTM_WSJ_FLAGS),
                     state_dict=state, logger=logger)
    weights = [(module, leaf) for module in rec.model.modules()
               if parametrize.is_parametrized(module)
               for leaf in module.parametrizations]
    check(any(isinstance(m, torch.nn.LSTM) for m, _ in weights),
          "int8: no LSTM weight is quantized")
    q_bytes, f_bytes = quantized_bytes(rec.model)
    for name, feats_list in wsj_serve_batches().items():
        got = rec.transcribe_batch_detailed(feats_list)
        check([r["ids"] for r in got] == [
            r["ids"] for r in cpu.transcribe_batch_detailed(feats_list)],
            "LSTM-WSJ int8 %s: card ids differ from the CPU's" % name)
        feats, lengths = rec.pad(feats_list)
        card_logits = rec.forward(feats, lengths).cpu()
        err = (card_logits - cpu.forward(feats.cpu(), lengths)).abs().max(
        ).item()
        check(err <= LSTM_LOGIT_ATOL, "LSTM-WSJ int8 %s: card logits differ "
              "from the CPU's by %.3e" % (name, err))
        gap = (card_logits - f32.forward(feats, lengths).cpu()).abs().max(
        ).item()
        fwd_ms = timed_ms(torch, lambda: rec.forward(feats, lengths), 10)
        f32_ms = timed_ms(torch, lambda: f32.forward(feats, lengths), 10)
        print("LSTM-WSJ int8 serve %s: card = CPU (logits max %.3e, atol "
              "%.0e; ids equal); int8 - f32 logits max %.3e (a reading); "
              "forward median %.3f ms int8, %.3f ms f32 [%s]"
              % (name, err, LSTM_LOGIT_ATOL, gap, float(np.median(fwd_ms)),
                 float(np.median(f32_ms)), card))
    read_ms = timed_ms(torch, lambda: [getattr(m, leaf) for m, leaf in weights],
                       10)
    print("LSTM-WSJ int8: %d quantized weights, resident %d bytes int8 + "
          "scales against %d float32 (%.3f); dequantizing all of them once "
          "(what each forward does) median %.3f ms [%s]"
          % (len(weights), q_bytes, f_bytes, q_bytes / f_bytes,
             float(np.median(read_ms)), card))


def serving_extras_phase(torch, card, state, lstm_state):
    """Phase 14: --wav through the CLI, int8 weights and forced alignment,
    each on the card against --feats or the CPU; int8 also for LSTM-WSJ
    (``lstm_state``: phase 11's weights). Returns K1's launches."""
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
    before = kernel_counts()
    lstm_int8_check(torch, card, lstm_state)
    check(kernel_counts() == before, "LSTM-WSJ int8 serving moved K1-K5's "
          "counters: %s -> %s" % (before, kernel_counts()))

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


# phase 15: the training extras and the bf16 variants of K1, K2
# and K5. The variants against their plain versions on the card: K1-bf16's
# output is float32, but its inputs, u_hat, v and c are rounded to bf16 at
# JAX's points, so where a float32 sum taken in another order rounds one of
# them to the other bf16 neighbour the output moves by a bf16 ulp of one
# term: held within BF16_K1_ATOL_REL x max|plain| (2.5 bf16 ulps; measured
# up to 6.4e-3 x max on an H100); K2-bf16's du, dW and db are themselves
# rounded to bf16: within BF16_K2_ATOL_REL x max|plain| (4 bf16 ulps;
# measured up to 7.4e-3); K5-bf16 bit for bit, and its mask equal to K5's
# at the same seed
BF16_K1_ATOL_REL, BF16_K2_ATOL_REL = 1e-2, 1.6e-2
# Those limits are wider than the whole effect of the bf16 roundings at
# some shapes, so each variant is also held to controls that skip them, by
# mean |difference| from the plain bf16 version: K1-bf16's must be at
# most BF16_K1_SHARE of the float32 recurrence's on the same bf16 inputs
# (no rounding) and of the float32 recurrence's on the bf16 u_hat (v and
# c not rounded); K2-bf16's, per gradient, at most BF16_K2_SHARE of the
# float32 K2's on the same inputs with its gradients rounded to bf16.
# These run on the same rows cut into sequences of CONTROL_STEPS steps:
# over a whole sequence one flipped rounding moves the carry and, through
# it, the later roundings, and the sound kernels' mean distance grows
# toward the controls' (up to 0.32 of them for K1 and 0.78 for K2, at the
# WSJ layer 0 B=3 T=17). On 2-step sequences the shares measure up to 9e-4
# (K1) and 7.8e-3 (K2), the controls' distances down to 9.9e-4 and 2.1e-3
# of mean |plain|; the limits sit near the geometric mean of each share
# and 1. The prediction kernel's bf16 u_hat is within BF16_UHAT_ULPS of
# predict_capsules_bf16 (bit for bit: measured so at every shape). All
# measured on an H100
BF16_K1_SHARE, BF16_K2_SHARE, BF16_UHAT_ULPS = 0.03, 0.1, 0
CONTROL_STEPS = 2
# the bf16 steps' loss against the float32 step's on the same weights and
# batch (dropout off, or at K5's sites, whose masks are the same bits):
# within BF16_LOSS_RTOL (measured up to 6.5e-5 on an H100) and at least
# BF16_LOSS_GAP from it (measured down to 2.2e-5), so that a step that
# ran in float32 fails
BF16_LOSS_RTOL, BF16_LOSS_GAP = 1e-3, 2e-6
# bf16 operations on the tensor cores (H100 SXM data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
# the microbatch (B, T') shapes the phase's steps route at that phases 3-4
# do not already hold K1 and K2 at: the recipe's buckets 12 x 541 and 8 x
# 841 in 4 microbatches, the accumulated parity step (8 x 241 in 4), the
# accumulated timing step (28 x 241 in 4) and MWER's 8 x 241
ACCUM_SHAPES = ((3, 136), (2, 211), (2, 61), (7, 61), (8, 61))
EXTRAS_ACCUM = 4
# the recipe run with the extras: utterances of the TIMIT buckets whose
# batch sizes 4 divides (12 at <= 541 frames, 8 at <= 841), 2 batches each
# an epoch; valid one batch of 12
EXTRAS_TRAIN = (((392, 541), 24), ((692, 778), 16))
EXTRAS_VALID = (((392, 541), 12),)
EXTRAS_EPOCHS = 2
EXTRAS_STEPS = 5  # timed steps of each extras step
MWER_BATCH, MWER_NBEST, MWER_BEAM, MWER_STEPS = 8, 4, 16, 3


def sdr_bf16_bound_ms(batch, seq_len, geometry, num_iter, backward=False):
    """Least time of one SDR call in bf16 routing: its bytes (u, W, bias in
    bf16 read once; out float32 written once; the backward's vs, dvs
    float32 read and du, dW, db bf16 written) over HBM bandwidth, and its
    operations: the prediction and routing products (bf16 operands,
    float32 sums) at the tensor cores' bf16 rate, the logits' softmax and
    the squash in float32. Returns (bytes_ms, operations_ms)."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    u_size, w_size = batch * seq_len * in_n * in_d, in_n * out_no * in_d
    v_size, b_size = batch * seq_len * out_no, in_n * out_no
    nbytes = 2 * (u_size + w_size + b_size) + 4 * v_size
    products = 2 * in_d * in_n * out_no + num_iter * 4 * in_n * out_no
    other = num_iter * (6 * in_n * out_n + 4 * out_no + 4 * out_n)
    if backward:
        nbytes += 4 * v_size + 2 * (u_size + w_size + b_size)
        products += 4 * in_d * in_n * out_no + 8 * in_n * out_no
        other += 4 * in_n * out_n + 4 * out_no + 12 * out_n
    rows = batch * seq_len
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            1e3 * rows * (products / PEAK_BF16_FLOPS
                          + other / PEAK_F32_FLOPS))


def bf16_ulps(torch, a, b):
    """|a - b| in bf16 units in the last place, entry by entry, for bf16
    tensors of one shape: the distance of their bit patterns in the order
    of the values (so -0 = +0)."""
    def key(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (key(a) - key(b)).abs()


def k1_bf16_uhat(torch, u, w, b, mask):
    """The bf16 u_hat that K1-bf16's prediction kernel writes, [B, T, in_n,
    out_n * out_d]: K1-bf16 launched through its C entry point (so not
    counted) on a scratch buffer of this function's, whose head holds
    u_hat in rows of ``row_pitch(out_n * out_d, 2)`` bf16."""
    from srf_tpu_torch.ops.routing import row_pitch
    from srf_tpu_torch.ops.routing_cuda import _lib

    lib = _lib("sdr_fwd")
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = w.shape[1], w.shape[2]
    out = torch.empty((batch, seq_len, out_n, out_d), dtype=torch.float32,
                      device=u.device)
    scratch = torch.empty(lib.sdr_fwd_bf16_scratch_floats(
        batch, seq_len, in_n, in_d, out_n, out_d), dtype=torch.float32,
        device=u.device)
    err = lib.sdr_fwd_bf16(
        u.data_ptr(), w.data_ptr(), b.data_ptr(), None, None,
        scratch.data_ptr(), out.data_ptr(), batch, seq_len, in_n, in_d,
        out_n, out_d, 1, int(bool(mask)),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(err == 0, "sdr_fwd_bf16 returned %d" % err)
    pitch = row_pitch(out_n * out_d, 2)
    rows = scratch.view(torch.bfloat16)[:batch * seq_len * in_n * pitch]
    return rows.view(batch, seq_len, in_n, pitch)[..., :out_n * out_d]


def bf16_kernel_phase(torch, device):
    """Phase 15a: K1-bf16 and K2-bf16 against their plain versions at
    SDR_SHAPES x TIMIT_LAYERS and EXTRA_LAYERS' wsj_layer0 and general,
    K1 and K2 at ACCUM_SHAPES, K5-bf16 at the CNN's sites; their times.
    Returns the three JSON entries."""
    import torch.nn.functional as F
    from srf_tpu_torch.ops.dropout import fused_dropout_plain
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda
    from srf_tpu_torch.ops.routing import (predict_capsules_bf16,
                                           sequential_routing,
                                           sequential_routing_bwd,
                                           sequential_routing_bwd_bf16,
                                           sequential_routing_from_uhat)
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    start = time.perf_counter()
    bf = torch.bfloat16
    rng = np.random.RandomState(SEED + 50)
    # the largest |kernel - plain| over the largest |plain|, and absolute
    err, err_abs = {"K1": 0.0, "K2": 0.0}, {"K1": 0.0, "K2": 0.0}
    totals = {"K1": sdr_totals(), "K2": sdr_totals()}
    per_layer = {"K1": [], "K2": []}
    # the controls: the largest mean |kernel - plain| over the smallest
    # mean |control - plain| (the share), each mean over mean |plain|;
    # u_hat's largest ulp distance and the share of its entries equal
    control = {key: {"share": 0.0, "kernel_mean_rel": 0.0,
                     "control_mean_rel": float("inf")}
               for key in ("K1", "K2")}
    uhat = {"max_ulps": 0, "equal": 1.0}

    def hold_control(key, what, got, want, controls, limit):
        def mean(x):
            return (x.float() - want.float()).abs().mean().item()
        scale = want.float().abs().mean().item()
        sound, worst = mean(got), min(mean(c) for c in controls)
        reading = control[key]
        reading["share"] = max(reading["share"], sound / worst)
        reading["kernel_mean_rel"] = max(reading["kernel_mean_rel"],
                                         sound / scale)
        reading["control_mean_rel"] = min(reading["control_mean_rel"],
                                          worst / scale)
        check(sound <= limit * worst, "%s: mean |kernel - plain| %.3e is "
              "not below %.2f x its control's %.3e" % (what, sound, limit,
                                                       worst))

    def draw(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32,
                            device=device)

    def hold(name, geometry, mask, batch, seq_len, num_iter, w, b):
        in_n, out_n, out_d, in_d = geometry
        u = draw(batch, seq_len, in_n, in_d).to(bf)
        got = sequential_routing_cuda(u, w, b, num_iter, mask)
        want = sequential_routing(u.float(), w.float(), b.float(), num_iter,
                                  mask, bf16=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "K1-bf16 output not finite")
        e = (got - want).abs().max().item()
        err_abs["K1"] = max(err_abs["K1"], e)
        e /= want.abs().max().item()
        err["K1"] = max(err["K1"], e)
        where = "%s %s B=%d T=%d iter=%d" % (name, geometry, batch, seq_len,
                                             num_iter)
        check(e <= BF16_K1_ATOL_REL, "K1-bf16 differs from its plain version "
              "by %.3e x max at %s" % (e, where))
        u_hat = predict_capsules_bf16(u, w, b)
        ulps = bf16_ulps(torch, k1_bf16_uhat(torch, u, w, b, mask),
                         u_hat.reshape(batch, seq_len, in_n, -1))
        uhat["max_ulps"] = max(uhat["max_ulps"], int(ulps.max().item()))
        uhat["equal"] = min(uhat["equal"], (ulps == 0).float().mean().item())
        check(uhat["max_ulps"] <= BF16_UHAT_ULPS, "K1-bf16's u_hat is %d "
              "bf16 ulps from predict_capsules_bf16's at %s"
              % (uhat["max_ulps"], where))
        # the controls take the same rows cut into sequences of
        # CONTROL_STEPS steps: over a whole sequence a flipped rounding
        # moves the carry, and with it later roundings
        steps = min(CONTROL_STEPS, seq_len)
        rows, kept = batch * (seq_len // steps), seq_len // steps * steps
        u_c = u[:, :kept].reshape(rows, steps, in_n, in_d)
        got_c = sequential_routing_cuda(u_c, w, b, num_iter, mask)
        hold_control("K1", "K1-bf16 at " + where, got_c, sequential_routing(
            u_c.float(), w.float(), b.float(), num_iter, mask, bf16=True), (
            sequential_routing(u_c.float(), w.float(), b.float(), num_iter,
                               mask),
            sequential_routing_from_uhat(
                u_hat[:, :kept].reshape(rows, steps, *u_hat.shape[2:])
                .float(), num_iter, mask)), BF16_K1_SHARE)
        if num_iter != 1:
            return u, got
        dvs = draw(batch, seq_len, out_n, out_d)
        grads = sequential_routing_bwd_cuda(u, w, b, got, dvs, mask)
        plain = sequential_routing_bwd_bf16(u, w, b, dvs, mask)
        dvs_c = dvs[:, :kept].reshape(rows, steps, out_n, out_d)
        # the control: the float32 K2 on the same inputs, rounded
        pairs = zip(sequential_routing_bwd_cuda(u_c, w, b, got_c, dvs_c,
                                                mask),
                    sequential_routing_bwd_bf16(u_c, w, b, dvs_c, mask),
                    sequential_routing_bwd_cuda(u_c.float(), w.float(),
                                                b.float(), got_c, dvs_c,
                                                mask))
        for label, (g, p, c) in zip(("du", "dW", "db"), pairs):
            hold_control("K2", "K2-bf16 %s at %s" % (label, where), g, p,
                         (c.to(bf),), BF16_K2_SHARE)
        torch.cuda.synchronize()
        for label, g, p in zip(("du", "dW", "db"), grads, plain):
            check(g.dtype == bf and bool(torch.isfinite(g).all()),
                  "K2-bf16 %s not a finite bf16 tensor" % label)
            e = (g.float() - p.float()).abs().max().item()
            err_abs["K2"] = max(err_abs["K2"], e)
            e /= p.float().abs().max().item()
            err["K2"] = max(err["K2"], e)
            check(e <= BF16_K2_ATOL_REL, "K2-bf16 %s differs from its plain "
                  "version by %.3e x max at %s %s B=%d T=%d"
                  % (label, e, name, geometry, batch, seq_len))
        return u, got

    for name, geometry, mask, count in TIMIT_LAYERS:
        in_n, out_n, out_d, in_d = geometry
        w = draw(in_n, out_n, out_d, in_d, scale=0.1)
        b = draw(in_n, out_n, out_d, scale=0.1)
        wb, bb = w.to(bf), b.to(bf)
        for batch, seq_len, num_iter, flip in SDR_SHAPES:
            u, out = hold(name, geometry, mask != flip, batch, seq_len,
                          num_iter, wb, bb)
            if (batch, seq_len) != (29, 64):
                continue
            ms = event_ms(torch, lambda: sequential_routing_cuda(
                u, wb, bb, 1, mask), 20)
            plain_ms = event_ms(torch, lambda: sequential_routing(
                u.float(), w, b, 1, mask, bf16=True), 2)
            add_layer(totals["K1"], per_layer["K1"], name, count, ms,
                      plain_ms, sdr_bf16_bound_ms(batch, seq_len, geometry, 1),
                      geometry=list(geometry), per_forward=count)
            # K2-bf16 at the training path's T' = 61
            u61, dvs = u[:, :61].contiguous(), draw(batch, 61, out_n, out_d)
            vs = sequential_routing_cuda(u61, wb, bb, 1, mask)
            ms = event_ms(torch, lambda: sequential_routing_bwd_cuda(
                u61, wb, bb, vs, dvs, mask), 10)
            plain_ms = event_ms(torch, lambda: sequential_routing_bwd_bf16(
                u61, wb, bb, dvs, mask), 2)
            add_layer(totals["K2"], per_layer["K2"], name, count, ms,
                      plain_ms, sdr_bf16_bound_ms(batch, 61, geometry, 1,
                                                  backward=True),
                      geometry=list(geometry), per_step=count)
            print("K1-bf16 %s B=29 T=64 %.4f ms, K2-bf16 T=61 %.4f ms"
                  % (name, per_layer["K1"][-1]["ms"], ms))
        # K1 and K2 (float32) at the accumulated steps' microbatch shapes
        for batch, seq_len in ACCUM_SHAPES:
            u = draw(batch, seq_len, in_n, in_d)
            got = sequential_routing_cuda(u, w, b, 1, mask)
            want = sequential_routing(u, w, b, 1, mask)
            dvs = draw(batch, seq_len, out_n, out_d)
            grads = sequential_routing_bwd_cuda(u, w, b, got, dvs, mask)
            plain = sequential_routing_bwd(u, w, b, want, dvs, mask)
            torch.cuda.synchronize()
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  "K1 disagrees with its plain version at %s B=%d T=%d"
                  % (geometry, batch, seq_len))
            for label, g, p in zip(("du", "dW", "db"), grads, plain):
                check(torch.allclose(g, p, rtol=K2_RTOL,
                                     atol=K2_ATOL_REL * p.abs().max().item()),
                      "K2 %s disagrees with its plain version at %s B=%d "
                      "T=%d" % (label, geometry, batch, seq_len))
    for index, (name, geometry, mask, w_std, shapes) in enumerate(
            EXTRA_LAYERS):
        if name not in ("wsj_layer0", "general"):
            continue
        w, b, _ = extra_weights(torch, device, index, geometry, w_std)
        for batch, seq_len, num_iter in shapes:
            hold(name, geometry, mask, batch, seq_len, num_iter, w.to(bf),
                 b.to(bf))
    print("K1-bf16 and K2-bf16 = their plain versions at %d shapes x the 3 "
          "TIMIT layers, wsj_layer0 and general: max |kernel - plain| K1 "
          "%.3e, K2 %.3e x max (limits %.0e, %.1e); K1 and K2 = plain at "
          "the microbatch shapes %s" % (len(SDR_SHAPES), err["K1"], err["K2"],
                                        BF16_K1_ATOL_REL, BF16_K2_ATOL_REL,
                                        list(ACCUM_SHAPES)))
    for key, limit in (("K1", BF16_K1_SHARE), ("K2", BF16_K2_SHARE)):
        reading = control[key]
        print("%s-bf16 against its controls: mean |kernel - plain| up to "
              "%.3e of mean |plain|, the controls' down to %.3e; the "
              "largest share %.4f (limit %.2f)"
              % (key, reading["kernel_mean_rel"],
                 reading["control_mean_rel"], reading["share"], limit))
    print("K1-bf16's u_hat against predict_capsules_bf16: at most %d bf16 "
          "ulps (limit %d), %.6f of the entries equal at the least"
          % (uhat["max_ulps"], BF16_UHAT_ULPS, uhat["equal"]))
    entries = []
    for label, source, replaces in (
            ("K1", "sdr_fwd", "srf_tpu/ops/routing_pallas.py:81"),
            ("K2", "sdr_bwd", "srf_tpu/ops/routing_pallas.py:159")):
        entry = kernel_entry(source + "_bf16", replaces, err_abs[label],
                             totals[label], per_layer[label])
        entry.update(source="srf_tpu_torch/csrc/%s.cu" % source,
                     max_err_of_max=err[label], control=control[label])
        if label == "K1":
            entry["uhat"] = uhat
        entries.append(entry)
        print("%s-bf16 one %s's 7 calls: %.4f ms, plain %.4f ms, bound %.4f "
              "ms (%s)" % (label, "forward" if label == "K1" else "step",
                           totals[label]["ms"], totals[label]["plain_ms"],
                           totals[label]["bound_ms"], entry["bound_by"]))

    # K5-bf16 at the CNN-TIMIT sites
    sites = cnn_site_shapes(torch, device)
    gen = torch.Generator(device).manual_seed(SEED + 51)
    k5 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for index, (shape, rate) in enumerate(sites):
        # values in [1, 2): a zero reads as dropped
        x = (1 + torch.rand(shape, generator=gen, device=device)).to(bf)
        seed = int(rng.randint(0, 2 ** 62, dtype=np.int64))
        got = fused_dropout_cuda(x, seed, rate)
        check(torch.equal(got, fused_dropout_plain(x, seed, rate)),
              "K5-bf16 differs from its plain version at site %d" % index)
        check(torch.equal(got != 0, fused_dropout_cuda(x.float(), seed,
                                                       rate) != 0),
              "K5-bf16's mask is not K5's at site %d" % index)
        ms = event_ms(torch, lambda: fused_dropout_cuda(x, seed, rate), 10)
        plain_ms = event_ms(torch, lambda: fused_dropout_plain(x, seed, rate),
                            2)
        library_ms = event_ms(torch, lambda: F.dropout(x, rate,
                                                       training=True), 10)
        for key, value in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", library_ms),
                           ("bound_ms", 1e3 * 4 * x.numel()
                            / PEAK_BYTES_PER_S)):
            k5[key] += 2 * value  # forward and backward at each site
        del x, got
    print("K5-bf16 = its plain version bit for bit, with K5's mask, at the "
          "%d CNN-TIMIT sites; a step's %d launches: %.4f ms, plain %.4f "
          "ms, F.dropout (bf16) %.4f ms, bound %.4f ms (bytes); %.1f s"
          % (len(sites), 2 * len(sites), k5["ms"], k5["plain_ms"],
             k5["library_ms"], k5["bound_ms"], time.perf_counter() - start))
    entries.append({
        "name": "fused_dropout_bf16", "route": "cuda",
        "source": "srf_tpu_torch/csrc/fused_dropout.cu",
        "replaces": "srf_tpu/ops/dropout_pallas.py:48", "launches": None,
        "max_abs_err": 0.0, "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": "bytes",
        "library_ms": k5["library_ms"]})
    torch.cuda.synchronize()
    return entries


def extras_corpus(base, vocab):
    """The extras recipe run's npy features and JSON manifests under
    ``base`` (the test split is phase 6c's)."""
    rng = np.random.RandomState(SEED + 60)
    splits = {"train": {}, "valid": {}, "test": test_split_data()}
    for split, buckets in (("train", EXTRAS_TRAIN), ("valid", EXTRAS_VALID)):
        for (low, high), count in buckets:
            for _ in range(count):
                n = int(rng.randint(low, high + 1))
                splits[split]["%s%03d" % (split, len(splits[split]))] = (
                    rng.randn(n, 123).astype(np.float32),
                    rng.randint(1, 62, size=max(2, n // 8)))
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


def extras_recipe_phase(torch, card, state):
    """Phase 15b: the SRF-TIMIT recipe through trainer_sr's CLI with
    --tpu-grad-accum=4 --tpu-ema-decay=0.999 --tpu-specaug=True, averaged,
    decoded with --tpu-decode-ema and served with it. Returns the K1 and K2
    launches of its training."""
    import contextlib
    import io
    import shutil
    import tempfile

    from srf_tpu_torch import trainer_sr
    from srf_tpu_torch.config import Logger, ParseOption
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)
    from srf_tpu_torch.serve import Recognizer
    from srf_tpu_torch.tools import average_ckpt, save_tfrecord
    from srf_tpu_torch.train.step import microbatches
    from srf_tpu_torch.utils import checkpoint, log2utt
    from srf_tpu_torch.utils.vocab import load_vocab

    start = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_extras_")
    vocab_path = os.path.join(REPO, "egs", "data", "timit_62.vocab")
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    ckpt = os.path.join(base, "ckpt")
    extras = ("--tpu-grad-accum=%d" % EXTRAS_ACCUM, "--tpu-ema-decay=0.999",
              "--tpu-specaug=True")
    try:
        splits = extras_corpus(base, load_vocab(vocab_path, logger)[0])
        save_tfrecord.main([
            "save_tfrecord", "--path-base=%s" % base,
            "--path-vocab=%s" % vocab_path, "--prep-data-shard=2",
            "--prep-data-name=synth", "--prep-data-unit=word",
            "--feat-type=None", "--feat-dim=123",
            "--path-train-json=train.json", "--path-valid-json=valid.json",
            "--path-test-json=test.json", "--path-wrt-tfrecord=tfrecord",
            "--decoding-from-npy=True"])
        counts = [len(splits[s]) for s in ("train", "valid", "test")]
        # each update launches K1 14 and K2 28 times per microbatch
        updates, real = [], trainer_sr.make_train_step

        def counted(*args, **kwargs):
            step = real(*args, **kwargs)

            def train_step(state_, batch, seed):
                before = (sequential_routing_cuda.launches,
                          sequential_routing_bwd_cuda.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state_, batch, seed)
                torch.cuda.synchronize()
                k = len(microbatches(batch, EXTRAS_ACCUM))
                got = (sequential_routing_cuda.launches - before[0],
                       sequential_routing_bwd_cuda.launches - before[1])
                check(got == (7 * K1_LAUNCHES * k, 7 * K2_LAUNCHES * k),
                      "an accumulated update of %s in %d microbatches "
                      "launched K1 %d and K2 %d times"
                      % (tuple(batch["feats"].shape[:2]), k, *got))
                updates.append((tuple(batch["feats"].shape[:2]), k,
                                1e3 * (time.perf_counter() - t0)))
                return out

            return train_step

        sequential_routing_cuda.launches = 0
        sequential_routing_bwd_cuda.launches = 0
        trainer_sr.make_train_step = counted
        try:
            t0 = time.perf_counter()
            trainer_sr.main(recipe_argv(
                base, ckpt, "--train-lr-param-k=0.5",
                "--train-es-tolerance=%d" % EXTRAS_EPOCHS,
                "--train-max-epoch=%d" % EXTRAS_EPOCHS,
                "--prep-data-num-train=%d" % counts[0],
                "--prep-data-num-valid=%d" % counts[1], *extras))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            trainer_sr.make_train_step = real
        launches = (sequential_routing_cuda.launches,
                    sequential_routing_bwd_cuda.launches)
        with open(os.path.join(ckpt, "metrics.jsonl")) as lines:
            records = [json.loads(line) for line in lines]
        check(len(records) == 2 * EXTRAS_EPOCHS
              and all(np.isfinite(r["loss"]) for r in records),
              "the extras run's records: %s" % records)
        check(len(updates) == EXTRAS_EPOCHS * 4
              and all(k == EXTRAS_ACCUM for _, k, _ in updates),
              "the extras run's updates: %s" % updates)
        manager = checkpoint.CheckpointManager(ckpt)
        trees = [manager.restore(s) for s in manager.all_steps()]
        check(len(trees) == EXTRAS_EPOCHS and all("ema" in t for t in trees),
              "the extras run's checkpoints hold no EMA")
        # the EMA trails the weights at decay 0.999: after 8 updates it
        # sits near the start, the weights moved away from it
        name = "W0"
        moved = (trees[-1]["model"][name] - trees[-1]["ema"][name]).abs()
        check(moved.max().item() > 0, "the EMA did not trail the weights")
        average_ckpt.main(recipe_argv(base, ckpt, "--model-average-num=%d"
                                      % EXTRAS_EPOCHS, *extras))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer_sr.main(decode_argv(
                base, "--path-ckpt=%s" % os.path.join(ckpt, "avg"),
                "--tpu-decode-ema=True", "--tpu-decode-batch=8",
                "--tpu-decode-pad-last=True"))
        decode_s = time.perf_counter() - t0
        hyps = dict(log2utt.parse_decode_log(io.StringIO(out.getvalue())))
        check(len(hyps) == counts[2], "the EMA decode gave %d utterances"
              % len(hyps))
        # the Recognizer serves the averaged EMA weights; the CPU's equal
        argv = ["serve", "--config=%s" % os.path.join(REPO, "egs", "conf",
                                                      "timit.conf"),
                "--path-base=%s" % REPO, "--path-ckpt=%s"
                % os.path.join(ckpt, "avg"), "--tpu-decode-ema=True",
                *TIMIT_FLAGS]
        config = ParseOption(argv, logger, is_print_opts=False).args
        feats_list = serve_batches()["8x150-400"][:4]
        rec = Recognizer(config, device="cuda", logger=logger)
        cpu = Recognizer(config, device="cpu", logger=logger)
        ema = checkpoint.CheckpointManager(os.path.join(ckpt, "avg")
                                           ).restore(1)["ema"]
        check(torch.equal(rec.model.W0.detach().cpu(), ema["W0"]),
              "the Recognizer does not serve the EMA weights")
        feats, lengths = rec.pad(feats_list)
        card_logits = rec.forward(feats, lengths).cpu()
        cpu_logits = cpu.forward(feats.cpu(), lengths)
        lerr = (card_logits - cpu_logits).abs().max().item()
        check(lerr <= LOGIT_ATOL, "EMA serving: card logits differ from the "
              "CPU's by %.3e" % lerr)
        check([r["ids"] for r in rec.transcribe_batch_detailed(feats_list)]
              == [r["ids"] for r in cpu.transcribe_batch_detailed(
                  feats_list)], "EMA serving: card ids differ from the CPU's")
        by_shape = {}
        for shape, _, ms in updates:
            by_shape.setdefault(shape, []).append(ms)
        print("extras recipe (trainer_sr, --tpu-grad-accum=%d "
              "--tpu-ema-decay=0.999 --tpu-specaug=True): %d train, %d "
              "valid, %d test utterances; %d epochs, %.1f s; epoch losses "
              "%s; %d updates, each K1 %d and K2 %d launches (%d "
              "microbatches); ms an update (host clock, the first at a "
              "shape included) %s; K1 %d, K2 %d launches in all; averaged "
              "(EMA too), decoded with --tpu-decode-ema (device beam, batch "
              "8) %d utterances in %.2f s; the Recognizer serves the EMA, "
              "card = CPU (logits %.3e, ids equal); %.1f s [%s]"
              % (EXTRAS_ACCUM, *counts, EXTRAS_EPOCHS, wall,
                 ["%.3f" % r["loss"] for r in records], len(updates),
                 7 * K1_LAUNCHES * EXTRAS_ACCUM,
                 7 * K2_LAUNCHES * EXTRAS_ACCUM, EXTRAS_ACCUM,
                 {"%dx%d" % s: ["%.1f" % x for x in v]
                  for s, v in by_shape.items()}, *launches, len(hyps),
                 decode_s, lerr, time.perf_counter() - start, card))
        return launches
    finally:
        shutil.rmtree(base, ignore_errors=True)


def timed_steps(torch, step, train_state, batch, seed, reps=EXTRAS_STEPS):
    """(losses per step, host-clock ms of each step after a first one,
    peak allocated bytes above those before the first step)."""
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(1 + reps):
        t0 = time.perf_counter()
        train_state, metrics = step(train_state, batch, seed)
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss_sum"].item())
    return losses, times, torch.cuda.max_memory_allocated() - base_bytes


def srf_step_flops(config, batch):
    """Model FLOPs of one SRF train step of ``config``'s model on
    ``batch``'s padded features (``utils/flops.srf_train_step_flops``)."""
    from srf_tpu_torch.utils import flops

    batch_n, frames, feat_dim = batch["feats"].shape
    return flops.srf_train_step_flops(
        batch_n, frames, feat_dim=feat_dim,
        enc_num=config.model_encoder_num,
        ph=config.model_caps_primary_num, pd=config.model_caps_primary_dim,
        ch=config.model_caps_convolution_num,
        cd=config.model_caps_convolution_dim, class_n=class_count(config),
        vd=config.model_caps_class_dim, lpad=config.model_caps_window_lpad,
        rpad=config.model_caps_window_rpad,
        num_iter=(1 if config.model_caps_type == "lowmemory"
                  else config.model_caps_iter),
        conv_layer_num=config.model_conv_layer_num,
        conv_filter_num=config.model_conv_filter_num,
        stride=config.model_conv_stride)


def extras_step_phase(torch, card, state, cnn_state):
    """Phase 15c: an accumulated step held to the CPU's, accumulated and
    bf16 steps timed beside float32's, the CNN's bf16 step, SRF-WSJ's
    forward in bf16 routing. Returns the launches of K1-bf16, K2-bf16 and
    K5-bf16 on those paths, and of K1 and K2."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import routing
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda
    from srf_tpu_torch.ops.routing_cuda import (SDRFunction,
                                                sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)
    from srf_tpu_torch.serve import Recognizer
    from srf_tpu_torch.utils import flops

    start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    batch = train_batch(torch, "cuda")
    train_parity(torch, config, state,
                 {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()},
                 label="accum %d " % EXTRAS_ACCUM, accum_steps=EXTRAS_ACCUM)

    def counts():
        return (sequential_routing_cuda.launches,
                sequential_routing_bwd_cuda.launches,
                sequential_routing_cuda.launches_bf16,
                sequential_routing_bwd_cuda.launches_bf16,
                fused_dropout_cuda.launches, fused_dropout_cuda.launches_bf16)

    def delta(before):
        return tuple(a - b for a, b in zip(counts(), before))

    # accumulation: 28 x 241 (4 divides it) at accum 1 and 4, dropout on
    b28 = {k: v[:28] for k, v in batch.items()}
    readings = {}
    for accum in (1, EXTRAS_ACCUM):
        train_state, _, step = train_setup(torch, config, state, "cuda",
                                           accum_steps=accum)
        before = counts()
        losses, times, peak = timed_steps(torch, step, train_state, b28,
                                          config.tpu_seed)
        got = delta(before)
        check(got[:2] == (7 * K1_LAUNCHES * accum * (1 + EXTRAS_STEPS),
                          7 * K2_LAUNCHES * accum * (1 + EXTRAS_STEPS)),
              "accum %d: K1 %d, K2 %d launches" % (accum, *got[:2]))
        check(bool(np.isfinite(losses).all()), "non-finite accumulated loss")
        readings[accum] = (float(np.median(times)), peak)
        del train_state, step
    print("accumulated step 28 x 241 (dropout on): accum 1 %.3f ms/step, "
          "peak %.1f MB above the state; accum %d (4 microbatches of 7, K1 "
          "%d and K2 %d launches an update) %.3f ms/step, peak %.1f MB [%s]"
          % (readings[1][0], readings[1][1] / 2**20, EXTRAS_ACCUM,
             7 * K1_LAUNCHES * EXTRAS_ACCUM, 7 * K2_LAUNCHES * EXTRAS_ACCUM,
             readings[EXTRAS_ACCUM][0], readings[EXTRAS_ACCUM][1] / 2**20,
             card))

    # bf16 steps at 29 x 241, dropout off, against float32 on the same
    # weights and batch; the main path's bf16 launches are counted from 0
    sequential_routing_cuda.launches_bf16 = 0
    sequential_routing_bwd_cuda.launches_bf16 = 0
    fused_dropout_cuda.launches_bf16 = 0
    plain_calls = (routing.sequential_routing_from_uhat.cuda_calls,
                   SDRFunction.plain_backwards)
    results = {}
    for label, flags in (("float32", ()), ("bf16", ("--tpu-bf16=True",)),
                         ("bf16 + routing bf16",
                          ("--tpu-bf16=True", "--tpu-routing-bf16=True"))):
        cfg = timit_config(logger, "cuda", TIMIT_FLAGS + list(flags))
        train_state, _, step = train_setup(torch, cfg, state, "cuda",
                                           dropout=False)
        before = counts()
        losses, times, peak = timed_steps(torch, step, train_state, batch,
                                          cfg.tpu_seed)
        got = delta(before)
        routing_bf16 = "routing" in label
        want = ((0, 0, 7 * K1_LAUNCHES, 7 * K2_LAUNCHES) if routing_bf16
                else (7 * K1_LAUNCHES, 7 * K2_LAUNCHES, 0, 0))
        check(got[:4] == tuple(x * (1 + EXTRAS_STEPS) for x in want),
              "%s step: K1 %d, K2 %d, K1-bf16 %d, K2-bf16 %d launches"
              % (label, *got[:4]))
        check(bool(np.isfinite(losses).all()), "%s: non-finite loss" % label)
        all_on_card(train_state, {})
        check(all(p.dtype == torch.float32
                  for p in train_state.model.parameters()),
              "%s: the master parameters are not float32" % label)
        results[label] = (losses[0], float(np.median(times)), peak)
        del train_state, step
    check((routing.sequential_routing_from_uhat.cuda_calls,
           SDRFunction.plain_backwards) == plain_calls,
          "a bf16 step ran a plain SDR loop on the card")
    f32_loss = results["float32"][0]
    for label, (loss, ms, peak) in results.items():
        rel = abs(loss - f32_loss) / abs(f32_loss)
        check(rel <= BF16_LOSS_RTOL, "%s step's loss %.4f vs float32's %.4f"
              % (label, loss, f32_loss))
        check(label == "float32" or rel >= BF16_LOSS_GAP, "%s step's loss "
              "is within %.2e of float32's: it did not round in bf16"
              % (label, rel))
        print("SRF-TIMIT step 29 x 241 (dropout off), %s: loss %.4f (rel "
              "to float32 %.2e, limits %.0e and at least %.0e), %.3f "
              "ms/step (median of %d), peak %.1f MB above the state [%s]"
              % (label, loss, rel, BF16_LOSS_RTOL, BF16_LOSS_GAP, ms,
                 EXTRAS_STEPS, peak / 2**20, card))
    rel = (abs(results["bf16 + routing bf16"][0] - results["bf16"][0])
           / abs(f32_loss))
    check(rel >= BF16_LOSS_GAP, "the bf16-routing step's loss is within "
          "%.2e of the bf16 step's: its SDR layers did not round in bf16"
          % rel)
    print("SRF-TIMIT step, bf16 routing against float32 routing under "
          "--tpu-bf16: loss rel %.2e (at least %.0e)" % (rel, BF16_LOSS_GAP))
    # the whole step's share of the card's peak for its dtype
    step_flops = srf_step_flops(config, batch)
    for label, peak in (("float32", flops.H100_PEAK_FP32),
                        ("bf16", flops.H100_PEAK_BF16)):
        ms = results[label][1]
        print("SRF-TIMIT step 29 x 241, %s: %.4e model FLOPs "
              "(utils/flops.py: 3 x the forward), %.3f ms/step, MFU %.5f of "
              "the %s peak %.4g FLOP/s [%s]"
              % (label, step_flops, ms, flops.mfu(step_flops, ms / 1e3, peak),
                 "float32" if label == "float32" else "bf16", peak, card))

    # the CNN's bf16 step: K5-bf16 at every site, K5 at none
    cnn = {}
    for label, flags in (("float32", ()), ("bf16", ("--tpu-bf16=True",))):
        cfg = timit_config(logger, "cuda", CNN_FLAGS + list(flags))
        train_state, _, step = train_setup(torch, cfg, cnn_state, "cuda",
                                           dropout="k5")
        before = counts()
        losses, times, _ = timed_steps(torch, step, train_state, batch,
                                       cfg.tpu_seed, reps=3)
        got = delta(before)
        want = (0, 2 * CNN_SITES) if flags else (2 * CNN_SITES, 0)
        check(got[4:] == tuple(x * 4 for x in want),
              "CNN %s step: K5 %d, K5-bf16 %d launches" % (label, *got[4:]))
        check(bool(np.isfinite(losses).all()), "CNN %s: non-finite loss"
              % label)
        cnn[label] = (losses[0], float(np.median(times)))
        del train_state, step
    rel = abs(cnn["bf16"][0] - cnn["float32"][0]) / abs(cnn["float32"][0])
    check(BF16_LOSS_GAP <= rel <= BF16_LOSS_RTOL, "CNN bf16 step's loss "
          "%.4f vs float32's %.4f (rel %.2e)" % (cnn["bf16"][0],
                                               cnn["float32"][0], rel))
    print("CNN-TIMIT step 29 x 241 (dropout at K5's sites): float32 %.3f "
          "ms/step, --tpu-bf16 %.3f ms/step (K5-bf16 %d launches a step, K5 "
          "0); loss %.4f vs %.4f (rel %.2e) [%s]"
          % (cnn["float32"][1], cnn["bf16"][1], 2 * CNN_SITES, cnn["bf16"][0],
             cnn["float32"][0], rel, card))
    bf16_launches = (sequential_routing_cuda.launches_bf16,
                     sequential_routing_bwd_cuda.launches_bf16,
                     fused_dropout_cuda.launches_bf16)

    # SRF-WSJ's forward at 8 x 1664: peak memory in float32 and bf16
    # routing
    wsj = {}
    feats_list = wsj_serve_batches()["8x300-1600"]
    for label, flags in (("float32", ()),
                         ("bf16 routing", ("--tpu-routing-bf16=True",))):
        cfg = family_config(logger, "cuda", "wsj", SRF_WSJ_FLAGS
                            + list(flags))
        classes = class_count(cfg)
        rec = Recognizer(cfg, state_dict=random_weights(
            build_model(cfg, classes)[0]), logger=logger)
        feats, lengths = rec.pad(feats_list)
        rec.forward(feats, lengths)
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits = rec.forward(feats, lengths)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(logits).all()), "SRF-WSJ %s logits" % label)
        wsj[label] = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_allocated() - base_bytes,
                      float(np.median(timed_ms(
                          torch, lambda: rec.forward(feats, lengths), 3))),
                      logits.cpu())
        del rec, feats, lengths, logits
    gap = (wsj["bf16 routing"][3] - wsj["float32"][3]).abs().max().item()
    print("SRF-WSJ forward 8 x 1664: float32 peak %.1f MB (%.1f above the "
          "weights), %.3f ms; bf16 routing peak %.1f MB (%.1f above), %.3f "
          "ms; logits bf16 vs float32 routing max %.3e; %.1f s [%s]"
          % (wsj["float32"][0] / 2**20, wsj["float32"][1] / 2**20,
             wsj["float32"][2], wsj["bf16 routing"][0] / 2**20,
             wsj["bf16 routing"][1] / 2**20, wsj["bf16 routing"][2], gap,
             time.perf_counter() - start, card))
    return bf16_launches


def mwer_phase(torch, card, state):
    """Phase 15d: MWER updates at SRF-TIMIT width on the card, the n-best
    held to the CPU's, each update's time split into the host n-best and
    the update."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)
    from srf_tpu_torch.train import mwer
    from srf_tpu_torch.train.step import make_logits_fn

    start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    batch = {k: v[:MWER_BATCH] for k, v in train_batch(torch,
                                                        "cuda").items()}
    train_state, apply_fn, _ = train_setup(torch, config, state, "cuda")
    logits_fn = make_logits_fn(apply_fn)
    cpu_state, cpu_apply, _ = train_setup(torch, config, state, "cpu")
    step = mwer.make_mwer_train_step(apply_fn, logits_fn, 4, MWER_BEAM,
                                     MWER_NBEST, 62, lam_ctc=0.1)
    decode_ms, real = [], mwer.decode_nbest

    def timed_decode(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    mwer.decode_nbest = timed_decode
    step_ms, losses, got = [], [], (0, 0)
    try:
        for _ in range(MWER_STEPS):
            # the n-best of this update's weights, card and CPU
            cpu_state.model.load_state_dict(train_state.model.state_dict())
            host = {k: v.cpu() for k, v in batch.items()}
            lens = np.maximum(1, -(-host["inp_len"].numpy() // 4))
            card_nbest = real(logits_fn(train_state, batch).cpu().numpy(),
                              lens, MWER_BEAM, MWER_NBEST, 62)
            cpu_nbest = real(make_logits_fn(cpu_apply)(
                cpu_state, host).numpy(), lens, MWER_BEAM, MWER_NBEST, 62)
            check(all(np.array_equal(a, b) for a, b in zip(card_nbest,
                                                           cpu_nbest)),
                  "MWER: the card's n-best differs from the CPU's")
            torch.cuda.synchronize()
            # the update's launches, counted from 0 (the check's are not)
            sequential_routing_cuda.launches = 0
            sequential_routing_bwd_cuda.launches = 0
            t0 = time.perf_counter()
            train_state, metrics = step(train_state, batch, config.tpu_seed)
            losses.append(metrics["loss_sum"].item())
            step_ms.append(1e3 * (time.perf_counter() - t0))
            got = (got[0] + sequential_routing_cuda.launches,
                   got[1] + sequential_routing_bwd_cuda.launches)
    finally:
        mwer.decode_nbest = real
    # an update: the n-best's eval forward and the training forward (K1),
    # the backward (K2)
    check(got == (MWER_STEPS * 2 * 7 * K1_LAUNCHES,
                  MWER_STEPS * 7 * K2_LAUNCHES),
          "MWER: K1 %d and K2 %d launches over %d updates" % (*got,
                                                             MWER_STEPS))
    check(bool(np.isfinite(losses).all()), "MWER: non-finite loss %s"
          % losses)
    print("MWER %d updates at SRF-TIMIT width (B %d x 241, n-best %d, beam "
          "%d, lambda-CTC 0.1): losses %s; the n-best = the CPU's; ms an "
          "update %s, of which the host n-best %s, the rest (forward, "
          "errors, scoring forward and backward) %s; %.1f s [%s]"
          % (MWER_STEPS, MWER_BATCH, MWER_NBEST, MWER_BEAM,
             ["%.3f" % x for x in losses], ["%.1f" % x for x in step_ms],
             ["%.1f" % x for x in decode_ms],
             ["%.1f" % (a - b) for a, b in zip(step_ms, decode_ms)],
             time.perf_counter() - start, card))
    return got


# phase 16: parallelism on torch.distributed. One card: NCCL runs at world
# size 1 (two ranks on one device are refused, "invalid usage"); the
# multi-rank paths run as PAR_RANKS processes sharing cuda:0 over gloo,
# which stages CUDA tensors through the host: their times say nothing of
# scaling
PAR_RANKS = 2
PAR_ROWS = 28  # 16b's global batch: 14 rows a rank
PAR_TIMED = 5  # timed steps after each parity step
# 16d: STF-TIMIT's attention, D 128 over 4 heads (depth 32), T' 600
RING_SHAPE = (8, 4, 600, 32)
# ring vs blockwise on the card, float32 both: values within RING_ATOL
# and each gradient within RING_GRAD_REL x its largest entry
# (tests/test_ring_attention.py's 2e-5 and 3e-5, the latter taken
# relative to the gradient's scale)
RING_ATOL, RING_GRAD_REL = 2e-5, 3e-5
PIPE_BATCH, PIPE_MICRO = 8, 4  # 16e: a 2-stage STF-TIMIT step
# 16e in float64, pipelined vs sequential: only the order of sums differs
# (measured 2e-15 of max on an H100)
PIPE64_GRAD_REL = 1e-12
# 16f: the CLI's corpus (fbank-123, 150-241 frames: the 7000-frame
# bucket of 29, rounded to 28 for 2 ranks: 14 rows a rank a step)
PAR_CLI_TRAIN, PAR_CLI_VALID = 56, 28
NO_DROPOUT_FLAGS = ["--train-att-dropout=0", "--train-inn-dropout=0",
                    "--train-inp-dropout=0", "--train-res-dropout=0"]


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def par_step(torch, config, state, batch, group=None, grad_group=None,
             mesh=None, fsdp=False, apply_fn_of=None, timed=0, float64=False,
             model_mesh=None, device="cuda", dropout=False,
             cudnn_search=True, step_of=None):
    """One dropout-free train step of ``config``'s model from ``state`` on
    the card, at the Noam schedule's count PARITY_COUNT (phase 7's parity
    step), data-parallel over ``group`` / ``grad_group``, sharded over
    ``mesh`` where ``fsdp``, its class capsules over ``model_mesh``'s
    'model' axis where given (apply_rules); ``apply_fn_of(model,
    in_len_div)`` replaces the apply adapter (the pipeline's); ``float64``
    runs the model and the features in float64; ``dropout`` "k5" keeps
    the K5 sites' dropout on (``train_setup``'s "k5": their masks follow
    the step seed); ``cudnn_search`` False takes cuDNN's heuristics;
    ``step_of(apply_fn, in_len_div)`` replaces make_train_step (phase
    18's emulated DP step); ``device`` the CPU in phase 18's rehearsal. Then
    ``timed`` more steps. Returns the loss, the whole gradients and state
    after the step (on the host), the rate, K1's and K2's launches in the
    step (and K1-tp's and K2-tp's, K1-tp-bf16's and K2-tp-bf16's, and of
    the float32 ones the persistent transports'; K5's), each timed step's
    ms and the peak memory over the timed steps (MB; 0 on the CPU)."""
    from srf_tpu_torch.models.layers import set_batch_norm_group
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import dropout_cuda, routing_cuda
    from srf_tpu_torch.parallel import sharding_rules
    from srf_tpu_torch.train.optimizer import get_optimizer
    from srf_tpu_torch.train.state import TrainState
    from srf_tpu_torch.train.step import make_apply_fn, make_train_step

    model, in_len_div = build_model(config, class_count(config))
    model.load_state_dict(state)
    if float64:
        model = model.double()
        batch = dict(batch, feats=batch["feats"].double())
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Dropout) and (
                dropout != "k5" or name.startswith("conv_feat.")):
            module.p = 0.0
    set_batch_norm_group(model, group)
    train_state = TrainState.create(model, None, None, device=device)
    # TrainState.create turns cuDNN's search on (device.resolve_device)
    torch.backends.cudnn.benchmark = cudnn_search
    if fsdp:
        sharding_rules.fsdp(train_state.model, mesh)
    if model_mesh is not None:
        sharding_rules.apply_rules(train_state.model, model_mesh)
    train_state.optimizer, train_state.scheduler = get_optimizer(
        config, train_state.model.parameters())
    rate = train_state.scheduler.lr_lambdas[0](PARITY_COUNT)
    for param_group in train_state.optimizer.param_groups:
        param_group["lr"] = rate
    apply_fn = (apply_fn_of(train_state.model, in_len_div) if apply_fn_of
                else make_apply_fn(train_state.model,
                                   extra_kwargs_fn(config, in_len_div)))
    step = (step_of(apply_fn, in_len_div) if step_of else make_train_step(
        apply_fn, in_len_div, group=group, grad_group=grad_group,
        model_group=model_mesh.group("model") if model_mesh else None))
    k1, k2 = (routing_cuda.sequential_routing_cuda,
              routing_cuda.sequential_routing_bwd_cuda)
    k1tp, k2tp = (routing_cuda.sequential_routing_tp_cuda,
                  routing_cuda.sequential_routing_tp_bwd_cuda)
    k5 = dropout_cuda.fused_dropout_cuda
    k1.launches = k2.launches = k1tp.launches = k2tp.launches = 0
    k1tp.launches_persistent = k2tp.launches_persistent = 0
    k1tp.launches_bf16 = k2tp.launches_bf16 = k5.launches = 0
    _, metrics = step(train_state, batch, config.tpu_seed)
    synchronize(torch, device)
    launches = (k1.launches, k2.launches)
    k5_launches = k5.launches
    tp_launches = (k1tp.launches, k2tp.launches)
    tp_launches_bf16 = (k1tp.launches_bf16, k2tp.launches_bf16)
    tp_persistent = (k1tp.launches_persistent, k2tp.launches_persistent)
    model = train_state.model
    grads = sharding_rules.full_state(sharding_rules.gather_named(
        {k: p.grad for k, p in model.named_parameters() if p.requires_grad},
        model))
    after = sharding_rules.full_state({"model": model.state_dict()},
                                      model)["model"]
    result = {"loss": metrics["loss_sum"].item(), "rate": rate,
              "launches": launches, "tp_launches": tp_launches,
              "tp_launches_bf16": tp_launches_bf16,
              "tp_persistent": tp_persistent, "k5": k5_launches,
              "grads": {k: v.detach().to("cpu", copy=True)
                        for k, v in grads.items()},
              "state": {k: v.detach().to("cpu", copy=True)
                        for k, v in after.items()}}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    result["ms"] = timed_ms(torch, lambda: step(train_state, batch,
                                                config.tpu_seed), timed,
                            device)
    result["peak_mb"] = (torch.cuda.max_memory_allocated() / 2 ** 20
                         if cuda else 0.0)
    return result


def par_compare(label, got, want, card, grad_atol_rel=GRAD_ATOL_REL,
                loss_rtol=LOSS_RTOL, update_grad_rel=UPDATE_GRAD_REL):
    """``got``'s step held to ``want``'s with phase 7's limits: the loss
    within ``loss_rtol``, every gradient within GRAD_ATOL_REL x its largest
    entry, the BatchNorm statistics within STATS_ATOL, each update within
    UPDATE_ATOL_REL x the rate where the gradient is at least
    ``update_grad_rel`` x its largest (``grad_atol_rel`` None: the
    gradients printed, not held). Returns the worst readings."""
    rate = want["rate"]
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad_err = {k: (got["grads"][k] - w).abs().max().item()
                / max(w.abs().max().item(), 1e-30)
                for k, w in want["grads"].items()}
    stat_err = {k: (got["state"][k] - w).abs().max().item()
                for k, w in want["state"].items() if "running_" in k}
    update_err = {}
    for name, grad in want["grads"].items():
        sure = grad.abs() >= update_grad_rel * grad.abs().max()
        diff = got["state"][name] - want["state"][name]
        update_err[name] = diff[sure].abs().max().item() / rate
    worst_grad, worst_stat, worst_update = (
        worst(x) for x in (grad_err, stat_err, update_err))
    print("%s: the 4 worst gradients %s" % (label, ", ".join(
        "%s %.2e" % (k, v) for v, k in sorted(
            ((v, k) for k, v in grad_err.items()), reverse=True)[:4])))
    print("%s: loss %.6f vs %.6f (rel %.2e, rtol %.0e); worst gradient %s "
          "%.2e x max (atol %s); BatchNorm stats %.2e (atol %.0e); "
          "updates %.2e x rate (atol %.0e) [%s]"
          % (label, got["loss"], want["loss"], loss_err, loss_rtol,
             worst_grad[1], worst_grad[0],
             "%.0e" % grad_atol_rel if grad_atol_rel else "printed only",
             worst_stat[0],
             STATS_ATOL, worst_update[0], UPDATE_ATOL_REL, card))
    check(np.isfinite(got["loss"]) and loss_err <= loss_rtol,
          "%s: loss %r vs %r" % (label, got["loss"], want["loss"]))
    check(grad_atol_rel is None or worst_grad[0] <= grad_atol_rel,
          "%s: gradient %s %.3e x its max" % (label, worst_grad[1],
                                              worst_grad[0]))
    check(worst_stat[0] <= STATS_ATOL, "%s: %s differs by %.3e"
          % (label, worst_stat[1], worst_stat[0]))
    check(worst_update[0] <= UPDATE_ATOL_REL, "%s: update of %s %.3e x rate"
          % (label, worst_update[1], worst_update[0]))
    return {"loss_rel": loss_err, "grad_rel": worst_grad[0],
            "stats": worst_stat[0], "update_rel": worst_update[0]}


def ring_inputs(shape=RING_SHAPE):
    """16d's query, key, value, padding mask (rows padded from 70 % of T'
    on) and cotangent, from numpy."""
    rng = np.random.RandomState(SEED + 16)
    batch, heads, seq, depth = shape
    arrays = {n: rng.randn(*shape).astype(np.float32)
              for n in ("q", "k", "v", "cot")}
    lengths = rng.randint(int(0.7 * seq), seq + 1, size=batch)
    arrays["mask"] = (np.arange(seq)[None] >= lengths[:, None]).astype(
        np.float32)[:, None, None, :]
    return arrays


def stf_parallel_config(logger):
    """STF-TIMIT (phase 10's model) with its dropouts off."""
    return family_config(logger, "cuda", "timit",
                         STF_TIMIT_FLAGS + NO_DROPOUT_FLAGS)


def attention_run(torch, fn, arrays, device="cuda"):
    """``fn(q, k, v, mask)``'s output and the gradients of its dot product
    with the cotangent, on the card (``device``: the CPU in phase 18's
    rehearsal); and the peak memory of the forward and backward above the
    inputs (MB; 0 on the CPU)."""
    q, k, v = (torch.tensor(arrays[n], device=device, requires_grad=True)
               for n in ("q", "k", "v"))
    mask, cot = (torch.tensor(arrays[n], device=device)
                 for n in ("mask", "cot"))
    cuda = torch.device(device).type == "cuda"
    synchronize(torch, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    out = fn(q, k, v, mask)
    (out * cot).sum().backward()
    synchronize(torch, device)
    peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 20 if cuda
            else 0.0)
    ms = timed_ms(torch, lambda: (fn(q, k, v, mask) * cot).sum().backward(),
                  3, device)
    return {"out": out.detach().cpu(), "dq": q.grad.cpu(),
            "dk": k.grad.cpu(), "dv": v.grad.cpu(), "peak_mb": peak,
            "ms": ms}


def stf_penalty():
    """STF-TIMIT's closed-form attention penalty (ConvEncoder.from_config's
    PenaltyParams of zero width 1, stripe 1, scale 1)."""
    from srf_tpu_torch.ops.attention_penalty import MAX_LEN
    from srf_tpu_torch.ops.blockwise_attention import PenaltyParams

    return PenaltyParams(1, 1, 1.0, len(range(0, MAX_LEN, 1)))


def parallel_worker(workdir):
    """One rank of 16b-16e (``chip_smoke.py --parallel-worker DIR``, the
    SRF_* variables set): on cuda:0 over gloo, the DP step (16b), the FSDP
    step (16c), ring attention (16d) and the 2-stage pipelined step
    (16e); writes DIR/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.attention_penalty import create_attention_penalty
    from srf_tpu_torch.ops.ring_attention import ring_attention
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_mesh, make_pipeline_mesh
    from srf_tpu_torch.parallel.pipeline import make_pipeline_apply_fn

    distributed.maybe_initialize(backend="gloo", device="cuda")
    rank, world = distributed.rank(), distributed.world_size()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    rows = PAR_ROWS // world
    batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in
             inputs["batch"].items()}
    batch = {k: v.cuda() if k in ("feats", "labels") else v
             for k, v in batch.items()}
    mesh = make_mesh(device="cuda")
    out = {"device": str(torch.device("cuda", torch.cuda.current_device()))}
    out["dp"] = par_step(torch, config, inputs["state"], batch,
                         group=mesh.group(), timed=PAR_TIMED)
    # FSDP: every K1/K2 call must see whole, contiguous weights
    seen, real = [], routing_cuda.sequential_routing_cuda

    def recording(u, wgt, bias, *args, **kwargs):
        seen.append((type(wgt).__name__, wgt.is_contiguous(),
                     tuple(wgt.shape)))
        return real(u, wgt, bias, *args, **kwargs)

    routing_cuda.sequential_routing_cuda = recording
    try:
        out["fsdp"] = par_step(torch, config, inputs["state"], batch,
                               group=mesh.group(), mesh=mesh, fsdp=True,
                               timed=PAR_TIMED)
    finally:
        routing_cuda.sequential_routing_cuda = real
    out["fsdp_weights"] = sorted(set(seen))
    penalty = stf_penalty()
    out["ring"] = attention_run(
        torch, lambda q, k, v, mask: ring_attention(
            q, k, v, torch.distributed.group.WORLD, mask, penalty),
        inputs["ring"])
    stf_config = stf_parallel_config(logger)
    pipe_mesh = make_pipeline_mesh(world, device="cuda")

    def pipelined(model, in_len_div):
        return make_pipeline_apply_fn(
            model, pipe_mesh, PIPE_MICRO,
            create_attention_penalty(stf_config, logger), in_len_div)

    pipe_batch = {k: v.cuda() if k in ("feats", "labels") else v
                  for k, v in inputs["pipe_batch"].items()}
    for key, float64 in (("pipeline", False), ("pipeline64", True)):
        out[key] = par_step(
            torch, stf_config, inputs["stf_state"], pipe_batch,
            group=pipe_mesh.group("data"),
            grad_group=torch.distributed.group.WORLD, apply_fn_of=pipelined,
            timed=0 if float64 else PAR_TIMED, float64=float64)
    torch.save(out, os.path.join(workdir, "rank%d.pt" % rank))
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def parallel_cli_worker(workdir):
    """One rank of 16f (``chip_smoke.py --parallel-cli DIR``): the gloo
    group started first (two ranks share the card), then trainer_sr's
    main, which keeps it; writes the rank's K1/K2 launches."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch import trainer_sr
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel import distributed

    distributed.maybe_initialize(backend="gloo", device="cuda")
    with open(os.path.join(workdir, "argv.json")) as f:
        argv = json.load(f)
    start = time.perf_counter()
    trainer_sr.main(argv)
    torch.cuda.synchronize()
    with open(os.path.join(workdir, "cli%d.json" % distributed.rank()),
              "w") as f:
        json.dump({"k1": routing_cuda.sequential_routing_cuda.launches,
                   "k2": routing_cuda.sequential_routing_bwd_cuda.launches,
                   "secs": time.perf_counter() - start,
                   "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20},
                  f)
    torch.distributed.destroy_process_group()
    return 0


def launch_ranks(flag, workdir, timeout=600, ranks=PAR_RANKS, cards=False):
    """``chip_smoke.py flag workdir`` as ``ranks`` processes of one world
    on cuda:0 (LOCAL_RANK 0 for each), or with ``cards`` on cuda:0 ..
    cuda:ranks-1; fails on any exit code but 0."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, SRF_COORDINATOR="127.0.0.1:%d" % port,
                   SRF_NUM_PROCESSES=str(ranks), SRF_PROCESS_ID=str(rank),
                   LOCAL_RANK=str(rank) if cards else "0",
                   PYTHONFAULTHANDLER="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, workdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    codes = [proc.returncode for proc in procs]
    check(codes == [0] * ranks, "%s exited %s: %s" % (
        flag, codes, "\n".join("rank %d: %s" % (rank, err[-3000:])
                               for rank, (_, err) in enumerate(outputs))))
    return outputs


def parallel_phase(torch, card, state):
    """Phase 16 (the module docstring). Returns K1's and K2's launches by
    path: the NCCL world-size-1 steps here and every rank's steps."""
    import shutil
    import tempfile

    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.stf import ConvEncoder
    from srf_tpu_torch.ops.blockwise_attention import blockwise_attention
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_mesh
    from srf_tpu_torch.parallel.pipeline import bubble

    phase_start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = timit_config(logger, "cuda")
    k1_by, k2_by = {}, {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        # the one-process references on the card
        batch28 = train_batch(torch, "cuda", batch=PAR_ROWS)
        single28 = par_step(torch, config, state, batch28, timed=PAR_TIMED)
        stf_config = stf_parallel_config(logger)
        stf_model = ConvEncoder.from_config(stf_config,
                                            class_count(stf_config))
        stf_state = random_weights(stf_model)
        pipe_batch = train_batch(torch, "cuda", batch=PIPE_BATCH)
        stf_single = par_step(torch, stf_config, stf_state, pipe_batch,
                              timed=PAR_TIMED)
        stf_single64 = par_step(torch, stf_config, stf_state, pipe_batch,
                                float64=True)
        arrays, penalty = ring_inputs(), stf_penalty()
        block = attention_run(
            torch, lambda q, k, v, mask: blockwise_attention(
                q, k, v, mask, penalty=penalty), arrays)
        torch.save({"state": state, "stf_state": stf_state,
                    "batch": {k: v.cpu() for k, v in batch28.items()},
                    "pipe_batch": {k: v.cpu()
                                   for k, v in pipe_batch.items()},
                    "ring": arrays}, os.path.join(workdir, "inputs.pt"))

        # 16b-16e: two ranks on the card over gloo
        start = time.perf_counter()
        launch_ranks("--parallel-worker", workdir)
        ranks = [torch.load(os.path.join(workdir, "rank%d.pt" % r),
                            weights_only=False) for r in range(PAR_RANKS)]
        print("16b-e: %d ranks on %s over gloo, %.1f s"
              % (PAR_RANKS, ranks[0]["device"], time.perf_counter() - start))
        for label, key in (("16b DP", "dp"), ("16c FSDP", "fsdp")):
            for r, rank in enumerate(ranks):
                check(rank[key]["launches"] == (7 * K1_LAUNCHES,
                                                7 * K2_LAUNCHES),
                      "%s rank %d: K1/K2 launches %s" % (label, r,
                                                         rank[key]["launches"]))
                par_compare("%s rank %d (%d x 241 global) vs one process"
                            % (label, r, PAR_ROWS), rank[key], single28,
                            card)
            same = all(torch.equal(ranks[0][key]["state"][k],
                                   ranks[1][key]["state"][k])
                       for k in ranks[0][key]["state"] if "running_" in k)
            check(same, "%s: BatchNorm statistics differ between ranks"
                  % label)
            print("%s: K1 %d, K2 %d launches a rank; BatchNorm statistics "
                  "equal on both ranks; ms a step %s; peak %s MB (one "
                  "process: %s ms, %.1f MB) [gloo through the host: no "
                  "scaling result] [%s]"
                  % (label, 7 * K1_LAUNCHES, 7 * K2_LAUNCHES,
                     ["%.1f" % np.median(r[key]["ms"]) for r in ranks],
                     ["%.1f" % r[key]["peak_mb"] for r in ranks],
                     "%.1f" % np.median(single28["ms"]),
                     single28["peak_mb"], card))
            k1_by[key] = sum(r[key]["launches"][0] for r in ranks)
            k2_by[key] = sum(r[key]["launches"][1] for r in ranks)
        weights = ranks[0]["fsdp_weights"]
        whole = {tuple(v.shape) for k, v in state.items()
                 if re.fullmatch(r"W\d+", k)}
        check(weights and all(t in ("Tensor", "Parameter") and c
                              and shape in whole
                              for t, c, shape in weights),
              "16c: K1 saw %s (the whole W: %s)" % (weights, whole))
        print("16c: K1 received whole, contiguous weights under FSDP: %s"
              % weights)
        for r, rank in enumerate(ranks):
            ring = rank["ring"]
            err = (ring["out"] - block["out"]).abs().max().item()
            grad_err = max((ring[n] - block[n]).abs().max().item()
                           / block[n].abs().max().item()
                           for n in ("dq", "dk", "dv"))
            check(err <= RING_ATOL and grad_err <= RING_GRAD_REL,
                  "16d rank %d: ring vs blockwise %.3e, gradients %.3e x max"
                  % (r, err, grad_err))
            print("16d ring attention rank %d, %s: out %.3e from blockwise "
                  "(atol %.0e), gradients %.3e x max (%.0e); forward + "
                  "backward %.1f ms (blockwise %.1f ms), attention peak "
                  "%.1f MB a rank (blockwise %.1f MB) [gloo: no scaling "
                  "result] [%s]"
                  % (r, RING_SHAPE, err, RING_ATOL, grad_err, RING_GRAD_REL,
                     np.median(ring["ms"]), np.median(block["ms"]),
                     ring["peak_mb"], block["peak_mb"], card))
        for r, rank in enumerate(ranks):
            # float64: the schedule, the exchanges and the gradients' sums
            # are exact (a ReLU cannot flip there); float32: the loss, the
            # BatchNorm statistics and Adam's updates at phase 7's limits,
            # the gradients printed (microbatches of 2 rows take other
            # GEMM kernels than 8 rows, and a pre-activation within an ulp
            # of 0 flips its ReLU: a whole token's share of that unit's
            # weight gradient)
            exact = par_compare(
                "16e pipeline rank %d float64" % r, rank["pipeline64"],
                stf_single64, card, grad_atol_rel=PIPE64_GRAD_REL)
            par_compare("16e pipeline rank %d (STF-TIMIT, 2 stages x %d "
                        "microbatches, B %d)" % (r, PIPE_MICRO, PIPE_BATCH),
                        rank["pipeline"], stf_single, card,
                        grad_atol_rel=None)
            print("16e rank %d: float64 gradients %.2e of max (limit %.0e)"
                  % (r, exact["grad_rel"], PIPE64_GRAD_REL))
        print("16e: bubble (S-1)/(M+S-1) = %.2f; ms a step %s, peak %s MB "
              "(one process %.1f ms, %.1f MB) [gloo: no scaling result] [%s]"
              % (bubble(PAR_RANKS, PIPE_MICRO),
                 ["%.1f" % np.median(r["pipeline"]["ms"]) for r in ranks],
                 ["%.1f" % r["pipeline"]["peak_mb"] for r in ranks],
                 np.median(stf_single["ms"]), stf_single["peak_mb"], card))

        # 16a: NCCL at world size 1, in this process
        batch29 = train_batch(torch, "cuda")
        plain = par_step(torch, config, state, batch29, timed=PAR_TIMED)
        os.environ.update(SRF_COORDINATOR="127.0.0.1:%d" % free_port(),
                          SRF_NUM_PROCESSES="1", SRF_PROCESS_ID="0")
        try:
            check(distributed.maybe_initialize(device="cuda"),
                  "16a: no process group")
            check(torch.distributed.get_backend() == "nccl",
                  "16a: backend %s" % torch.distributed.get_backend())
            mesh = make_mesh(device="cuda")
            for label, kwargs in (("DP", {}), ("FSDP", {"fsdp": True})):
                got = par_step(torch, config, state, batch29,
                               group=mesh.group(), mesh=mesh,
                               timed=PAR_TIMED, **kwargs)
                check(got["launches"] == (7 * K1_LAUNCHES, 7 * K2_LAUNCHES),
                      "16a %s: launches %s" % (label, got["launches"]))
                dist = max(
                    [abs(got["loss"] - plain["loss"])]
                    + [(got["grads"][k] - v).abs().max().item()
                       for k, v in plain["grads"].items()]
                    + [(got["state"][k] - v).abs().max().item()
                       for k, v in plain["state"].items()
                       if v.is_floating_point()])
                par_compare("16a NCCL world size 1 %s vs the plain step"
                            % label, got, plain, card)
                print("16a %s: max distance from the plain step %.3e "
                      "(expected 0); ms a step %.1f (plain %.1f), peak "
                      "%.1f MB (plain %.1f) [%s]"
                      % (label, dist, np.median(got["ms"]),
                         np.median(plain["ms"]), got["peak_mb"],
                         plain["peak_mb"], card))
                k1_by["nccl_" + label.lower()] = got["launches"][0]
                k2_by["nccl_" + label.lower()] = got["launches"][1]
        finally:
            if distributed.is_initialized():
                torch.distributed.destroy_process_group()
            for name in ("SRF_COORDINATOR", "SRF_NUM_PROCESSES",
                         "SRF_PROCESS_ID"):
                os.environ.pop(name, None)

        # 16f: trainer_sr's epoch on two ranks
        k1_by["cli"], k2_by["cli"] = parallel_cli_phase(torch, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("parallel phase: %.1f s" % (time.perf_counter() - phase_start))
    return k1_by, k2_by


def parallel_cli_phase(torch, card, workdir):
    """16f: a synthetic corpus as TFRecords, trainer_sr's epoch on
    PAR_RANKS ranks (example sharding, lockstep), both ranks logging the
    same global losses, rank 0's checkpoint and metrics. Returns the
    ranks' K1 and K2 launches."""
    from srf_tpu_torch.utils import checkpoint

    base = os.path.join(workdir, "cli")
    rng = np.random.RandomState(SEED + 40)
    for split, count in (("train", PAR_CLI_TRAIN), ("valid", PAR_CLI_VALID),
                         ("test", 2)):
        utts = {}
        for i in range(count):
            n = int(rng.randint(150, 242))
            utts["%s%03d" % (split, i)] = (
                rng.randn(n, 123).astype(np.float32),
                rng.randint(1, 62, size=max(2, n // 8)))
        write_split(base, split, utts, 2)
    ckpt = os.path.join(base, "ckpt")
    argv = ["trainer_sr",
            "--config=%s" % os.path.join(REPO, "egs", "conf", "timit.conf"),
            "--path-base=%s" % base,
            "--path-vocab=%s" % os.path.join(REPO, "egs", "data",
                                             "timit_62.vocab"),
            "--path-ckpt=%s" % ckpt, "--feat-type=None",
            "--path-train-ptrn=tfrecord/synth-train-None-123-*-of-*",
            "--path-valid-ptrn=tfrecord/synth-valid-None-123-*-of-*",
            "--path-test-ptrn=tfrecord/synth-test-None-123-*-of-*",
            "--prep-data-num-train=%d" % PAR_CLI_TRAIN,
            "--prep-data-num-valid=%d" % PAR_CLI_VALID,
            "--prep-data-num-test=2", "--device=cuda",
            "--train-batch-frame=7000", "--train-warmup-n=1200",
            "--train-lr-param-k=0.5", "--train-max-epoch=1",
            *[f for f in TIMIT_FLAGS if not f.startswith("--decoding-beam")]]
    with open(os.path.join(workdir, "argv.json"), "w") as f:
        json.dump(argv, f)
    start = time.perf_counter()
    outs = launch_ranks("--parallel-cli", workdir)
    secs = time.perf_counter() - start
    valid = [re.findall(r"Epoch 001 Valid Loss ([0-9.]+)", err)
             for _, err in outs]
    check(valid[0] and valid[0] == valid[1],
          "16f: the ranks' valid losses %s" % valid)
    with open(os.path.join(ckpt, "metrics.jsonl")) as records:
        losses = [json.loads(line)["loss"] for line in records]
    check(len(losses) == 2 and np.isfinite(losses).all(),
          "16f: metrics %s" % losses)
    check(checkpoint.CheckpointManager(ckpt).all_steps() == [1],
          "16f: no epoch checkpoint")
    counts = []
    for r in range(PAR_RANKS):
        with open(os.path.join(workdir, "cli%d.json" % r)) as f:
            counts.append(json.load(f))
    # 2 steps of 14 rows a rank and one valid batch of 14
    check(all(c["k1"] == 3 * 7 * K1_LAUNCHES and c["k2"] == 2 * 7
              * K2_LAUNCHES for c in counts), "16f: launches %s" % counts)
    print("16f trainer_sr epoch on %d ranks (gloo, cuda:0): %d train and %d "
          "valid utterances, train/valid loss %s, both ranks' valid loss %s; "
          "K1 %s, K2 %s launches a rank; %.1f s in all, %s s a rank's "
          "process, peak %s MB [%s]"
          % (PAR_RANKS, PAR_CLI_TRAIN, PAR_CLI_VALID,
             ["%.4f" % x for x in losses], valid[0][0],
             [c["k1"] for c in counts], [c["k2"] for c in counts], secs,
             ["%.1f" % c["secs"] for c in counts],
             ["%.1f" % c["peak_mb"] for c in counts], card))
    return (sum(c["k1"] for c in counts), sum(c["k2"] for c in counts))


# phase 17: the 'model' mesh axis (class capsules sharded over ranks, the
# routing softmax split across them: K1-tp and K2-tp). 17a first runs the
# persistent kernels as a co-launch of every rank's shard in this process
# (one card; the exchange through flags in device memory, the protocol and
# kernels that run across cards), then the ranks as processes sharing
# cuda:0 over gloo (NCCL refuses two ranks on one device), whose transport
# is the host loop (processes on one card are time-sliced, so a persistent
# kernel could wait on a peer that is not running), every exchange staged
# through the host: those times are a check, not a scaling result. 17c
# takes two cards (the step across them over NCCL and CUDA IPC)
# 17a: K1-tp and K2-tp against the plain split version, as (label, ranks,
# whole geometry (in_n, out_n, out_d, in_d), PAD mask, (B, T', iterations)
# shapes): SRF-WSJ's last layer (150 -> 32 classes of dim 20, 16 a rank)
# at 8 x 1600 frames (T' 400), and SRF-TIMIT's at model 3 (90 -> 63 of dim
# 8, 21 a rank) at the unpadded bucket 29 x 241 (T' 61); on each, rank 0
# holds the PAD capsule and the others do not
TP_CASES = (
    ("wsj_last", 2, (150, 32, 20, 20), True, ((8, 400, 1), (8, 400, 2))),
    ("timit_last", 3, (90, 63, 8, 8), True, ((29, 61, 1), (29, 61, 2))),
)
# timed calls of each kernel and plain version (after a first; the
# median is kept: over gloo one call's time spreads ~2x), at each case's
# one-iteration shape, the one 17b's step routes at (the co-launch: at
# every shape)
TP_REPS = 3
# 17b: the SRF-WSJ step on a (data 1, model 2) mesh; its timed steps
TP_TIMED = 1
# item 7c's variants, held at each case's one-iteration shape: the
# co-launch and the host loop over gloo. K1-tp-bf16 and K2-tp-bf16 against
# the plain split bf16 version within BF16_K1_ATOL_REL and BF16_K2_ATOL_REL
# of its largest entry (K1-bf16's and K2-bf16's limits: float32 sums in
# another order may round a c, a v or a dc to the other bf16 neighbour),
# the (M, L) statistics within BF16_K1_ATOL_REL of their largest entry
# (M and L apart); K1-tp-stream
# (each shard's carry 0.3 x normal, its rows' first TP_WARMUP steps
# warm-up on every other row) at K1's RTOL and ATOL, its v_last (the last
# step's output) too. Over gloo (K1-tp and K2-tp too) the kernels' median
# of TP_REPS calls, the plain version's one call (the one compared)
TP_WARMUP = 3
# 17d: item 7c's drives on the SRF-WSJ recipe's widths at depth
# TP_7C_LAYERS, 8 utterances of TP_7C_FRAMES frames, 2 ranks on cuda:0
# over gloo: the bf16-routing step on (data 1, model 2) against one
# process's bf16 step (its loss within BF16_LOSS_RTOL, its gradients
# within TP_7C_GRAD_REL of their largest entry: the same rounding points,
# float32 sums in other orders, and a flipped rounding carried through 3
# layers; measured 9.0e-6 and 7.2e-3 on an H100, where phase 7's LOSS_RTOL
# leaves no margin),
# a streamed push and route_block through the sharded model against the
# unsharded ones, and the sharded wavefront forward against the unsharded
# wavefront, both within STREAM_7C_ATOL
TP_7C_LAYERS = 3
TP_7C_FRAMES = (300, 400)
TP_7C_GRAD_REL = 2.5e-2
STREAM_7C_ATOL = 1e-4


def tp_parts(ranks):
    """The co-launch's parts (as K1_PARTS) for ``ranks`` shards, timed by
    the profiler at the first case: (K1-tp's, K2-tp's)."""
    return ((("prediction", "sdr_predict_kernel", ranks),
             ("persistent", "sdr_tp_fwd_persistent_kernel", 1)),
            (("prediction", "sdr_predict_kernel", ranks),
             ("persistent", "sdr_tp_bwd_persistent_kernel", 1),
             ("weight_gradient", "sdr_bwd_wgrad_kernel", ranks),
             ("reduction", "sdr_bwd_reduce_kernel", ranks)))

# transport 2's set-up check: floats of the pattern rank 0 writes
IPC_PATTERN = 4096


def median_ms(torch, fns, reps):
    """Median ms of each function in ``fns`` over ``reps`` calls after one
    warm-up call each, from CUDA events, the calls interleaved (a round
    calls each function once, in order)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, kept in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            kept.append(start.elapsed_time(end))
    return [float(np.median(kept)) for kept in times]


def tp_case_inputs(torch, geometry, batch, seq_len, indices, size, seed):
    """The whole W (std 0.1) and bias of a 17a case, from numpy (every
    rank draws the same whole tensors), u, and for each rank of
    ``indices`` its contiguous shard of W and bias and the cotangent of its
    outputs: (u, [W_r], [b_r], [cot_r])."""
    in_n, out_n, out_d, in_d = geometry
    rng = np.random.RandomState(seed)
    wgt = rng.randn(in_n, out_n, out_d, in_d) * 0.1
    bias = rng.randn(in_n, out_n, out_d) * 0.1
    u = rng.randn(batch, seq_len, in_n, in_d)
    cot = rng.randn(batch, seq_len, out_n, out_d)
    cuda = lambda x: torch.tensor(np.ascontiguousarray(x),
                                  dtype=torch.float32, device="cuda")
    parts = [slice(q * out_n // size, (q + 1) * out_n // size)
             for q in indices]
    return (cuda(u), [cuda(wgt[:, p]) for p in parts],
            [cuda(bias[:, p]) for p in parts],
            [cuda(cot[:, :, p]) for p in parts])


def tp_variant_inputs(torch, u, wgts, seed):
    """Item 7c's variants' extra inputs for a 17a case: each shard's carry
    before step 0 (0.3 x normal, from numpy) and the step mask [B, T],
    every other row's first TP_WARMUP steps warm-up."""
    batch, seq_len = u.shape[:2]
    rng = np.random.RandomState(seed)
    v_inits = [torch.tensor(0.3 * rng.randn(batch, *w.shape[1:3]),
                            dtype=torch.float32, device=u.device)
               for w in wgts]
    valid = torch.ones(batch, seq_len, dtype=torch.bool, device=u.device)
    valid[::2, :TP_WARMUP] = False
    return v_inits, valid


def bf16_rel(torch, got, want):
    """The largest |got - want| over the largest |want|, float32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def stats_rel(torch, got, want):
    """The (M, L) statistics [..., 2] apart: the larger of M's and L's
    largest difference over their largest entry (M, a row's largest
    logit, can be near 0, where a relative reading says nothing)."""
    return max(bf16_rel(torch, got[..., i], want[..., i]) for i in (0, 1))


def event_call(torch, fn):
    """(fn's result, its ms from CUDA events): one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def tp_colaunch_variants(torch, label, geometry, local, is_last, batch,
                         seq_len, u, wgts, biases, cots):
    """17a's item-7c checks of one case in this process: K1-tp-bf16 and
    K2-tp-bf16 (bf16 u, W and b) and K1-tp-stream as co-launches, each
    held to its plain version (``sequential_routing_tp_colaunch(...,
    bf16=True / v_inits, step_valid)`` and its backward) on the same CUDA
    tensors, with launches a call, median ms of TP_REPS calls, the plain
    version's, and the bounds of the co-launch's work and of one rank's.
    Returns the reading's keys (k1tpbf16_*, k2tpbf16_*, k1tpstream_*)."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing import (sequential_routing_tp_bwd_colaunch,
                                           sequential_routing_tp_colaunch)

    fwd_k = routing_cuda.sequential_routing_tp_colaunch_cuda
    bwd_k = routing_cuda.sequential_routing_tp_bwd_colaunch_cuda
    shape = "(%d, %d)" % (batch, seq_len)
    ub = u.bfloat16()
    wb, bb = [w.bfloat16() for w in wgts], [b.bfloat16() for b in biases]
    reading = {}
    # K1-tp-bf16
    plain = lambda: sequential_routing_tp_colaunch(ub, wb, bb, 1, is_last,
                                                   bf16=True)
    kernel = lambda: fwd_k(ub, wb, bb, 1, is_last)
    (want, want_stats), (got, got_stats) = plain(), kernel()
    before = fwd_k.launches_bf16
    kernel()
    launches = fwd_k.launches_bf16 - before
    routing_cuda.check_tp_status()
    err = max(bf16_rel(torch, g, w) for g, w in zip(got, want))
    stats_err = max(stats_rel(torch, g, w)
                    for g, w in zip(got_stats, want_stats))
    check(err <= BF16_K1_ATOL_REL and stats_err <= BF16_K1_ATOL_REL,
          "17a co-launch %s %s: K1-tp-bf16 differs from its plain version "
          "by %.3e of max (statistics %.3e of max)"
          % (label, shape, err, stats_err))
    plain_ms, ms = median_ms(torch, (plain, kernel), TP_REPS)
    reading.update(
        k1tpbf16_err=err, k1tpbf16_stats_rel=stats_err,
        k1tpbf16_launches=launches, k1tpbf16_ms=ms,
        k1tpbf16_plain_ms=plain_ms,
        k1tpbf16_bound_ms=sdr_bf16_bound_ms(batch, seq_len, geometry, 1),
        k1tpbf16_rank_bound_ms=sdr_bf16_bound_ms(batch, seq_len, local, 1))
    # K2-tp-bf16 on that forward
    plain_b = lambda: sequential_routing_tp_bwd_colaunch(
        ub, wb, bb, want, cots, want_stats, is_last, bf16=True)
    kernel_b = lambda: bwd_k(ub, wb, bb, want, cots, want_stats, is_last)
    refs, gots = plain_b(), kernel_b()
    routing_cuda.check_tp_status()
    errs = [bf16_rel(torch, torch.cat(list(g), 1) if isinstance(g, list)
                     else g, torch.cat(list(r), 1) if isinstance(r, list)
                     else r) for g, r in zip(gots, refs)]
    check(max(errs) <= BF16_K2_ATOL_REL and all(
        g.dtype == torch.bfloat16 for g in [gots[0], *gots[1], *gots[2]]),
          "17a co-launch %s %s: K2-tp-bf16 (du, dW, db) differ from their "
          "plain versions by %s of max" % (label, shape, errs))
    before = bwd_k.launches_bf16
    kernel_b()
    b_launches = bwd_k.launches_bf16 - before
    plain_ms, ms = median_ms(torch, (plain_b, kernel_b), TP_REPS)
    reading.update(
        k2tpbf16_err=max(errs), k2tpbf16_launches=b_launches,
        k2tpbf16_ms=ms, k2tpbf16_plain_ms=plain_ms,
        k2tpbf16_bound_ms=sdr_bf16_bound_ms(batch, seq_len, geometry, 1,
                                            backward=True),
        k2tpbf16_rank_bound_ms=sdr_bf16_bound_ms(batch, seq_len, local, 1,
                                                 backward=True))
    # K1-tp-stream: a carry and warm-up steps
    v_inits, valid = tp_variant_inputs(torch, u, wgts, SEED + 178 + seq_len)
    plain_s = lambda: sequential_routing_tp_colaunch(
        u, wgts, biases, 1, is_last, v_inits=v_inits, step_valid=valid)
    kernel_s = lambda: fwd_k(u, wgts, biases, 1, is_last, v_inits, valid)
    (want, want_stats), (got, got_stats) = plain_s(), kernel_s()
    routing_cuda.check_tp_status()
    pairs = list(zip(got + got_stats, want + want_stats))
    err = max((g - w).abs().max().item() for g, w in pairs)
    check(all(torch.allclose(g, w, rtol=RTOL, atol=ATOL) for g, w in pairs)
          and all(torch.allclose(g[:, -1], w[:, -1], rtol=RTOL, atol=ATOL)
                  for g, w in zip(got, want))
          and not any(g[::2, :TP_WARMUP].any().item() for g in got),
          "17a co-launch %s %s: K1-tp-stream differs from its plain version "
          "by %.3e (or a warm-up step is not zero)" % (label, shape, err))
    before = fwd_k.launches_stream
    kernel_s()
    s_launches = fwd_k.launches_stream - before
    plain_ms, ms = median_ms(torch, (plain_s, kernel_s), TP_REPS)
    reading.update(
        k1tpstream_err=err, k1tpstream_launches=s_launches,
        k1tpstream_ms=ms, k1tpstream_plain_ms=plain_ms,
        k1tpstream_bound_ms=sdr_bound_ms(batch, seq_len, geometry, 1),
        k1tpstream_rank_bound_ms=sdr_bound_ms(batch, seq_len, local, 1))
    routing_cuda.check_tp_status()
    return reading


def tp_colaunch_checks(torch, card):
    """17a in this process: the persistent K1-tp and K2-tp as co-launches
    of every rank's shard (``sequential_routing_tp_colaunch_cuda`` and its
    backward). First the drive: one forward and one backward at the first
    case's one-iteration shape, float32 and bf16, and one forward with a
    carry and a step mask, the launch counts set to 0 just before and read
    just after. Then every case and shape held to the plain split version
    (``ops.routing.sequential_routing_tp_colaunch`` and its backward) on
    the same CUDA tensors, with the launches a call, median ms, plain ms,
    the bound of the co-launch's work (every shard: the whole layer) and of
    one rank's, and the parts' device ms at the first case; at each case's
    one-iteration shape item 7c's variants too (:func:`tp_colaunch_variants`).
    Then the co-launch of one shard (the whole layer). Every launch's
    status words are read (``check_tp_status``) before its results are
    held. Returns (the readings, (K1-tp's, K2-tp's, K1-tp-bf16's,
    K2-tp-bf16's, K1-tp-stream's) launches in the drive)."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing import (sequential_routing_tp_bwd_colaunch,
                                           sequential_routing_tp_colaunch)

    fwd_k = routing_cuda.sequential_routing_tp_colaunch_cuda
    bwd_k = routing_cuda.sequential_routing_tp_bwd_colaunch_cuda
    readings, drive = [], None
    for label, ranks, geometry, is_last, shapes in TP_CASES:
        local = (geometry[0], geometry[1] // ranks) + geometry[2:]
        for batch, seq_len, num_iter in shapes:
            u, wgts, biases, cots = tp_case_inputs(
                torch, geometry, batch, seq_len, range(ranks), ranks,
                SEED + 170 + seq_len + num_iter)
            if drive is None:
                # the drive: K1-tp, K2-tp and item 7c's K1-tp-bf16,
                # K2-tp-bf16 and K1-tp-stream, once each
                v_inits, valid = tp_variant_inputs(torch, u, wgts, SEED + 179)
                ub = u.bfloat16()
                wb = [w.bfloat16() for w in wgts]
                bb = [b.bfloat16() for b in biases]
                torch.cuda.synchronize()
                fwd_k.launches = bwd_k.launches = 0
                fwd_k.launches_bf16 = bwd_k.launches_bf16 = 0
                fwd_k.launches_stream = 0
                outs, statss = fwd_k(u, wgts, biases, 1, is_last)
                bwd_k(u, wgts, biases, outs, cots, statss, is_last)
                outs, statss = fwd_k(ub, wb, bb, 1, is_last)
                bwd_k(ub, wb, bb, outs, cots, statss, is_last)
                fwd_k(u, wgts, biases, 1, is_last, v_inits, valid)
                routing_cuda.check_tp_status()
                drive = (fwd_k.launches, bwd_k.launches, fwd_k.launches_bf16,
                         bwd_k.launches_bf16, fwd_k.launches_stream)
                want_drive = (ranks + 1, 3 * ranks + 1) * 2 + (ranks + 1,)
                check(drive == want_drive,
                      "17a: the co-launch drive made %s launches, not %s"
                      % (drive, want_drive))
            plain = lambda: sequential_routing_tp_colaunch(
                u, wgts, biases, num_iter, is_last)
            kernel = lambda: fwd_k(u, wgts, biases, num_iter, is_last)
            want, want_stats = plain()
            before = fwd_k.launches
            got, got_stats = kernel()
            routing_cuda.check_tp_status()
            launches = fwd_k.launches - before
            pairs = list(zip(got + got_stats, want + want_stats))
            err = max((g - w).abs().max().item() for g, w in pairs)
            check(all(torch.allclose(g, w, rtol=RTOL, atol=ATOL)
                      for g, w in pairs),
                  "17a co-launch %s (%d, %d, iter %d): K1-tp differs from "
                  "its plain version by %.3e" % (label, batch, seq_len,
                                                 num_iter, err))
            plain_ms, ms = median_ms(torch, (plain, kernel), TP_REPS)
            reading = {
                "case": label, "ranks": ranks,
                "shape": [batch, seq_len, num_iter], "k1tp_err": err,
                "k1tp_launches": launches, "k1tp_ms": ms,
                "k1tp_plain_ms": plain_ms,
                "k1tp_bound_ms": sdr_bound_ms(batch, seq_len, geometry,
                                              num_iter),
                "k1tp_rank_bound_ms": sdr_bound_ms(batch, seq_len, local,
                                                   num_iter)}
            if num_iter == 1:
                plain_b = lambda: sequential_routing_tp_bwd_colaunch(
                    u, wgts, biases, want, cots, want_stats, is_last)
                kernel_b = lambda: bwd_k(u, wgts, biases, want, cots,
                                         want_stats, is_last)
                refs = plain_b()
                before = bwd_k.launches
                gots = kernel_b()
                routing_cuda.check_tp_status()
                errs = []
                for name, ref, val in zip(
                        ("du", "dW", "db"),
                        (refs[0], torch.cat(refs[1], 1),
                         torch.cat(refs[2], 1)),
                        (gots[0], torch.cat(gots[1], 1),
                         torch.cat(gots[2], 1))):
                    limit = K2_ATOL_REL * ref.abs().max().item()
                    errs.append((val - ref).abs().max().item())
                    check(torch.allclose(val, ref, rtol=K2_RTOL, atol=limit),
                          "17a co-launch %s (%d, %d): K2-tp %s differs from "
                          "its plain version by %.3e (atol %.3e)"
                          % (label, batch, seq_len, name, errs[-1], limit))
                b_launches = bwd_k.launches - before
                plain_ms, ms = median_ms(torch, (plain_b, kernel_b), TP_REPS)
                reading.update(
                    k2tp_err=max(errs), k2tp_launches=b_launches,
                    k2tp_ms=ms, k2tp_plain_ms=plain_ms,
                    k2tp_bound_ms=sdr_bwd_bound_ms(batch, seq_len, geometry),
                    k2tp_rank_bound_ms=sdr_bwd_bound_ms(batch, seq_len,
                                                        local))
                reading.update(tp_colaunch_variants(
                    torch, label, geometry, local, is_last, batch, seq_len,
                    u, wgts, biases, cots))
                if not readings:
                    fwd_parts, bwd_parts = tp_parts(ranks)
                    (reading["k1tp_parts_ms"],
                     reading["k1tp_parts_traces_discarded"]) = parts_ms(
                         torch, kernel, fwd_parts)
                    (reading["k2tp_parts_ms"],
                     reading["k2tp_parts_traces_discarded"]) = parts_ms(
                         torch, kernel_b, bwd_parts)
            readings.append(reading)
            print("17a co-launch %s, %d ranks (B, T', iter) %s: K1-tp %.3e "
                  "from its plain version, %d launches, %.3f ms (plain %.3f, "
                  "bound %.3f, one rank's %.3f)%s [%s]"
                  % (label, ranks, tuple(reading["shape"]), err,
                     reading["k1tp_launches"], reading["k1tp_ms"],
                     reading["k1tp_plain_ms"],
                     max(reading["k1tp_bound_ms"]),
                     max(reading["k1tp_rank_bound_ms"]),
                     "" if num_iter > 1 else
                     "; K2-tp %.3e, %d launches, %.3f ms (plain %.3f, bound "
                     "%.3f, one rank's %.3f)"
                     % (reading["k2tp_err"], reading["k2tp_launches"],
                        reading["k2tp_ms"], reading["k2tp_plain_ms"],
                        max(reading["k2tp_bound_ms"]),
                        max(reading["k2tp_rank_bound_ms"])), card))
            if "k1tpbf16_ms" in reading:
                print("17a co-launch %s %s: K1-tp-bf16 %.3e of max, %d "
                      "launches, %.3f ms (plain %.3f, bound %.3f, one rank's "
                      "%.3f); K2-tp-bf16 %.3e of max, %d launches, %.3f ms "
                      "(plain %.3f, bound %.3f, one rank's %.3f); "
                      "K1-tp-stream %.3e, %d launches, %.3f ms (plain %.3f, "
                      "bound %.3f) [%s]"
                      % (label, tuple(reading["shape"]),
                         reading["k1tpbf16_err"],
                         reading["k1tpbf16_launches"],
                         reading["k1tpbf16_ms"], reading["k1tpbf16_plain_ms"],
                         max(reading["k1tpbf16_bound_ms"]),
                         max(reading["k1tpbf16_rank_bound_ms"]),
                         reading["k2tpbf16_err"],
                         reading["k2tpbf16_launches"],
                         reading["k2tpbf16_ms"], reading["k2tpbf16_plain_ms"],
                         max(reading["k2tpbf16_bound_ms"]),
                         max(reading["k2tpbf16_rank_bound_ms"]),
                         reading["k1tpstream_err"],
                         reading["k1tpstream_launches"],
                         reading["k1tpstream_ms"],
                         reading["k1tpstream_plain_ms"],
                         max(reading["k1tpstream_bound_ms"]), card))
            if "k1tp_parts_ms" in reading:
                print("17a co-launch %s: parts ms a call, K1-tp %s, K2-tp %s "
                      "(traces discarded: %d, %d)"
                      % (label, reading["k1tp_parts_ms"],
                         reading["k2tp_parts_ms"],
                         reading["k1tp_parts_traces_discarded"],
                         reading["k2tp_parts_traces_discarded"]))
    # the co-launch of one shard (every capsule): the last SRF-TIMIT layer
    # whole, two out capsules a lane (K2-tp one row a warp)
    label, _, geometry, is_last, shapes = TP_CASES[1]
    batch, seq_len, _ = shapes[0]
    u, wgts, biases, (cot,) = tp_case_inputs(
        torch, geometry, batch, seq_len, (0,), 1, SEED + 177)
    (want,), (want_stats,) = sequential_routing_tp_colaunch(
        u, wgts, biases, 1, is_last)
    (got,), (got_stats,) = fwd_k(u, wgts, biases, 1, is_last)
    refs = sequential_routing_tp_bwd_colaunch(
        u, wgts, biases, [want], [cot], [want_stats], is_last)
    gots = bwd_k(u, wgts, biases, [want], [cot], [want_stats], is_last)
    routing_cuda.check_tp_status()
    refs, gots = ([refs[0], refs[1][0], refs[2][0]],
                  [gots[0], gots[1][0], gots[2][0]])
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL)
          and torch.allclose(got_stats, want_stats, rtol=RTOL, atol=ATOL)
          and all(torch.allclose(g, r, rtol=K2_RTOL,
                                 atol=K2_ATOL_REL * r.abs().max().item())
                  for g, r in zip(gots, refs)),
          "17a one shard: the persistent K1-tp or K2-tp differs from its "
          "plain version")
    print("17a co-launch of one shard, %s whole (B, T') (%d, %d): K1-tp "
          "%.3e, K2-tp %.3e of max from their plain versions"
          % (label, batch, seq_len,
             max((got - want).abs().max().item(),
                 (got_stats - want_stats).abs().max().item()),
             max(((g - r).abs().max() / r.abs().max()).item()
                 for g, r in zip(gots, refs))))
    return readings, drive


def tp_kernel_checks(torch, label, geometry, is_last, shapes, group):
    """17a on this rank: K1-tp against ``sequential_routing_tp`` (output
    and the global (M, L)) and, at one iteration, K2-tp against
    ``sequential_routing_tp_bwd`` on the same forward, on the same CUDA
    tensors, over the group's transport; at one iteration each one's
    median ms, the plain version's, the bound (K1's and K2's on this
    rank's shard), and the host loop's ms without the exchange (the same
    launches on this rank's shard alone, ``group`` None: another softmax,
    the same work); at more iterations,
    K2-tp's refusal of that forward's stats. Returns the readings per
    (B, T', iterations)."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing import (sequential_routing_tp,
                                           sequential_routing_tp_bwd)
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_tp_bwd_cuda,
                                                sequential_routing_tp_cuda)
    from srf_tpu_torch.parallel import distributed

    index, size = distributed.rank(group), distributed.world_size(group)
    pad_owner = is_last and index == 0
    readings = []
    for batch, seq_len, num_iter in shapes:
        u, (wgt,), (bias,), (cot,) = tp_case_inputs(
            torch, geometry, batch, seq_len, (index,), size,
            SEED + 170 + seq_len + num_iter)
        local = (geometry[0], wgt.shape[1], geometry[2], geometry[3])
        plain = lambda: sequential_routing_tp(u, wgt, bias, num_iter,
                                              pad_owner, group,
                                              return_stats=True)
        kernel = lambda: sequential_routing_tp_cuda(u, wgt, bias, num_iter,
                                                    pad_owner, group)
        (want, want_stats), plain_ms = event_call(torch, plain)
        got, got_stats = kernel()
        routing_cuda.check_tp_status()
        err = max((got - want).abs().max().item(),
                  (got_stats - want_stats).abs().max().item())
        ok = (torch.allclose(got, want, rtol=RTOL, atol=ATOL)
              and torch.allclose(got_stats, want_stats, rtol=RTOL,
                                 atol=ATOL))
        check(ok, "17a %s rank %d (%d, %d, iter %d): K1-tp differs from its "
              "plain version by %.3e" % (label, index, batch, seq_len,
                                         num_iter, err))
        reading = {"shape": [batch, seq_len, num_iter], "pad_owner": pad_owner,
                   "k1tp_err": err}
        if num_iter > 1:
            # K2-tp is the one-iteration backward: a deeper forward's (M, L)
            # must be refused (before any launch or exchange)
            try:
                sequential_routing_tp_bwd_cuda(u, wgt, bias, got, cot,
                                               got_stats, pad_owner, group)
            except ValueError:
                pass
            else:
                check(False, "17a %s rank %d: K2-tp took a %d-iteration "
                      "forward's stats" % (label, index, num_iter))
        if num_iter == 1:
            ms, alone_ms = median_ms(torch, (
                kernel, lambda: sequential_routing_tp_cuda(
                    u, wgt, bias, 1, pad_owner, None)), TP_REPS)
            reading.update(
                k1tp_ms=ms, k1tp_plain_ms=plain_ms, k1tp_alone_ms=alone_ms,
                k1tp_bound_ms=sdr_bound_ms(batch, seq_len, local, 1))
            plain_b = lambda: sequential_routing_tp_bwd(
                u, wgt, bias, want, cot, pad_owner, group, want_stats)
            kernel_b = lambda: sequential_routing_tp_bwd_cuda(
                u, wgt, bias, want, cot, want_stats, pad_owner, group)
            refs, plain_ms = event_call(torch, plain_b)
            gots = kernel_b()
            routing_cuda.check_tp_status()
            errs = []
            for name, ref, val in zip(("du", "dW", "db"), refs, gots):
                limit = K2_ATOL_REL * ref.abs().max().item()
                errs.append((val - ref).abs().max().item())
                check(torch.allclose(val, ref, rtol=K2_RTOL, atol=limit),
                      "17a %s rank %d (%d, %d): K2-tp %s differs from its "
                      "plain version by %.3e (atol %.3e)"
                      % (label, index, batch, seq_len, name, errs[-1], limit))
            ms, alone_ms = median_ms(torch, (
                kernel_b, lambda: sequential_routing_tp_bwd_cuda(
                    u, wgt, bias, want, cot, want_stats, pad_owner, None)),
                TP_REPS)
            reading.update(k2tp_err=max(errs), k2tp_ms=ms,
                           k2tp_plain_ms=plain_ms, k2tp_alone_ms=alone_ms,
                           k2tp_bound_ms=sdr_bwd_bound_ms(batch, seq_len,
                                                          local))
            reading.update(tp_host_loop_variants(
                torch, label, index, pad_owner, group, u, wgt, bias, cot,
                local, batch, seq_len))
        readings.append(reading)
    return readings


def tp_host_loop_variants(torch, label, index, pad_owner, group, u, wgt,
                          bias, cot, local, batch, seq_len):
    """17a's item-7c checks on this rank over the group's transport (the
    host loop over gloo): K1-tp-bf16 and K2-tp-bf16 against
    ``sequential_routing_tp(..., bf16=True)`` and
    ``sequential_routing_tp_bwd_bf16``, K1-tp-stream against
    ``sequential_routing_tp(..., v_init, step_valid)``, on the same CUDA
    tensors; each kernel's median ms of TP_REPS calls, the plain version's
    one call. Returns the reading's keys."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.routing import (sequential_routing_tp,
                                           sequential_routing_tp_bwd_bf16)
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_tp_bwd_cuda,
                                                sequential_routing_tp_cuda)

    where = "17a %s rank %d (%d, %d)" % (label, index, batch, seq_len)
    ub, wb, bb = u.bfloat16(), wgt.bfloat16(), bias.bfloat16()
    reading = {}
    (want, want_stats), plain_ms = event_call(
        torch, lambda: sequential_routing_tp(
            ub, wb, bb, 1, pad_owner, group, return_stats=True, bf16=True))
    kernel = lambda: sequential_routing_tp_cuda(ub, wb, bb, 1, pad_owner,
                                                group)
    got, got_stats = kernel()
    routing_cuda.check_tp_status()
    err = bf16_rel(torch, got, want)
    stats_err = stats_rel(torch, got_stats, want_stats)
    check(err <= BF16_K1_ATOL_REL and stats_err <= BF16_K1_ATOL_REL,
          "%s: K1-tp-bf16 differs from its plain version by %.3e of max "
          "(statistics %.3e of max)" % (where, err, stats_err))
    reading.update(k1tpbf16_err=err, k1tpbf16_plain_ms=plain_ms,
                   k1tpbf16_ms=median_ms(torch, (kernel,), TP_REPS)[0],
                   k1tpbf16_bound_ms=sdr_bf16_bound_ms(batch, seq_len, local,
                                                       1))
    refs, plain_ms = event_call(torch, lambda: sequential_routing_tp_bwd_bf16(
        ub, wb, bb, cot, pad_owner, group))
    kernel_b = lambda: sequential_routing_tp_bwd_cuda(
        ub, wb, bb, want, cot, want_stats, pad_owner, group)
    gots = kernel_b()
    routing_cuda.check_tp_status()
    errs = [bf16_rel(torch, g, r) for g, r in zip(gots, refs)]
    check(max(errs) <= BF16_K2_ATOL_REL
          and all(g.dtype == torch.bfloat16 for g in gots),
          "%s: K2-tp-bf16 (du, dW, db) differ from their plain versions by "
          "%s of max" % (where, errs))
    reading.update(k2tpbf16_err=max(errs), k2tpbf16_plain_ms=plain_ms,
                   k2tpbf16_ms=median_ms(torch, (kernel_b,), TP_REPS)[0],
                   k2tpbf16_bound_ms=sdr_bf16_bound_ms(
                       batch, seq_len, local, 1, backward=True))
    (v_init,), valid = tp_variant_inputs(torch, u, [wgt],
                                         SEED + 180 + index)
    (want, want_stats), plain_ms = event_call(
        torch, lambda: sequential_routing_tp(
            u, wgt, bias, 1, pad_owner, group, return_stats=True,
            v_init=v_init, step_valid=valid))
    kernel_s = lambda: sequential_routing_tp_cuda(
        u, wgt, bias, 1, pad_owner, group, v_init, valid)
    got, got_stats = kernel_s()
    routing_cuda.check_tp_status()
    err = max((got - want).abs().max().item(),
              (got_stats - want_stats).abs().max().item())
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL)
          and torch.allclose(got_stats, want_stats, rtol=RTOL, atol=ATOL)
          and not got[::2, :TP_WARMUP].any().item(),
          "%s: K1-tp-stream differs from its plain version by %.3e (or a "
          "warm-up step is not zero)" % (where, err))
    reading.update(k1tpstream_err=err, k1tpstream_plain_ms=plain_ms,
                   k1tpstream_ms=median_ms(torch, (kernel_s,), TP_REPS)[0],
                   k1tpstream_bound_ms=sdr_bound_ms(batch, seq_len, local, 1))
    return reading


def layer_scratch_mb(torch, geometry, batch, seq_len, shard=None):
    """Peak memory (MB) above its inputs of one forward and backward of a
    routing layer of ``geometry`` at (batch, seq_len) on the card: the
    layer's scratch (u_hat, the kernels' buffers, the saved output). With
    ``shard`` (offset, whole out_n, group) the layer is this rank's shard
    (K1-tp, K2-tp), else the whole layer (K1, K2)."""
    from srf_tpu_torch.ops.routing import route_layer

    in_n, out_n, out_d, in_d = geometry
    if shard is not None:
        out_n //= torch.distributed.get_world_size(shard[2])
    u = torch.randn(batch, seq_len, in_n, in_d, device="cuda",
                    requires_grad=True)
    wgt = (0.1 * torch.randn(in_n, out_n, out_d, in_d, device="cuda")
           ).requires_grad_()
    bias = (0.1 * torch.randn(in_n, out_n, out_d, device="cuda")
            ).requires_grad_()
    cot = torch.randn(batch, seq_len, out_n, out_d, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = route_layer(u, wgt, bias, 1, True, True, shard=shard)
    out.backward(cot)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def ipc_setup_check(torch, group):
    """Transport 2's set-up between this rank and its peer (2 ranks on one
    card, no kernel spinning): each rank's exchange buffer allocated by
    csrc/sdr_tp.cu, its handle gathered over the host group and opened by
    the other; rank 0 writes IPC_PATTERN floats into its own buffer and,
    after a host barrier, rank 1 reads them through its mapping of rank
    0's buffer; then both close the mappings and free their buffers.
    Returns rank 1's largest difference from the pattern (0 on rank 0)."""
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel import distributed

    lib = routing_cuda._tp_libs()[0]
    me = distributed.rank(group)
    exchange = routing_cuda.ipc_exchange(
        group, 1, torch.device("cuda", torch.cuda.current_device()))
    pattern = np.arange(IPC_PATTERN, dtype=np.float32) * 0.5 + 1.0
    err = 0.0
    if me == 0:
        check(lib.sdr_tp_copy(exchange.xbufs[0], pattern.ctypes.data,
                              pattern.nbytes) == 0,
              "17a: rank 0 could not write its IPC buffer")
    distributed.barrier()
    if me == 1:
        seen = np.zeros_like(pattern)
        check(lib.sdr_tp_copy(seen.ctypes.data, exchange.xbufs[0],
                              seen.nbytes) == 0,
              "17a: rank 1 could not read rank 0's IPC buffer")
        err = float(np.abs(seen - pattern).max())
    distributed.barrier()
    routing_cuda.release_ipc(barrier=distributed.barrier)
    return err


def model_axis_worker(workdir):
    """One rank of phase 17 (``chip_smoke.py --model-axis-worker DIR``, the
    SRF_* variables set): a (data 1, model ranks) mesh over gloo on cuda:0,
    or (17c, DIR/inputs.pt's "backend" nccl) over NCCL on the rank's own
    card; the model group's transport; 17a's checks of the case in
    DIR/inputs.pt, transport 2's set-up check where it asks for it, and,
    for SRF-WSJ, the 17b step; writes DIR/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_mesh

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    distributed.maybe_initialize(backend=inputs.get("backend", "gloo"),
                                 device="cuda")
    rank, world = distributed.rank(), distributed.world_size()
    mesh = make_mesh(1, world, device="cuda")
    group = mesh.group("model")
    label, _, geometry, is_last, shapes = inputs["case"]
    out = {"index": mesh.index("model"),
           "transport": routing_cuda.tp_transport(group),
           "deadline_s": routing_cuda.group_timeout_s(
               group, torch.device("cuda", torch.cuda.current_device())),
           "kernels": tp_kernel_checks(torch, label, geometry, is_last,
                                       shapes, group)}
    if inputs.get("ipc_check"):
        out["ipc_err"] = ipc_setup_check(torch, group)
    if "state" in inputs:
        logger = Logger(name="chip_smoke", level=Logger.WARN).logger
        config = wsj_tp_config(logger)
        batch = {k: v.cuda() if k in ("feats", "labels") else v
                 for k, v in inputs["batch"].items()}
        out["step"] = par_step(torch, config, inputs["state"], batch,
                               group=mesh.group("data"), model_mesh=mesh,
                               timed=TP_TIMED)
        seq_len = -(-batch["feats"].shape[1] // 4)
        offset = mesh.index("model") * geometry[1] // world
        out["scratch_mb"] = layer_scratch_mb(
            torch, geometry, batch["feats"].shape[0], seq_len,
            shard=(offset, geometry[1], group))
    routing_cuda.check_tp_status()
    torch.save(out, os.path.join(workdir, "rank%d.pt" % rank))
    routing_cuda.release_ipc(barrier=distributed.barrier)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def wsj_tp_config(logger):
    """Phase 12c's SRF-WSJ training configuration."""
    return family_config(logger, "cuda", "wsj",
                         SRF_WSJ_FLAGS + ["--train-lr-param-k=0.6"])


def tp_7c_config(logger, bf16):
    """17d's model: phase 12c's SRF-WSJ configuration at depth
    TP_7C_LAYERS, with bf16 routing where ``bf16``."""
    return family_config(
        logger, "cuda", "wsj",
        SRF_WSJ_FLAGS + ["--train-lr-param-k=0.6",
                         "--model-encoder-num=%d" % TP_7C_LAYERS]
        + (["--tpu-routing-bf16=True"] if bf16 else []))


def model_axis_7c_worker(workdir):
    """One rank of 17d (``chip_smoke.py --model-axis-7c-worker DIR``, the
    SRF_* variables set): a (data 1, model ranks) mesh over gloo on cuda:0
    and item 7c's three drives (:func:`tp_7c_drives`) on DIR/inputs.pt's
    state and batch. Writes DIR/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_mesh

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    distributed.maybe_initialize(backend="gloo", device="cuda")
    rank, world = distributed.rank(), distributed.world_size()
    mesh = make_mesh(1, world, device="cuda")
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    out = tp_7c_drives(torch, tp_7c_config(logger, True),
                       tp_7c_config(logger, False), inputs["state"],
                       inputs["batch"], mesh)
    routing_cuda.check_tp_status()
    torch.save(out, os.path.join(workdir, "rank%d.pt" % rank))
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def tp_7c_drives(torch, bf16_config, config, state, batch, mesh,
                 device="cuda", timed=TP_TIMED, stream_frames=TP_7C_FRAMES[0]):
    """Item 7c's three drives on this rank of ``mesh`` (data 1, model
    ranks), each with its kernels' launch counts set to 0 just before and
    read just after: the bf16-routing step of ``bf16_config``
    (K1-tp-bf16, K2-tp-bf16); ``config``'s last layer's route_block with
    a carry and warm-up steps and a streamed utterance through the sharded
    model, against the same on the unsharded model (K1-tp-stream); and
    the sharded wavefront forward against the unsharded wavefront (plain
    PyTorch, no kernel). ``batch`` on the host, its first
    ``stream_frames`` frames streamed; ``device`` the CPU in phase 18's
    rehearsal. Returns the readings."""
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel import sharding_rules
    from srf_tpu_torch.streaming import StreamingTranscriber

    batch = {k: v.to(device) if k in ("feats", "labels") else v
             for k, v in batch.items()}
    out = {"transport": (routing_cuda.tp_transport(mesh.group("model"))
                         if torch.device(device).type == "cuda"
                         else "plain")}
    out["step"] = par_step(torch, bf16_config, state, batch,
                           group=mesh.group("data"), model_mesh=mesh,
                           timed=timed, device=device)

    classes = class_count(config)
    models = []
    for sharded in (False, True):
        model = build_model(config, classes)[0]
        model.load_state_dict(state)
        model = model.to(device).eval()
        if sharded:
            sharding_rules.apply_rules(model, mesh)
        models.append(model)
    whole, sharded = models
    last = whole.enc_num - 1
    k1tp = routing_cuda.sequential_routing_tp_cuda
    rng = np.random.RandomState(SEED + 181)
    in_n, in_d = whole.caps_conv_num, whole.caps_conv_dim
    ctx = whole.lpad + whole.rpad
    u_ctx = torch.tensor(rng.randn(2, ctx + 8, in_n, in_d),
                         dtype=torch.float32, device=device)
    v_init = torch.tensor(0.3 * rng.randn(2, classes, whole.caps_class_dim),
                          dtype=torch.float32, device=device)
    valid = torch.arange(8, device=device)[None] >= torch.tensor(
        [[TP_WARMUP], [0]], device=device)
    feats = batch["feats"][0, :stream_frames].cpu().numpy()
    with torch.no_grad():
        want = whole.route_block(u_ctx, last, v_init, valid)
        synchronize(torch, device)
        k1tp.launches_stream = 0
        got = sharded.route_block(u_ctx, last, v_init, valid)
        logits = []
        for model in (whole, sharded):
            session = StreamingTranscriber(model, blank_id=classes - 1,
                                           chunk=STREAM_CHUNK)
            push = STREAM_CHUNK * session.div
            for lo in range(0, feats.shape[0], push):
                session.push(feats[lo:lo + push])
            session.flush()
            logits.append(session.logits)
        synchronize(torch, device)
        out["stream_launches"] = k1tp.launches_stream
        out["route_block_err"] = max((g - w).abs().max().item()
                                     for g, w in zip(got, want))
        out["warmup_zero"] = not got[0][0, :TP_WARMUP].any().item()
        out["stream_err"] = float(np.abs(logits[1] - logits[0]).max())
        out["stream_frames"] = int(logits[0].shape[0])
        for model in models:
            model.routing_impl = "wavefront"
        lens = batch["inp_len"].to(device)
        forwards = [timed_ms(torch, lambda: model(batch["feats"], lens), 1,
                             device) for model in models]
        wave = [model(batch["feats"], lens) for model in models]
        out["wavefront_err"] = (wave[1] - wave[0]).abs().max().item()
        out["wavefront_ms"] = [f[0] for f in forwards]
    return out


def model_axis_7c_drives(torch, card, workdir):
    """17d (see TP_7C_LAYERS): one process's bf16 step, then the 2 ranks'
    drives (:func:`model_axis_7c_worker`), each held to its unsharded
    counterpart. Returns the launches summed over the ranks:
    (K1-tp-bf16's, K2-tp-bf16's) in the step, K1-tp-stream's in the
    streaming drive."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model

    start = time.perf_counter()
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = tp_7c_config(logger, True)
    classes = class_count(config)
    state = random_weights(build_model(config, classes)[0])
    batch = train_batch(torch, "cuda", batch=8, frames=TP_7C_FRAMES[1],
                        vocab=classes - 1, shortest=TP_7C_FRAMES[0])
    single = par_step(torch, config, state, batch, timed=TP_TIMED)
    torch.save({"state": state, "batch": {k: v.cpu() for k, v in
                                          batch.items()}},
               os.path.join(workdir, "inputs.pt"))
    launch_ranks("--model-axis-7c-worker", workdir, ranks=2)
    results = [torch.load(os.path.join(workdir, "rank%d.pt" % r),
                          weights_only=False) for r in range(2)]
    seq_len = -(-TP_7C_FRAMES[1] // 4)
    want_bf16 = (1 + 2 * seq_len, 3 + 2 * seq_len)
    for r, result in enumerate(results):
        got = result["step"]
        check(result["transport"] == "host_loop"
              and got["tp_launches_bf16"] == want_bf16
              and got["tp_launches"] == (0, 0)
              and got["launches"] == single["launches"],
              "17d rank %d: transport %s, K1-tp-bf16/K2-tp-bf16 launches %s "
              "(expected %s), float32 K1-tp/K2-tp %s, K1/K2 %s (one "
              "process: %s)" % (r, result["transport"],
                                got["tp_launches_bf16"], want_bf16,
                                got["tp_launches"], got["launches"],
                                single["launches"]))
        readings = par_compare(
            "17d bf16-routing SRF-WSJ (depth %d, data 1, model 2) rank %d vs "
            "one process's bf16 step" % (TP_7C_LAYERS, r), got, single, card,
            grad_atol_rel=TP_7C_GRAD_REL, loss_rtol=BF16_LOSS_RTOL)
        check(result["stream_launches"] > 0 and result["warmup_zero"]
              and result["route_block_err"] <= STREAM_7C_ATOL
              and result["stream_err"] <= STREAM_7C_ATOL,
              "17d rank %d: the sharded route_block differs from the "
              "unsharded by %.3e, the streamed logits by %.3e (limit %.0e; "
              "K1-tp-stream launches %d)"
              % (r, result["route_block_err"], result["stream_err"],
                 STREAM_7C_ATOL, result["stream_launches"]))
        check(result["wavefront_err"] <= STREAM_7C_ATOL,
              "17d rank %d: the sharded wavefront differs from the unsharded "
              "by %.3e" % (r, result["wavefront_err"]))
        print("17d rank %d: bf16 step %s ms a step (one process %s), K1-tp-"
              "bf16 %d and K2-tp-bf16 %d launches, gradients %.2e x max; "
              "route_block %.3e and a streamed utterance (%d frames) %.3e "
              "from the unsharded, K1-tp-stream %d launches; wavefront "
              "%.3e from the unsharded, %.1f ms (unsharded %.1f) [%s]"
              % (r, ["%.1f" % x for x in got["ms"]],
                 ["%.1f" % x for x in single["ms"]],
                 *got["tp_launches_bf16"], readings["grad_rel"],
                 result["route_block_err"], result["stream_frames"],
                 result["stream_err"], result["stream_launches"],
                 result["wavefront_err"], result["wavefront_ms"][1],
                 result["wavefront_ms"][0], card))
    print("17d: %.1f s" % (time.perf_counter() - start))
    return ([sum(r["step"]["tp_launches_bf16"][i] for r in results)
             for i in (0, 1)], sum(r["stream_launches"] for r in results))


def tp_entry(name, kernel, replaces, readings, launches):
    """K1-tp's ("k1tp") or K2-tp's ("k2tp") entry of the "kernels" line for
    ``kernel`` (the host loop's sdr_tp_fwd / sdr_tp_bwd, or the persistent
    kernels; item 7c's "k1tpbf16", "k2tpbf16", "k1tpstream"): its times at
    the first of ``readings`` that has them (SRF-WSJ's last layer at 8 x
    400, one iteration: rank 0's, or the co-launch's), the largest error
    over every case and rank, each case's readings, and ``launches``."""
    first = next(r for r in readings if name + "_ms" in r)
    bytes_ms, ops_ms = first[name + "_bound_ms"]
    return {
        "name": kernel, "route": "cuda",
        "source": "srf_tpu_torch/csrc/sdr_tp.cu", "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r[name + "_err"] for r in readings
                           if name + "_err" in r),
        "ms": first[name + "_ms"], "plain_ms": first[name + "_plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a split SDR
        "per_case": [{k: v for k, v in r.items()
                      if k in ("case", "rank", "ranks", "shape", "pad_owner")
                      or k.startswith(name)} for r in readings
                     if name + "_err" in r],
    }


def print_tp_readings(stage, label, results, card):
    """Each rank's 17a worker readings (``stage``: "17a" over gloo, "17c"
    over NCCL)."""
    for r, result in enumerate(results):
        for reading in result["kernels"]:
            timed = "k1tp_ms" in reading
            print("%s %s rank %d (B, T', iter) %s%s, transport %s: K1-tp "
                  "%.3e from its plain version%s%s [%s]"
                  % (stage, label, r, tuple(reading["shape"]),
                     " PAD owner" if reading["pad_owner"] else "",
                     result["transport"], reading["k1tp_err"],
                     "" if not timed else
                     ", %.3f ms (plain %.3f, the host loop without the "
                     "exchange %.3f, bound %.3f)"
                     % (reading["k1tp_ms"], reading["k1tp_plain_ms"],
                        reading["k1tp_alone_ms"],
                        max(reading["k1tp_bound_ms"])),
                     "" if "k2tp_err" not in reading else
                     "; K2-tp %.3e, %.3f ms (plain %.3f, the host loop "
                     "without the exchange %.3f, bound %.3f)"
                     % (reading["k2tp_err"], reading["k2tp_ms"],
                        reading["k2tp_plain_ms"], reading["k2tp_alone_ms"],
                        max(reading["k2tp_bound_ms"])), card))
            if "k1tpbf16_ms" in reading:
                print("%s %s rank %d (B, T') %s: K1-tp-bf16 %.3e of max, "
                      "%.3f ms (plain %.3f, bound %.3f); K2-tp-bf16 %.3e of "
                      "max, %.3f ms (plain %.3f, bound %.3f); K1-tp-stream "
                      "%.3e, %.3f ms (plain %.3f, bound %.3f) [%s]"
                      % (stage, label, r, tuple(reading["shape"][:2]),
                         *(reading[name + key] if key != "_bound_ms"
                           else max(reading[name + key])
                           for name in ("k1tpbf16", "k2tpbf16", "k1tpstream")
                           for key in ("_err", "_ms", "_plain_ms",
                                       "_bound_ms")), card))


def check_tp_step(stage, results, single, layers, seq_len, card,
                  transport):
    """17b's (or 17c's) step on each rank: the transport, K1's and K2's
    launches, K1-tp's and K2-tp's (all persistent ones, or none), and the
    step held to the one-process step at phase 12c's limits."""
    if transport == "host_loop":
        tp_launches, persistent = (1 + 2 * seq_len, 1 + 2 * seq_len + 2), (
            0, 0)
    else:
        tp_launches = persistent = (2, 4)
    for r, result in enumerate(results):
        got = result["step"]
        check(result["transport"] == transport,
              "%s rank %d: transport %s, not %s"
              % (stage, r, result["transport"], transport))
        check(got["launches"] == (layers * K1_LAUNCHES, layers * K2_LAUNCHES)
              and got["tp_launches"] == tp_launches
              and got["tp_persistent"] == persistent,
              "%s rank %d: K1/K2 launches %s, K1-tp/K2-tp %s (persistent "
              "%s; expected %s, %s and %s)"
              % (stage, r, got["launches"], got["tp_launches"],
                 got["tp_persistent"],
                 (layers * K1_LAUNCHES, layers * K2_LAUNCHES), tp_launches,
                 persistent))
        par_compare("%s SRF-WSJ (data 1, model 2) rank %d vs one process"
                    % (stage, r), got, single, card,
                    grad_atol_rel=WSJ_GRAD_ATOL_REL)
        print("%s rank %d: transport %s, K1 %d, K2 %d, K1-tp %d, K2-tp %d "
              "launches a step (persistent %d, %d); ms a step %s; peak %.1f "
              "MB; the sharded layer's scratch %.1f MB (one process: K1 %d, "
              "K2 %d launches, %s ms, peak %.1f MB) [%s]"
              % (stage, r, result["transport"], *got["launches"],
                 *got["tp_launches"], *got["tp_persistent"],
                 ["%.1f" % x for x in got["ms"]], got["peak_mb"],
                 result["scratch_mb"], *single["launches"],
                 ["%.1f" % x for x in single["ms"]], single["peak_mb"],
                 card))


def cards_step(torch, card, workdir, inputs, single, layers, seq_len):
    """17c: 17b's step and 17a's worker checks at SRF-WSJ's last layer with
    its 2 ranks on cuda:0 and cuda:1 over NCCL, the transport CUDA IPC,
    held to ``single`` (the one-process step). Returns the persistent
    K1-tp's and K2-tp's launches in the step, summed over the ranks."""
    inputs = dict(inputs, backend="nccl", ipc_check=False)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    start = time.perf_counter()
    launch_ranks("--model-axis-worker", workdir, ranks=2, cards=True)
    results = [torch.load(os.path.join(workdir, "rank%d.pt" % r),
                          weights_only=False) for r in range(2)]
    print_tp_readings("17c", inputs["case"][0], results, card)
    check_tp_step("17c", results, single, layers, seq_len, card, "ipc")
    print("17c: 2 ranks on cuda:0 and cuda:1 over NCCL, the persistent "
          "kernels' wait for a peer ends at the model group's timeout, %s "
          "s; %.1f s" % ([r["deadline_s"] for r in results],
                         time.perf_counter() - start))
    return [sum(r["step"]["tp_persistent"][i] for r in results)
            for i in (0, 1)]


def model_axis_phase(torch, card):
    """Phase 17 (the module docstring). Returns the "kernels" entries of
    K1-tp and K2-tp's host loop, their launches those of 17b's step summed
    over its ranks; of their persistent kernels, their launches those of
    17a's co-launch drive (and of 17c's step, where it ran); and K1's and
    K2's launches in 17b's step, summed the same way."""
    import shutil
    import tempfile

    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model

    phase_start = time.perf_counter()
    colaunch, drive = tp_colaunch_checks(torch, card)
    print("17a co-launch: %.1f s" % (time.perf_counter() - phase_start))
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = wsj_tp_config(logger)
    classes = class_count(config)
    check(classes == TP_CASES[0][2][1], "SRF-WSJ has %d classes" % classes)
    state = random_weights(build_model(config, classes)[0])
    batch = train_batch(torch, "cuda", batch=8, frames=WSJ_TRAIN_FRAMES[1],
                        vocab=classes - 1, shortest=WSJ_TRAIN_FRAMES[0])
    single = par_step(torch, config, state, batch, timed=TP_TIMED)
    seq_len = -(-batch["feats"].shape[1] // 4)
    single_scratch = layer_scratch_mb(torch, TP_CASES[0][2], 8, seq_len)
    print("17b one process: the layer's scratch %.1f MB [%s]"
          % (single_scratch, card))
    layers = config.model_encoder_num - 1
    readings, cards_persistent = [], (0, 0)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_model_axis_")
    try:
        for case in TP_CASES:
            label, ranks = case[0], case[1]
            inputs = {"case": case, "ipc_check": ranks == 2}
            if label == "wsj_last":
                inputs.update(state=state, batch={k: v.cpu() for k, v in
                                                  batch.items()})
            torch.save(inputs, os.path.join(workdir, "inputs.pt"))
            start = time.perf_counter()
            launch_ranks("--model-axis-worker", workdir, ranks=ranks)
            results = [torch.load(os.path.join(workdir, "rank%d.pt" % r),
                                  weights_only=False) for r in range(ranks)]
            for r, result in enumerate(results):
                check(result["transport"] == "host_loop",
                      "17a %s rank %d: %d ranks on one card took transport "
                      "%s, not the host loop"
                      % (label, r, ranks, result["transport"]))
                for reading in result["kernels"]:
                    reading.update(case=label, rank=r)
                    readings.append(reading)
            print_tp_readings("17a", label, results, card)
            if ranks == 2:
                err = results[1]["ipc_err"]
                check(err == 0.0, "17a: rank 1 read rank 0's IPC buffer "
                      "%.3e off its pattern" % err)
                print("17a: transport 2's set-up on one card: rank 1 read "
                      "rank 0's %d floats through its IPC mapping exactly; "
                      "both released their buffers" % IPC_PATTERN)
            print("17a %s: %d ranks on cuda:0 over gloo, %.1f s"
                  % (label, ranks, time.perf_counter() - start))
            if label != "wsj_last":
                continue
            # 17b: the SRF-WSJ step on (data 1, model 2)
            check_tp_step("17b", results, single, layers, seq_len, card,
                          "host_loop")
            step_tp = [sum(r["step"]["tp_launches"][i] for r in results)
                       for i in (0, 1)]
            step_k12 = [sum(r["step"]["launches"][i] for r in results)
                        for i in (0, 1)]
            if torch.cuda.device_count() < 2:
                print("17c: skipped, one card (transport 2 needs two)")
                continue
            cards_persistent = cards_step(torch, card, workdir, inputs,
                                          single, layers, seq_len)
        step_bf16, stream_7c = model_axis_7c_drives(torch, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    replaces = ("srf_tpu/ops/routing.py:122 (no pallas_call: the loop body "
                "XLA partitions on a 'model' mesh)")
    k1tp = tp_entry("k1tp", "sdr_tp_fwd", replaces, readings, step_tp[0])
    k2tp = tp_entry("k2tp", "sdr_tp_bwd", replaces, readings, step_tp[1])
    k1tp_p = tp_entry("k1tp", "sdr_tp_fwd_persistent", replaces, colaunch,
                      drive[0] + cards_persistent[0])
    k2tp_p = tp_entry("k2tp", "sdr_tp_bwd_persistent", replaces, colaunch,
                      drive[1] + cards_persistent[1])
    for entry, i in ((k1tp_p, 0), (k2tp_p, 1)):
        entry["launches_by_path"] = {"colaunch_drive": drive[i],
                                     "cards_step": cards_persistent[i]}
    check(all(step_tp), "K1-tp or K2-tp was not launched on the model-axis "
          "step: %s" % step_tp)
    check(k1tp_p["launches"] and k2tp_p["launches"],
          "the persistent K1-tp or K2-tp was not launched in 17a's drive")
    # item 7c's kernels: the persistent instances' readings from the
    # co-launch, the host loop's in per_case; their launches those of
    # 17a's co-launch drive and of 17d's drives, summed over the ranks
    variants = []
    for name, kernel, colaunch_n, drive_n, path in (
            ("k1tpbf16", "sdr_tp_fwd_persistent<bf16>", drive[2],
             step_bf16[0], "bf16_step"),
            ("k2tpbf16", "sdr_tp_bwd_persistent<bf16>", drive[3],
             step_bf16[1], "bf16_step"),
            ("k1tpstream", "sdr_tp_fwd_persistent (carry, step mask)",
             drive[4], stream_7c, "stream")):
        entry = tp_entry(name, kernel, replaces, colaunch + readings,
                         colaunch_n + drive_n)
        entry["launches_by_path"] = {"colaunch_drive": colaunch_n,
                                     path + "_host_loop": drive_n}
        check(colaunch_n > 0 and drive_n > 0,
              "%s was not launched on its main path: %s"
              % (kernel, entry["launches_by_path"]))
        variants.append(entry)
    print("model axis phase: %.1f s" % (time.perf_counter() - phase_start))
    return (k1tp, k2tp, k1tp_p, k2tp_p, *variants), step_k12


# phase 18: a rank a card over NCCL (two cards or more; one card skips
# it). The multi-rank paths of phases 16-17 with each rank on its own card
# and NCCL its backend, held to the one-process results on cuda:0: 18a DP
# (the SRF-TIMIT step with global BatchNorm, timed; CNN-TIMIT's step with
# K5), 18b FSDP, 18c ring attention, 18d the GPipe STF-TIMIT step
# (CARDS_RANKS stages, and 2 stages x 2 data shards on 4 cards), 18e
# trainer_sr's and trainer_tf's epochs launched by torchrun, a SIGTERM to
# one rank and F26's resume, 18f the 'model' axis over CUDA IPC between
# cards ((1, 2) with item 7c's drives; on 4 cards (2, 2) and (1, 4)), 18g
# a (data 1, model 2) SRF-WSJ epoch through the library API. CARDS holds
# the widths and sizes (full width); the CPU rehearsal
# (tests/test_torch_cards_rehearsal.py: every rank on the CPU, gloo)
# shrinks them, and there no kernel launches: the launch counts are held
# only on the card
CARDS = {
    # 18a-18d: the SRF-TIMIT and CNN-TIMIT steps on PAR_ROWS rows of 241
    # frames (14 or 7 a rank), phase 16e's STF-TIMIT and ring shapes
    "timit_flags": TIMIT_FLAGS, "cnn_flags": CNN_FLAGS,
    "stf_flags": STF_TIMIT_FLAGS + NO_DROPOUT_FLAGS,
    "stf_cli_flags": STF_TIMIT_FLAGS,
    "rows": PAR_ROWS, "frames": 241, "timed": PAR_TIMED,
    "ring_shape": RING_SHAPE, "pipe_batch": PIPE_BATCH,
    "pipe_micro": PIPE_MICRO,
    # 18e: fbank-123 utterances of 150-241 frames (train, valid), the
    # 7000-frame bucket of 28 rows (7 or 14 a rank): 4 steps an epoch
    "cli_utts": (112, 28), "cli_frames": (150, 241), "cli_bucket": 7000,
    "cli_rows": 28, "cli_signal_step": 6,
    # F26's runs: LSTM-WSJ's BLSTM at its width (train_lstm_wsj.sh: L=5,
    # D=534) on the raw features, dropout off (below)
    "f26_flags": ["--model-type=blstm", "--model-encoder-num=5",
                  "--model-dimension=534", "--model-lstm-is-cnnfe=False"],
    # 18f: phase 12c's SRF-WSJ step (8 x 300-1600), 17a's WSJ case, 17d's
    # 3-layer bf16 model on 8 x 300-400
    "wsj_flags": SRF_WSJ_FLAGS + ["--train-lr-param-k=0.6"],
    "wsj_rows": 8, "wsj_frames": WSJ_TRAIN_FRAMES,
    "tp_case": TP_CASES[0], "tp_7c_layers": TP_7C_LAYERS,
    "tp_7c_frames": TP_7C_FRAMES,
    # 18g: 160 utterances of 300-400 frames at batch 8: 20 steps
    "epoch_utts": (160, 16), "epoch_frames": (300, 400), "epoch_batch": 8,
    "epoch_min_steps": 20,
}
# 18e: F26's runs (uninterrupted, signalled, resumed) train at a fixed
# global batch (the buckets' sizes round to the ranks, and a mid
# checkpoint of other sizes is refused), without dropout (F22: the seed
# folds in the rank, so no step with dropout is the same on another world
# size; the SRF's front end and primary capsules drop at a fixed 0.2, as
# JAX's, so these runs take a BLSTM, as tests/test_torch_elastic.py takes
# an LSTM) and with plain SGD at rate CLI_SGD_RATE: Adam's first updates
# are ~rate x sign(gradient), so float32's other order of sums on another
# world size flips entries whose gradient is near 0 by a whole rate, past
# JAX's elastic tolerance (RESUME_RTOL, RESUME_ATOL: tests/test_elastic.py);
# SGD moves each entry by the rate x its gradient, which a resume from the
# wrong batch or state would change by far more than the tolerance
CLI_SGD_RATE = 0.01
RESUME_RTOL, RESUME_ATOL = 2e-4, 1e-6
# 18f: the SRF-WSJ step on a mesh whose data axis splits the batch ((2,
# 2)) against one process, each gradient within WSJ_DP_GRAD_ATOL_REL x its
# largest entry (phase 12c's WSJ_GRAD_ATOL_REL where the data axis is 1).
# The global BatchNorm's and the gradients' sums over two ranks round
# apart from one process's in the front end's cancelling sums: on an H100
# conv_feat.conv1_1.weight read 1.6e-3 of its largest entry (the loss
# 8.9e-8, BatchNorm 3.7e-9, the updates 6.4e-7 of the rate), while
# float32 itself sits 1.2e-2 from float64 there and a TF32 card 5.2e-2
# (chip_wsj_numerics.py, WSJ_GRAD_ATOL_REL's comment): this limit lies
# below float32's own distance and refuses TF32
WSJ_DP_GRAD_ATOL_REL = 1e-2
# 18g: a parameter whose largest gradient over the epoch is at most this
# fraction of any parameter's is 0 to float32's rounding (a sum that
# cancels), and its change is not held
GRAD_ROUNDING_REL = 1e-5
# 18g: 20 Adam steps amplify float32's rounding: on an H100 the witness
# (one process from weights x (1 + 2^-23)) ended 7.38e-3 of a parameter's
# change from one process's epoch (conv_feat.conv1_0.weight), the (1, 2)
# split 3.37e-3 (flatten.weight), while every loss agreed within 1.3e-6
# and each step's gradients within 8.8e-5 of max (18f). The split is held
# within EPOCH_WITNESS x the witness's furthest parameter; a witness past
# EPOCH_WITNESS_MAX fails the phase (rounding would hide a fault). So the
# epoch takes Adam: under plain SGD at 1e-3 the witness itself ended 0.29
# of a parameter's change away and its losses up to 1.7e-3 off (the
# split: 0.37 and 2.0e-3), where rounding hides everything
EPOCH_WITNESS, EPOCH_WITNESS_MAX = 2.0, 5e-2
# the script the launches start (the rehearsal keeps it)
WORKER = os.path.abspath(__file__)


def card_lines():
    """nvidia-smi's name and power limit of every card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()


def rank_device(torch, device):
    """This rank's device: its own card (the process group bound it), or
    the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rows_of(batch, parts, index, device):
    """Part ``index`` of ``parts`` equal row blocks of a host ``batch``,
    its features and labels on ``device``."""
    rows = batch["feats"].shape[0] // parts
    return {k: (v[index * rows:(index + 1) * rows].to(device)
                if k in ("feats", "labels") else
                v[index * rows:(index + 1) * rows])
            for k, v in batch.items()}


def emulated_dp_step(torch, ranks):
    """``par_step``'s ``step_of``: make_train_step's data-parallel step of
    ``ranks`` ranks in one process. Rank r's rows (the r-th of ``ranks``
    equal blocks) go through the model with rank r's dropout seed (F22),
    each loss over the global batch; the gradients sum in ``.grad``, one
    update. What the ranks compute, in another order of sums (the model
    must hold no BatchNorm: its statistics would be each block's)."""
    from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
    from srf_tpu_torch.train.step import optimizer_update, step_seed

    def make(apply_fn, in_len_div):
        generators = {}

        def train_step(state, batch, seed):
            feats = batch["feats"]
            if feats.device not in generators:
                generators[feats.device] = torch.Generator(feats.device)
            generator = generators[feats.device]
            state.optimizer.zero_grad(set_to_none=True)
            loss_sum = None
            for r in range(ranks):
                part = rows_of(batch, ranks, r, feats.device)
                generator.manual_seed(step_seed(seed, state.step, r))
                logits = apply_fn(part, True, generator)
                pe_loss = ctc_loss_from_frames(
                    logits, part["inp_len"], in_len_div, part["labels"],
                    part["tar_len"])
                (pe_loss.sum() / feats.shape[0]).backward()
                part_sum = pe_loss.detach().sum()
                loss_sum = part_sum if loss_sum is None else (loss_sum
                                                              + part_sum)
            optimizer_update(state)
            return state, {"loss_sum": loss_sum}

        return train_step

    return make


def rank_kernel_ms(torch, rows, frames, cnn_sites):
    """This rank's kernel times on its own card while the other ranks time
    theirs (CUDA events): K1 a forward and K2 a backward of SRF-TIMIT's 7
    routing layers at ``rows`` x T' (``frames`` after the front end's two
    stride-2 convs), one iteration; K5 a CNN-TIMIT step (each of
    ``cnn_sites`` twice). Outside any drive: the launches here are not
    counted."""
    from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda
    from srf_tpu_torch.ops.routing_cuda import (sequential_routing_bwd_cuda,
                                                sequential_routing_cuda)

    seq_len = math.ceil(math.ceil(frames / 2) / 2)
    rng = np.random.RandomState(SEED + 180)
    out = {"k1_ms": 0.0, "k2_ms": 0.0, "k5_ms": 0.0}
    on_card = lambda *shape: torch.tensor(rng.randn(*shape) * 0.1,
                                          dtype=torch.float32, device="cuda")
    for _, (in_n, out_n, out_d, in_d), mask, count in TIMIT_LAYERS:
        u, w, b = (on_card(rows, seq_len, in_n, in_d),
                   on_card(in_n, out_n, out_d, in_d),
                   on_card(in_n, out_n, out_d))
        vs = sequential_routing_cuda(u, w, b, 1, mask)
        dvs = on_card(*vs.shape)
        out["k1_ms"] += count * event_ms(
            torch, lambda: sequential_routing_cuda(u, w, b, 1, mask), 5)
        out["k2_ms"] += count * event_ms(
            torch, lambda: sequential_routing_bwd_cuda(u, w, b, vs, dvs,
                                                       mask), 5)
    for shape, rate in cnn_sites:
        x = on_card(*shape)
        out["k5_ms"] += 2 * event_ms(
            torch, lambda: fused_dropout_cuda(x, SEED + 18, rate), 5)
    return out


def cards_worker(workdir):
    """One rank of 18a-18d (``chip_smoke.py --cards-worker DIR``, the SRF_*
    variables set): DIR/inputs.pt's backend on the rank's own card (NCCL;
    gloo and the CPU in the rehearsal): the DP steps of SRF-TIMIT (timed)
    and CNN-TIMIT (dropout on at the K5 sites), the FSDP step, ring
    attention over the world, the pipelined STF-TIMIT step at each stage
    count of the inputs (float32 timed, float64), and this rank's kernel
    times; writes DIR/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.ops.attention_penalty import create_attention_penalty
    from srf_tpu_torch.ops.ring_attention import ring_attention
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_mesh, make_pipeline_mesh
    from srf_tpu_torch.parallel.pipeline import make_pipeline_apply_fn

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    device = inputs["device"]
    distributed.maybe_initialize(backend=inputs["backend"], device=device)
    rank, world = distributed.rank(), distributed.world_size()
    here = rank_device(torch, device)
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    out = {"device": str(here), "backend": torch.distributed.get_backend(),
           "seconds": {}}
    mesh = make_mesh(device=device)
    begin = time.perf_counter()
    config = timit_config(logger, device, inputs["timit_flags"])
    batch = rows_of(inputs["batch"], world, rank, here)
    out["dp"] = par_step(torch, config, inputs["state"], batch,
                         group=mesh.group(), timed=inputs["timed"],
                         device=device)
    cnn_config = timit_config(logger, device, inputs["cnn_flags"])
    # cuDNN's heuristics, as in the one-process reference: a search at
    # this rank's new shape would take ~40 s (F14)
    out["cnn"] = par_step(torch, cnn_config, inputs["cnn_state"], batch,
                          group=mesh.group(), device=device, dropout="k5",
                          cudnn_search=False)
    out["seconds"]["18a"] = time.perf_counter() - begin

    begin = time.perf_counter()
    seen, real = [], routing_cuda.sequential_routing_cuda

    def recording(u, wgt, bias, *args, **kwargs):
        seen.append((type(wgt).__name__, wgt.is_contiguous(),
                     tuple(wgt.shape)))
        return real(u, wgt, bias, *args, **kwargs)

    routing_cuda.sequential_routing_cuda = recording
    try:
        out["fsdp"] = par_step(torch, config, inputs["state"], batch,
                               group=mesh.group(), mesh=mesh, fsdp=True,
                               timed=inputs["timed"], device=device)
    finally:
        routing_cuda.sequential_routing_cuda = real
    out["fsdp_weights"] = sorted(set(seen))
    out["seconds"]["18b"] = time.perf_counter() - begin

    begin = time.perf_counter()
    penalty = stf_penalty()
    out["ring"] = attention_run(
        torch, lambda q, k, v, mask: ring_attention(
            q, k, v, torch.distributed.group.WORLD, mask, penalty),
        inputs["ring"], here)
    out["seconds"]["18c"] = time.perf_counter() - begin

    begin = time.perf_counter()
    stf_config = family_config(logger, device, "timit", inputs["stf_flags"])
    for stages in inputs["stages"]:
        pipe_mesh = make_pipeline_mesh(stages, device=device)

        def pipelined(model, in_len_div, pipe_mesh=pipe_mesh):
            return make_pipeline_apply_fn(
                model, pipe_mesh, inputs["pipe_micro"],
                create_attention_penalty(stf_config, logger), in_len_div)

        pipe_batch = rows_of(inputs["pipe_batch"], pipe_mesh.shape["data"],
                             pipe_mesh.index("data"), here)
        for float64 in (False, True):
            out["pipe%d%s" % (stages, "_64" if float64 else "")] = par_step(
                torch, stf_config, inputs["stf_state"], pipe_batch,
                group=pipe_mesh.group("data"),
                grad_group=torch.distributed.group.WORLD,
                apply_fn_of=pipelined,
                timed=0 if float64 else inputs["timed"], float64=float64,
                device=device)
        out["pipe%d_index" % stages] = (pipe_mesh.index("data"),
                                        pipe_mesh.index("pipe"))
    out["seconds"]["18d"] = time.perf_counter() - begin
    if here.type == "cuda":
        # every rank times its kernels at once, as a step runs them
        distributed.barrier()
        out["kernel_ms"] = rank_kernel_ms(torch, batch["feats"].shape[0],
                                          batch["feats"].shape[1],
                                          inputs["cnn_sites"])
    torch.save(out, os.path.join(workdir, "rank%d.pt" % rank))
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def launch_check(label, got, want, device):
    """The kernels' launches ``got`` (a count or a tuple of counts) must be
    ``want`` on the card; on the CPU (the rehearsal) no kernel launches,
    so there they must be 0."""
    if torch_type(device) != "cuda":
        want = (0,) * len(want) if isinstance(want, tuple) else 0
    got = tuple(got) if isinstance(want, tuple) else got
    check(got == want, "%s: launches %s, expected %s" % (label, got, want))


def torch_type(device):
    """"cuda" or "cpu" of a device name."""
    return str(device).split(":")[0]


def cards_train_phase(torch, card, state, workdir, device, world):
    """18a-18d: the one-process references on cuda:0 (the rank's own
    device in the rehearsal), the ranks' steps (:func:`cards_worker`),
    each held to them. Returns the launches summed over the ranks, by
    path: K1's and K2's (DP, FSDP) and K5's (the CNN DP step)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.models.stf import ConvEncoder
    from srf_tpu_torch.ops.blockwise_attention import blockwise_attention
    from srf_tpu_torch.parallel.pipeline import bubble

    sizes = CARDS
    cuda = torch_type(device) == "cuda"
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    start = time.perf_counter()
    config = timit_config(logger, device, sizes["timit_flags"])
    if state is None:
        state = random_weights(build_model(config, class_count(config))[0])
    layers = config.model_encoder_num
    cnn_config = timit_config(logger, device, sizes["cnn_flags"])
    cnn_state = random_weights(build_model(cnn_config,
                                           class_count(cnn_config))[0])
    stf_config = family_config(logger, device, "timit", sizes["stf_flags"])
    stf_state = random_weights(ConvEncoder.from_config(
        stf_config, class_count(stf_config)))
    rows = sizes["rows"]
    batch = train_batch(torch, device, batch=rows, frames=sizes["frames"])
    single = par_step(torch, config, state, batch, timed=sizes["timed"],
                      device=device)
    cnn_single = par_step(torch, cnn_config, cnn_state, batch, device=device,
                          dropout="k5", cudnn_search=False,
                          step_of=emulated_dp_step(torch, world))
    pipe_batch = train_batch(torch, device, batch=sizes["pipe_batch"],
                             frames=sizes["frames"])
    stf_single = par_step(torch, stf_config, stf_state, pipe_batch,
                          timed=sizes["timed"], device=device)
    stf_single64 = par_step(torch, stf_config, stf_state, pipe_batch,
                            float64=True, device=device)
    arrays, penalty = ring_inputs(sizes["ring_shape"]), stf_penalty()
    block = attention_run(
        torch, lambda q, k, v, mask: blockwise_attention(
            q, k, v, mask, penalty=penalty), arrays, device)
    stages = [world] + ([2] if world > 2 else [])
    cnn_sites = (cnn_site_shapes(torch, device, cnn_config,
                                 rows_of(batch, world, 0, device))
                 if cuda else [])
    torch.save({"device": device, "backend": "nccl" if cuda else "gloo",
                "timit_flags": sizes["timit_flags"],
                "cnn_flags": sizes["cnn_flags"],
                "stf_flags": sizes["stf_flags"], "state": state,
                "cnn_state": cnn_state, "stf_state": stf_state,
                "batch": {k: v.cpu() for k, v in batch.items()},
                "pipe_batch": {k: v.cpu() for k, v in pipe_batch.items()},
                "ring": arrays, "timed": sizes["timed"],
                "pipe_micro": sizes["pipe_micro"], "stages": stages,
                "cnn_sites": cnn_sites},
               os.path.join(workdir, "inputs.pt"))
    print("18a-d one-process references on %s: %.1f s"
          % (rank_device(torch, device), time.perf_counter() - start))

    start = time.perf_counter()
    launch_ranks("--cards-worker", workdir, ranks=world, cards=True)
    ranks = [torch.load(os.path.join(workdir, "rank%d.pt" % r),
                        weights_only=False) for r in range(world)]
    backend = "nccl" if cuda else "gloo"
    for r, rank in enumerate(ranks):
        want = "cuda:%d" % r if cuda else "cpu"
        check(rank["backend"] == backend and rank["device"] == want,
              "18 rank %d: backend %s on %s, not %s on %s"
              % (r, rank["backend"], rank["device"], backend, want))
    print("18a-d: %d ranks, %s, backend %s; %.1f s (per rank and sub-phase "
          "%s)" % (world, [r["device"] for r in ranks], backend,
                   time.perf_counter() - start,
                   [{k: round(v, 1) for k, v in r["seconds"].items()}
                    for r in ranks]))
    counts = {}
    # 18a: DP
    for r, rank in enumerate(ranks):
        launch_check("18a DP rank %d K1/K2" % r, rank["dp"]["launches"],
                     (layers * K1_LAUNCHES, layers * K2_LAUNCHES), device)
        par_compare("18a DP rank %d (%d x %d global, %d a rank) vs one "
                    "process" % (r, rows, sizes["frames"], rows // world),
                    rank["dp"], single, card)
    for key in ("dp", "fsdp"):
        same = all(torch.equal(ranks[0][key]["state"][k],
                               rank[key]["state"][k])
                   for rank in ranks for k in ranks[0][key]["state"]
                   if "running_" in k)
        check(same, "18 %s: BatchNorm statistics differ between ranks" % key)
    step_ms = [float(np.median(r["dp"]["ms"])) for r in ranks]
    single_ms = float(np.median(single["ms"]))
    rate, single_rate = rows / (max(step_ms) / 1e3), rows / (single_ms
                                                             / 1e3)
    print("18a DP SRF-TIMIT on %d cards over %s: ms a step a rank %s (one "
          "process %.1f); %.1f samples/s over the ranks (the slowest rank's "
          "step) against one process's %.1f: %.2f x; peak %s MB a rank (one "
          "process %.1f); BatchNorm statistics equal on every rank [%s]"
          % (world, backend, ["%.1f" % x for x in step_ms], single_ms, rate,
             single_rate, rate / single_rate,
             ["%.1f" % r["dp"]["peak_mb"] for r in ranks],
             single["peak_mb"], card))
    counts["k1_dp"] = sum(r["dp"]["launches"][0] for r in ranks)
    counts["k2_dp"] = sum(r["dp"]["launches"][1] for r in ranks)
    for r, rank in enumerate(ranks):
        launch_check("18a CNN DP rank %d K5" % r, rank["cnn"]["k5"],
                     2 * CNN_SITES, device)
        par_compare("18a CNN-TIMIT DP rank %d (dropout on at the K5 sites) "
                    "vs the one-process step of every rank's rows and seed"
                    % r, rank["cnn"], cnn_single, card,
                    grad_atol_rel=CNN_GRAD_ATOL_REL,
                    update_grad_rel=CNN_UPDATE_GRAD_REL)
    counts["k5_cnn_dp"] = sum(r["cnn"]["k5"] for r in ranks)
    print("18a CNN-TIMIT DP: K5 %s launches a rank (one process emulating "
          "the %d ranks: %d) [%s]" % ([r["cnn"]["k5"] for r in ranks],
                                      world, cnn_single["k5"], card))
    # 18b: FSDP
    for r, rank in enumerate(ranks):
        launch_check("18b FSDP rank %d K1/K2" % r, rank["fsdp"]["launches"],
                     (layers * K1_LAUNCHES, layers * K2_LAUNCHES), device)
        par_compare("18b FSDP rank %d vs DP" % r, rank["fsdp"], rank["dp"],
                    card)
    if cuda:
        weights = ranks[0]["fsdp_weights"]
        whole = {tuple(v.shape) for k, v in state.items()
                 if re.fullmatch(r"W\d+", k)}
        check(weights and all(t in ("Tensor", "Parameter") and c
                              and shape in whole
                              for t, c, shape in weights),
              "18b: K1 saw %s (the whole W: %s)" % (weights, whole))
        print("18b: K1 received whole, contiguous weights under FSDP: %s"
              % weights)
    print("18b FSDP on %d cards: ms a step a rank %s (DP %s); peak %s MB a "
          "rank (DP %s) [%s]"
          % (world, ["%.1f" % np.median(r["fsdp"]["ms"]) for r in ranks],
             ["%.1f" % x for x in step_ms],
             ["%.1f" % r["fsdp"]["peak_mb"] for r in ranks],
             ["%.1f" % r["dp"]["peak_mb"] for r in ranks], card))
    counts["k1_fsdp"] = sum(r["fsdp"]["launches"][0] for r in ranks)
    counts["k2_fsdp"] = sum(r["fsdp"]["launches"][1] for r in ranks)
    # 18c: ring attention
    for r, rank in enumerate(ranks):
        ring = rank["ring"]
        err = (ring["out"] - block["out"]).abs().max().item()
        grad_err = max((ring[n] - block[n]).abs().max().item()
                       / block[n].abs().max().item()
                       for n in ("dq", "dk", "dv"))
        check(err <= RING_ATOL and grad_err <= RING_GRAD_REL,
              "18c rank %d: ring vs blockwise %.3e, gradients %.3e x max"
              % (r, err, grad_err))
        print("18c ring attention rank %d of %d, %s (T' %d a rank): out "
              "%.3e from blockwise on one card (atol %.0e), gradients %.3e x "
              "max (%.0e); forward + backward %.1f ms (blockwise %.1f ms), "
              "attention peak %.1f MB a rank (blockwise %.1f MB) [%s]"
              % (r, world, sizes["ring_shape"],
                 sizes["ring_shape"][2] // world, err, RING_ATOL, grad_err,
                 RING_GRAD_REL, np.median(ring["ms"]), np.median(block["ms"]),
                 ring["peak_mb"], block["peak_mb"], card))
    # 18d: the pipeline
    for stages in stages:
        for r, rank in enumerate(ranks):
            data, stage = rank["pipe%d_index" % stages]
            exact = par_compare(
                "18d pipeline %d stages rank %d (data %d, stage %d) float64"
                % (stages, r, data, stage), rank["pipe%d_64" % stages],
                stf_single64, card, grad_atol_rel=PIPE64_GRAD_REL)
            par_compare("18d pipeline %d stages rank %d (STF-TIMIT, %d "
                        "microbatches, B %d)" % (stages, r,
                                                 sizes["pipe_micro"],
                                                 sizes["pipe_batch"]),
                        rank["pipe%d" % stages], stf_single, card,
                        grad_atol_rel=None)
            print("18d %d stages rank %d: float64 gradients %.2e of max "
                  "(limit %.0e)" % (stages, r, exact["grad_rel"],
                                    PIPE64_GRAD_REL))
        print("18d %d stages x %d data shards: bubble (S-1)/(M+S-1) = %.2f; "
              "ms a step %s, peak %s MB by rank (one process %.1f ms, %.1f "
              "MB) [%s]"
              % (stages, world // stages, bubble(stages, sizes["pipe_micro"]),
                 ["%.1f" % np.median(r["pipe%d" % stages]["ms"])
                  for r in ranks],
                 ["%.1f" % r["pipe%d" % stages]["peak_mb"] for r in ranks],
                 np.median(stf_single["ms"]), stf_single["peak_mb"], card))
    if cuda:
        for r, rank in enumerate(ranks):
            print("18 rank %d kernels on its own card, all ranks at once: K1 "
                  "%.3f ms a forward and K2 %.3f a backward (7 calls, %d "
                  "rows x 241), K5 %.3f a CNN-TIMIT step [%s]"
                  % (r, rank["kernel_ms"]["k1_ms"],
                     rank["kernel_ms"]["k2_ms"], rows // world,
                     rank["kernel_ms"]["k5_ms"], card))
        counts["kernel_ms"] = [r["kernel_ms"] for r in ranks]
    return counts


def cli_corpus(base, seed):
    """18e's corpus: CARDS' fbank-123 train and valid utterances (and 2 test
    ones) as TFRecords under ``base``, TIMIT's labels."""
    rng = np.random.RandomState(seed)
    low, high = CARDS["cli_frames"]
    for split, count in zip(("train", "valid", "test"),
                            CARDS["cli_utts"] + (2,)):
        utts = {}
        for i in range(count):
            n = int(rng.randint(low, high + 1))
            utts["%s%03d" % (split, i)] = (
                rng.randn(n, 123).astype(np.float32),
                rng.randint(1, 62, size=max(2, n // 8)))
        write_split(base, split, utts, 2)


def cli_argv(base, ckpt, device, flags, *extra):
    """trainer_sr's or trainer_tf's argv on 18e's corpus: timit.conf, the
    7000-frame bucket, ``flags`` (a recipe's model and training flags)."""
    train, valid = CARDS["cli_utts"]
    return ["trainer",
            "--config=%s" % os.path.join(REPO, "egs", "conf", "timit.conf"),
            "--path-base=%s" % base,
            "--path-vocab=%s" % os.path.join(REPO, "egs", "data",
                                             "timit_62.vocab"),
            "--path-ckpt=%s" % ckpt, "--feat-type=None",
            "--path-train-ptrn=tfrecord/synth-train-None-123-*-of-*",
            "--path-valid-ptrn=tfrecord/synth-valid-None-123-*-of-*",
            "--path-test-ptrn=tfrecord/synth-test-None-123-*-of-*",
            "--prep-data-num-train=%d" % train,
            "--prep-data-num-valid=%d" % valid, "--prep-data-num-test=2",
            "--device=%s" % device, *flags,
            "--train-batch-frame=%d" % CARDS["cli_bucket"], *extra]


def cards_cli_worker(workdir, name):
    """One process of an 18e job (``chip_smoke.py --cards-cli DIR NAME``,
    under torchrun, or alone): DIR/NAME.json's trainer main (trainer_sr's
    or trainer_tf's) on its argv, which starts the process group itself
    from torchrun's variables; then writes DIR/NAME-rank<r>.json: K1's,
    K2's and K5's launches, the seconds in main, the peak memory, the
    device and the backend."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch import trainer_sr, trainer_tf
    from srf_tpu_torch.ops import dropout_cuda, routing_cuda
    from srf_tpu_torch.parallel import distributed

    with open(os.path.join(workdir, name + ".json")) as f:
        job = json.load(f)
    cuda = torch_type(job["device"]) == "cuda"
    start = time.perf_counter()
    {"sr": trainer_sr, "tf": trainer_tf}[job["main"]].main(job["argv"])
    synchronize(torch, job["device"])
    report = {"k1": routing_cuda.sequential_routing_cuda.launches,
              "k2": routing_cuda.sequential_routing_bwd_cuda.launches,
              "k5": dropout_cuda.fused_dropout_cuda.launches,
              "secs": time.perf_counter() - start,
              "peak_mb": (torch.cuda.max_memory_allocated() / 2 ** 20
                          if cuda else 0.0),
              "device": str(rank_device(torch, job["device"])),
              "backend": (torch.distributed.get_backend()
                          if distributed.is_initialized() else None)}
    with open(os.path.join(workdir, "%s-rank%d.json"
                           % (name, distributed.rank())), "w") as f:
        json.dump(report, f)
    if distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def start_job(workdir, job, device):
    """Starts 18e's ``job`` (a dict: name, main "sr" or "tf", argv, cards,
    module): on several cards through torchrun (``SRF_MULTIHOST=1``, each
    rank's output in its own log), on one as a plain process; the
    counting wrapper (:func:`cards_cli_worker`), or with ``module`` the
    trainer's own ``python -m``. Returns the Popen."""
    with open(os.path.join(workdir, job["name"] + ".json"), "w") as f:
        json.dump(dict(job, device=device), f)
    logdir = os.path.join(workdir, job["name"])
    os.makedirs(logdir)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SRF_", "LOCAL_RANK", "RANK", "WORLD_SIZE",
                                "MASTER_", "TORCHELASTIC"))}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               PYTHONFAULTHANDLER="1")
    if torch_type(device) == "cuda":
        env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, job["cards"]))
    program = (["-m", "srf_tpu_torch.trainer_" + job["main"]]
               + job["argv"][1:] if job.get("module")
               else [WORKER, "--cards-cli", workdir, job["name"]])
    if len(job["cards"]) > 1:
        env["SRF_MULTIHOST"] = "1"
        command = [sys.executable, "-m", "torch.distributed.run",
                   "--nproc-per-node", str(len(job["cards"])),
                   "--master-addr", "127.0.0.1",
                   "--master-port", str(free_port()),
                   "--log-dir", logdir, "--redirects", "3", *program]
    else:
        command = [sys.executable, *program]
    with open(os.path.join(logdir, "launcher.log"), "w") as log:
        return subprocess.Popen(command, env=env, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT)


def rank_logs(workdir, job):
    """Each rank's stderr of a finished ``job``, in rank order."""
    import glob

    logdir = os.path.join(workdir, job["name"])
    if len(job["cards"]) == 1:
        paths = [os.path.join(logdir, "launcher.log")]
    else:
        paths = [glob.glob(os.path.join(logdir, "*", "attempt_0", str(r),
                                        "stderr.log"))
                 for r in range(len(job["cards"]))]
        check(all(len(p) == 1 for p in paths),
              "18e %s: no log of every rank under %s" % (job["name"],
                                                          logdir))
        paths = [p[0] for p in paths]
    logs = []
    for path in paths:
        with open(path) as f:
            logs.append(f.read())
    return logs


def run_wave(workdir, jobs, device, timeout=900):
    """Runs ``jobs`` at once (each on its own cards) and waits. Returns
    {name: (exit code, wall seconds, each rank's stderr, each rank's
    counting report or None)}."""
    start = time.perf_counter()
    procs = [(job, start_job(workdir, job, device)) for job in jobs]
    results = {}
    try:
        for job, proc in procs:
            left = max(1.0, timeout - (time.perf_counter() - start))
            proc.wait(timeout=left)
            results[job["name"]] = [proc.returncode,
                                    time.perf_counter() - start]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
    for job, proc in procs:
        reports = []
        for r in range(len(job["cards"])):
            path = os.path.join(workdir, "%s-rank%d.json" % (job["name"], r))
            reports.append(json.load(open(path)) if os.path.exists(path)
                           else None)
        results[job["name"]] += [rank_logs(workdir, job), reports]
    return results


def epoch_losses(log):
    """The valid losses an 18e rank logged, by epoch."""
    return re.findall(r"Epoch (\d+) Valid Loss ([0-9.]+)", log)


def cards_cli_phase(torch, card, workdir, device, world):
    """18e: trainer_sr's SRF-TIMIT epoch on ``world`` ranks under torchrun
    with example sharding, and with batch sharding and
    ``--tpu-async-ckpt``; F26's runs (CLI_SGD_RATE's comment):
    uninterrupted (2 epochs), a SIGTERM to rank 1, its checkpoint resumed
    on 2 ranks and on one process; trainer_tf's STF-TIMIT epoch; each
    epoch's wall against one process's. Returns the launches summed over
    the ranks by run."""
    import shutil

    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.utils import checkpoint

    sizes = CARDS
    cuda = torch_type(device) == "cuda"
    base = os.path.join(workdir, "cli")
    start = time.perf_counter()
    cli_corpus(base, SEED + 41)
    print("18e corpus: %s train and valid utterances of %s frames, %.1f s"
          % (sizes["cli_utts"], sizes["cli_frames"],
             time.perf_counter() - start))
    steps = sizes["cli_utts"][0] // sizes["cli_rows"]
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    layers = timit_config(logger, device,
                          sizes["timit_flags"]).model_encoder_num
    sr_flags = ["--train-warmup-n=1200", "--train-lr-param-k=0.5",
                *[f for f in sizes["timit_flags"]
                  if not f.startswith("--decoding-beam")]]
    f26_flags = sizes["f26_flags"] + [
        "--train-opti-type=sgd", "--train-lr-param-k=%g" % CLI_SGD_RATE,
        "--train-inp-dropout=0", "--train-inn-dropout=0",
        "--tpu-data-shard=batch", "--tpu-async-ckpt=True",
        "--tpu-ckpt-every-steps=1", "--train-max-epoch=2",
        "--train-batch-dynamic=False",
        "--train-batch-size=%d" % sizes["cli_rows"]]
    stf_flags = [f for f in sizes["stf_cli_flags"]
                 if not f.startswith("--train-batch-frame")]
    ckpt = lambda name: os.path.join(base, name)
    cards = list(range(world))
    job = lambda name, main, argv, on, module=False: {
        "name": name, "main": main, "argv": argv, "cards": on,
        "module": module}
    waves = [
        [job("example", "sr", cli_argv(base, ckpt("example"), device,
                                       sr_flags, "--train-max-epoch=1",
                                       "--tpu-data-shard=example"), cards)],
        [job("batch", "sr", cli_argv(base, ckpt("batch"), device, sr_flags,
                                     "--train-max-epoch=1",
                                     "--tpu-data-shard=batch",
                                     "--tpu-async-ckpt=True"), cards)],
        [job("whole", "sr", cli_argv(base, ckpt("whole"), device,
                                     f26_flags), cards)],
        [job("signal", "sr", cli_argv(
            base, ckpt("signal"), device, f26_flags,
            "--tpu-fault-signal-at-step=%d" % sizes["cli_signal_step"],
            "--tpu-fault-signal-process=1"), cards, True)],
    ]
    results = {}
    # on the CPU (the rehearsal) no card bounds a wave: two run at once
    paired = lambda waves: (waves if cuda else [
        sum(waves[i:i + 2], []) for i in range(0, len(waves), 2)])
    for wave in paired(waves):
        results.update(run_wave(workdir, wave, device))
    for name in ("resume2", "resume1"):
        shutil.copytree(ckpt("signal"), ckpt(name))
    resume = lambda name, on: job(name, "sr", cli_argv(
        base, ckpt(name), device, f26_flags), on, True)
    single = lambda main, flags, on: job(
        "single_" + main, main, cli_argv(base, ckpt("single_" + main),
                                         device, flags, "--train-max-epoch=1"),
        on)
    stf = job("stf", "tf", cli_argv(base, ckpt("stf"), device, stf_flags,
                                    "--train-max-epoch=1",
                                    "--tpu-data-shard=example"), cards)
    # the one-process epochs (wall-time references) run beside the resumes
    # where the cards allow: each job on cards of its own
    if world > 2:
        waves = [[resume("resume2", cards[:2]), resume("resume1", [2]),
                  single("sr", sr_flags, [3])],
                 [stf], [single("tf", stf_flags, [0])]]
    else:
        waves = [[resume("resume2", cards)], [resume("resume1", [0]),
                                              single("sr", sr_flags, [1])],
                 [stf], [single("tf", stf_flags, [0])]]
    for wave in paired(waves):
        results.update(run_wave(workdir, wave, device))

    def ok(name, code=0):
        rc, secs, logs, _ = results[name]
        check(rc == code, "18e %s exited %s, not %s: %s"
              % (name, rc, code, "\n".join(log[-2000:] for log in logs)))
        return logs

    counts = {}
    for name, main, epochs in (("example", "sr", 1), ("batch", "sr", 1),
                               ("whole", "sr", 2), ("stf", "tf", 1)):
        logs = ok(name)
        _, secs, _, reports = results[name]
        losses = [epoch_losses(log) for log in logs]
        check(len(losses[0]) == epochs
              and all(x == losses[0] for x in losses),
              "18e %s: the ranks' valid losses %s" % (name, losses))
        backends = {(r or {}).get("backend") for r in reports}
        devices = [(r or {}).get("device") for r in reports]
        check(backends == {"nccl" if cuda else "gloo"}
              and devices == (["cuda:%d" % r for r in range(world)] if cuda
                              else ["cpu"] * world),
              "18e %s: backends %s on %s" % (name, backends, devices))
        # the SRF's K1 in every forward, K2 in every backward; none in the
        # STF and the BLSTM
        srf = name in ("example", "batch")
        valid = sizes["cli_utts"][1] // sizes["cli_rows"]
        want_k1 = epochs * (steps + valid) * layers * K1_LAUNCHES * srf
        want_k2 = epochs * steps * layers * K2_LAUNCHES * srf
        got = [(r["k1"], r["k2"]) for r in reports]
        check(all(g == (want_k1, want_k2) if cuda else g == (0, 0)
                  for g in got),
              "18e %s: K1/K2 launches a rank %s, expected (%d, %d): %d "
              "steps an epoch on every rank" % (name, got, want_k1, want_k2,
                                                steps))
        counts[name] = (sum(g[0] for g in got), sum(g[1] for g in got))
        single = results["single_" + main]
        print("18e %s (trainer_%s, %d ranks under torchrun, %s): valid "
              "losses %s on every rank; K1, K2 launches a rank %s (%d steps "
              "an epoch); %d epoch(s): wall %.1f s, in main %s s, peak %s MB "
              "a rank; one process's epoch (trainer_%s, the recipe's flags) "
              "%.1f s wall, %.1f in main [%s]"
              % (name, main, world, ",".join(sorted(map(str, backends))),
                 losses[0], got,
                 steps, epochs, secs, ["%.1f" % r["secs"] for r in reports],
                 ["%.1f" % r["peak_mb"] for r in reports], main,
                 single[1], single[3][0]["secs"], card))
    # the SIGTERM: every rank saves the same mid checkpoint, then exits
    _, _, logs, _ = results["signal"]
    signal_rc = results["signal"][0]
    saved = [re.findall(r"SIGTERM: saved mid-epoch checkpoint at global "
                        r"step (\d+)", log) for log in logs]
    raised = ["raising SIGTERM" in log for log in logs]
    check(signal_rc != 0 and raised == [r == 1 for r in range(world)]
          and all(s and s == saved[0] for s in saved),
          "18e signal: exit %s, SIGTERM raised on %s, saved at %s"
          % (signal_rc, raised, saved))
    step = int(saved[0][0])
    # the state after the last step: its mid checkpoint (an epoch's is
    # written only where the valid loss improved)
    mids = lambda name: checkpoint.CheckpointManager(
        os.path.join(ckpt(name), "mid"))
    last = mids("whole").latest_step()
    whole = mids("whole").restore(last)["state"]
    for name, procs in (("resume2", min(2, world)), ("resume1", 1)):
        logs = ok(name)
        check(all("Resuming mid-epoch" in log for log in logs),
              "18e %s: no mid-epoch resume" % name)
        got = mids(name).restore(last)["state"]
        check(got["step"] == whole["step"],
              "18e %s: step %s, the uninterrupted run %s"
              % (name, got["step"], whole["step"]))
        worst_rel = 0.0
        for key, value in whole["model"].items():
            if not value.is_floating_point():
                continue
            diff = (got["model"][key] - value).abs()
            bound = RESUME_ATOL + RESUME_RTOL * value.abs()
            worst_rel = max(worst_rel, (diff / bound).max().item())
            check(bool((diff <= bound).all()),
                  "18e %s: %s differs from the uninterrupted run by %.3e"
                  % (name, key, diff.max().item()))
        print("18e SIGTERM to rank 1 of %d at step %d: every rank saved the "
              "mid checkpoint at step %d and exited (torchrun %s); resumed "
              "on %d process(es): the uninterrupted run's weights at step "
              "%d, worst |diff| %.2f of JAX's elastic tolerance (rtol %.0e, "
              "atol %.0e) [%s]"
              % (world, sizes["cli_signal_step"], step, signal_rc, procs,
                 whole["step"], worst_rel, RESUME_RTOL, RESUME_ATOL, card))
    return counts



def epoch_corpus(base, classes, seed):
    """18g's corpus: CARDS' SRF-WSJ train and valid utterances (and 2 test
    ones) as TFRecords under ``base``, labels 1..classes-2."""
    rng = np.random.RandomState(seed)
    low, high = CARDS["epoch_frames"]
    for split, count in zip(("train", "valid", "test"),
                            CARDS["epoch_utts"] + (2,)):
        utts = {}
        for i in range(count):
            n = int(rng.randint(low, high + 1))
            utts["%s%03d" % (split, i)] = (
                rng.randn(n, 123).astype(np.float32),
                rng.randint(1, classes - 1, size=max(2, n // 8)))
        write_split(base, split, utts, 2)


def epoch_argv(base, ckpt, device, flags, lr_flags):
    """18g's SRF-WSJ training configuration on its corpus: wsj.conf,
    ``flags`` (phase 12c's model and optimizer), ``lr_flags`` (the
    schedule), batches of CARDS' epoch_batch, the configurable dropout off
    (the SRF's front end keeps its fixed rate, its masks from the step's
    seed), one epoch."""
    train, valid = CARDS["epoch_utts"]
    return ["chip_smoke",
            "--config=%s" % os.path.join(REPO, "egs", "conf", "wsj.conf"),
            "--path-base=%s" % base,
            "--path-vocab=%s" % os.path.join(REPO, "egs", "data",
                                             "wsj_31.vocab"),
            "--path-ckpt=%s" % ckpt, "--feat-type=None",
            "--path-train-ptrn=tfrecord/synth-train-None-123-*-of-*",
            "--path-valid-ptrn=tfrecord/synth-valid-None-123-*-of-*",
            "--path-test-ptrn=tfrecord/synth-test-None-123-*-of-*",
            "--prep-data-num-train=%d" % train,
            "--prep-data-num-valid=%d" % valid, "--prep-data-num-test=2",
            "--device=%s" % device, *flags, "--train-batch-dynamic=False",
            "--train-batch-size=%d" % CARDS["epoch_batch"],
            "--train-inp-dropout=0", "--train-inn-dropout=0",
            "--train-max-epoch=1", *lr_flags]


def epoch_lr_flags(config, steps):
    """18g's schedule: wsj.conf's Noam schedule with a warmup of the
    epoch's ``steps``, scaled so that its last step takes par_step's rate
    (the schedule's at PARITY_COUNT): at wsj.conf's warmup of 25000 an
    epoch of 20 steps would move a weight by ~3e-5, too little to show a
    wrong gradient against float32's rounding."""
    from srf_tpu_torch.train.optimizer import noam_schedule

    rate = noam_schedule(config.train_lr_param_k, config.model_dimension,
                         config.train_warmup_n,
                         config.train_lr_max)(PARITY_COUNT)
    scale = float(config.model_dimension) ** 0.5 * steps ** 0.5
    return ["--train-warmup-n=%d" % steps,
            "--train-lr-param-k=%r" % (rate * scale)]


def library_epoch(torch, argv, mesh_shape, device, reference=False,
                  nudge=False):
    """18g: one epoch through the library API, wired as trainer_sr.main
    wires it (no CLI flag builds a 'model' axis, as in JAX): the mesh of
    ``mesh_shape`` (data, model), or one process (None); the model built
    from --tpu-seed, build_state (the class capsules sharded over
    'model'), build_loaders, the train step over the mesh's groups,
    run_training, the epoch's checkpoint from rank 0. Returns each step's
    loss, the seconds in the loop, K1's, K2's, K1-tp's and K2-tp's
    launches in it (the persistent transport's), and with ``reference``
    (one process) the weights it started from, each trained parameter's
    largest |gradient| over the epoch's steps and, entry by entry, the
    least over the steps of |gradient| / that step's largest of the
    parameter (on the host). ``nudge`` first moves every trained weight
    by one or two units in its last place (x (1 + 2^-23)): a change the
    size of float32's rounding."""
    from srf_tpu_torch import trainer_sr
    from srf_tpu_torch.config import Logger, ParseOption
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel.mesh import broadcast_state, make_mesh
    from srf_tpu_torch.train.loop import run_training
    from srf_tpu_torch.train.step import (make_apply_fn, make_train_step,
                                          make_valid_step)
    from srf_tpu_torch.utils.checkpoint import load_checkpoint, restore_into

    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = ParseOption(argv, logger, is_print_opts=False).args
    mesh = (make_mesh(*mesh_shape, device=device) if mesh_shape
            else make_mesh(device=device))
    model, in_len_div = trainer_sr.build_model(
        config, class_count(config), logger,
        generator=torch.Generator().manual_seed(config.tpu_seed))
    state = trainer_sr.build_state(config, logger, model, mesh, True)
    ckpt_manager, _, epoch_offset = load_checkpoint(config, logger, state)
    broadcast_state(state)
    apply_fn = make_apply_fn(state.model)
    train_loader, valid_loader = trainer_sr.build_loaders(
        config, logger, mesh, seed=config.tpu_seed)
    step = make_train_step(apply_fn, in_len_div, group=mesh.group("data"),
                           model_group=mesh.group("model"))
    losses = []
    trained = [(k, p) for k, p in state.model.named_parameters()
               if p.requires_grad]
    grad_top = torch.zeros(len(trained), dtype=torch.float64)
    grad_floor = ({k: torch.full_like(p, math.inf) for k, p in trained}
                  if reference else {})

    def recording(state, batch, seed):
        state, metrics = step(state, batch, seed)
        losses.append(metrics["loss_sum"])
        if reference:
            # the step leaves its gradients in .grad
            tops = torch.stack([p.grad.abs().max() for _, p in trained])
            torch.maximum(grad_top, tops.double().cpu(), out=grad_top)
            for (k, p), top in zip(trained, tops):
                torch.minimum(grad_floor[k],
                              p.grad.abs() / top.clamp_min(1e-30),
                              out=grad_floor[k])
        return state, metrics

    k1, k2 = (routing_cuda.sequential_routing_cuda,
              routing_cuda.sequential_routing_bwd_cuda)
    k1tp, k2tp = (routing_cuda.sequential_routing_tp_cuda,
                  routing_cuda.sequential_routing_tp_bwd_cuda)
    initial = ({k: v.detach().to("cpu", copy=True)
                for k, v in state.model.state_dict().items()}
               if reference else None)
    if nudge:
        with torch.no_grad():
            for _, p in trained:
                p.mul_(1 + 2 ** -23)
    k1.launches = k2.launches = 0
    k1tp.launches_persistent = k2tp.launches_persistent = 0
    start = time.perf_counter()
    run_training(config, logger, state, recording,
                 make_valid_step(apply_fn, in_len_div, mesh.group("data"),
                                 mesh.group("model")),
                 train_loader, valid_loader, ckpt_manager, epoch_offset,
                 config.tpu_seed, config.prep_data_num_train,
                 schedule_fn=(state.scheduler.lr_lambdas[0]
                              if state.scheduler is not None else None),
                 state_to_save=trainer_sr.state_to_tree,
                 state_from_tree=lambda tree: restore_into(state, tree))
    synchronize(torch, device)
    secs = time.perf_counter() - start
    ckpt_manager.close()
    return {"losses": [float(x) for x in losses], "secs": secs,
            "initial": initial,
            "grad_top": ({k: float(g) for (k, _), g in zip(trained, grad_top)}
                         if reference else None),
            "grad_floor": ({k: v.cpu() for k, v in grad_floor.items()}
                           if reference else None),
            "launches": (k1.launches, k2.launches,
                         k1tp.launches_persistent,
                         k2tp.launches_persistent)}


def epoch_distances(got, want, reference):
    """18g: each trained parameter's distance between the final weights
    ``got`` and ``want`` (``reference``'s epoch, library_epoch's), as a
    share of the parameter's largest change over that epoch: {name:
    (share over the entries whose gradient was at least UPDATE_GRAD_REL x
    the parameter's largest at every step, as phase 12c holds an update,
    share over every entry, the change, the fraction of entries held)}.
    Adam moves an entry by ~rate x gradient / its running scale, so an
    entry whose gradient passes near 0 moves by rounding's sign. A
    parameter whose largest gradient is at most GRAD_ROUNDING_REL x any
    parameter's (0 but for float32's rounding) is left out."""
    initial, grad_top = reference["initial"], reference["grad_top"]
    largest = max(grad_top.values())
    out = {}
    for k, top in grad_top.items():
        if top <= GRAD_ROUNDING_REL * largest:
            continue
        sure = reference["grad_floor"][k] >= UPDATE_GRAD_REL
        change = max((want[k] - initial[k]).abs().max().item(), 1e-30)
        diff = (got[k] - want[k]).abs()
        out[k] = ((diff[sure].max().item() if sure.any() else 0.0) / change,
                  diff.max().item() / change, change,
                  sure.float().mean().item())
    return out


def cards_model_worker(workdir):
    """One rank of 18f-18g (``chip_smoke.py --cards-model-worker DIR``, the
    SRF_* variables set): DIR/inputs.pt's backend on the rank's own card;
    for each (data, model) mesh of the inputs, the model group's
    transport, 17a's kernel checks of the inputs' case (on the card, at
    the mesh's model size) and the SRF-WSJ step on the mesh, the status
    words read after them; where asked, item 7c's drives (17d) and 18g's
    epoch on (1, 2). A mesh of 'model' 1 ((2, 1)) is the data split
    alone: the step's DP, no kernel checks. Writes DIR/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.ops import routing_cuda
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_mesh

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    device = inputs["device"]
    cuda = torch_type(device) == "cuda"
    distributed.maybe_initialize(backend=inputs["backend"], device=device)
    rank = distributed.rank()
    here = rank_device(torch, device)
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    config = family_config(logger, device, "wsj", inputs["wsj_flags"])
    out = {"device": str(here), "backend": torch.distributed.get_backend(),
           "meshes": {}, "seconds": {}}
    for shape in inputs["meshes"]:
        begin = time.perf_counter()
        mesh = make_mesh(*shape, device=device)
        group = mesh.group("model")
        result = {"index": (mesh.index("data"), mesh.index("model"))}
        split = shape[1] > 1
        if cuda and split:
            label, _, geometry, is_last, shapes = inputs["case"]
            result["transport"] = routing_cuda.tp_transport(group)
            result["deadline_s"] = routing_cuda.group_timeout_s(group, here)
            result["kernels"] = tp_kernel_checks(torch, label, geometry,
                                                 is_last, shapes, group)
            routing_cuda.check_tp_status()
        batch = rows_of(inputs["batch"], shape[0], mesh.index("data"), here)
        result["step"] = par_step(torch, config, inputs["state"], batch,
                                  group=mesh.group("data"),
                                  model_mesh=mesh if split else None,
                                  timed=inputs["timed"], device=device)
        if cuda:
            # every status word clean after the step's calls
            routing_cuda.check_tp_status()
        out["meshes"][tuple(shape)] = result
        out["seconds"]["%dx%d" % tuple(shape)] = time.perf_counter() - begin
    if "drives_7c" in inputs:
        begin = time.perf_counter()
        drives = inputs["drives_7c"]
        out["7c"] = tp_7c_drives(
            torch, family_config(logger, device, "wsj", drives["bf16_flags"]),
            family_config(logger, device, "wsj", drives["flags"]),
            drives["state"], drives["batch"], make_mesh(1, 2, device=device),
            device=device, timed=inputs["timed"],
            stream_frames=drives["stream_frames"])
        if cuda:
            routing_cuda.check_tp_status()
        out["seconds"]["7c"] = time.perf_counter() - begin
    if "epoch_argv" in inputs:
        begin = time.perf_counter()
        out["epoch"] = library_epoch(torch, inputs["epoch_argv"], (1, 2),
                                     device)
        if cuda:
            routing_cuda.check_tp_status()
        out["seconds"]["epoch"] = time.perf_counter() - begin
    torch.save(out, os.path.join(workdir, "rank%d.pt" % rank))
    if cuda:
        routing_cuda.release_ipc(barrier=distributed.barrier)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def cards_model_phase(torch, card, workdir, device, world):
    """18f-18g: the one-process references on cuda:0 (phase 12c's SRF-WSJ
    step, 17d's bf16 step, 18g's epoch), then 2 ranks on (data 1, model 2)
    and (2, 1) (the data split alone, the witness of (2, 2)'s data axis)
    and, on 4 cards, 4 ranks on (2, 2) and (1, 4)
    (:func:`cards_model_worker`), each held to them. Returns (K1-tp's and
    K2-tp's "kernels" readings across cards, the persistent launches
    summed over the ranks by run, K1's and K2's launches summed over the
    ranks)."""
    from srf_tpu_torch.config import Logger
    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.utils import checkpoint

    sizes = CARDS
    cuda = torch_type(device) == "cuda"
    logger = Logger(name="chip_smoke", level=Logger.WARN).logger
    start = time.perf_counter()
    config = family_config(logger, device, "wsj", sizes["wsj_flags"])
    classes = class_count(config)
    layers = config.model_encoder_num - 1
    state = random_weights(build_model(config, classes)[0])
    low, high = sizes["wsj_frames"]
    batch = train_batch(torch, device, batch=sizes["wsj_rows"], frames=high,
                        vocab=classes - 1, shortest=low)
    single = par_step(torch, config, state, batch, timed=TP_TIMED,
                      device=device)
    flags_7c = sizes["wsj_flags"] + ["--model-encoder-num=%d"
                                     % sizes["tp_7c_layers"]]
    bf16_flags = flags_7c + ["--tpu-routing-bf16=True"]
    config_7c = family_config(logger, device, "wsj", bf16_flags)
    state_7c = random_weights(build_model(config_7c, classes)[0])
    low_7c, high_7c = sizes["tp_7c_frames"]
    batch_7c = train_batch(torch, device, batch=8, frames=high_7c,
                           vocab=classes - 1, shortest=low_7c)
    single_7c = par_step(torch, config_7c, state_7c, batch_7c,
                         timed=TP_TIMED, device=device)
    base = os.path.join(workdir, "epoch")
    epoch_corpus(base, classes, SEED + 42)
    lr_flags = epoch_lr_flags(config, sizes["epoch_utts"][0]
                              // sizes["epoch_batch"])
    argv = lambda ckpt: epoch_argv(base, os.path.join(base, ckpt), device,
                                   sizes["wsj_flags"], lr_flags)
    one_epoch = library_epoch(torch, argv("single"), None, device,
                              reference=True)
    # the witness: one process again, from weights moved by rounding
    witness_epoch = library_epoch(torch, argv("witness"), None, device,
                                  nudge=True)
    print("18f-g one-process references on %s: %.1f s"
          % (rank_device(torch, device), time.perf_counter() - start))
    host = lambda b: {k: v.cpu() for k, v in b.items()}
    label, _, geometry, is_last, shapes = sizes["tp_case"]
    runs = [(2, [(1, 2), (2, 1)], {
        "drives_7c": {"bf16_flags": bf16_flags, "flags": flags_7c,
                      "state": state_7c, "batch": host(batch_7c),
                      "stream_frames": low_7c},
        "epoch_argv": argv("sharded"),
        "case": (label, 2, geometry, is_last, shapes)})]
    if world >= 4:
        runs.append((4, [(2, 2), (1, 4)], {
            "case": (label, 4, geometry, is_last, shapes[:1])}))
    transport = "ipc" if cuda else None
    readings, persistent, k12 = [], {}, [0, 0]
    for ranks, meshes, extra in runs:
        torch.save(dict(extra, device=device,
                        backend="nccl" if cuda else "gloo",
                        wsj_flags=sizes["wsj_flags"], state=state,
                        batch=host(batch), timed=TP_TIMED, meshes=meshes),
                   os.path.join(workdir, "inputs.pt"))
        start = time.perf_counter()
        launch_ranks("--cards-model-worker", workdir, ranks=ranks,
                     cards=True)
        results = [torch.load(os.path.join(workdir, "rank%d.pt" % r),
                              weights_only=False) for r in range(ranks)]
        print("18f: %d ranks on %s over %s, %.1f s (per rank %s)"
              % (ranks, [r["device"] for r in results],
                 results[0]["backend"], time.perf_counter() - start,
                 [{k: round(v, 1) for k, v in r["seconds"].items()}
                  for r in results]))
        for shape in meshes:
            stage = "18f (%d, %d)" % shape
            mesh_results = [dict(r["meshes"][shape], device=r["device"])
                            for r in results]
            split = shape[1] > 1
            for r, result in enumerate(mesh_results):
                if cuda and split:
                    check(result["transport"] == transport,
                          "%s rank %d: transport %s, not %s"
                          % (stage, r, result["transport"], transport))
                    for reading in result["kernels"]:
                        reading.update(case="%s_%dx%d" % ((label,) + shape),
                                       rank=r, ranks=shape[1])
                        readings.append(reading)
                got = result["step"]
                launch_check("%s rank %d K1/K2" % (stage, r),
                             got["launches"],
                             (layers * K1_LAUNCHES, layers * K2_LAUNCHES)
                             if split else single["launches"], device)
                launch_check("%s rank %d persistent K1-tp/K2-tp"
                             % (stage, r), got["tp_persistent"],
                             (2, 4) if split else (0, 0), device)
                par_compare("%s SRF-WSJ rank %d (data %d, model %d) vs one "
                            "process" % ((stage, r) + result["index"]), got,
                            single, card,
                            grad_atol_rel=(WSJ_DP_GRAD_ATOL_REL
                                           if shape[0] > 1
                                           else WSJ_GRAD_ATOL_REL))
            if cuda and split:
                print_tp_readings(stage, label, mesh_results, card)
            print("%s: ms a step a rank %s (one process %s), peak %s MB; %s "
                  "[%s]"
                  % (stage, ["%.1f" % np.median(r["step"]["ms"])
                             for r in mesh_results],
                     ["%.1f" % x for x in single["ms"]],
                     ["%.1f" % r["step"]["peak_mb"] for r in mesh_results],
                     "every status word clean after each call; the wait for "
                     "a peer ends at %s s"
                     % sorted({r.get("deadline_s") for r in mesh_results})
                     if split else "the data split alone (DP, no K1-tp)",
                     card))
            if split:
                persistent["%dx%d" % shape] = [
                    sum(r["step"]["tp_persistent"][i] for r in mesh_results)
                    for i in (0, 1)]
            for i in (0, 1):
                k12[i] += sum(r["step"]["launches"][i] for r in mesh_results)
        if "drives_7c" not in extra:
            continue
        for r, result in enumerate(results):
            drive = result["7c"]
            got = drive["step"]
            launch_check("18f 7c rank %d K1-tp-bf16/K2-tp-bf16" % r,
                         got["tp_launches_bf16"], (2, 4), device)
            launch_check("18f 7c rank %d float32 K1-tp/K2-tp" % r,
                         got["tp_launches"], (0, 0), device)
            readings_7c = par_compare(
                "18f bf16-routing SRF-WSJ (depth %d, data 1, model 2) rank %d "
                "vs one process's bf16 step" % (sizes["tp_7c_layers"], r),
                got, single_7c, card, grad_atol_rel=TP_7C_GRAD_REL,
                loss_rtol=BF16_LOSS_RTOL)
            check((drive["stream_launches"] > 0 or not cuda)
                  and drive["warmup_zero"]
                  and drive["route_block_err"] <= STREAM_7C_ATOL
                  and drive["stream_err"] <= STREAM_7C_ATOL
                  and drive["wavefront_err"] <= STREAM_7C_ATOL,
                  "18f 7c rank %d: route_block %.3e, streamed %.3e, "
                  "wavefront %.3e from the unsharded (limit %.0e); "
                  "K1-tp-stream launches %d"
                  % (r, drive["route_block_err"], drive["stream_err"],
                     drive["wavefront_err"], STREAM_7C_ATOL,
                     drive["stream_launches"]))
            print("18f 7c rank %d (transport %s): bf16 step %s ms (one "
                  "process %s), K1-tp-bf16 %d, K2-tp-bf16 %d launches, "
                  "gradients %.2e x max; route_block %.3e, a streamed "
                  "utterance %.3e from the unsharded, K1-tp-stream %d "
                  "launches; wavefront %.3e [%s]"
                  % (r, drive["transport"],
                     ["%.1f" % x for x in got["ms"]],
                     ["%.1f" % x for x in single_7c["ms"]],
                     *got["tp_launches_bf16"], readings_7c["grad_rel"],
                     drive["route_block_err"], drive["stream_err"],
                     drive["stream_launches"], drive["wavefront_err"], card))
        persistent["7c_bf16"] = [sum(r["7c"]["step"]["tp_launches_bf16"][i]
                                     for r in results) for i in (0, 1)]
        persistent["7c_stream"] = sum(r["7c"]["stream_launches"]
                                      for r in results)
        # 18g: the epoch on (data 1, model 2)
        epochs = [r["epoch"] for r in results]
        losses = np.asarray(epochs[0]["losses"])
        check(len(losses) >= sizes["epoch_min_steps"]
              and np.isfinite(losses).all()
              and all(e["losses"] == epochs[0]["losses"] for e in epochs),
              "18g: the ranks' step losses %s"
              % [e["losses"] for e in epochs])
        for r, epoch in enumerate(epochs):
            # K2-tp once a train step; K1-tp in every forward, the valid
            # batches' too
            k1tp, k2tp = epoch["launches"][2:]
            check(k2tp == (4 * len(losses) if cuda else 0)
                  and (k1tp >= 2 * len(losses) if cuda else k1tp == 0),
                  "18g rank %d: persistent K1-tp %d, K2-tp %d launches in %d "
                  "steps" % (r, k1tp, k2tp, len(losses)))
        want = checkpoint.CheckpointManager(os.path.join(
            base, "single")).restore(1)["model"]
        got = checkpoint.CheckpointManager(os.path.join(
            base, "sharded")).restore(1)["model"]
        # every step's loss within LOSS_RTOL, and each trained parameter's
        # change over the epoch (epoch_distances) within EPOCH_WITNESS x
        # the witness's furthest parameter (and never held tighter than
        # phase 12c's WSJ_GRAD_ATOL_REL)
        witness = checkpoint.CheckpointManager(os.path.join(
            base, "witness")).restore(1)["model"]
        readings = {}
        for name, weights, run in (
                ("sharded", got, epochs[0]),
                ("witness (one process, every weight x (1 + 2^-23) first)",
                 witness, witness_epoch)):
            moves = epoch_distances(weights, want, one_epoch)
            loss_rel = float(np.max(np.abs(np.asarray(run["losses"])
                                           - one_epoch["losses"])
                                    / np.abs(one_epoch["losses"])))
            readings[name.split()[0]] = (loss_rel, moves)
            print("18g %s: each step's loss within %.2e of one process's; "
                  "the 4 parameters furthest from one process's on their "
                  "held entries, as a share of their own largest change "
                  "(on every entry in brackets): %s" % (
                      name, loss_rel,
                      ", ".join("%s %.2e (%.2e; changed %.2e, %.0f%% of "
                                "entries held)" % (k, v[0], v[1], v[2],
                                                   100 * v[3])
                                for v, k in sorted(((v, k) for k, v in
                                                    moves.items()),
                                                   reverse=True)[:4])))
        loss_rel, moves = readings["sharded"]
        (worst_rel, _, worst_change, _), worst_name = max(
            (v, k) for k, v in moves.items())
        rounding = sorted(set(one_epoch["grad_top"]) - set(moves))
        floor = max(v[0] for v in readings["witness"][1].values())
        limit = max(WSJ_GRAD_ATOL_REL, EPOCH_WITNESS * floor)
        check(loss_rel <= LOSS_RTOL,
              "18g: a step's loss %.3e from one process's" % loss_rel)
        check(floor <= EPOCH_WITNESS_MAX,
              "18g: the witness's parameters %.3e of their change from one "
              "process's (at most %.0e): the epoch cannot tell a fault from "
              "rounding" % (floor, EPOCH_WITNESS_MAX))
        check(worst_rel <= limit,
              "18g: the sharded epoch's %s %.3e of its own largest change "
              "(%.3e) from one process's, limit %.3e" % (
                  worst_name, worst_rel, worst_change, limit))
        print("18g SRF-WSJ epoch on (data 1, model 2) through the library "
              "API (%s): %d steps, losses finite and equal on both ranks "
              "(%.3f .. %.3f), each step's within %.2e of one process's "
              "(rtol %.0e); every status word clean, no wait reached the "
              "group's timeout; %d trained parameters each within %.2e of "
              "its own largest change (worst %s, changed %.3e; the witness "
              "%.2e, limit %.2e), left out as 0 to rounding: %s; %.1f s in "
              "the loop a rank %s (one process %.1f) [%s]"
              % (" ".join(lr_flags), len(losses), losses[0], losses[-1],
                 loss_rel, LOSS_RTOL, len(moves), worst_rel, worst_name,
                 worst_change, floor, limit, rounding or "none",
                 epochs[0]["secs"], ["%.1f" % e["secs"] for e in epochs],
                 one_epoch["secs"], card))
        persistent["epoch"] = [sum(e["launches"][2 + i] for e in epochs)
                               for i in (0, 1)]
    return readings, persistent, k12


def cards_phase(torch, card, state=None, device="cuda", world=None):
    """Phase 18 (the module docstring): ``world`` ranks, one a card (4
    where the host has 4 cards or more, else 2; every rank on the CPU
    over gloo in the rehearsal, ``device`` "cpu"). Returns the launches
    summed over the ranks by path ({"k1": {...}, "k2": {...}, "k5":
    {...}}), the ranks' kernel times, and K1-tp's and K2-tp's readings and
    persistent launches across cards."""
    import shutil
    import tempfile

    cuda = torch_type(device) == "cuda"
    if world is None:
        world = 4 if torch.cuda.device_count() >= 4 else 2
    phase_start = time.perf_counter()
    if cuda:
        count = torch.cuda.device_count()
        print("18: %d cards: %s" % (count, "; ".join(card_lines())))
        print("18: peer access %s" % ", ".join(
            "%d->%d %s" % (a, b, "yes" if torch.cuda.can_device_access_peer(
                a, b) else "no")
            for a in range(count) for b in range(count) if a != b))
        print("18: %d ranks, one a card, over NCCL" % world)
    seconds = {}
    got = {"k1": {}, "k2": {}, "k5": {}, "kernel_ms": None,
           "tp_readings": [], "tp_persistent": {}}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        begin = time.perf_counter()
        train = cards_train_phase(torch, card, state, workdir, device, world)
        seconds["18a-d"] = time.perf_counter() - begin
        for name in ("k1", "k2"):
            got[name].update(cards_dp=train[name + "_dp"],
                             cards_fsdp=train[name + "_fsdp"])
        got["k5"]["cards_cnn_dp"] = train["k5_cnn_dp"]
        got["kernel_ms"] = train.get("kernel_ms")
        begin = time.perf_counter()
        cli = cards_cli_phase(torch, card, workdir, device, world)
        seconds["18e"] = time.perf_counter() - begin
        for i, name in enumerate(("k1", "k2")):
            got[name]["cards_cli"] = sum(v[i] for v in cli.values())
        begin = time.perf_counter()
        (got["tp_readings"], got["tp_persistent"],
         axis_k12) = cards_model_phase(torch, card, workdir, device, world)
        seconds["18f-g"] = time.perf_counter() - begin
        for i, name in enumerate(("k1", "k2")):
            got[name]["cards_model_axis"] = axis_k12[i]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("18 seconds: %s; phase 18 %.1f s" % (
        {k: round(v, 1) for k, v in seconds.items()},
        time.perf_counter() - phase_start))
    return got


def cards_run():
    """``python3 chip_smoke.py --cards``: phase 18 on a multi-card host,
    alone (the whole run leaves it out), building only the kernels it
    runs (K1, K2, K5, K1-tp and K2-tp); then a "cards" JSON line (each
    path's launches, the ranks' kernel times, K1-tp's and K2-tp's readings
    across cards), the card line and the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "srf_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < 2:
        print("chip_smoke --cards: one card (a rank a card needs two)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from srf_tpu_torch.device import resolve_device
    from srf_tpu_torch.ops import cuda_build

    card = card_line()
    print("card: %s" % card)
    resolve_device("cuda")
    start = time.perf_counter()
    cuda_build.build(["sdr_fwd", "sdr_bwd", "fused_dropout", "sdr_tp"])
    print("build: %.2f s" % (time.perf_counter() - start))
    got = cards_phase(torch, card)
    for name in ("k1", "k2", "k5"):
        check(all(got[name].values()), "%s was not launched on a path of "
              "phase 18: %s" % (name.upper(), got[name]))
    check(all(np.all(v) for v in got["tp_persistent"].values()),
          "a persistent K1-tp or K2-tp was not launched across cards: %s"
          % got["tp_persistent"])
    print(json.dumps({"cards": {
        "launches_by_path": {k: got[k] for k in ("k1", "k2", "k5")},
        "tp_persistent_by_path": got["tp_persistent"],
        "rank_kernel_ms": got["kernel_ms"],
        "tp_readings": got["tp_readings"]}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
                              "sdr_scan_bwd", "fused_dropout", "sdr_tp"])
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

    seconds = {"2 build": time.perf_counter() - start}

    def phase(name, fn, *args):
        """``fn(*args)``, its seconds printed and kept under ``name``."""
        begin = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - begin
        print("phase %s: %.1f s" % (name, seconds[name]))
        return out

    k1, k3 = phase("3 K1, K3", kernel_phase, torch, device)
    k2, k4 = phase("4 K2, K4", k2_phase, torch, device)
    k5 = phase("5 K5", k5_phase, torch, device)
    serve_k1, state = phase("6 SRF serve", main_path_phase, torch, card)
    scan_k3, scan_k4, scan_times = phase("6b scan", scan_path_phase, torch,
                                         card, state)
    check(scan_k3 > 0 and scan_k4 > 0,
          "K3 or K4 was not launched on the scan path")
    decode_k1 = phase("6c decode", decode_phase, torch, card, state)
    check(decode_k1 > 0, "K1 was not launched on the decode path")
    (train_k1, train_k2), direct_ms = phase("7 SRF train", train_phase,
                                            torch, card, state)
    check(serve_k1 > 0, "K1 was not launched on the serving path")
    check(train_k1 > 0 and train_k2 > 0,
          "K1 or K2 was not launched on the training path")
    recipe_k1, recipe_k2 = phase("7b SRF recipe", recipe_train_phase, torch,
                                 card, state, direct_ms)
    check(recipe_k1 > 0 and recipe_k2 > 0,
          "K1 or K2 was not launched on the recipe's training path")
    serve_k5, cnn_state = phase("8 CNN serve", cnn_serve_phase, torch, card)
    train_k5 = phase("9 CNN train", cnn_train_phase, torch, card, cnn_state)
    check(train_k5 > 0, "K5 was not launched on the CNN training path")
    phase("10 STF-TIMIT", stf_phase, torch, card)
    lstm_state = phase("11 LSTM-WSJ", lstm_phase, torch, card)
    cnn_wsj_k5, cnn_wsj_recipe_k5, cnn_wsj = phase("11b CNN-WSJ",
                                                   cnn_wsj_phase, torch, card)
    check(cnn_wsj_k5 > 0 and cnn_wsj_recipe_k5 > 0,
          "K5 was not launched on the CNN-WSJ training path")
    phase("11c STF-WSJ", stf_wsj_phase, torch, card)
    stream_k1, stream_readings = phase("12 stream", stream_phase, torch,
                                       card, state)
    check(stream_k1 > 0, "K1 was not launched on the streaming path")
    wsj_k1 = phase("12b SRF-WSJ", wsj_phase, torch, card)
    wsj_train_k1, wsj_train_k2 = phase("12c SRF-WSJ train", wsj_train_phase,
                                       torch, card)
    wavefront_k1 = phase("12d wavefront", wavefront_phase, torch, card,
                         state)
    daemon_k1, daemon_readings = phase("13 daemon", daemon_phase, torch, card,
                                       state)
    int8_k1 = phase("14 serving extras", serving_extras_phase, torch, card,
                    state, lstm_state)
    k1_bf16, k2_bf16, k5_bf16 = phase("15 bf16 kernels", bf16_kernel_phase,
                                      torch, device)
    extras_k1, extras_k2 = phase("15 extras recipe", extras_recipe_phase,
                                 torch, card, state)
    (k1_bf16["launches"], k2_bf16["launches"],
     k5_bf16["launches"]) = phase("15 extras steps", extras_step_phase, torch,
                                  card, state, cnn_state)
    check(all(k["launches"] > 0 for k in (k1_bf16, k2_bf16, k5_bf16)),
          "a bf16 variant was not launched on its main path")
    mwer_k1, mwer_k2 = phase("15 MWER", mwer_phase, torch, card, state)
    par_k1, par_k2 = phase("16 parallel", parallel_phase, torch, card, state)
    check(all(par_k1.values()) and all(par_k2.values()),
          "K1 or K2 was not launched on a parallel path: %s %s"
          % (par_k1, par_k2))
    tp_entries, (axis_k1, axis_k2) = phase("17 model axis", model_axis_phase,
                                           torch, card)
    # phase 18 runs alone (``--cards``): within the whole run it would
    # take ~10 more minutes on a 4-card host, past the run's 1200 s
    if torch.cuda.device_count() < 2:
        print("18: skipped, one card (a rank a card needs two)")
    else:
        print("18: skipped in the whole run; `python3 chip_smoke.py "
              "--cards` runs it on these %d cards"
              % torch.cuda.device_count())
    # the daemon's launches are counted in its own process (its stats),
    # the rest in this one
    k1["launches_by_path"] = {"serve": serve_k1, "decode": decode_k1,
                              "train": train_k1, "recipe": recipe_k1,
                              "stream": stream_k1, "wsj_serve": wsj_k1,
                              "wsj_train": wsj_train_k1,
                              "wavefront_one_layer": wavefront_k1,
                              "int8_serve": int8_k1, "daemon": daemon_k1,
                              "extras_recipe": extras_k1, "mwer": mwer_k1,
                              **{"parallel_" + k: v
                                 for k, v in par_k1.items()},
                              "model_axis": axis_k1}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            stream_readings["carry_max_abs_err"])
    k1["stream"] = dict(stream_readings, launches_per_step=7 * K1_LAUNCHES)
    k1["daemon"] = daemon_readings
    k2["launches_by_path"] = {"train": train_k2, "recipe": recipe_k2,
                              "wsj_train": wsj_train_k2,
                              "extras_recipe": extras_k2, "mwer": mwer_k2,
                              **{"parallel_" + k: v
                                 for k, v in par_k2.items()},
                              "model_axis": axis_k2}
    k2["launches"] = sum(k2["launches_by_path"].values())
    k1["calls"] = k1["launches"] // K1_LAUNCHES
    k2["calls"] = k2["launches"] // K2_LAUNCHES
    k3["launches"] = scan_k3
    k3["launches_by_path"] = {"scan": scan_k3}
    k3["stack_ms"] = {key: scan_times[key] for key in ("forward_ms",
                                                       "k1_forward_ms")}
    k4["launches"] = scan_k4
    k4["calls"] = scan_k4 // 2  # two kernels per call
    k4["launches_by_path"] = {"scan": scan_k4}
    k4["stack_ms"] = {key: scan_times[key] for key in ("backward_ms",
                                                       "k2_backward_ms")}
    k5["launches_by_path"] = {"cnn_serve": serve_k5, "cnn_train": train_k5,
                              "cnn_wsj_train": cnn_wsj_k5,
                              "cnn_wsj_recipe": cnn_wsj_recipe_k5}
    k5["launches"] = sum(k5["launches_by_path"].values())
    k5["max_abs_err"] = max(k5["max_abs_err"], cnn_wsj.pop("max_abs_err"))
    # one CNN-WSJ train step's 72 launches at its 36 sites (44 x 541)
    k5["cnn_wsj"] = cnn_wsj

    print("phase seconds: %s" % json.dumps(
        {name: round(sec, 1) for name, sec in seconds.items()}))
    print("profiler: %d traces, each primed with %d records; records the "
          "profiler lost of a trace's priming: %s (lost: traces)"
          % (len(PRIMING_LOST), PROFILER_PRIMING,
             dict(sorted(collections.Counter(PRIMING_LOST).items()))))
    # the bf16 variants' launches: the --tpu-routing-bf16 SRF-TIMIT steps
    # (K1-bf16, K2-bf16) and the --tpu-bf16 CNN-TIMIT steps (K5-bf16)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k1_bf16, k2_bf16,
                                  k5_bf16, *tp_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--parallel-worker"]:
            code = parallel_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--parallel-cli"]:
            code = parallel_cli_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--model-axis-worker"]:
            code = model_axis_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--model-axis-7c-worker"]:
            code = model_axis_7c_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--cards-worker"]:
            code = cards_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--cards-model-worker"]:
            code = cards_model_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--cards-cli"]:
            code = cards_cli_worker(sys.argv[2], sys.argv[3])
        elif sys.argv[1:2] == ["--cards"]:
            code = cards_run()
        else:
            code = run()
    except SmokeFailure as failure:
        print("chip_smoke FAILED: %s" % failure, file=sys.stderr)
        code = 1
    sys.exit(code)
