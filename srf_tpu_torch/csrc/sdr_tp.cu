// The split-softmax SDR on a shard of the out capsules, for Hopper, sm_90a:
// K1-tp (the forward) and K2-tp (its backward, one routing iteration).
//
// No Pallas kernel is replaced: on a ("data", "model") mesh, JAX shards the
// class-capsule layer's W and b on the out capsules
// (srf_tpu/parallel/sharding_rules.py:srf_rules) and XLA partitions the
// loop body of its SDR scan (srf_tpu/ops/routing.py:_sdr_step_factored),
// putting the softmax's row max and row sum, all-reduced over "model",
// inside every step and iteration. The plain versions are
// srf_tpu_torch/ops/routing.py:sequential_routing_tp and
// sequential_routing_tp_bwd; the wrappers are in ops/routing_cuda.py.
//
// The persistent kernels (transports 1 and 2 below). K1-tp is two launches:
// the prediction kernel (sdr_fwd.cu's sdr_predict) writes this rank's u_hat
// [B, T, in_n, pitch] (O = the shard's out capsules, pitch = O * out_d
// rounded up to 4), then sdr_tp_fwd_persistent_kernel runs one block per
// (utterance, rank) and walks t and the iterations on the card, its
// producer warp streaming u_hat_t through K1's ring (sdr_stream.cuh) twice
// an iteration:
//   pass A (kSplitStats)  b[n,o] (+)= <u_hat[n,o,:], v[o,:]> (+ -1e9 at
//                         global capsule 0, on the rank that holds it), kept
//                         in shared memory; each row's local max m and sum l
//                         of exp(b - m)
//   exchange              the block's (m, l) pairs to every rank; wait for
//                         every rank's; M = max_r m_r, L = sum_r l_r
//                         exp(m_r - M) in rank order, saved for K2-tp
//   pass B (kSplitRoute)  c = exp(b - M) / L; s = sum_n c u_hat in
//                         per-warp partials, summed in warp order; v =
//                         squash(s), the carry, and the output of step t
//                         after the last iteration
// K2-tp is four launches: the prediction, sdr_tp_bwd_persistent_kernel
// walking t from T-1 down to 0 with u_hat_t streamed three times a step,
//   pass 1 (kSplitC)      c from the saved (M, L) and b = <u_hat, v_{t-1}>
//                         (+ PAD), no exchange; s; then ds = squash'^T
//                         (dvs[t] + carry)
//   pass 2 (kSplitDc)     dc[n,o] = <u_hat[n,o,:], ds[o,:]>, kept in shared
//                         memory; each row's local sum_o c dc
//   exchange              those sums summed over the ranks in rank order
//   pass 3 (kSplitVjp)    da = c (dc - sum); carry = sum_n da u_hat
// writing du_hat's factors (c, da, ds) in K2's layout; then K2's weight-
// gradient and reduction kernels (sdr_bwd.cu's sdr_bwd_wgrad) form the
// shard's dW and db and this rank's part of du, which the wrapper sums
// over "model" once.
//
// The exchange. Every rank owns xbuf [2 slots][ranks][cap][2] floats and
// flags [ranks][cap] uint64 (cap >= B * in_n; a flag per utterance). To
// publish exchange e, a block writes its rows' pairs into slot e % 2, its
// rank's place, of every rank's xbuf, then (after the compute warps'
// barrier and a system-scope fence) stores its utterance's flag, e's epoch,
// into every rank's flags with release semantics: remote stores, so that a
// reader finds the data in its own memory. It then acquire-loads the flags
// of every rank in its own buffer until each reaches the epoch, and reads
// the pairs from its own xbuf. Epochs are monotone: the rank set's
// exchanges before this call plus e + 1 (a host counter, equal on every
// rank because every rank makes the same calls; a count of exchanges, not
// call number times T * ITER, which would fall back when T shrinks), so
// flags are zeroed once, at allocation, and never cleared. Two slots
// suffice: a rank publishes exchange e + 1 only after it has read every
// rank's pairs of exchange e (its wait, then its reads, then the barrier
// before its next publish), and a rank reaches exchange e + 2 only after
// reading every rank's e + 1, which each published after reading e; so no
// rank writes a slot that a peer has not finished reading. The wait is
// bounded: past `timeout_ns` on %globaltimer it records the rank, the
// utterance, the step, the iteration, the epoch and the rank it waited for
// in the status words, and every later wait of the launch returns at once,
// so the launch ends and the wrapper raises. The launch is cooperative
// (cudaLaunchAttributeCooperative), so that all its blocks are resident;
// where they cannot be, it is refused and the wrapper raises with the
// limit.
//
// Where the peers' buffers live: (1) co-launch, one process, R shards on
// one card: one launch of B x R blocks (blockIdx.y the rank), the R
// buffers slices of one allocation; (2) peers over CUDA IPC, one rank a
// card, every card of the group on one host: each rank's buffer is
// cudaMalloc'd here (sdr_tp_ipc_alloc; torch's caching allocator would
// hand out a segment's base), its handle exchanged over the host group and
// opened by every peer, and each rank's launch holds its own B blocks.
//
// What bounds the persistent kernels on this card: the serial chain over
// time, as for K1 (the rows' dot products, softmax statistics and sums,
// behind the compute warps' barriers), plus one exchange a step and
// iteration, whose latency is a round trip through the memory system
// (L2 on one card, NVLink across cards). Their bytes: u_hat read 2 * ITER
// (K1-tp) or 3 (K2-tp) times a step, from L2 or device memory; the least
// time counts each input once (chip_smoke.py's bound).
//
// (3) The host loop, for groups whose ranks share a card (their processes
// are time-sliced, so a block spinning in one waits for a peer that runs
// only in the next slice) or span hosts: the prediction kernel, then for
// each step t and iteration k:
//   sdr_tp_stats_kernel   b[n,o] (+)= <u_hat[n,o,:], v[o,:]> (+ -1e9 at
//                         global capsule 0, on the rank that holds it);
//                         each row's local max m and sum l of exp(b - m)
//   (host)                one all-gather of the (m, l) pairs over "model"
//   sdr_tp_route_kernel   M = max_r m_r, L = sum_r l_r exp(m_r - M);
//                         c = exp(b - M) / L; s[o,:] = sum_n c[n,o]
//                         u_hat[n,o,:]; v = squash(s); out[:, t] = v after
//                         the last iteration; (M, L) saved for K2-tp
// the logits b accumulating over the iterations in global memory ([B,
// in_n, O]); and K2-tp, for t from T-1 down to 0:
//   sdr_tp_bwd_a_kernel   c from the saved (M, L) and b = <u_hat,
//                         v_{t-1}> (+ PAD); s; ds = squash'^T (dvs[t] +
//                         carry); dc[n,o] = <u_hat[n,o,:], ds[o,:]>; each
//                         row's local sum_o c dc
//   (host)                one SUM all-reduce of those [B, in_n] sums
//   sdr_tp_bwd_b_kernel   da = c (dc - sum); carry = sum_n da u_hat
// It is bound by its launches and collectives: two launches and one
// collective a step and iteration. One thread per row in the stats kernel
// and in the row sums, one block per utterance where a step sums over
// rows, every sum in a fixed order (no atomics).
//
// The bf16 instances (template argument BF; K1-tp-bf16, K2-tp-bf16, the
// entries' `bf16` argument) compute the split SDR under bf16 routing
// (ops/routing.py:sequential_routing_tp(..., bf16=True) and its backward
// by autograd): u_hat is the bf16 prediction (sdr_fwd.cu's
// sdr_predict_bf16), streamed in bf16; each agreement is taken against
// bf16(v) (bf16(v_{t-1}) backward), each sum over rows with bf16(c), dc and
// the backward's carry are rounded to bf16, as K1-bf16 and K2-bf16 do
// (sdr_stream.cuh). The logits, the (m, l) pairs and their exchange, the
// (M, L) statistics, the squash and the outputs stay float32.
//
// Streaming (K1-tp-stream, the forward's v_init and step_valid): the
// carry before step 0 is v_init (this rank's part), or zeros; an invalid
// step emits zeros and leaves a zero carry (sdr_fwd.cu's semantics). An
// invalid step still makes its exchanges, so that every rank counts the
// same epochs. The host loop's carry starts as the wrapper's copy of
// v_init and its route kernel applies the mask.
//
// SDR_TP_HOST builds this file as host C++ (tests/_sdr_tp_host.h: CUDA
// threads as std::threads, a block's barrier as a std::barrier, a
// cooperative launch's blocks all at once), so that the CPU tests run
// these kernels against their plain versions.

#include "sdr_stream.cuh"

#ifndef SDR_TP_HOST
#define SDR_TP_SMEM(name)                  \
  extern __shared__ float4 name##_raw_[]; \
  float* name = reinterpret_cast<float*>(name##_raw_)
#define SDR_TP_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

using sdr::kComputeThreads;
using sdr::kPadLogit;
using sdr::kSquashEps;
using sdr::kWarps;
using sdr::Ring;
using sdr::RowGeom;
constexpr int kRowThreads = 128;     // the stats kernel: a thread a row
constexpr int kBlockThreads = 256;   // the per-utterance kernels
constexpr long long kMaxSmemBytes = sdr::kMaxSmemBytes;

// Floats of shared memory the per-utterance kernels take: (M, L) of every
// row, c (or da) of every row and out capsule, and three out vectors.
long long smem_floats(int in_n, int out_n, int out_d) {
  return 2LL * in_n + (long long)in_n * out_n + 3LL * out_n * out_d;
}

bool geometry_ok(int batch, int seq_len, int in_n, int out_n, int out_d) {
  return batch >= 1 && seq_len >= 1 && in_n >= 1 && out_n >= 1 &&
         out_d >= 1 &&
         smem_floats(in_n, out_n, out_d) * 4 <= kMaxSmemBytes;
}

// A u_hat row's entries: out_no rounded up to 16 bytes of E's.
template <typename E>
__host__ __device__ inline int pitch_of(int out_no) {
  return sdr::row_pitch(out_no, (int)sizeof(E));
}

// One thread per row r = b * in_n + n of step t: the logits b[r, o] of
// iteration `it` (the previous iterations' sum plus the agreement with v,
// the carry [B, out_no], bf16(v) in BF; the PAD logit at o = 0 where
// `pad`), and the row's local max m and sum l of exp(b - m) into
// local_ml[r] = (m, l).
template <bool BF>
__global__ void __launch_bounds__(kRowThreads)
sdr_tp_stats_kernel(const sdr::uhat_t<BF>* __restrict__ uhat,
                    const float* __restrict__ vcar, float* __restrict__ bacc,
                    float* __restrict__ local_ml, int batch, int seq_len,
                    int t, int in_n, int out_n, int out_d, int it, int pad) {
  using E = sdr::uhat_t<BF>;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= batch * in_n) return;
  const int b = r / in_n;
  const int n = r % in_n;
  const int out_no = out_n * out_d;
  const E* row =
      uhat + (((size_t)b * seq_len + t) * in_n + n) * pitch_of<E>(out_no);
  const float* v = vcar + (size_t)b * out_no;
  float* logits = bacc + (size_t)r * out_n;
  float m = -INFINITY;
  for (int o = 0; o < out_n; ++o) {
    float agree = 0.f;
    for (int i = 0; i < out_d; ++i) {
      agree = fmaf(sdr::to_f32(row[o * out_d + i]),
                   sdr::keep<BF>(v[o * out_d + i]), agree);
    }
    float logit = (it > 0 ? logits[o] : 0.f) + agree;
    if (pad && o == 0) logit += kPadLogit;
    logits[o] = logit;
    m = fmaxf(m, logit);
  }
  float l = 0.f;
  for (int o = 0; o < out_n; ++o) l += expf(logits[o] - m);
  local_ml[2 * (size_t)r] = m;
  local_ml[2 * (size_t)r + 1] = l;
}

// s[oi] = sum_n coef[n, oi / out_d] * row_n[oi] over the rows of step t of
// utterance b, a thread per entry oi, the rows summed in order; RC: the
// coefficients rounded to bf16 first (bf16(c) in the bf16 instances).
template <bool RC, typename E>
__device__ __forceinline__ float row_sum(const float* coef, const E* uhat_bt,
                                         int in_n, int out_n, int out_d,
                                         int pitch, int oi) {
  const int o = oi / out_d;
  float s = 0.f;
  for (int n = 0; n < in_n; ++n) {
    s = fmaf(sdr::keep<RC>(coef[n * out_n + o]),
             sdr::to_f32(uhat_bt[(size_t)n * pitch + oi]), s);
  }
  return s;
}

// One block per utterance b: the global (M, L) of each row from the ranks'
// pairs gathered [ranks, B * in_n, 2], saved to stats [B, in_n, 2] (this
// step's and iteration's slot); c = exp(b - M) / L; s (with bf16(c) in
// BF) and its squash, the new carry v; the output of step t after the last
// iteration, zeros (and a zero carry) where step_valid [B, T] (or null:
// every step valid) says the step is not valid.
template <bool BF>
__global__ void __launch_bounds__(kBlockThreads)
sdr_tp_route_kernel(const sdr::uhat_t<BF>* __restrict__ uhat,
                    const float* __restrict__ gathered, int ranks,
                    const float* __restrict__ bacc, float* __restrict__ vcar,
                    float* __restrict__ out, float* __restrict__ stats,
                    const unsigned char* __restrict__ step_valid,
                    int batch, int seq_len, int t, int in_n, int out_n,
                    int out_d, int last) {
  using E = sdr::uhat_t<BF>;
  SDR_TP_SMEM(smem);
  const int out_no = out_n * out_d;
  float* m_s = smem;                  // [in_n]
  float* l_s = m_s + in_n;            // [in_n]
  float* c_s = l_s + in_n;            // [in_n, out_n]
  float* s_s = c_s + in_n * out_n;    // [out_no]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t rows = (size_t)batch * in_n;
  for (int n = tid; n < in_n; n += nthr) {
    const size_t r = (size_t)b * in_n + n;
    float m = -INFINITY;
    for (int q = 0; q < ranks; ++q) m = fmaxf(m, gathered[2 * (q * rows + r)]);
    float l = 0.f;
    for (int q = 0; q < ranks; ++q) {
      l += gathered[2 * (q * rows + r) + 1] *
           expf(gathered[2 * (q * rows + r)] - m);
    }
    m_s[n] = m;
    l_s[n] = l;
    stats[2 * r] = m;
    stats[2 * r + 1] = l;
  }
  __syncthreads();
  for (int e = tid; e < in_n * out_n; e += nthr) {
    const int n = e / out_n;
    c_s[e] = expf(bacc[(size_t)b * in_n * out_n + e] - m_s[n]) / l_s[n];
  }
  __syncthreads();
  const int pitch = pitch_of<E>(out_no);
  const E* uhat_bt = uhat + ((size_t)b * seq_len + t) * in_n * pitch;
  for (int oi = tid; oi < out_no; oi += nthr) {
    s_s[oi] = row_sum<BF>(c_s, uhat_bt, in_n, out_n, out_d, pitch, oi);
  }
  __syncthreads();
  const bool valid =
      !last || !step_valid || step_valid[(size_t)b * seq_len + t];
  for (int oi = tid; oi < out_no; oi += nthr) {
    const float* s_o = s_s + (oi / out_d) * out_d;
    float sq = 0.f;
    for (int i = 0; i < out_d; ++i) sq = fmaf(s_o[i], s_o[i], sq);
    const float v =
        valid ? (sq / (1.f + sq)) * (s_s[oi] / sqrtf(sq + kSquashEps)) : 0.f;
    vcar[(size_t)b * out_no + oi] = v;
    if (last) out[((size_t)b * seq_len + t) * out_no + oi] = v;
  }
}

// K2-tp's first kernel, one block per utterance b, step t: c from the
// saved (M, L) of the forward's first iteration (stats [B, in_n, 2]) and
// the logits against v_{t-1} (vs[t - 1], or 0; bf16(v_{t-1}) in BF); s
// (with bf16(c) in BF); ds = the squash's VJP of dv = dvs[t] + carry; dc
// = <u_hat, ds> per (row, out capsule) (bf16(dc) in BF) into dc_g [B,
// in_n, out_n]; each row's local sum_o c dc into rowsum [B, in_n]. c and
// ds go to K2's factor layout: cfac [B, T, in_n, out_n], dsfac [B, T,
// out_no].
template <bool BF>
__global__ void __launch_bounds__(kBlockThreads)
sdr_tp_bwd_a_kernel(const sdr::uhat_t<BF>* __restrict__ uhat,
                    const float* __restrict__ vs, const float* __restrict__ dvs,
                    const float* __restrict__ stats,
                    const float* __restrict__ carry, float* __restrict__ cfac,
                    float* __restrict__ dsfac, float* __restrict__ dc_g,
                    float* __restrict__ rowsum, int batch, int seq_len, int t,
                    int in_n, int out_n, int out_d, int pad) {
  using E = sdr::uhat_t<BF>;
  SDR_TP_SMEM(smem);
  const int out_no = out_n * out_d;
  float* m_s = smem;                  // [in_n]
  float* l_s = m_s + in_n;            // [in_n]
  float* c_s = l_s + in_n;            // [in_n, out_n]
  float* s_s = c_s + in_n * out_n;    // [out_no]
  float* dv_s = s_s + out_no;         // [out_no]
  float* ds_s = dv_s + out_no;        // [out_no]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int pitch = pitch_of<E>(out_no);
  const size_t bt = (size_t)b * seq_len + t;
  const E* uhat_bt = uhat + bt * in_n * pitch;
  const float* vprev = t > 0 ? vs + (bt - 1) * out_no : nullptr;
  for (int n = tid; n < in_n; n += nthr) {
    const size_t r = (size_t)b * in_n + n;
    m_s[n] = stats[2 * r];
    l_s[n] = stats[2 * r + 1];
  }
  __syncthreads();
  for (int e = tid; e < in_n * out_n; e += nthr) {
    const int n = e / out_n;
    const int o = e % out_n;
    float logit = 0.f;
    if (vprev) {
      const E* row = uhat_bt + (size_t)n * pitch + o * out_d;
      for (int i = 0; i < out_d; ++i) {
        logit = fmaf(sdr::to_f32(row[i]), sdr::keep<BF>(vprev[o * out_d + i]),
                     logit);
      }
    }
    if (pad && o == 0) logit += kPadLogit;
    const float c = expf(logit - m_s[n]) / l_s[n];
    c_s[e] = c;
    cfac[bt * in_n * out_n + e] = c;
  }
  __syncthreads();
  for (int oi = tid; oi < out_no; oi += nthr) {
    s_s[oi] = row_sum<BF>(c_s, uhat_bt, in_n, out_n, out_d, pitch, oi);
    dv_s[oi] = dvs[bt * out_no + oi] + carry[(size_t)b * out_no + oi];
  }
  __syncthreads();
  for (int oi = tid; oi < out_no; oi += nthr) {
    const int base = (oi / out_d) * out_d;
    float sq = 0.f, dot = 0.f;
    for (int i = 0; i < out_d; ++i) {
      sq = fmaf(s_s[base + i], s_s[base + i], sq);
      dot = fmaf(dv_s[base + i], s_s[base + i], dot);
    }
    const float inv_sqrt = 1.f / sqrtf(sq + kSquashEps);
    const float ratio = sq / (1.f + sq);
    const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                       0.5f * ratio * (inv_sqrt / (sq + kSquashEps));
    const float ds = dv_s[oi] * (ratio * inv_sqrt) + 2.f * s_s[oi] * (dot * dfdq);
    ds_s[oi] = ds;
    dsfac[bt * out_no + oi] = ds;
  }
  __syncthreads();
  for (int n = tid; n < in_n; n += nthr) {
    const E* row = uhat_bt + (size_t)n * pitch;
    float* dc_row = dc_g + ((size_t)b * in_n + n) * out_n;
    float sum = 0.f;
    for (int o = 0; o < out_n; ++o) {
      float dc = 0.f;
      for (int i = 0; i < out_d; ++i) {
        dc = fmaf(sdr::to_f32(row[o * out_d + i]), ds_s[o * out_d + i], dc);
      }
      dc = sdr::keep<BF>(dc);
      dc_row[o] = dc;
      sum = fmaf(dc, c_s[n * out_n + o], sum);
    }
    rowsum[(size_t)b * in_n + n] = sum;
  }
}

// K2-tp's second kernel, one block per utterance b, step t, after the
// rows' sums were summed over the ranks: da = c (dc - sum) into dafac (K2's
// layout [B, T, in_n, out_n]); the carry into step t - 1, sum_n da u_hat
// (rounded to bf16 in BF: the cotangent of bf16(v_{t-1})).
template <bool BF>
__global__ void __launch_bounds__(kBlockThreads)
sdr_tp_bwd_b_kernel(const sdr::uhat_t<BF>* __restrict__ uhat,
                    const float* __restrict__ cfac,
                    const float* __restrict__ dc_g,
                    const float* __restrict__ rowsum,
                    float* __restrict__ dafac, float* __restrict__ carry,
                    int batch, int seq_len, int t, int in_n, int out_n,
                    int out_d) {
  using E = sdr::uhat_t<BF>;
  SDR_TP_SMEM(smem);
  float* da_s = smem + 2 * in_n;  // [in_n, out_n], the other kernels' c_s
  const int out_no = out_n * out_d;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int pitch = pitch_of<E>(out_no);
  const size_t bt = (size_t)b * seq_len + t;
  for (int e = tid; e < in_n * out_n; e += nthr) {
    const int n = e / out_n;
    const float c = cfac[bt * in_n * out_n + e];
    const float da = c * (dc_g[(size_t)b * in_n * out_n + e] -
                          rowsum[(size_t)b * in_n + n]);
    da_s[e] = da;
    dafac[bt * in_n * out_n + e] = da;
  }
  __syncthreads();
  const E* uhat_bt = uhat + bt * in_n * pitch;
  for (int oi = tid; oi < out_no; oi += nthr) {
    carry[(size_t)b * out_no + oi] = sdr::keep<BF>(
        row_sum<false>(da_s, uhat_bt, in_n, out_n, out_d, pitch, oi));
  }
}

// ---- the persistent kernels (transports 1 and 2) ----

constexpr int kMaxRanks = 8;
// status words: 0 while every wait succeeded, else 1; then the waiting
// rank, the utterance, the step, the iteration, the epoch waited for and
// the rank whose flag did not reach it
constexpr int kStatusWords = 8;

#ifndef SDR_TP_HOST
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// true for the one caller that moves status[0] from 0 to 1
__device__ __forceinline__ bool status_claim(unsigned long long* p) {
  return atomicCAS(p, 0ULL, 1ULL) == 0ULL;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void fence_system() { __threadfence_system(); }
__device__ __forceinline__ void backoff() { __nanosleep(128); }
// a pair another rank wrote into this rank's xbuf: past L1, which the
// writes did not go through
__device__ __forceinline__ float2 load_peer(const float2* p) {
  return __ldcg(p);
}
#endif

// A launch's rank set: every rank's buffers (xbuf, flags), this launch's
// first rank (blockIdx.y = rank - rank0), the status words, the epoch
// before this call and the wait's deadline.
struct Exch {
  float* xbuf[kMaxRanks];
  unsigned long long* flags[kMaxRanks];
  unsigned long long* status;
  unsigned long long epoch0;
  unsigned long long timeout_ns;
  int ranks, rank0, cap;
  int pad_rank;  // the rank that holds the PAD capsule, or -1
};

// Thread 0 of the compute warps: waits until every rank's flag for
// utterance b in this rank's buffer has reached `epoch`. Past the deadline
// it records the failure (the launch's first only) and returns; once one is
// recorded, every wait of the launch returns at once.
__device__ void wait_ranks(const Exch& x, int rank, int b, int t, int it,
                           unsigned long long epoch) {
  const unsigned long long* flags = x.flags[rank];
  unsigned long long start = 0;
  for (int peer = 0; peer < x.ranks; ++peer) {
    const unsigned long long* f = flags + (size_t)peer * x.cap + b;
    while (load_acquire(f) < epoch) {
      if (status_word(x.status) != 0) return;
      const unsigned long long now = now_ns();
      if (start == 0) {
        start = now;
      } else if (now - start > x.timeout_ns) {
        if (status_claim(x.status)) {
          x.status[1] = rank;
          x.status[2] = b;
          x.status[3] = t;
          x.status[4] = it;
          x.status[5] = epoch;
          x.status[6] = peer;
        }
        return;
      }
      backoff();
    }
  }
}

// The compute warps: one exchange of the block's rows' pairs (row_out
// [in_n, 2]) with every rank, epoch `epoch`. Returns, after a barrier, with
// every rank's pairs in this rank's xbuf, slot epoch % 2.
__device__ void exchange(const Exch& x, const float* row_out, int in_n,
                         int rank, int b, int t, int it,
                         unsigned long long epoch, int tid) {
  const int slot = (int)(epoch & 1);
  const size_t at = ((size_t)slot * x.ranks + rank) * x.cap + (size_t)b * in_n;
  const float2* src = reinterpret_cast<const float2*>(row_out);
  for (int e = tid; e < x.ranks * in_n; e += kComputeThreads) {
    const int peer = e / in_n;
    const int n = e - peer * in_n;
    reinterpret_cast<float2*>(x.xbuf[peer])[at + n] = src[n];
  }
  sdr::sync_compute();
  if (tid == 0) {
    fence_system();
    for (int peer = 0; peer < x.ranks; ++peer) {
      store_release(x.flags[peer] + (size_t)rank * x.cap + b, epoch);
    }
    wait_ranks(x, rank, b, t, it, epoch);
    fence_system();
  }
  sdr::sync_compute();
}

// Rank `peer`'s pair of row n, utterance b, in this rank's xbuf.
__device__ __forceinline__ float2 pair_of(const Exch& x, int rank, int peer,
                                          unsigned long long epoch, int b,
                                          int in_n, int n) {
  return load_peer(reinterpret_cast<const float2*>(x.xbuf[rank]) +
                   ((size_t)(epoch & 1) * x.ranks + peer) * x.cap +
                   (size_t)b * in_n + n);
}

// Floats of a persistent kernel's shared memory besides the ring: the
// rows' pairs in and out, the per-warp partials and logits, K1-tp's v and
// s (K2-tp's v_{t-1}, dv, ds and s), and the logits (K2-tp: c and dc) of
// every row and out capsule.
size_t persistent_floats(const RowGeom& g, int in_n, bool backward) {
  return 4 * (size_t)in_n + (size_t)kWarps * (g.out_no + g.out_n) +
         (backward ? 4 : 2) * (size_t)g.pitch +
         (backward ? 2 : 1) * (size_t)in_n * g.out_n;
}

// Rows per warp per chunk of the persistent kernels' register path:
// sdr_stream.cuh's lane_rows, but one for K2-tp at two out capsules a lane,
// whose two rows spill past its 128 registers a thread.
SDR_HOST_DEVICE constexpr int tp_rows(int d, int no, bool backward) {
  return backward && no == 2 ? 1 : sdr::lane_rows(d, no);
}

// A persistent kernel's pass over a step's rows: D == 0 takes the general
// path.
template <bool BF, int D, int NO, bool BWD, int MODE>
__device__ __forceinline__ void tp_pass(const sdr::Pass<BF>& p,
                                        sdr::Cursor& q, int warp, int lane) {
  if constexpr (D == 0) {
    sdr::warp_pass_rows<BF, MODE>(p, q, warp, lane);
  } else {
    sdr::warp_pass_lanes<BF, D, NO, tp_rows(D, NO, BWD), MODE>(p, q, warp,
                                                               lane);
  }
}

// The persistent kernels' plan: K1's ring (of bf16 rows in the bf16
// instances, esize 2) beside their fixed shared memory, the per-warp
// scratch always in shared memory. False if the geometry does not fit.
bool plan_persistent(int in_n, int out_n, int out_d, bool backward,
                     int esize, sdr::StreamPlan* p) {
  if (in_n < 1 || out_n < 1 || out_d < 1 ||
      (size_t)out_n * out_d > sdr::kMaxSmemFloats) {
    return false;
  }
  p->g = sdr::row_geom(out_n, out_d, esize);
  p->warp_global = false;
  const int caps = sdr::lane_caps(p->g);
  return sdr::plan_ring(in_n, (size_t)p->g.pitch * esize,
                        caps ? tp_rows(out_d, caps, backward) : 1,
                        persistent_floats(p->g, in_n, backward) * 4, &p->r);
}

size_t persistent_smem_bytes(const sdr::StreamPlan& p, int in_n,
                             bool backward) {
  return persistent_floats(p.g, in_n, backward) * 4 + sdr::ring_bytes(p.r, p.g);
}

// The ring's slots (of E's), their barriers, and the floats after them.
template <typename E>
struct RingSmem {
  E* ring;
  uint64_t* full;
  uint64_t* empty;
  float* rest;
};

template <typename E>
__device__ __forceinline__ RingSmem<E> ring_smem(float* smem, const Ring& r,
                                                 const RowGeom& g) {
  RingSmem<E> m;
  m.ring = reinterpret_cast<E*>(smem);
  m.full = reinterpret_cast<uint64_t*>(m.ring + (size_t)r.stages * r.chunk *
                                                    g.pitch);
  m.empty = m.full + r.stages;
  m.rest = reinterpret_cast<float*>(m.empty + r.stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      sdr::mbar_init(m.full + s, 1);
      sdr::mbar_init(m.empty + s, kWarps);
    }
    sdr::mbar_fence_init();
  }
  return m;
}

// uhat: of float32 or bf16 entries (the kernel's BF); v_init: this rank's
// part of the carry before step 0 [B, out_no], or null
struct FwdArgs {
  const void* uhat[kMaxRanks];
  float* out[kMaxRanks];
  float* stats[kMaxRanks];
  const float* v_init[kMaxRanks];
};

// K1-tp: block (b, rank - rank0) routes utterance b on that rank's shard,
// uhat [B, T, in_n, pitch] -> out [B, T, O, out_d] and the global (M, L)
// of every step and iteration, stats [T, ITER, B, in_n, 2]; the carry
// starts at v_init (or 0), and step_valid [B, T] (or null) zeroes an
// invalid step's output and carry. The agreement vector holds bf16(v) in
// BF (the only v the next pass reads).
template <bool BF, int D, int NO>
__global__ void __launch_bounds__(sdr::kThreads, 1)
sdr_tp_fwd_persistent_kernel(FwdArgs a, Exch x,
                             const unsigned char* __restrict__ step_valid,
                             int batch, int seq_len, int in_n, RowGeom g,
                             Ring r, int num_iter) {
  using E = sdr::uhat_t<BF>;
  SDR_TP_SMEM(smem);
  const RingSmem<E> m = ring_smem<E>(smem, r, g);
  float* row_ml = m.rest;                   // [in_n, 2] (M, L)
  float* row_out = row_ml + 2 * in_n;       // [in_n, 2] (m, l)
  float* part = row_out + 2 * in_n;         // [kWarps, out_no]
  float* vec = part + kWarps * g.out_no;    // [pitch] v, the carry
  float* s_s = vec + g.pitch;               // [pitch]
  float* lgw = s_s + g.pitch;               // [kWarps, out_n]
  float* lg_all = lgw + kWarps * g.out_n;   // [in_n, out_n] the logits
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const int local = blockIdx.y;
  const int rank = x.rank0 + local;
  const E* uhat_b = static_cast<const E*>(a.uhat[local]) +
                    (size_t)b * seq_len * in_n * g.pitch;
  float* out_b = a.out[local] + (size_t)b * seq_len * g.out_no;
  const float* vinit_b =
      a.v_init[local] ? a.v_init[local] + (size_t)b * g.out_no : nullptr;
  const unsigned char* valid_b =
      step_valid ? step_valid + (size_t)b * seq_len : nullptr;

  for (int k = tid; k < g.pitch; k += blockDim.x) {
    vec[k] = vinit_b && k < g.out_no ? sdr::keep<BF>(vinit_b[k]) : 0.f;
  }
  __syncthreads();
  if (warp == kWarps) {
    sdr::produce(uhat_b, m.ring, m.full, m.empty, r, in_n, g.pitch, seq_len,
                 0, 1, 2 * num_iter);
    return;
  }

  sdr::Pass<BF> stats{m.ring, m.full, m.empty, r, g, in_n, vec,
                      rank == x.pad_rank ? kPadLogit : 0.f, nullptr,
                      nullptr, part + warp * g.out_no,
                      lgw + warp * g.out_n};
  stats.lg_all = lg_all;
  stats.row_out = row_out;
  sdr::Pass<BF> route = stats;
  route.row_ml = row_ml;
  sdr::Cursor q{0, 0};  // the next chunk, in the producer's order
  for (int t = 0; t < seq_len; ++t) {
    for (int it = 0; it < num_iter; ++it) {
      const unsigned long long epoch =
          x.epoch0 + (unsigned long long)t * num_iter + it + 1;
      // pass A: the logits and each row's local (m, l)
      stats.accumulate = it > 0;
      tp_pass<BF, D, NO, false, sdr::kSplitStats>(stats, q, warp, lane);
      sdr::sync_compute();
      exchange(x, row_out, in_n, rank, b, t, it, epoch, tid);

      // the global (M, L) of each row, in rank order
      float* stats_g = a.stats[local] +
                       (((size_t)t * num_iter + it) * batch + b) * in_n * 2;
      for (int n = tid; n < in_n; n += kComputeThreads) {
        float mx = -INFINITY;
        for (int peer = 0; peer < x.ranks; ++peer) {
          mx = fmaxf(mx, pair_of(x, rank, peer, epoch, b, in_n, n).x);
        }
        float l = 0.f;
        for (int peer = 0; peer < x.ranks; ++peer) {
          const float2 ml = pair_of(x, rank, peer, epoch, b, in_n, n);
          l += ml.y * expf(ml.x - mx);
        }
        row_ml[2 * n] = mx;
        row_ml[2 * n + 1] = l;
        stats_g[2 * n] = mx;
        stats_g[2 * n + 1] = l;
      }
      sdr::sync_compute();

      // pass B: c and the rows' shares of s
      tp_pass<BF, D, NO, false, sdr::kSplitRoute>(route, q, warp, lane);
      sdr::sync_compute();

      // s = the sum of the warps' partials; v = squash(s), the carry and,
      // after the last iteration, the output (zero at an invalid step)
      const bool last = it == num_iter - 1;
      const bool zero = last && valid_b && !valid_b[t];
      if (g.shift >= 0) {
        for (int base = 0; base < g.out_no; base += kComputeThreads) {
          const int oi = base + tid;
          const float s =
              oi < g.out_no ? sdr::sum_partials(part, g.out_no, oi) : 0.f;
          const float sq = sdr::group_sum(s * s, g.shift);
          if (oi < g.out_no) {
            const float v =
                zero ? 0.f : (sq / (1.f + sq)) * (s / sqrtf(sq + kSquashEps));
            vec[oi] = sdr::keep<BF>(v);
            if (last) out_b[(size_t)t * g.out_no + oi] = v;
          }
        }
      } else {
        for (int oi = tid; oi < g.out_no; oi += kComputeThreads) {
          s_s[oi] = sdr::sum_partials(part, g.out_no, oi);
        }
        sdr::sync_compute();
        for (int oi = tid; oi < g.out_no; oi += kComputeThreads) {
          const float* s_o = s_s + (oi / g.out_d) * g.out_d;
          float sq = 0.f;
          for (int i = 0; i < g.out_d; ++i) sq = fmaf(s_o[i], s_o[i], sq);
          const float v =
              zero ? 0.f
                   : (sq / (1.f + sq)) * (s_s[oi] / sqrtf(sq + kSquashEps));
          vec[oi] = sdr::keep<BF>(v);
          if (last) out_b[(size_t)t * g.out_no + oi] = v;
        }
      }
      sdr::sync_compute();
    }
  }
}

struct BwdArgs {
  const void* uhat[kMaxRanks];
  const float* vs[kMaxRanks];
  const float* dvs[kMaxRanks];
  const float* stats[kMaxRanks];
  float* cfac[kMaxRanks];
  float* dafac[kMaxRanks];
  float* dsfac[kMaxRanks];
};

// K2-tp: block (b, rank - rank0) walks utterance b's steps backwards on
// that rank's shard: vs and dvs [B, T, O, out_d], the forward's (M, L)
// stats [T, 1, B, in_n, 2] -> cfac, dafac [B, T, in_n, O] and dsfac [B, T,
// O * out_d]. BF: v_{t-1} and the carry rounded to bf16 (the cotangent of
// bf16(v_{t-1})), as K2-bf16 does.
template <bool BF, int D, int NO>
__global__ void __launch_bounds__(sdr::kThreads, 1)
sdr_tp_bwd_persistent_kernel(BwdArgs a, Exch x, int batch, int seq_len,
                             int in_n, RowGeom g, Ring r) {
  using E = sdr::uhat_t<BF>;
  SDR_TP_SMEM(smem);
  const RingSmem<E> m = ring_smem<E>(smem, r, g);
  float* row_ml = m.rest;                   // [in_n, 2] (M, L), then (S, -)
  float* row_out = row_ml + 2 * in_n;       // [in_n, 2] (sum_o c dc, -)
  float* part = row_out + 2 * in_n;         // [kWarps, out_no]
  float* vp_s = part + kWarps * g.out_no;   // [pitch] v_{t-1}
  float* dv_s = vp_s + g.pitch;             // [pitch] dvs[t] + carry
  float* ds_s = dv_s + g.pitch;             // [pitch]
  float* s_s = ds_s + g.pitch;              // [pitch]
  float* lgw = s_s + g.pitch;               // [kWarps, out_n]
  float* c_all = lgw + kWarps * g.out_n;    // [in_n, out_n] c
  float* dc_all = c_all + in_n * g.out_n;   // [in_n, out_n] dc
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const int local = blockIdx.y;
  const int rank = x.rank0 + local;
  const E* uhat_b = static_cast<const E*>(a.uhat[local]) +
                    (size_t)b * seq_len * in_n * g.pitch;
  const float* vs_b = a.vs[local] + (size_t)b * seq_len * g.out_no;
  const float* dvs_b = a.dvs[local] + (size_t)b * seq_len * g.out_no;
  float* cfac_b = a.cfac[local] + (size_t)b * seq_len * in_n * g.out_n;
  float* dafac_b = a.dafac[local] + (size_t)b * seq_len * in_n * g.out_n;
  float* dsfac_b = a.dsfac[local] + (size_t)b * seq_len * g.out_no;
  const int last_t = seq_len - 1;

  for (int k = tid; k < g.out_no; k += blockDim.x) {
    dv_s[k] = dvs_b[(size_t)last_t * g.out_no + k];
    vp_s[k] = last_t > 0
                  ? sdr::keep<BF>(vs_b[(size_t)(last_t - 1) * g.out_no + k])
                  : 0.f;
  }
  __syncthreads();
  if (warp == kWarps) {
    sdr::produce(uhat_b, m.ring, m.full, m.empty, r, in_n, g.pitch, seq_len,
                 last_t, -1, 3);
    return;
  }

  sdr::Pass<BF> c_pass{m.ring, m.full, m.empty, r, g, in_n, vp_s,
                       rank == x.pad_rank ? kPadLogit : 0.f, c_all,
                       nullptr, part + warp * g.out_no,
                       lgw + warp * g.out_n};
  c_pass.row_ml = row_ml;
  sdr::Pass<BF> dc_pass = c_pass;
  dc_pass.vec = ds_s;
  dc_pass.lg_all = dc_all;
  dc_pass.row_out = row_out;
  sdr::Pass<BF> vjp_pass = c_pass;
  vjp_pass.lg_all = dc_all;
  sdr::Cursor q{0, 0};  // the next chunk, in the producer's order
  for (int t = last_t; t >= 0; --t) {
    const unsigned long long epoch = x.epoch0 + (last_t - t) + 1;
    const float* stats_t = a.stats[local] + ((size_t)t * batch + b) * in_n * 2;
    for (int n = tid; n < 2 * in_n; n += kComputeThreads) {
      row_ml[n] = stats_t[n];
    }
    sdr::sync_compute();

    // ---- pass 1: c from the saved (M, L), and s ----
    c_pass.fac = cfac_b + (size_t)t * in_n * g.out_n;
    tp_pass<BF, D, NO, true, sdr::kSplitC>(c_pass, q, warp, lane);
    sdr::sync_compute();

    // ---- s and the squash backward:
    //      ds = dv f(q) + 2 s (sum_i dv s) f'(q), q = |s[o,:]|^2 ----
    if (g.shift >= 0) {
      for (int base = 0; base < g.out_no; base += kComputeThreads) {
        const int oi = base + tid;
        const bool in = oi < g.out_no;
        const float s = in ? sdr::sum_partials(part, g.out_no, oi) : 0.f;
        const float dv = in ? dv_s[oi] : 0.f;
        const float sq = sdr::group_sum(s * s, g.shift);
        const float dvs_dot = sdr::group_sum(dv * s, g.shift);
        if (in) {
          const float inv_sqrt = 1.f / sqrtf(sq + kSquashEps);
          const float ratio = sq / (1.f + sq);
          const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                             0.5f * ratio * (inv_sqrt / (sq + kSquashEps));
          const float ds = dv * (ratio * inv_sqrt) + 2.f * s * (dvs_dot * dfdq);
          ds_s[oi] = ds;
          dsfac_b[(size_t)t * g.out_no + oi] = ds;
        }
      }
    } else {
      for (int oi = tid; oi < g.out_no; oi += kComputeThreads) {
        s_s[oi] = sdr::sum_partials(part, g.out_no, oi);
      }
      sdr::sync_compute();
      for (int oi = tid; oi < g.out_no; oi += kComputeThreads) {
        const int base = (oi / g.out_d) * g.out_d;
        float sq = 0.f, dvs_dot = 0.f;
        for (int i = 0; i < g.out_d; ++i) {
          sq = fmaf(s_s[base + i], s_s[base + i], sq);
          dvs_dot = fmaf(dv_s[base + i], s_s[base + i], dvs_dot);
        }
        const float inv_sqrt = 1.f / sqrtf(sq + kSquashEps);
        const float ratio = sq / (1.f + sq);
        const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                           0.5f * ratio * (inv_sqrt / (sq + kSquashEps));
        const float ds =
            dv_s[oi] * (ratio * inv_sqrt) + 2.f * s_s[oi] * (dvs_dot * dfdq);
        ds_s[oi] = ds;
        dsfac_b[(size_t)t * g.out_no + oi] = ds;
      }
    }
    sdr::sync_compute();

    // ---- pass 2: dc and each row's local sum_o c dc ----
    tp_pass<BF, D, NO, true, sdr::kSplitDc>(dc_pass, q, warp, lane);
    sdr::sync_compute();
    exchange(x, row_out, in_n, rank, b, t, 0, epoch, tid);
    for (int n = tid; n < in_n; n += kComputeThreads) {
      float sum = 0.f;
      for (int peer = 0; peer < x.ranks; ++peer) {
        sum += pair_of(x, rank, peer, epoch, b, in_n, n).x;
      }
      row_ml[2 * n] = sum;
    }
    sdr::sync_compute();

    // ---- pass 3: da and the carry into step t - 1 ----
    vjp_pass.fac = dafac_b + (size_t)t * in_n * g.out_n;
    tp_pass<BF, D, NO, true, sdr::kSplitVjp>(vjp_pass, q, warp, lane);
    sdr::sync_compute();
    if (t > 0) {
      for (int oi = tid; oi < g.out_no; oi += kComputeThreads) {
        dv_s[oi] = sdr::keep<BF>(sdr::sum_partials(part, g.out_no, oi)) +
                   dvs_b[(size_t)(t - 1) * g.out_no + oi];
        vp_s[oi] = t > 1
                       ? sdr::keep<BF>(vs_b[(size_t)(t - 2) * g.out_no + oi])
                       : 0.f;
      }
    }
    sdr::sync_compute();
  }
}

// The persistent kernel for a plan: the register path for out_d 8 or 20
// (sdr_stream.cuh's lane_caps), else the general path.
#define SDR_TP_PICK(K, BF, g)                                          \
  (::sdr::lane_caps(g) == 1 && (g).out_d == 8    ? K<BF, 8, 1>         \
   : ::sdr::lane_caps(g) == 2 && (g).out_d == 8  ? K<BF, 8, 2>         \
   : ::sdr::lane_caps(g) == 1 && (g).out_d == 20 ? K<BF, 20, 1>        \
                                                 : K<BF, 0, 0>)

#ifndef SDR_TP_HOST
// A cooperative launch of `kernel` on a (gx, gy) grid: every block
// resident at once, or the launch is refused.
template <typename... Params, typename... Args>
int coop_launch(void (*kernel)(Params...), int gx, int gy, size_t smem,
                cudaStream_t stream, Args... args) {
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, 1);
  cfg.blockDim = dim3(sdr::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? err : (int)cudaGetLastError();
}
#define SDR_TP_COOP_LAUNCH(kernel, gx, gy, block, smem, stream, ...) \
  coop_launch(kernel, gx, gy, smem, stream, __VA_ARGS__)
#endif

// The blocks of a persistent kernel (BF: its bf16 instance) the card holds
// at once, or -1.
template <bool BF>
int persistent_capacity(const sdr::StreamPlan& p, int in_n, bool backward) {
#ifdef SDR_TP_HOST
  (void)p, (void)in_n, (void)backward;
  return 1 << 20;
#else
  const size_t smem = persistent_smem_bytes(p, in_n, backward);
  const void* kernel =
      backward
          ? (const void*)SDR_TP_PICK(sdr_tp_bwd_persistent_kernel, BF, p.g)
          : (const void*)SDR_TP_PICK(sdr_tp_fwd_persistent_kernel, BF, p.g);
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    sdr::kThreads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return per_sm * sms;
#endif
}

// The rank set of a launch from the C interface's arguments; false if they
// do not describe one.
bool make_exch(void* const* xbuf, void* const* flags, void* status,
               int ranks, int rank0, int local_ranks, int pad_rank, int cap,
               long long epoch0, long long timeout_ns, int batch, int in_n,
               Exch* x) {
  if (ranks < 1 || ranks > kMaxRanks || rank0 < 0 || local_ranks < 1 ||
      rank0 + local_ranks > ranks || pad_rank < -1 || pad_rank >= ranks ||
      (long long)cap < (long long)batch * in_n || epoch0 < 0 ||
      timeout_ns < 1 || !status) {
    return false;
  }
  for (int q = 0; q < ranks; ++q) {
    if (!xbuf[q] || !flags[q]) return false;
    x->xbuf[q] = static_cast<float*>(xbuf[q]);
    x->flags[q] = static_cast<unsigned long long*>(flags[q]);
  }
  x->status = static_cast<unsigned long long*>(status);
  x->epoch0 = (unsigned long long)epoch0;
  x->timeout_ns = (unsigned long long)timeout_ns;
  x->ranks = ranks;
  x->rank0 = rank0;
  x->cap = cap;
  x->pad_rank = pad_rank;
  return true;
}

int set_smem(const void* kernel, long long bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The host loop's launches of a kernel's float32 or bf16 instance: u_hat's
// entries follow `bf16`.
template <template <bool> class K, typename... Args>
int launch_tp(int bf16, int grid, int threads, long long smem,
              cudaStream_t stream, const void* uhat, Args... args) {
  if (bf16) {
    return K<true>::launch(grid, threads, smem, stream,
                           static_cast<const __nv_bfloat16*>(uhat), args...);
  }
  return K<false>::launch(grid, threads, smem, stream,
                          static_cast<const float*>(uhat), args...);
}

// One struct per host-loop kernel: its launch, after its shared memory
// attribute where it takes dynamic shared memory.
#define SDR_TP_STEP(Name, kernel)                                           \
  template <bool BF>                                                        \
  struct Name {                                                             \
    template <typename... Args>                                             \
    static int launch(int grid, int threads, long long smem,                \
                      cudaStream_t stream, Args... args) {                  \
      if (smem) {                                                           \
        const int err = set_smem((const void*)kernel<BF>, smem);            \
        if (err) return err;                                                \
      }                                                                     \
      SDR_TP_LAUNCH(kernel<BF>, grid, threads, smem, stream, args...);      \
      return (int)cudaGetLastError();                                       \
    }                                                                       \
  };
SDR_TP_STEP(StatsStep, sdr_tp_stats_kernel)
SDR_TP_STEP(RouteStep, sdr_tp_route_kernel)
SDR_TP_STEP(BwdAStep, sdr_tp_bwd_a_kernel)
SDR_TP_STEP(BwdBStep, sdr_tp_bwd_b_kernel)
#undef SDR_TP_STEP

extern "C" {

// Bytes of dynamic shared memory the per-utterance kernels take for this
// geometry (out_n: the shard's out capsules), or -1 if it does not fit.
int sdr_tp_smem_bytes(int in_n, int out_n, int out_d) {
  return geometry_ok(1, 1, in_n, out_n, out_d)
             ? (int)(smem_floats(in_n, out_n, out_d) * 4)
             : -1;
}

// Step t, iteration it of K1-tp: uhat [batch, seq_len, in_n, pitch] (bf16
// entries, pitch a multiple of 8, where `bf16`; float32, a multiple of 4,
// else), vcar (the carry) [batch, out_n * out_d], bacc (the logits)
// [batch, in_n, out_n], local_ml [batch, in_n, 2]; pad nonzero on the rank
// whose shard holds the PAD capsule of the last layer. float32 but u_hat,
// contiguous, on the current device; launches on `stream`, returns the
// launch error.
int sdr_tp_stats(const void* uhat, const float* vcar, float* bacc,
                 float* local_ml, int batch, int seq_len, int t, int in_n,
                 int out_n, int out_d, int it, int pad, int bf16,
                 void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || t < 0 ||
      t >= seq_len || it < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch * in_n + kRowThreads - 1) / kRowThreads;
  return launch_tp<StatsStep>(bf16, blocks, kRowThreads, 0,
                              (cudaStream_t)stream, uhat, vcar, bacc,
                              local_ml, batch, seq_len, t, in_n, out_n,
                              out_d, it, pad);
}

// Step t of K1-tp after the exchange: gathered [ranks, batch, in_n, 2] (the
// ranks' (m, l) pairs), bacc, uhat as above; writes the carry vcar, out
// [batch, seq_len, out_n, out_d] at step t where `last` (the last
// iteration), and this step's and iteration's global (M, L) to stats
// [batch, in_n, 2]; step_valid [batch, seq_len] (nonzero: valid) or null:
// an invalid step's output and carry are zeros.
int sdr_tp_route(const void* uhat, const float* gathered, int ranks,
                 const float* bacc, float* vcar, float* out, float* stats,
                 const unsigned char* step_valid, int batch, int seq_len,
                 int t, int in_n, int out_n, int out_d, int last, int bf16,
                 void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || ranks < 1 ||
      t < 0 || t >= seq_len) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_tp<RouteStep>(
      bf16, batch, kBlockThreads, smem_floats(in_n, out_n, out_d) * 4,
      (cudaStream_t)stream, uhat, gathered, ranks, bacc, vcar, out, stats,
      step_valid, batch, seq_len, t, in_n, out_n, out_d, last);
}

// Step t of K2-tp before the exchange: uhat as above, the forward's output
// vs and its cotangent dvs [batch, seq_len, out_n, out_d], stats (the
// forward's (M, L) of step t, first iteration) [batch, in_n, 2], carry
// [batch, out_n * out_d]; writes cfac [batch, seq_len, in_n, out_n] and
// dsfac [batch, seq_len, out_n * out_d] at step t, dc [batch, in_n, out_n]
// and rowsum [batch, in_n].
int sdr_tp_bwd_a(const void* uhat, const float* vs, const float* dvs,
                 const float* stats, const float* carry, float* cfac,
                 float* dsfac, float* dc, float* rowsum, int batch,
                 int seq_len, int t, int in_n, int out_n, int out_d, int pad,
                 int bf16, void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || t < 0 ||
      t >= seq_len) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_tp<BwdAStep>(
      bf16, batch, kBlockThreads, smem_floats(in_n, out_n, out_d) * 4,
      (cudaStream_t)stream, uhat, vs, dvs, stats, carry, cfac, dsfac, dc,
      rowsum, batch, seq_len, t, in_n, out_n, out_d, pad);
}

// Step t of K2-tp after the exchange (rowsum summed over the ranks): writes
// dafac [batch, seq_len, in_n, out_n] at step t and the carry.
int sdr_tp_bwd_b(const void* uhat, const float* cfac, const float* dc,
                 const float* rowsum, float* dafac, float* carry, int batch,
                 int seq_len, int t, int in_n, int out_n, int out_d, int bf16,
                 void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || t < 0 ||
      t >= seq_len) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_tp<BwdBStep>(
      bf16, batch, kBlockThreads, smem_floats(in_n, out_n, out_d) * 4,
      (cudaStream_t)stream, uhat, cfac, dc, rowsum, dafac, carry, batch,
      seq_len, t, in_n, out_n, out_d);
}


// ---- the persistent kernels' C interface ----

// Bytes of dynamic shared memory a persistent kernel takes for this
// geometry (out_n: the shard's out capsules; backward nonzero: K2-tp's;
// bf16 nonzero: its bf16 instance's, a ring of bf16 rows), or -1 if it
// does not fit.
int sdr_tp_persistent_smem_bytes(int in_n, int out_n, int out_d,
                                 int backward, int bf16) {
  sdr::StreamPlan p;
  return plan_persistent(in_n, out_n, out_d, backward, bf16 ? 2 : 4, &p)
             ? (int)persistent_smem_bytes(p, in_n, backward)
             : -1;
}

// The blocks of that kernel the current device holds at once (a
// cooperative launch may take no more), or -1.
int sdr_tp_persistent_capacity(int in_n, int out_n, int out_d,
                               int backward, int bf16) {
  sdr::StreamPlan p;
  if (!plan_persistent(in_n, out_n, out_d, backward, bf16 ? 2 : 4, &p)) {
    return -1;
  }
  return bf16 ? persistent_capacity<true>(p, in_n, backward)
              : persistent_capacity<false>(p, in_n, backward);
}

// K1-tp's persistent kernel, one cooperative launch of batch x local_ranks
// blocks, for ranks rank0 .. rank0 + local_ranks - 1 of a set of `ranks`:
// per launched rank l (arrays of local_ranks pointers) uhat[l] [batch,
// seq_len, in_n, pitch] (16-byte aligned; bf16 entries where `bf16`) ->
// out[l] [batch, seq_len, out_n, out_d] and stats[l] [seq_len, num_iter,
// batch, in_n, 2], the carry before step 0 v_init[l] [batch, out_n *
// out_d] (v_init itself, or any v_init[l], may be null: zeros); step_valid
// [batch, seq_len] (nonzero: valid) or null; per rank of the set (arrays
// of `ranks`) its xbuf [2, ranks, cap, 2] float32 and flags [ranks, cap]
// uint64; status [8] uint64 of this process (zero, and left zero unless a
// wait timed out); pad_rank the rank whose shard holds the PAD capsule, or
// -1; epoch0 the set's exchanges before this call. float32 but u_hat, on
// the current device; launches on `stream` and returns the launch error
// (cudaErrorCooperativeLaunchTooLarge where the blocks cannot all be
// resident: sdr_tp_persistent_capacity says how many can).
int sdr_tp_fwd_persistent(void* const* uhat, void* const* out,
                          void* const* stats, void* const* v_init,
                          const unsigned char* step_valid, void* const* xbuf,
                          void* const* flags, void* status, int ranks,
                          int rank0, int local_ranks, int pad_rank, int cap,
                          long long epoch0, long long timeout_ns, int batch,
                          int seq_len, int in_n, int out_n, int out_d,
                          int num_iter, int bf16, void* stream) {
  sdr::StreamPlan p;
  Exch x;
  FwdArgs a;
  if (batch < 1 || seq_len < 1 || num_iter < 1 ||
      !plan_persistent(in_n, out_n, out_d, false, bf16 ? 2 : 4, &p) ||
      !make_exch(xbuf, flags, status, ranks, rank0, local_ranks, pad_rank,
                 cap, epoch0, timeout_ns, batch, in_n, &x)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < local_ranks; ++l) {
    if ((uintptr_t)uhat[l] % 16 != 0 || !out[l] || !stats[l]) {
      return (int)cudaErrorInvalidValue;
    }
    a.uhat[l] = uhat[l];
    a.out[l] = static_cast<float*>(out[l]);
    a.stats[l] = static_cast<float*>(stats[l]);
    a.v_init[l] = v_init ? static_cast<const float*>(v_init[l]) : nullptr;
  }
  const size_t smem = persistent_smem_bytes(p, in_n, false);
  if (bf16) {
    const auto kernel = SDR_TP_PICK(sdr_tp_fwd_persistent_kernel, true, p.g);
    return SDR_TP_COOP_LAUNCH(kernel, batch, local_ranks, sdr::kThreads,
                              smem, (cudaStream_t)stream, a, x, step_valid,
                              batch, seq_len, in_n, p.g, p.r, num_iter);
  }
  const auto kernel = SDR_TP_PICK(sdr_tp_fwd_persistent_kernel, false, p.g);
  return SDR_TP_COOP_LAUNCH(kernel, batch, local_ranks, sdr::kThreads, smem,
                            (cudaStream_t)stream, a, x, step_valid, batch,
                            seq_len, in_n, p.g, p.r, num_iter);
}

// K2-tp's persistent kernel, launched as K1-tp's: per launched rank uhat,
// vs and dvs [batch, seq_len, out_n, out_d], stats (the forward's, one
// iteration) [seq_len, 1, batch, in_n, 2] -> cfac, dafac [batch, seq_len,
// in_n, out_n] and dsfac [batch, seq_len, out_n * out_d]; the rank set as
// for K1-tp.
int sdr_tp_bwd_persistent(void* const* uhat, void* const* vs,
                          void* const* dvs, void* const* stats,
                          void* const* cfac, void* const* dafac,
                          void* const* dsfac, void* const* xbuf,
                          void* const* flags, void* status, int ranks,
                          int rank0, int local_ranks, int pad_rank, int cap,
                          long long epoch0, long long timeout_ns, int batch,
                          int seq_len, int in_n, int out_n, int out_d,
                          int bf16, void* stream) {
  sdr::StreamPlan p;
  Exch x;
  BwdArgs a;
  if (batch < 1 || seq_len < 1 ||
      !plan_persistent(in_n, out_n, out_d, true, bf16 ? 2 : 4, &p) ||
      !make_exch(xbuf, flags, status, ranks, rank0, local_ranks, pad_rank,
                 cap, epoch0, timeout_ns, batch, in_n, &x)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < local_ranks; ++l) {
    if ((uintptr_t)uhat[l] % 16 != 0 || !vs[l] || !dvs[l] || !stats[l] ||
        !cfac[l] || !dafac[l] || !dsfac[l]) {
      return (int)cudaErrorInvalidValue;
    }
    a.uhat[l] = uhat[l];
    a.vs[l] = static_cast<const float*>(vs[l]);
    a.dvs[l] = static_cast<const float*>(dvs[l]);
    a.stats[l] = static_cast<const float*>(stats[l]);
    a.cfac[l] = static_cast<float*>(cfac[l]);
    a.dafac[l] = static_cast<float*>(dafac[l]);
    a.dsfac[l] = static_cast<float*>(dsfac[l]);
  }
  const size_t smem = persistent_smem_bytes(p, in_n, true);
  if (bf16) {
    const auto kernel = SDR_TP_PICK(sdr_tp_bwd_persistent_kernel, true, p.g);
    return SDR_TP_COOP_LAUNCH(kernel, batch, local_ranks, sdr::kThreads,
                              smem, (cudaStream_t)stream, a, x, batch,
                              seq_len, in_n, p.g, p.r);
  }
  const auto kernel = SDR_TP_PICK(sdr_tp_bwd_persistent_kernel, false, p.g);
  return SDR_TP_COOP_LAUNCH(kernel, batch, local_ranks, sdr::kThreads, smem,
                            (cudaStream_t)stream, a, x, batch, seq_len, in_n,
                            p.g, p.r);
}

#ifndef SDR_TP_HOST
// Transport 2's buffers, outside torch's caching allocator: `bytes` of
// device memory on the current device, zeroed, and its IPC handle
// (cudaIpcMemHandle_t, 64 bytes) into `handle`.
int sdr_tp_ipc_alloc(long long bytes, void** ptr, void* handle) {
  int err = (int)cudaMalloc(ptr, (size_t)bytes);
  if (err) return err;
  err = (int)cudaMemset(*ptr, 0, (size_t)bytes);
  if (!err) {
    err = (int)cudaIpcGetMemHandle(
        static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  if (err) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return err;
}

// A peer's buffer from its handle, mapped with lazy peer access.
int sdr_tp_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int sdr_tp_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int sdr_tp_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// `bytes` from src to dst (device or host memory), synchronously.
int sdr_tp_copy(void* dst, const void* src, long long bytes) {
  return (int)cudaMemcpy(dst, src, (size_t)bytes, cudaMemcpyDefault);
}
#endif

const char* sdr_tp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
