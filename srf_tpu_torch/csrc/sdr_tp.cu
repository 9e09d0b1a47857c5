// The split-softmax SDR on a shard of the out capsules, for Hopper, sm_90a:
// K1-tp (the forward) and K2-tp (its backward, one routing iteration).
//
// No Pallas kernel is replaced: on a ("data", "model") mesh, JAX shards the
// class-capsule layer's W and b on the out capsules
// (srf_tpu/parallel/sharding_rules.py:srf_rules) and XLA partitions the
// loop body of its SDR scan (srf_tpu/ops/routing.py:_sdr_step_factored),
// putting the softmax's row max and row sum, all-reduced over "model",
// inside every step and iteration. K1 and K2 (sdr_fwd.cu, sdr_bwd.cu) walk a
// whole utterance's time in one launch and cannot make that exchange, so a
// shard routes step by step, with the exchange between launches. The plain
// versions are srf_tpu_torch/ops/routing.py:sequential_routing_tp and
// sequential_routing_tp_bwd; the wrappers (ops/routing_cuda.py) drive the
// loop over time from the host:
//
// K1-tp: the prediction kernel (sdr_fwd.cu's sdr_predict) writes this
// rank's u_hat [B, T, in_n, pitch] (O = the shard's out capsules, pitch =
// O * out_d rounded up to 4); then for each step t and iteration k:
//   sdr_tp_stats_kernel   b[n,o] (+)= <u_hat[n,o,:], v[o,:]> (+ -1e9 at
//                         global capsule 0, on the rank that holds it);
//                         each row's local max m and sum l of exp(b - m)
//   (host)                one all-gather of the (m, l) pairs over "model"
//   sdr_tp_route_kernel   M = max_r m_r, L = sum_r l_r exp(m_r - M);
//                         c = exp(b - M) / L; s[o,:] = sum_n c[n,o]
//                         u_hat[n,o,:]; v = squash(s); out[:, t] = v after
//                         the last iteration; (M, L) saved for K2-tp
// v is the carry: the agreement vector of the next iteration or step. The
// logits b accumulate over the iterations in global memory ([B, in_n, O]).
//
// K2-tp, for t from T-1 down to 0 (v_{t-1} read from the forward's output,
// the carry dv into step t starting at 0):
//   sdr_tp_bwd_a_kernel   c from the saved (M, L) and b = <u_hat,
//                         v_{t-1}> (+ PAD), no exchange; s = sum_n c
//                         u_hat; ds = squash'^T (dvs[t] + carry); dc[n,o] =
//                         <u_hat[n,o,:], ds[o,:]>; each row's local
//                         sum_o c dc
//   (host)                one SUM all-reduce of those [B, in_n] sums
//   sdr_tp_bwd_b_kernel   da = c (dc - sum); carry = sum_n da u_hat (into
//                         v_{t-1}'s gradient)
// writing du_hat's factors (c, da, ds) in K2's layout; then K2's weight-
// gradient and reduction kernels (sdr_bwd.cu's sdr_bwd_wgrad) form the
// shard's dW and db and this rank's part of du, which the wrapper sums
// over "model" once.
//
// What bounds it on this card: the host-driven loop, two launches and one
// collective per step and iteration, and their latency; each launch reads
// one step's u_hat of the shard (B * in_n * pitch floats, 1.5 MB at
// SRF-WSJ's last layer at B 8 on 2 ranks) and does a few flops per byte.
// The design keeps it simple and right: one thread per row in the stats
// kernel and in the row sums, one block per utterance where a step sums
// over rows, every sum in a fixed order (no atomics).
//
// SDR_TP_HOST builds this file as host C++ (tests/_sdr_tp_host.h: CUDA
// threads as std::threads, a block's barrier as a std::barrier), so that
// the CPU tests run these kernels against their plain versions.

#ifndef SDR_TP_HOST
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SDR_TP_SMEM(name)                  \
  extern __shared__ float4 name##_raw_[]; \
  float* name = reinterpret_cast<float*>(name##_raw_)
#define SDR_TP_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr float kPadLogit = -1e9f;   // ops/routing.py NEG_INF
constexpr float kSquashEps = 1e-7f;  // ops/squash.py epsilon
constexpr int kRowThreads = 128;     // the stats kernel: a thread a row
constexpr int kBlockThreads = 256;   // the per-utterance kernels
// the most dynamic shared memory one block may use on sm_90 (227 KB)
constexpr long long kMaxSmemBytes = 232448;

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

__host__ __device__ inline int pitch_of(int out_no) {
  return (out_no + 3) / 4 * 4;
}

// One thread per row r = b * in_n + n of step t: the logits b[r, o] of
// iteration `it` (the previous iterations' sum plus the agreement with v,
// the carry [B, out_no]; the PAD logit at o = 0 where `pad`), and the row's
// local max m and sum l of exp(b - m) into local_ml[r] = (m, l).
__global__ void __launch_bounds__(kRowThreads)
sdr_tp_stats_kernel(const float* __restrict__ uhat,
                    const float* __restrict__ vcar, float* __restrict__ bacc,
                    float* __restrict__ local_ml, int batch, int seq_len,
                    int t, int in_n, int out_n, int out_d, int it, int pad) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= batch * in_n) return;
  const int b = r / in_n;
  const int n = r % in_n;
  const int out_no = out_n * out_d;
  const float* row =
      uhat + (((size_t)b * seq_len + t) * in_n + n) * pitch_of(out_no);
  const float* v = vcar + (size_t)b * out_no;
  float* logits = bacc + (size_t)r * out_n;
  float m = -INFINITY;
  for (int o = 0; o < out_n; ++o) {
    float agree = 0.f;
    for (int i = 0; i < out_d; ++i) {
      agree = fmaf(row[o * out_d + i], v[o * out_d + i], agree);
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
// utterance b, a thread per entry oi, the rows summed in order.
__device__ __forceinline__ float row_sum(const float* coef,
                                         const float* uhat_bt, int in_n,
                                         int out_n, int out_d, int pitch,
                                         int oi) {
  const int o = oi / out_d;
  float s = 0.f;
  for (int n = 0; n < in_n; ++n) {
    s = fmaf(coef[n * out_n + o], uhat_bt[(size_t)n * pitch + oi], s);
  }
  return s;
}

// One block per utterance b: the global (M, L) of each row from the ranks'
// pairs gathered [ranks, B * in_n, 2], saved to stats [B, in_n, 2] (this
// step's and iteration's slot); c = exp(b - M) / L; s and its squash, the
// new carry v; the output of step t after the last iteration.
__global__ void __launch_bounds__(kBlockThreads)
sdr_tp_route_kernel(const float* __restrict__ uhat,
                    const float* __restrict__ gathered, int ranks,
                    const float* __restrict__ bacc, float* __restrict__ vcar,
                    float* __restrict__ out, float* __restrict__ stats,
                    int batch, int seq_len, int t, int in_n, int out_n,
                    int out_d, int last) {
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
  const int pitch = pitch_of(out_no);
  const float* uhat_bt = uhat + ((size_t)b * seq_len + t) * in_n * pitch;
  for (int oi = tid; oi < out_no; oi += nthr) {
    s_s[oi] = row_sum(c_s, uhat_bt, in_n, out_n, out_d, pitch, oi);
  }
  __syncthreads();
  for (int oi = tid; oi < out_no; oi += nthr) {
    const float* s_o = s_s + (oi / out_d) * out_d;
    float sq = 0.f;
    for (int i = 0; i < out_d; ++i) sq = fmaf(s_o[i], s_o[i], sq);
    const float v = (sq / (1.f + sq)) * (s_s[oi] / sqrtf(sq + kSquashEps));
    vcar[(size_t)b * out_no + oi] = v;
    if (last) out[((size_t)b * seq_len + t) * out_no + oi] = v;
  }
}

// K2-tp's first kernel, one block per utterance b, step t: c from the
// saved (M, L) of the forward's first iteration (stats [B, in_n, 2]) and
// the logits against v_{t-1} (vs[t - 1], or 0); s; ds = the squash's VJP of
// dv = dvs[t] + carry; dc = <u_hat, ds> per (row, out capsule) into dc_g
// [B, in_n, out_n]; each row's local sum_o c dc into rowsum [B, in_n]. c
// and ds go to K2's factor layout: cfac [B, T, in_n, out_n], dsfac [B, T,
// out_no].
__global__ void __launch_bounds__(kBlockThreads)
sdr_tp_bwd_a_kernel(const float* __restrict__ uhat,
                    const float* __restrict__ vs, const float* __restrict__ dvs,
                    const float* __restrict__ stats,
                    const float* __restrict__ carry, float* __restrict__ cfac,
                    float* __restrict__ dsfac, float* __restrict__ dc_g,
                    float* __restrict__ rowsum, int batch, int seq_len, int t,
                    int in_n, int out_n, int out_d, int pad) {
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
  const int pitch = pitch_of(out_no);
  const size_t bt = (size_t)b * seq_len + t;
  const float* uhat_bt = uhat + bt * in_n * pitch;
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
      const float* row = uhat_bt + (size_t)n * pitch + o * out_d;
      for (int i = 0; i < out_d; ++i) {
        logit = fmaf(row[i], vprev[o * out_d + i], logit);
      }
    }
    if (pad && o == 0) logit += kPadLogit;
    const float c = expf(logit - m_s[n]) / l_s[n];
    c_s[e] = c;
    cfac[bt * in_n * out_n + e] = c;
  }
  __syncthreads();
  for (int oi = tid; oi < out_no; oi += nthr) {
    s_s[oi] = row_sum(c_s, uhat_bt, in_n, out_n, out_d, pitch, oi);
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
    const float* row = uhat_bt + (size_t)n * pitch;
    float* dc_row = dc_g + ((size_t)b * in_n + n) * out_n;
    float sum = 0.f;
    for (int o = 0; o < out_n; ++o) {
      float dc = 0.f;
      for (int i = 0; i < out_d; ++i) {
        dc = fmaf(row[o * out_d + i], ds_s[o * out_d + i], dc);
      }
      dc_row[o] = dc;
      sum = fmaf(dc, c_s[n * out_n + o], sum);
    }
    rowsum[(size_t)b * in_n + n] = sum;
  }
}

// K2-tp's second kernel, one block per utterance b, step t, after the
// rows' sums were summed over the ranks: da = c (dc - sum) into dafac (K2's
// layout [B, T, in_n, out_n]); the carry into step t - 1, sum_n da u_hat.
__global__ void __launch_bounds__(kBlockThreads)
sdr_tp_bwd_b_kernel(const float* __restrict__ uhat,
                    const float* __restrict__ cfac,
                    const float* __restrict__ dc_g,
                    const float* __restrict__ rowsum,
                    float* __restrict__ dafac, float* __restrict__ carry,
                    int batch, int seq_len, int t, int in_n, int out_n,
                    int out_d) {
  SDR_TP_SMEM(smem);
  float* da_s = smem + 2 * in_n;  // [in_n, out_n], the other kernels' c_s
  const int out_no = out_n * out_d;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int pitch = pitch_of(out_no);
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
  const float* uhat_bt = uhat + bt * in_n * pitch;
  for (int oi = tid; oi < out_no; oi += nthr) {
    carry[(size_t)b * out_no + oi] =
        row_sum(da_s, uhat_bt, in_n, out_n, out_d, pitch, oi);
  }
}

int set_smem(const void* kernel, long long bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the per-utterance kernels take for this
// geometry (out_n: the shard's out capsules), or -1 if it does not fit.
int sdr_tp_smem_bytes(int in_n, int out_n, int out_d) {
  return geometry_ok(1, 1, in_n, out_n, out_d)
             ? (int)(smem_floats(in_n, out_n, out_d) * 4)
             : -1;
}

// Step t, iteration it of K1-tp: uhat [batch, seq_len, in_n, pitch], vcar
// (the carry) [batch, out_n * out_d], bacc (the logits) [batch, in_n,
// out_n], local_ml [batch, in_n, 2]; pad nonzero on the rank whose shard
// holds the PAD capsule of the last layer. float32, contiguous, on the
// current device; launches on `stream`, returns the launch error.
int sdr_tp_stats(const float* uhat, const float* vcar, float* bacc,
                 float* local_ml, int batch, int seq_len, int t, int in_n,
                 int out_n, int out_d, int it, int pad, void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || t < 0 ||
      t >= seq_len || it < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch * in_n + kRowThreads - 1) / kRowThreads;
  SDR_TP_LAUNCH(sdr_tp_stats_kernel, blocks, kRowThreads, 0,
                (cudaStream_t)stream, uhat, vcar, bacc, local_ml, batch,
                seq_len, t, in_n, out_n, out_d, it, pad);
  return (int)cudaGetLastError();
}

// Step t of K1-tp after the exchange: gathered [ranks, batch, in_n, 2] (the
// ranks' (m, l) pairs), bacc, uhat as above; writes the carry vcar, out
// [batch, seq_len, out_n, out_d] at step t where `last` (the last
// iteration), and this step's and iteration's global (M, L) to stats
// [batch, in_n, 2].
int sdr_tp_route(const float* uhat, const float* gathered, int ranks,
                 const float* bacc, float* vcar, float* out, float* stats,
                 int batch, int seq_len, int t, int in_n, int out_n,
                 int out_d, int last, void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || ranks < 1 ||
      t < 0 || t >= seq_len) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = smem_floats(in_n, out_n, out_d) * 4;
  int err = set_smem((const void*)sdr_tp_route_kernel, smem);
  if (err) return err;
  SDR_TP_LAUNCH(sdr_tp_route_kernel, batch, kBlockThreads, smem,
                (cudaStream_t)stream, uhat, gathered, ranks, bacc, vcar,
                out, stats, batch, seq_len, t, in_n, out_n, out_d, last);
  return (int)cudaGetLastError();
}

// Step t of K2-tp before the exchange: uhat as above, the forward's output
// vs and its cotangent dvs [batch, seq_len, out_n, out_d], stats (the
// forward's (M, L) of step t, first iteration) [batch, in_n, 2], carry
// [batch, out_n * out_d]; writes cfac [batch, seq_len, in_n, out_n] and
// dsfac [batch, seq_len, out_n * out_d] at step t, dc [batch, in_n, out_n]
// and rowsum [batch, in_n].
int sdr_tp_bwd_a(const float* uhat, const float* vs, const float* dvs,
                 const float* stats, const float* carry, float* cfac,
                 float* dsfac, float* dc, float* rowsum, int batch,
                 int seq_len, int t, int in_n, int out_n, int out_d, int pad,
                 void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || t < 0 ||
      t >= seq_len) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = smem_floats(in_n, out_n, out_d) * 4;
  int err = set_smem((const void*)sdr_tp_bwd_a_kernel, smem);
  if (err) return err;
  SDR_TP_LAUNCH(sdr_tp_bwd_a_kernel, batch, kBlockThreads, smem,
                (cudaStream_t)stream, uhat, vs, dvs, stats, carry, cfac,
                dsfac, dc, rowsum, batch, seq_len, t, in_n, out_n, out_d,
                pad);
  return (int)cudaGetLastError();
}

// Step t of K2-tp after the exchange (rowsum summed over the ranks): writes
// dafac [batch, seq_len, in_n, out_n] at step t and the carry.
int sdr_tp_bwd_b(const float* uhat, const float* cfac, const float* dc,
                 const float* rowsum, float* dafac, float* carry, int batch,
                 int seq_len, int t, int in_n, int out_n, int out_d,
                 void* stream) {
  if (!geometry_ok(batch, seq_len, in_n, out_n, out_d) || t < 0 ||
      t >= seq_len) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = smem_floats(in_n, out_n, out_d) * 4;
  int err = set_smem((const void*)sdr_tp_bwd_b_kernel, smem);
  if (err) return err;
  SDR_TP_LAUNCH(sdr_tp_bwd_b_kernel, batch, kBlockThreads, smem,
                (cudaStream_t)stream, uhat, cfac, dc, rowsum, dafac, carry,
                batch, seq_len, t, in_n, out_n, out_d);
  return (int)cudaGetLastError();
}

const char* sdr_tp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
