// SDR forward (sequence-wise dynamic routing) for Hopper, sm_90a: K1.
//
// Replaces the TPU kernel srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel
// (reached through _pallas_sdr and sequential_routing_pallas). Same function
// as the plain version srf_tpu_torch/ops/routing.py:sequential_routing:
//
//   for t in 0..T-1, for every utterance b (v_{-1} = v_init[b], or 0):
//     u_hat[n,o,i] = bias[n,o,i] + sum_j W[n,o,i,j] * u[b,t,n,j]
//     logits = 0
//     num_iter times:
//       logits[n,o] += sum_i u_hat[n,o,i] * v[o,i]   (+ -1e9 at o == 0 on
//                                                     the last layer)
//       c[n,:] = softmax(logits[n,:])                over the out capsules
//       s[o,i] = sum_n c[n,o] * u_hat[n,o,i]
//       v[o,:] = squash(s[o,:])
//     if step_valid and !step_valid[b,t]: v = 0   (the output and the carry)
//     out[b,t] = v
//
// The initial carry and the step mask serve streaming: a chunk of frames
// continues the previous chunk's recurrence, and warm-up steps before the
// utterance's first frame emit zeros and leave a zero carry
// (ops/routing.py:sequential_routing_from_uhat).
//
// Two launches. The prediction kernel (sdr_stream.cuh) writes u_hat for
// every (b, t, n) over all SMs: it does not depend on v. The recurrence
// kernel runs one block per utterance (rows are independent chains) and
// walks t: a producer warp streams u_hat_t through a shared-memory ring of
// in-capsule row chunks with bulk copies, running ahead into the coming
// steps, and kWarps compute warps take the rows of each chunk (logits,
// softmax and the rows' share of s in registers, see sdr_stream.cuh), then
// sum the per-warp partials of s and squash them. Iteration k's logits are
// the agreement with the sum of v_{t-1} and the v's of the iterations so
// far (the logits are linear in v), so no logits are kept between
// iterations; with num_iter > 1 each iteration streams u_hat_t again.
//
// What bounds it on this card: the serial dependence over time. A step is a
// chain (the rows' dot products and softmaxes, then the sum over rows and
// the squash) behind two compute-warp barriers; u_hat's bytes (written and
// read once) stream underneath it.
//
// The bf16 variant (sdr_fwd_bf16; template argument BF) computes JAX's SDR
// under --tpu-routing-bf16 (srf_tpu/ops/routing.py:sequential_routing with
// compute_dtype bfloat16, its materialized scan body), the plain version
// ops/routing.py:sequential_routing(..., bf16=True): u_hat = bf16(bf16(W u)
// + b) from bf16 W, u and b, stored and streamed in bf16, so the ring moves
// half the bytes;
// each agreement is taken against bf16(v), each sum over rows with bf16(c)
// (sdr_stream.cuh), and v, the logits, the softmax and the squash stay
// float32. The agreement vector holds the sum of the rounded v's.

#include "sdr_stream.cuh"

namespace {

using sdr::kWarps;
using sdr::RowGeom;
using sdr::Ring;
using sdr::StreamPlan;

// warp_g: the per-warp scratch of every block in global memory
// ([batch, warp_floats]) where the plan puts it there (general path only),
// else null; v_init [batch, out_no] and step_valid [batch, seq_len], or null
template <bool BF, int D, int NO>
__global__ void __launch_bounds__(sdr::kThreads, 1)
sdr_fwd_kernel(const sdr::uhat_t<BF>* __restrict__ uhat,
               float* __restrict__ out,
               float* __restrict__ warp_g,
               const float* __restrict__ v_init,
               const unsigned char* __restrict__ step_valid, int seq_len,
               int in_n, RowGeom g, Ring r, int num_iter, int mask_pad) {
  extern __shared__ float4 smem4[];
  using E = sdr::uhat_t<BF>;
  E* ring = reinterpret_cast<E*>(smem4);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + (size_t)r.stages * r.chunk * g.pitch);
  uint64_t* empty = full + r.stages;
  float* rest = reinterpret_cast<float*>(empty + r.stages);
  // the per-warp scratch (partial sums, logits) first, unless it is in
  // global memory
  const bool global = D == 0 && warp_g;
  float* part = global ? warp_g + blockIdx.x * sdr::warp_floats(g)
                       : rest;                              // [kWarps, out_no]
  float* vagg = global ? rest : part + kWarps * g.out_no;     // [pitch]
  float* s_s = vagg + g.pitch;                                // [pitch]
  float* lg_all = global ? part + kWarps * g.out_no
                         : s_s + g.pitch;                     // [kWarps, out_n]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const E* uhat_b = uhat + (size_t)blockIdx.x * seq_len * in_n * g.pitch;
  float* out_b = out + (size_t)blockIdx.x * seq_len * g.out_no;

  if (tid == 0) {
    for (int s = 0; s < r.stages; ++s) {
      sdr::mbar_init(full + s, 1);
      sdr::mbar_init(empty + s, kWarps);
    }
    sdr::mbar_fence_init();
  }
  // v_{-1}
  const float* vinit_b =
      v_init ? v_init + (size_t)blockIdx.x * g.out_no : nullptr;
  for (int k = tid; k < g.out_no; k += blockDim.x) {
    vagg[k] = vinit_b ? sdr::keep<BF>(vinit_b[k]) : 0.f;
  }
  const unsigned char* valid_b =
      step_valid ? step_valid + (size_t)blockIdx.x * seq_len : nullptr;
  __syncthreads();
  if (warp == kWarps) {
    sdr::produce(uhat_b, ring, full, empty, r, in_n, g.pitch, seq_len, 0, 1,
                 num_iter);
    return;
  }

  sdr::Pass<BF> pass{ring, full, empty, r, g, in_n, vagg, 0.f, nullptr,
                     nullptr, part + warp * g.out_no,
                     lg_all + warp * g.out_n};
  sdr::Cursor q{0, 0};  // the next chunk, in the producer's order
  for (int t = 0; t < seq_len; ++t) {
    // an invalid step's v is zero: its output and the next step's carry
    const bool valid = !valid_b || valid_b[t];
    for (int it = 0; it < num_iter; ++it) {
      // logits, c and the rows' shares of s
      pass.pad = mask_pad ? sdr::kPadLogit * (it + 1) : 0.f;
      sdr::warp_pass<BF, D, NO, sdr::kRoute>(pass, q, warp, lane);
      sdr::sync_compute();

      // s = the sum of the warps' partials; v = squash(s); the agreement
      // vector gains v, or becomes v_t after the last iteration
      const bool last = it == num_iter - 1;
      if (g.shift >= 0) {
        for (int base = 0; base < g.out_no; base += sdr::kComputeThreads) {
          const int oi = base + tid;
          const float s = oi < g.out_no ? sdr::sum_partials(part, g.out_no, oi)
                                        : 0.f;
          const float sq = sdr::group_sum(s * s, g.shift);
          if (oi < g.out_no) {
            const float v =
                (sq / (1.f + sq)) * (s / sqrtf(sq + sdr::kSquashEps));
            if (last) {
              const float kept = valid ? v : 0.f;
              vagg[oi] = sdr::keep<BF>(kept);
              out_b[(size_t)t * g.out_no + oi] = kept;
            } else {
              vagg[oi] += sdr::keep<BF>(v);
            }
          }
        }
      } else {
        for (int oi = tid; oi < g.out_no; oi += sdr::kComputeThreads) {
          s_s[oi] = sdr::sum_partials(part, g.out_no, oi);
        }
        sdr::sync_compute();
        for (int oi = tid; oi < g.out_no; oi += sdr::kComputeThreads) {
          const float* s_o = s_s + (oi / g.out_d) * g.out_d;
          float sq = 0.f;
          for (int i = 0; i < g.out_d; ++i) sq = fmaf(s_o[i], s_o[i], sq);
          const float v =
              (sq / (1.f + sq)) * (s_s[oi] / sqrtf(sq + sdr::kSquashEps));
          if (last) {
            const float kept = valid ? v : 0.f;
            vagg[oi] = sdr::keep<BF>(kept);
            out_b[(size_t)t * g.out_no + oi] = kept;
          } else {
            vagg[oi] += sdr::keep<BF>(v);
          }
        }
      }
      sdr::sync_compute();
    }
  }
}

// Floats of the scratch buffer sdr_fwd (sdr_fwd_bf16: BF) takes: u_hat
// [batch, seq_len, in_n, pitch] (of 2-byte entries in bf16, rounded up to
// 16 bytes), then the blocks' per-warp scratch where the plan puts it in
// global memory; -1 if the geometry does not fit.
template <bool BF>
long long scratch_floats(int batch, int seq_len, int in_n, int in_d,
                         int out_n, int out_d) {
  StreamPlan p;
  if (!sdr::plan_fwd(in_n, in_d, out_n, out_d, &p, BF ? 2 : 4)) return -1;
  const long long uhat_bytes =
      (long long)batch * seq_len * in_n * p.g.pitch * p.g.esize;
  return (uhat_bytes + 15) / 16 * 4 +
         (p.warp_global ? (long long)batch * sdr::warp_floats(p.g) : 0);
}

template <bool BF>
int launch(const sdr::uhat_t<BF>* u, const sdr::uhat_t<BF>* w,
           const sdr::uhat_t<BF>* bias, const float* v_init,
           const unsigned char* step_valid,
           float* scratch, float* out, int batch, int seq_len, int in_n,
           int in_d, int out_n, int out_d, int num_iter, int mask_pad,
           void* stream) {
  StreamPlan p;
  if (batch < 1 || seq_len < 1 || num_iter < 1 ||
      !sdr::plan_fwd(in_n, in_d, out_n, out_d, &p, BF ? 2 : 4) ||
      (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const RowGeom& g = p.g;
  auto* uhat = reinterpret_cast<sdr::uhat_t<BF>*>(scratch);
  const long long uhat_floats =
      ((long long)batch * seq_len * in_n * g.pitch * g.esize + 15) / 16 * 4;
  float* warp_g = p.warp_global ? scratch + uhat_floats : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = sdr::launch_predict(u, w, bias, uhat, batch * seq_len,
                                        in_n, in_d, g.out_no, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sdr::fwd_smem_bytes(p);
  const auto kernel = SDR_PICK(sdr_fwd_kernel, BF, p);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, sdr::kThreads, smem, s>>>(
      uhat, out, warp_g, v_init, step_valid, seq_len, in_n, g, p.r,
      num_iter, mask_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the recurrence kernel needs for this
// geometry, or -1 if the geometry does not fit.
int sdr_fwd_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  return sdr::fwd_smem_bytes(in_n, in_d, out_n, out_d);
}

// Floats of the scratch buffer sdr_fwd takes: u_hat [batch, seq_len, in_n,
// pitch], then the blocks' per-warp scratch where the plan puts it in
// global memory; -1 if the geometry does not fit.
long long sdr_fwd_scratch_floats(int batch, int seq_len, int in_n, int in_d,
                                 int out_n, int out_d) {
  return scratch_floats<false>(batch, seq_len, in_n, in_d, out_n, out_d);
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d] -> out [batch, seq_len, out_n, out_d]; v_init
// [batch, out_n, out_d] (the carry before step 0) and step_valid [batch,
// seq_len] (nonzero: a valid step) may each be null (a zero carry, every
// step valid); scratch
// holds sdr_fwd_scratch_floats floats, 16-byte aligned. float32,
// contiguous, on the current device. Launches the prediction kernel and the
// recurrence kernel on `stream` and returns the first launch's error
// (0 on success); does not synchronise.
int sdr_fwd(const float* u, const float* w, const float* bias,
            const float* v_init, const unsigned char* step_valid,
            float* scratch, float* out, int batch, int seq_len, int in_n,
            int in_d, int out_n, int out_d, int num_iter, int mask_pad,
            void* stream) {
  return launch<false>(u, w, bias, v_init, step_valid, scratch, out, batch,
                       seq_len, in_n, in_d, out_n, out_d, num_iter, mask_pad,
                       stream);
}

// The bf16 variant: the same arguments, with u, w and bias bf16, v_init
// (float32) rounded to bf16 where the agreement takes it, and scratch of
// sdr_fwd_bf16_scratch_floats floats; out is float32.
int sdr_fwd_bf16_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  return sdr::fwd_smem_bytes(in_n, in_d, out_n, out_d, 2);
}

long long sdr_fwd_bf16_scratch_floats(int batch, int seq_len, int in_n,
                                      int in_d, int out_n, int out_d) {
  return scratch_floats<true>(batch, seq_len, in_n, in_d, out_n, out_d);
}

int sdr_fwd_bf16(const void* u, const void* w, const void* bias,
                 const float* v_init, const unsigned char* step_valid,
                 float* scratch, float* out, int batch, int seq_len,
                 int in_n, int in_d, int out_n, int out_d, int num_iter,
                 int mask_pad, void* stream) {
  using B = const __nv_bfloat16*;
  return launch<true>(static_cast<B>(u), static_cast<B>(w),
                      static_cast<B>(bias), v_init, step_valid, scratch, out,
                      batch, seq_len, in_n, in_d, out_n, out_d, num_iter,
                      mask_pad, stream);
}

// The prediction kernel alone (K1-tp's first launch, sdr_tp.cu): u
// [rows_total, in_n, in_d], w [in_n, out_no, in_d], bias [in_n, out_no] ->
// uhat [rows_total, in_n, pitch] (pitch: out_no rounded up to 4, the
// padding written as 0; 16-byte aligned). float32, contiguous, on the
// current device; launches on `stream` and returns its error.
int sdr_predict(const float* u, const float* w, const float* bias,
                float* uhat, int rows_total, int in_n, int in_d, int out_no,
                void* stream) {
  if ((uintptr_t)uhat % 16 != 0) return (int)cudaErrorInvalidValue;
  return (int)sdr::launch_predict(u, w, bias, uhat, rows_total, in_n, in_d,
                                  out_no, (cudaStream_t)stream);
}

// The bf16 prediction kernel alone (K1-tp-bf16's first launch): u, w and
// bias bf16 as above -> uhat bf16 [rows_total, in_n, pitch] (pitch: out_no
// rounded up to 8, 16 bytes), bf16(bf16(W u) + b) as sdr_fwd_bf16's. It
// takes in_d in one tile of in entries (in_d <= 20, every recipe's
// geometry); another in_d gives cudaErrorInvalidValue.
int sdr_predict_bf16(const void* u, const void* w, const void* bias,
                     void* uhat, int rows_total, int in_n, int in_d,
                     int out_no, void* stream) {
  if ((uintptr_t)uhat % 16 != 0) return (int)cudaErrorInvalidValue;
  using B = const __nv_bfloat16*;
  return (int)sdr::launch_predict(
      static_cast<B>(u), static_cast<B>(w), static_cast<B>(bias),
      static_cast<__nv_bfloat16*>(uhat), rows_total, in_n, in_d, out_no,
      (cudaStream_t)stream);
}

// 1 if the prediction kernel takes its tiled path for in_d (in one tile of
// in entries, W's rows whole in registers: plan_predict), 0 if its general
// path.
int sdr_predict_tiled(int in_d) { return sdr::predict_tiled(in_d) ? 1 : 0; }

const char* sdr_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
