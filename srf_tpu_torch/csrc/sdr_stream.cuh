// Shared by the SDR forward (sdr_fwd.cu, K1) and backward (sdr_bwd.cu, K2)
// for Hopper, sm_90a: the prediction kernel, the primitives of the
// recurrence kernels' shared-memory ring, and a warp's pass over the rows of
// one step.
//
// The prediction kernel hoists u_hat out of the time loop:
//
//   u_hat[b, t, n, o*out_d + i] = bias[n,o,i] + sum_j W[n,o,i,j] u[b,t,n,j]
//
// for every (b, t, n) in one launch over all SMs, written in the layout the
// recurrence streams, [B, T, in_n, pitch], each in-capsule row padded with
// zeros to `pitch` = out_n*out_d rounded up to a multiple of 4 floats (a
// bulk copy moves 16-byte multiples from 16-byte-aligned addresses). u_hat
// does not depend on v, so nothing of it belongs on the serial chain over
// time; the TPU kernels built it inside their time step
// (srf_tpu/ops/routing_pallas.py:96-98, 188-190). It is bound by the bytes
// of u_hat it writes (in_d FMAs an entry against 4 bytes: 5 FMAs a byte at
// in_d 20, under the card's ~10 float32 FMAs a byte of HBM). A block keeps
// the rows of W of a few neighbouring in-capsules in registers, a thread 4
// out entries by all of in_d, walks a run of B*T row tiles with their u
// rows staged ahead in shared memory, and writes each row's out entries
// with 16-byte stores. Where in_d is more than the registers hold (no
// recipe's geometry), the block sums over tiles of its in entries through
// u_hat itself (plan_predict in sdr_plan.cuh).
//
// The recurrence kernels run one block per utterance: kWarps compute warps
// walk time, and one producer warp streams u_hat_t into a ring of chunks of
// in-capsule rows with cp.async.bulk (TMA's 1-D bulk copy), each chunk's
// completion reported to a "full" mbarrier and its release by the compute
// warps to an "empty" one. The producer runs ahead over the chunks of the
// coming steps while the compute warps walk the v-dependent chain, so the
// next step's rows are in flight during this step's reductions. Compute
// warps meet at a named barrier that leaves the producer out.
//
// Where out_d is 8 (out_n <= 64) or 20 (out_n <= 32), the recipes'
// capsule dims (warp_pass_lanes), lane k owns out capsules o = k, k + 32:
// it reads their out_d entries as float4s, so the agreement dot products,
// the row's share of s (or of the carry) and the vector it is taken
// against stay in registers, and the softmax over out capsules is a warp
// sum (and, only if a logit is large, a warp max first). A warp takes 1-4
// rows of each chunk together (lane_rows), independent chains to
// interleave. Other geometries (warp_pass_rows) take one row per warp at a
// time, a lane per out capsule. Either way the sum over rows goes to one
// partial per warp, summed in warp order (no atomics); the partials live
// in shared memory, or in global memory where they do not fit (plan_stream
// in sdr_plan.cuh).
//
// The bf16 variants (template argument BF true) follow the rounding points
// of JAX's bf16 SDR scan (srf_tpu/ops/routing.py:_sdr_step with a bf16
// u_hat_t, the materialized body of sequential_routing): the prediction
// kernel reads bf16 W, u and b and writes u_hat = bf16(bf16(W u) + b), and
// the ring streams bf16 rows (half the bytes). A pass widens each
// entry to float32 and takes its products there; it rounds the routing
// coefficient c to bf16 before the weighted sum s (a VJP pass rounds dc,
// the cotangent of that rounded c), and the caller keeps the vector the
// agreement is taken against rounded to bf16. Logits, softmax, squash, the
// sums and the carried v stay float32.
//
// The split-softmax modes of the warp passes (kSplitStats .. kSplitVjp)
// serve the persistent K1-tp and K2-tp kernels (sdr_tp.cu), which route a
// shard of the out capsules: a row's softmax spans every rank's shard, so a
// pass either forms the row's local statistics for the exchange, or takes
// the exchanged ones. They keep a row's logits (or dc) in shared memory
// across the exchange. K1 and K2 take kRoute and kVjp. Their bf16
// instances (K1-tp-bf16, K2-tp-bf16) round where kRoute and kVjp do: c to
// bf16 before the sum over rows (kSplitRoute, kSplitC; c_all and fac keep
// it unrounded) and dc to bf16 (kSplitDc, before its row sum and the VJP);
// the logits and the exchanged statistics stay float32.
//
// SDR_HOST_SHIM marks a host build of the device code (a CPU rehearsal of
// the math with threads standing in for lanes: tests/_sdr_tp_host.h); it
// supplies its own versions of the primitives guarded below, and builds
// no prediction kernel.

#pragma once

#ifndef SDR_HOST_SHIM
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sdr_plan.cuh"

namespace sdr {

constexpr float kPadLogit = -1e9f;   // routing.py NEG_INF
constexpr float kSquashEps = 1e-7f;  // squash.py epsilon

// A u_hat entry: float32, or bf16 in the bf16 variants.
template <bool BF>
using uhat_t = std::conditional_t<BF, __nv_bfloat16, float>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to bf16 (to nearest even) and widened back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as the bf16 variants keep it (rounded) or as float32 keeps it.
template <bool BF>
__device__ __forceinline__ float keep(float x) {
  return BF ? round_bf16(x) : x;
}

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

#ifndef SDR_HOST_SHIM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "SDR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra SDR_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` that also expects `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completion counted on `bar`; no arrival.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread: a bulk copy and the one arrival its slot's phase expects.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// The compute warps' barrier (named barrier 1); the producer is not in it.
__device__ __forceinline__ void sync_compute() {
  asm volatile("bar.sync 1, %0;" ::"n"(kComputeThreads) : "memory");
}

// An asynchronous 4-byte copy from global to shared memory (cp.async), and
// the wait for all of this thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The same, 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// An asynchronous 4-byte copy that writes +0 instead where `valid` is
// false (reading nothing), the end of this thread's group of copies, and
// the wait until at most N of its groups are still in flight.
__device__ __forceinline__ void copy_async_zfill(float* dst, const float* src,
                                                 bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

#endif  // SDR_HOST_SHIM

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// sum over aligned groups of 2^shift lanes; every lane gets its group's sum
__device__ __forceinline__ float group_sum(float x, int shift) {
  for (int off = (1 << shift) >> 1; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// sum_w part[w][oi], in warp order
__device__ __forceinline__ float sum_partials(const float* part, int out_no,
                                              int oi) {
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += part[w * out_no + oi];
  return s;
}

// Where a consumer stands in the ring: the slot of its next chunk and the
// parity of that slot's current fill.
struct Cursor {
  int slot;
  uint32_t phase;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The producer warp's loop: `passes` passes over u_hat_t for each step, in
// the order t = first + k * dir, each pass a sequence of chunks through the
// ring. Lane 0 issues every copy.
template <typename E>
__device__ __forceinline__ void produce(const E* uhat_b, E* ring,
                                        uint64_t* full, uint64_t* empty,
                                        const Ring& r, int in_n, int pitch,
                                        int steps, int first, int dir,
                                        int passes) {
  if (threadIdx.x % 32 != 0) return;
  Cursor at{0, 1};  // the slots start empty: their "empty" phase -1 is done
  for (int k = 0; k < steps; ++k) {
    const E* uhat_t = uhat_b + (size_t)(first + k * dir) * in_n * pitch;
    for (int p = 0; p < passes; ++p) {
      for (int c = 0; c < r.chunks_per_pass; ++c, at.next(r.stages)) {
        mbar_wait(empty + at.slot, at.phase);
        const int n0 = c * r.chunk;
        const int rows = min(r.chunk, in_n - n0);
        bulk_load(ring + (size_t)at.slot * r.chunk * pitch,
                  uhat_t + (size_t)n0 * pitch,
                  (uint32_t)(rows * pitch * sizeof(E)), full + at.slot);
      }
    }
  }
}

// What a warp's pass does with a step's rows, its MODE. K1 and K2:
//   kRoute       c = softmax(<u_hat[n,o,:], vec[o,:]> + pad at o == 0)
//   kVjp         da = c * (dc - sum_o dc c), dc = <u_hat[n,o,:], vec[o,:]>,
//                with c read from c_all
// and on a shard of the out capsules, the softmax split over the ranks
// (sdr_tp.cu):
//   kSplitStats  the logits b = (lg_all, where `accumulate`: the earlier
//                iterations') + <u_hat, vec> + pad at o == 0, kept in lg_all,
//                and the row's local max m and sum l of exp(b - m) in
//                row_out[n] = (m, l)
//   kSplitRoute  c = exp(lg_all - M) / L, (M, L) = row_ml[n]
//   kSplitC      c = exp(<u_hat, vec> + pad at o == 0 - M) / L, into c_all
//   kSplitDc     dc = <u_hat, vec>, kept in lg_all, and the row's local
//                sum_o c dc (c from c_all) in row_out[n].x
//   kSplitVjp    da = c * (dc - S), c from c_all, dc from lg_all and S =
//                row_ml[n].x (the sum over every rank)
// The pass writes each row's coefficients (c or da) to fac[n * out_n + o]
// (if fac is not null) and, in kRoute, to c_all (if not null), and leaves
// the sum over its rows of coef[n,o] * u_hat[n,o,i] in part_w (but for
// kSplitStats and kSplitDc, which sum nothing over rows). BF: the bf16
// variants' pass (a bf16 ring, c rounded before the sum, dc rounded before
// the VJP; in the split modes too).
enum PassMode : int {
  kRoute, kVjp, kSplitStats, kSplitRoute, kSplitC, kSplitDc, kSplitVjp
};

// Does a mode take the agreement <u_hat, vec>; does it sum over rows?
SDR_HOST_DEVICE constexpr bool takes_dot(int mode) {
  return mode != kSplitRoute && mode != kSplitVjp;
}
SDR_HOST_DEVICE constexpr bool sums_rows(int mode) {
  return mode != kSplitStats && mode != kSplitDc;
}

template <bool BF>
struct Pass {
  const uhat_t<BF>* ring;
  uint64_t* full;
  uint64_t* empty;
  Ring r;
  RowGeom g;
  int in_n;
  const float* vec;  // [out_no], shared memory
  float pad;
  float* c_all;      // [in_n, out_n], shared memory, or null
  float* fac;        // [in_n, out_n], global memory, or null
  float* part_w;     // [out_no], shared memory
  float* lg;         // [out_n] scratch of the warp (warp_pass_rows)
  // the split modes' rows, shared memory
  float* lg_all = nullptr;        // [in_n, out_n]: the logits, or dc
  const float* row_ml = nullptr;  // [in_n, 2]: (M, L), or (S, -)
  float* row_out = nullptr;       // [in_n, 2]: (m, l), or (sum_o c dc, -)
  bool accumulate = false;        // kSplitStats: add lg_all's logits
};

// A split mode's coefficient of row n, out capsule o, from `dot` (the
// agreement, where the mode takes it): kSplitRoute's or kSplitC's c (also
// kept in c_all by kSplitC) or kSplitVjp's da.
template <int MODE, bool BF>
__device__ __forceinline__ float split_coef(const Pass<BF>& p, int n, int o,
                                            float dot) {
  const int e = n * p.g.out_n + o;
  if constexpr (MODE == kSplitVjp) {
    return p.c_all[e] * (p.lg_all[e] - p.row_ml[2 * n]);
  } else {
    float logit = dot;
    if constexpr (MODE == kSplitRoute) {
      logit = p.lg_all[e];
    } else if (o == 0) {
      logit += p.pad;
    }
    const float c = expf(logit - p.row_ml[2 * n]) / p.row_ml[2 * n + 1];
    if constexpr (MODE == kSplitC) p.c_all[e] = c;
    return c;
  }
}

template <int D>
__device__ __forceinline__ void load_cap(const float* p, float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

// The bf16 ring's capsule: 4 entries (8 bytes) a load, widened. A capsule
// starts at a multiple of out_d entries in a row of 16-byte pitch, so at
// 8 bytes for out_d 8 or 20.
template <int D>
__device__ __forceinline__ void load_cap(const __nv_bfloat16* p,
                                         float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[i] = lo.x;
    x[i + 1] = lo.y;
    x[i + 2] = hi.x;
    x[i + 3] = hi.y;
  }
}

// Logits within this bound take the softmax without its max: exp cannot
// overflow or vanish, and exp(l) / sum exp(l) is the softmax.
constexpr float kSafeLogit = 64.f;

// The register path: out_d == D, out capsules o = lane + 32 k, k < NO, R
// rows of each chunk per warp (rows warp, warp + kWarps, ...).
template <bool BF, int D, int NO, int R, int MODE>
__device__ __forceinline__ void warp_pass_lanes(const Pass<BF>& p, Cursor& q,
                                                int warp, int lane) {
  const int out_n = p.g.out_n;
  float vec[NO][D], acc[NO][D];
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const int o = lane + 32 * k;
    if (takes_dot(MODE) && o < out_n) {
      load_cap<D>(p.vec + o * D, vec[k]);
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) vec[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) acc[k][i] = 0.f;
  }
  for (int c = 0; c < p.r.chunks_per_pass; ++c, q.next(p.r.stages)) {
    mbar_wait(p.full + q.slot, q.phase);
    const uhat_t<BF>* rows_s =
        p.ring + (size_t)q.slot * p.r.chunk * p.g.pitch;
    const int rows = min(p.r.chunk, p.in_n - c * p.r.chunk);
    const int n0 = c * p.r.chunk + warp;
    float x[R][NO][D], coef[R][NO];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int row = warp + rr * kWarps;
#pragma unroll
      for (int k = 0; k < NO; ++k) {
        const int o = lane + 32 * k;
        if (row < rows && o < out_n) {
          load_cap<D>(rows_s + row * p.g.pitch + o * D, x[rr][k]);
        } else {
#pragma unroll
          for (int i = 0; i < D; ++i) x[rr][k][i] = 0.f;
        }
        float dot = 0.f;
        if constexpr (takes_dot(MODE)) {
#pragma unroll
          for (int i = 0; i < D; ++i) dot = fmaf(x[rr][k][i], vec[k][i], dot);
        }
        coef[rr][k] = dot;
      }
    }
    if constexpr (MODE == kRoute) {
      // c = softmax over the out capsules of each row; a padded logit's
      // exp is 0 (exp(-1e9 - max) is, too)
      bool safe = true;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          safe = safe && fabsf(coef[rr][k]) <= kSafeLogit;
        }
      }
      float sum[R];
      if (__all_sync(0xffffffffu, safe)) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          sum[rr] = 0.f;
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            const int o = lane + 32 * k;
            const bool padded = o == 0 && p.pad != 0.f;
            coef[rr][k] = o < out_n && !padded ? expf(coef[rr][k]) : 0.f;
            sum[rr] += coef[rr][k];
          }
        }
      } else {
        float m[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          m[rr] = -INFINITY;
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            const int o = lane + 32 * k;
            if (o == 0) coef[rr][k] += p.pad;
            if (o < out_n) m[rr] = fmaxf(m[rr], coef[rr][k]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < R; ++rr) m[rr] = warp_max(m[rr]);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          sum[rr] = 0.f;
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            const int o = lane + 32 * k;
            coef[rr][k] = o < out_n ? expf(coef[rr][k] - m[rr]) : 0.f;
            sum[rr] += coef[rr][k];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) sum[rr] = warp_sum(sum[rr]);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float inv = 1.f / sum[rr];
        const int n = n0 + rr * kWarps;
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          const int o = lane + 32 * k;
          coef[rr][k] *= inv;
          if (warp + rr * kWarps < rows && o < out_n) {
            if (p.c_all) p.c_all[n * out_n + o] = coef[rr][k];
            if (p.fac) p.fac[(size_t)n * out_n + o] = coef[rr][k];
          }
          coef[rr][k] = keep<BF>(coef[rr][k]);  // the sum takes bf16(c)
        }
      }
    } else if constexpr (MODE == kVjp) {
      // da = c * (dc - sum_o dc c); bf16 rounds dc, the cotangent of the
      // rounded c
      float cin[R][NO], dot[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int n = n0 + rr * kWarps;
        dot[rr] = 0.f;
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          const int o = lane + 32 * k;
          coef[rr][k] = keep<BF>(coef[rr][k]);
          cin[rr][k] = warp + rr * kWarps < rows && o < out_n
                           ? p.c_all[n * out_n + o]
                           : 0.f;
          dot[rr] = fmaf(coef[rr][k], cin[rr][k], dot[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) dot[rr] = warp_sum(dot[rr]);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int n = n0 + rr * kWarps;
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          const int o = lane + 32 * k;
          coef[rr][k] = cin[rr][k] * (coef[rr][k] - dot[rr]);
          if (warp + rr * kWarps < rows && o < out_n && p.fac) {
            p.fac[(size_t)n * out_n + o] = coef[rr][k];
          }
        }
      }
    } else {
      // the split modes; rows past the chunk's end and lanes past out_n
      // take no part
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int n = n0 + rr * kWarps;
        const bool row_in = warp + rr * kWarps < rows;
        if constexpr (MODE == kSplitStats) {
          float m = -INFINITY;
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            const int o = lane + 32 * k;
            if (row_in && o < out_n) {
              float* at = p.lg_all + n * out_n + o;
              float logit = (p.accumulate ? *at : 0.f) + coef[rr][k];
              if (o == 0) logit += p.pad;
              *at = logit;
              coef[rr][k] = logit;
              m = fmaxf(m, logit);
            }
          }
          m = warp_max(m);
          float l = 0.f;
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            if (row_in && lane + 32 * k < out_n) l += expf(coef[rr][k] - m);
          }
          l = warp_sum(l);
          if (lane == 0 && row_in) {
            p.row_out[2 * n] = m;
            p.row_out[2 * n + 1] = l;
          }
        } else if constexpr (MODE == kSplitDc) {
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            const int e = n * out_n + lane + 32 * k;
            if (row_in && lane + 32 * k < out_n) {
              const float dc = keep<BF>(coef[rr][k]);  // bf16 rounds dc
              p.lg_all[e] = dc;
              sum = fmaf(dc, p.c_all[e], sum);
            }
          }
          sum = warp_sum(sum);
          if (lane == 0 && row_in) p.row_out[2 * n] = sum;
        } else {
#pragma unroll
          for (int k = 0; k < NO; ++k) {
            const int o = lane + 32 * k;
            float cv = 0.f;
            if (row_in && o < out_n) {
              cv = split_coef<MODE>(p, n, o, coef[rr][k]);
              if (p.fac) p.fac[(size_t)n * out_n + o] = cv;
            }
            // the sum takes bf16(c); da stays float32
            coef[rr][k] = MODE == kSplitVjp ? cv : keep<BF>(cv);
          }
        }
      }
    }
    // the rows' shares of the sum over rows; rows past the chunk's end
    // have x = 0
    if constexpr (sums_rows(MODE)) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int k = 0; k < NO; ++k) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            acc[k][i] = fmaf(coef[rr][k], x[rr][k][i], acc[k][i]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(p.empty + q.slot);
  }
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const int o = lane + 32 * k;
    if (sums_rows(MODE) && o < out_n) {
      float4* dst = reinterpret_cast<float4*>(p.part_w + o * D);
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        dst[i / 4] = make_float4(acc[k][i], acc[k][i + 1], acc[k][i + 2],
                                 acc[k][i + 3]);
      }
    }
  }
}

// dots[o] = <row[o,:], vec[o,:]> for o < out_n, by one warp.
template <typename E>
__device__ __forceinline__ void row_dots(const E* row, const float* vec,
                                         float* dots, const RowGeom& g,
                                         int lane) {
  for (int o = lane; o < g.out_n; o += 32) {
    const E* r = row + o * g.out_d;
    const float* v = vec + o * g.out_d;
    float x = 0.f;
    for (int i = 0; i < g.out_d; ++i) x = fmaf(to_f32(r[i]), v[i], x);
    dots[o] = x;
  }
  __syncwarp();
}

// The general path: a row at a time per warp, through the warp's scratch.
template <bool BF, int MODE>
__device__ __forceinline__ void warp_pass_rows(const Pass<BF>& p, Cursor& q,
                                               int warp, int lane) {
  const RowGeom& g = p.g;
  if constexpr (sums_rows(MODE)) {
    for (int e = lane; e < g.out_no; e += 32) p.part_w[e] = 0.f;
  }
  for (int c = 0; c < p.r.chunks_per_pass; ++c, q.next(p.r.stages)) {
    mbar_wait(p.full + q.slot, q.phase);
    const uhat_t<BF>* rows_s = p.ring + (size_t)q.slot * p.r.chunk * g.pitch;
    const int rows = min(p.r.chunk, p.in_n - c * p.r.chunk);
    for (int row = warp; row < rows; row += kWarps) {
      const int n = c * p.r.chunk + row;
      const uhat_t<BF>* uh = rows_s + row * g.pitch;
      if constexpr (takes_dot(MODE)) row_dots(uh, p.vec, p.lg, g, lane);
      if constexpr (MODE == kRoute) {
        // softmax over the out capsules
        float m = -INFINITY;
        for (int o = lane; o < g.out_n; o += 32) {
          m = fmaxf(m, o == 0 ? p.lg[o] + p.pad : p.lg[o]);
        }
        m = warp_max(m);
        float sum = 0.f;
        for (int o = lane; o < g.out_n; o += 32) {
          const float ex = expf((o == 0 ? p.lg[o] + p.pad : p.lg[o]) - m);
          p.lg[o] = ex;
          sum += ex;
        }
        sum = warp_sum(sum);
        for (int o = lane; o < g.out_n; o += 32) {
          const float cv = p.lg[o] / sum;
          p.lg[o] = keep<BF>(cv);  // the sum takes bf16(c)
          if (p.c_all) p.c_all[n * g.out_n + o] = cv;
          if (p.fac) p.fac[(size_t)n * g.out_n + o] = cv;
        }
      } else if constexpr (MODE == kVjp) {
        const float* cin = p.c_all + n * g.out_n;
        float dot = 0.f;
        for (int o = lane; o < g.out_n; o += 32) {
          p.lg[o] = keep<BF>(p.lg[o]);  // dc, rounded in bf16
          dot = fmaf(p.lg[o], cin[o], dot);
        }
        dot = warp_sum(dot);
        for (int o = lane; o < g.out_n; o += 32) {
          const float da = cin[o] * (p.lg[o] - dot);
          p.lg[o] = da;
          if (p.fac) p.fac[(size_t)n * g.out_n + o] = da;
        }
      } else if constexpr (MODE == kSplitStats) {
        float* lgn = p.lg_all + n * g.out_n;
        float m = -INFINITY;
        for (int o = lane; o < g.out_n; o += 32) {
          float logit = (p.accumulate ? lgn[o] : 0.f) + p.lg[o];
          if (o == 0) logit += p.pad;
          lgn[o] = logit;
          m = fmaxf(m, logit);
        }
        m = warp_max(m);
        float l = 0.f;
        for (int o = lane; o < g.out_n; o += 32) l += expf(lgn[o] - m);
        l = warp_sum(l);
        if (lane == 0) {
          p.row_out[2 * n] = m;
          p.row_out[2 * n + 1] = l;
        }
      } else if constexpr (MODE == kSplitDc) {
        float sum = 0.f;
        for (int o = lane; o < g.out_n; o += 32) {
          const int e = n * g.out_n + o;
          p.lg[o] = keep<BF>(p.lg[o]);  // dc, rounded in bf16
          p.lg_all[e] = p.lg[o];
          sum = fmaf(p.lg[o], p.c_all[e], sum);
        }
        sum = warp_sum(sum);
        if (lane == 0) p.row_out[2 * n] = sum;
      } else {
        for (int o = lane; o < g.out_n; o += 32) {
          const float cv = split_coef<MODE>(p, n, o, p.lg[o]);
          p.lg[o] = MODE == kSplitVjp ? cv : keep<BF>(cv);  // bf16(c) summed
          if (p.fac) p.fac[(size_t)n * g.out_n + o] = cv;
        }
      }
      __syncwarp();
      if constexpr (sums_rows(MODE)) {
        for (int e = lane; e < g.out_no; e += 32) {
          p.part_w[e] = fmaf(p.lg[e / g.out_d], to_f32(uh[e]), p.part_w[e]);
        }
      }
      __syncwarp();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(p.empty + q.slot);
  }
}

// One pass over a step's rows: D == 0 takes the general path.
template <bool BF, int D, int NO, int MODE>
__device__ __forceinline__ void warp_pass(const Pass<BF>& p, Cursor& q,
                                          int warp, int lane) {
  if constexpr (D == 0) {
    warp_pass_rows<BF, MODE>(p, q, warp, lane);
  } else {
    warp_pass_lanes<BF, D, NO, lane_rows(D, NO), MODE>(p, q, warp, lane);
  }
}

// The kernel template instance for a plan (StreamPlan): K<BF, D, NO> with
// out_d == D and NO out capsules per lane (lane_caps), or K<BF, 0, 0>,
// which also takes every geometry whose per-warp scratch is in global
// memory.
#define SDR_PICK(K, BF, p)                                                 \
  ((p).warp_global                                      ? K<BF, 0, 0>      \
   : ::sdr::lane_caps((p).g) == 1 && (p).g.out_d == 8   ? K<BF, 8, 1>      \
   : ::sdr::lane_caps((p).g) == 2 && (p).g.out_d == 8   ? K<BF, 8, 2>      \
   : ::sdr::lane_caps((p).g) == 1 && (p).g.out_d == 20  ? K<BF, 20, 1>     \
                                                        : K<BF, 0, 0>)

// Four u_hat entries as one store: 16 bytes of float32, 8 of bf16 (the
// address 16- or 8-byte aligned), marked as streamed (written once, read
// once later: evicted from the caches first); and four float32 entries
// read back (the general path, float32 only).
__device__ __forceinline__ void store4(float* at, const float* a) {
  __stcs(reinterpret_cast<float4*>(at), make_float4(a[0], a[1], a[2], a[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* at, const float* a) {
  uint2 v;
  v.x = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(a[0])) |
        (uint32_t)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(a[1])) << 16;
  v.y = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(a[2])) |
        (uint32_t)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(a[3])) << 16;
  __stcs(reinterpret_cast<uint2*>(at), v);
}
__device__ __forceinline__ void load4(const float* at, float* a) {
  const float4 v = *reinterpret_cast<const float4*>(at);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

#ifndef SDR_HOST_SHIM
#define SDR_PREDICT_SMEM(name) extern __shared__ float4 name[]
#endif

// A unit of the prediction's work: its out tile, group of in-capsules and
// row tile; a block walks its run of units by predict_next, with no
// division.
struct PredictUnit {
  int ot, ng, rt;
};

__device__ __forceinline__ PredictUnit predict_unit(const PredictPlan& pp,
                                                    long long k) {
  const long long og = k / pp.row_tiles;
  return PredictUnit{(int)(og / pp.n_groups), (int)(og % pp.n_groups),
                     (int)(k % pp.row_tiles)};
}

__device__ __forceinline__ void predict_next(const PredictPlan& pp,
                                             PredictUnit& c) {
  if (++c.rt == pp.row_tiles) {
    c.rt = 0;
    if (++c.ng == pp.n_groups) {
      c.ng = 0;
      ++c.ot;
    }
  }
}

// Unit c's u rows into stage `dst` of the prediction's ring
// ([tile_rows][groups][4 * JQ]; in entries past jt, and in-capsules past
// in_n, +0), a thread's share: float32 by asynchronous copies (one group a
// unit, waited for in the kernel), bf16 widened and stored here.
template <bool BF, int JQ>
__device__ __forceinline__ void predict_stage(
    const uhat_t<BF>* __restrict__ u, const PredictPlan& pp,
    const PredictUnit& c, int j0, int jt, int rows_total, int in_n, int in_d,
    int tid, int nthr, float* dst) {
  constexpr int JP = 4 * JQ;
  const int row_floats = pp.groups * JP;
  const int r0 = c.rt * pp.tile_rows;
  const int n0 = c.ng * pp.groups;
  const int count = min(pp.tile_rows, rows_total - r0) * row_floats;
  for (int e = tid; e < count; e += nthr) {
    const int r = e / row_floats, gj = e - r * row_floats;
    const int n = n0 + gj / JP, jj = gj % JP;
    const bool real = n < in_n && jj < jt;
    const uhat_t<BF>* src =
        u + ((size_t)(r0 + r) * in_n + n) * in_d + j0 + jj;
    if constexpr (BF) {
      dst[e] = real ? to_f32(*src) : 0.f;
    } else {
      copy_async_zfill(dst + e, real ? src : u, real);
    }
  }
  if constexpr (!BF) copy_async_commit();
}

// The prediction kernel (plan_predict in sdr_plan.cuh): u [rows_total,
// in_n, in_d], W [in_n, out_no, in_d], bias [in_n, out_no] -> uhat
// [rows_total, in_n, pitch], the padding entries written as 0; a 1-D grid
// of pp.blocks blocks of predict_threads(pp) threads, JQ = pp.jq.
//
// A thread keeps its out quad's W rows in registers (4 x JQ float4s' worth)
// and reads a row's u as JQ float4s from shared memory, the same address
// for every thread of its in-capsule (a broadcast): 16 FMAs a 16-byte
// shared load. (With W and u both read from shared memory for each FMA,
// the rate of shared loads, not the bytes written, bounds the kernel: 5
// loads for 4 FMAs ran at a third of the byte bound on an H100.)
// Neighbouring threads hold neighbouring out quads of neighbouring
// in-capsules, so a block writes groups * pitch contiguous u_hat entries a
// row, a warp 512 contiguous bytes (256 in bf16). A unit's u rows are
// staged two units ahead of the one computed, in a ring of kPredictStages
// stages (float32 by asynchronous copies; bf16, which widens them, by
// loads): under the stream of u_hat's writes a read waits microseconds.
// They are groups * in_d contiguous entries a row: among the writes, u's
// reads cost more than their bytes (at SRF-WSJ's width, reads of 1/30
// of u_hat's bytes took a fifth of the kernel's time on an H100). One
// barrier a unit.
//
// The arithmetic is fixed, bit for bit: each entry is the chain a =
// fmaf(W[n,o,j], u[r,n,j], a) over j = 0 .. in_d - 1 in order, from a =
// bias[n,o] (BF: from 0; then bf16(bf16(a) + bias), the bias and u and W
// widened from bf16). A padded in entry (W -0, u +0) adds fmaf(-0, +0, a)
// = a + (-0), which is a for every a, -0 included. The general path's
// later j tiles start from the entry the tile before wrote.
template <bool BF, int JQ>
__global__ void __launch_bounds__(kPredictMaxThreads, 1)
sdr_predict_kernel(const uhat_t<BF>* __restrict__ u,
                   const uhat_t<BF>* __restrict__ w,
                   const uhat_t<BF>* __restrict__ bias,
                   uhat_t<BF>* __restrict__ uhat, int rows_total, int in_n,
                   int in_d, int out_no, int pitch, PredictPlan pp) {
  constexpr int JP = 4 * JQ;
  SDR_PREDICT_SMEM(smem4);  // the ring's stages
  float* ring = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nthr = pp.o_quads * pp.groups;
  const int q = tid % pp.o_quads;
  const int g = tid / pp.o_quads;
  const int stage_floats = predict_stage_floats(pp);
  const long long first = (long long)blockIdx.x * pp.units / gridDim.x;
  const long long end = (long long)(blockIdx.x + 1) * pp.units / gridDim.x;
  const size_t row_stride = (size_t)in_n * pitch;
  float wr[4][JP], br[4];

  for (int j0 = 0; j0 < in_d; j0 += pp.j_tile) {
    const int jt = min(pp.j_tile, in_d - j0);
    PredictUnit cur = predict_unit(pp, first), ahead = cur;
    long long staged = first;  // the next unit to stage, at `ahead`
    for (int d = 0; d < kPredictStages - 1; ++d, ++staged) {
      if (staged < end) {
        predict_stage<BF, JQ>(u, pp, ahead, j0, jt, rows_total, in_n, in_d,
                              tid, nthr, ring + d * stage_floats);
        predict_next(pp, ahead);
      } else if (!BF) {
        copy_async_commit();
      }
    }
    int held_ng = -1, held_ot = -1;  // the W rows wr holds
    for (long long k = first; k < end; ++k, ++staged) {
      if constexpr (!BF) copy_async_wait_pending<kPredictStages - 2>();
      __syncthreads();  // unit k staged; unit k - 1's stage read
      if (staged < end) {
        predict_stage<BF, JQ>(
            u, pp, ahead, j0, jt, rows_total, in_n, in_d, tid, nthr,
            ring + (int)((staged - first) % kPredictStages) * stage_floats);
        predict_next(pp, ahead);
      } else if (!BF) {
        copy_async_commit();
      }
      const int n = cur.ng * pp.groups + g;    // this thread's in-capsule
      const int oq = cur.ot * pp.o_quads + q;  // and out quad
      const bool active = n < in_n && 4 * oq < pitch;
      if (cur.ng != held_ng || cur.ot != held_ot) {
        held_ng = cur.ng;
        held_ot = cur.ot;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 4 * oq + e;
          const bool real = active && o < out_no;
          const size_t wo = (size_t)n * out_no + o;
          br[e] = real ? to_f32(bias[wo]) : 0.f;
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            wr[e][j] = real && j < jt ? to_f32(w[wo * in_d + j0 + j]) : -0.f;
          }
        }
      }
      const int r0 = cur.rt * pp.tile_rows;
      const int rows = min(pp.tile_rows, rows_total - r0);
      if (active) {
        const float4* ur =
            reinterpret_cast<const float4*>(
                ring + (int)((k - first) % kPredictStages) * stage_floats) +
            g * JQ;
        uhat_t<BF>* out = uhat + ((size_t)r0 * in_n + n) * pitch + 4 * oq;
        for (int r = 0; r < rows; ++r) {
          float a[4];
          if (j0 == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = BF ? 0.f : br[e];
          } else if constexpr (!BF) {
            load4(out, a);
          }
#pragma unroll
          for (int c = 0; c < JQ; ++c) {
            const float4 x = ur[c];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[e] = fmaf(wr[e][4 * c], x.x, a[e]);
              a[e] = fmaf(wr[e][4 * c + 1], x.y, a[e]);
              a[e] = fmaf(wr[e][4 * c + 2], x.z, a[e]);
              a[e] = fmaf(wr[e][4 * c + 3], x.w, a[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (BF) a[e] = round_bf16(a[e]) + br[e];
            if (4 * oq + e >= out_no) a[e] = 0.f;
          }
          store4(out, a);
          ur += pp.groups * JQ;
          out += row_stride;
        }
      }
      predict_next(pp, cur);
    }
    __syncthreads();  // the ring's last stages read before the next tile
  }
}

// The prediction kernel's instance for a plan's jq.
template <bool BF>
inline auto predict_kernel(int jq) {
  switch (jq) {
    case 1: return sdr_predict_kernel<BF, 1>;
    case 2: return sdr_predict_kernel<BF, 2>;
    case 3: return sdr_predict_kernel<BF, 3>;
    case 4: return sdr_predict_kernel<BF, 4>;
    default: return sdr_predict_kernel<BF, kPredictMaxJq>;
  }
}

#ifndef SDR_HOST_SHIM
// Launches the prediction kernel on `stream`, reading u, W and bias and
// writing u_hat in E's type (float, or __nv_bfloat16 for the bf16
// variants; uhat 16-byte aligned), planned for the current device's
// resident blocks; returns its cudaError_t. The bf16 instance takes in_d
// in one tile (predict_tiled): another in_d gives cudaErrorInvalidValue.
template <typename E>
inline cudaError_t launch_predict(const E* u, const E* w, const E* bias,
                                  E* uhat,
                                  int rows_total, int in_n, int in_d,
                                  int out_no, cudaStream_t stream) {
  constexpr bool BF = std::is_same<E, __nv_bfloat16>::value;
  if (rows_total < 1 || in_n < 1 || in_d < 1 || out_no < 1 ||
      (BF && !predict_tiled(in_d))) {
    return cudaErrorInvalidValue;
  }
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  PredictPlan pp;
  plan_predict(rows_total, in_n, in_d, out_no, (int)sizeof(E), sms, &pp);
  const auto kernel = predict_kernel<BF>(pp.jq);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, predict_threads(pp), predict_smem_bytes(pp));
  if (err != cudaSuccess) return err;
  if (per_sm > 1) {
    plan_predict(rows_total, in_n, in_d, out_no, (int)sizeof(E),
                 sms * per_sm, &pp);
  }
  kernel<<<pp.blocks, predict_threads(pp), predict_smem_bytes(pp), stream>>>(
      u, w, bias, uhat, rows_total, in_n, in_d, out_no,
      row_pitch(out_no, (int)sizeof(E)), pp);
  return cudaGetLastError();
}
#endif  // SDR_HOST_SHIM

}  // namespace sdr
