// The cluster scan's parts, shared by K3 (sdr_scan_fwd.cu) and K4
// (sdr_scan_bwd.cu), for Hopper, sm_90a: the thread-block cluster's
// primitives and the per-CTA passes of a step.
//
// One cluster of plan.cluster CTAs routes a batch tile of plan.bt
// utterances (plan_scan in sdr_plan.cuh). CTA q owns a contiguous slice of
// whole in-capsule rows and a contiguous slice of out capsules
// (split_begin). A step's sum over rows (s, or K4's carry) is a
// reduce-scatter: each CTA sums its rows, then stores the sum of each out
// capsule into the inbox of the CTA that owns it, in the slot of its own
// rank, through distributed shared memory; after a cluster barrier each
// owner adds its inbox's slots in rank order (a fixed order: every call
// and every time block gives the same bits), finishes its capsules (the
// squash, or its backward), and stores the result into every CTA of the
// cluster; a second barrier makes it visible. Peers only ever store into
// each other's shared memory (a store does not wait for the far side); no
// one loads from a peer.
//
// The barrier is split: barrier.cluster.arrive.release publishes what this
// thread stored, barrier.cluster.wait.acquire waits until every thread of
// the cluster has arrived. Work that does not depend on the exchange (the
// next step's prediction vectors, K4's dW, db and du) runs between the two.
//
// SDR_HOST_SHIM marks a host build of the device code (a CPU rehearsal with
// threads standing in for a cluster's threads); it supplies its own
// versions of the primitives guarded below.

#pragma once

#include "sdr_stream.cuh"

namespace sdr {

#ifndef SDR_HOST_SHIM

// A peer's shared memory, as an address in the cluster's shared window.
using peer_ptr = uint32_t;

__device__ __forceinline__ int cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return (int)rank;
}

// Where `p` (in this CTA's shared memory) lies in CTA `rank`'s.
__device__ __forceinline__ peer_ptr peer_addr(const float* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer(peer_ptr at, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(at), "f"(x)
               : "memory");
}

// Four floats to a 16-byte-aligned address of a peer, in one store.
__device__ __forceinline__ void st_peer4(peer_ptr at, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(at),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// Every thread of the CTA calls both, in the same order.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

#endif  // SDR_HOST_SHIM

// What a CTA owns: utterances b0.. (nb of them), rows n0.. (nr), out
// capsules o0.. (no).
struct Cta {
  int rank, tile;
  int b0, nb;
  int n0, nr;
  int o0, no;
};

__device__ __forceinline__ Cta cta_of(const ScanPlan& p) {
  Cta c;
  c.rank = cluster_rank();
  c.tile = blockIdx.x / p.cluster;
  c.b0 = c.tile * p.bt;
  c.nb = min(p.bt, p.batch - c.b0);
  c.n0 = split_begin(p.in_n, p.cluster, c.rank);
  c.nr = split_begin(p.in_n, p.cluster, c.rank + 1) - c.n0;
  c.o0 = split_begin(p.out_n, p.cluster, c.rank);
  c.no = split_begin(p.out_n, p.cluster, c.rank + 1) - c.o0;
  return c;
}

// Buffer i of the plan: in shared memory, or in this CTA's global region.
__device__ __forceinline__ float* scan_buf(const ScanPlan& p, float* smem,
                                           float* global, int i) {
  return (p.in_smem[i] ? smem : global) + p.off[i];
}

// The rows of u a step reads: row r of utterance b at
// base + b * b_stride + r * in_d (a ring slot, or u in global memory).
struct URows {
  const float* base;
  size_t b_stride;
};

// Steps in processing order: forward s -> t = s, backward t = T - 1 - s.
// The ring holds two slots of plan.ring steps; block pb (processing steps
// pb*ring ..) goes to slot pb % 2, filled when block pb - 1 begins.
struct URing {
  float* slots;     // [2][ring][bt][rows][in_d], or null: u from global
  uint64_t* full;   // [2] completion of a slot's bulk copies
  int bulk;         // fill by cp.async.bulk (else by every thread)
};

__device__ __forceinline__ int step_time(const ScanPlan& p, int s) {
  return p.backward ? p.seq_len - 1 - s : s;
}

// Copies block pb's u into its slot: one thread issues bulk copies, or
// every thread copies (then a later barrier orders the copy).
__device__ __forceinline__ void ring_fill(const ScanPlan& p, const Cta& c,
                                          const URing& ring, const float* u,
                                          int pb) {
  const int s0 = pb * p.ring;
  const int steps = min(p.ring, p.seq_len - s0);
  const size_t row_floats = (size_t)c.nr * p.in_d;
  const size_t in_nd = (size_t)p.in_n * p.in_d;
  float* slot =
      ring.slots + (size_t)(pb % 2) * p.ring * p.bt * p.rows * p.in_d;
  if (ring.bulk) {
    if (threadIdx.x == 0) {
      uint64_t* bar = ring.full + pb % 2;
      mbar_expect_tx(bar,
                     (uint32_t)(steps * c.nb * row_floats * sizeof(float)));
      for (int k = 0; k < steps; ++k) {
        const int t = step_time(p, s0 + k);
        for (int b = 0; b < c.nb; ++b) {
          bulk_copy(slot + ((size_t)k * p.bt + b) * p.rows * p.in_d,
                    u + ((size_t)(c.b0 + b) * p.seq_len + t) * in_nd +
                        (size_t)c.n0 * p.in_d,
                    (uint32_t)(row_floats * sizeof(float)), bar);
        }
      }
    }
    return;
  }
  const size_t per_step = c.nb * row_floats;
  for (size_t e = threadIdx.x; e < steps * per_step; e += blockDim.x) {
    const int k = (int)(e / per_step);
    const int b = (int)(e / row_floats % c.nb);
    const size_t x = e % row_floats;
    const int t = step_time(p, s0 + k);
    slot[((size_t)k * p.bt + b) * p.rows * p.in_d + x] =
        u[((size_t)(c.b0 + b) * p.seq_len + t) * in_nd +
          (size_t)c.n0 * p.in_d + x];
  }
}

// The rows of u at processing step s. The first call for a block waits
// for its bulk copies (every thread calls it in the same order).
__device__ __forceinline__ URows ring_rows(const ScanPlan& p, const Cta& c,
                                           const URing& ring, const float* u,
                                           int s, int* ready) {
  if (ring.slots == nullptr) {
    const size_t in_nd = (size_t)p.in_n * p.in_d;
    return URows{u + ((size_t)c.b0 * p.seq_len + step_time(p, s)) * in_nd +
                     (size_t)c.n0 * p.in_d,
                 (size_t)p.seq_len * in_nd};
  }
  const int pb = s / p.ring;
  if (ring.bulk && pb != *ready) {
    mbar_wait(ring.full + pb % 2, (uint32_t)(pb / 2) & 1);
    *ready = pb;
  }
  return URows{ring.slots + ((size_t)(pb % 2) * p.ring + s % p.ring) * p.bt *
                                p.rows * p.in_d,
               (size_t)p.rows * p.in_d};
}

// u_hat[b][r][o,i] = bias[r][oi] + sum_j W[r][oi][j] u[b][r][j] (oi = o *
// out_d + i) for the (r, oi) entries e0 .. e1 - 1 of the CTA's rows and
// every utterance: one thread per entry reads its W row once for up to
// kPredictB utterances. wr is [nr][out_no][in_d], br [nr][out_no] (shared
// memory if resident, else W's and bias's rows in global memory); u_hat's
// rows are [rp] (capsule pitch cp); the sum runs over j in order.
constexpr int kPredictB = 4;

// in_d == 8 (the recipes' TIMIT layers), rows 16-byte aligned: the W row in
// registers, one utterance at a time through pointers that step.
__device__ __forceinline__ void predict_rows8(const ScanPlan& p,
                                              const Cta& c, const float* wr,
                                              const float* br, URows ur,
                                              float* uhat, int e0, int e1) {
  const size_t out_step = (size_t)p.rows * p.rp;
  for (int e = e0 + (int)threadIdx.x; e < e1; e += blockDim.x) {
    const int r = e / p.out_no;
    const int oi = e - r * p.out_no;
    const int o = oi / p.out_d;
    const float4* w4 = reinterpret_cast<const float4*>(wr + (size_t)e * 8);
    const float4 wa = w4[0], wb = w4[1];
    const float bias_e = br[e];
    const float* ub = ur.base + (size_t)r * 8;
    float* ob = uhat + (size_t)r * p.rp + o * p.cp + (oi - o * p.out_d);
#pragma unroll 4
    for (int b = 0; b < c.nb; ++b) {
      const float4 xa = reinterpret_cast<const float4*>(ub)[0];
      const float4 xb = reinterpret_cast<const float4*>(ub)[1];
      float acc = fmaf(wa.x, xa.x, bias_e);
      acc = fmaf(wa.y, xa.y, acc);
      acc = fmaf(wa.z, xa.z, acc);
      acc = fmaf(wa.w, xa.w, acc);
      acc = fmaf(wb.x, xb.x, acc);
      acc = fmaf(wb.y, xb.y, acc);
      acc = fmaf(wb.z, xb.z, acc);
      acc = fmaf(wb.w, xb.w, acc);
      *ob = acc;
      ub += ur.b_stride;
      ob += out_step;
    }
  }
}

__device__ __forceinline__ void predict_rows(const ScanPlan& p, const Cta& c,
                                             const float* wr, const float* br,
                                             URows ur, float* uhat, int e0,
                                             int e1, int vec4) {
  if (vec4 && p.in_d == 8) {
    predict_rows8(p, c, wr, br, ur, uhat, e0, e1);
    return;
  }
  for (int e = e0 + (int)threadIdx.x; e < e1; e += blockDim.x) {
    const int r = e / p.out_no;
    const int oi = e - r * p.out_no;
    const int o = oi / p.out_d;
    const size_t at = (size_t)r * p.rp + o * p.cp + (oi - o * p.out_d);
    const float* w_row = wr + (size_t)e * p.in_d;
    const float* u_r = ur.base + (size_t)r * p.in_d;
    const float bias_e = br[e];
    for (int b0 = 0; b0 < c.nb; b0 += kPredictB) {
      float acc[kPredictB];
#pragma unroll
      for (int bb = 0; bb < kPredictB; ++bb) acc[bb] = bias_e;
      if (vec4) {
        for (int j = 0; j < p.in_d; j += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w_row + j);
#pragma unroll
          for (int bb = 0; bb < kPredictB; ++bb) {
            if (b0 + bb < c.nb) {
              const float4 x = *reinterpret_cast<const float4*>(
                  u_r + (b0 + bb) * ur.b_stride + j);
              acc[bb] = fmaf(w4.x, x.x, acc[bb]);
              acc[bb] = fmaf(w4.y, x.y, acc[bb]);
              acc[bb] = fmaf(w4.z, x.z, acc[bb]);
              acc[bb] = fmaf(w4.w, x.w, acc[bb]);
            }
          }
        }
      } else {
        for (int j = 0; j < p.in_d; ++j) {
          const float wj = w_row[j];
#pragma unroll
          for (int bb = 0; bb < kPredictB; ++bb) {
            if (b0 + bb < c.nb) {
              acc[bb] = fmaf(wj, u_r[(b0 + bb) * ur.b_stride + j], acc[bb]);
            }
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < kPredictB; ++bb) {
        if (b0 + bb < c.nb) {
          uhat[(size_t)(b0 + bb) * p.rows * p.rp + at] = acc[bb];
        }
      }
    }
  }
}

// A warp per (utterance, row), a lane per out capsule o (o = lane + 32k),
// vectors and rows at capsule pitch cp. Routing (VJP false): coef[b][r][o]
// = softmax_o(<uhat[b][r][o,:], vec[b][o,:]> + pad at o == 0). VJP: dc =
// <uhat[b][r][o,:], vec[b][o,:]>, coef = c * (dc - sum_o dc c), c read
// from cin. OD: out_d known at compile time (8, the recipes' TIMIT
// layers), or 0. (Two rows a warp at a time, interleaved, measured slower
// on the H100.)
template <bool VJP, int OD>
__device__ __forceinline__ void rows_pass_d(const ScanPlan& p, const Cta& c,
                                            const float* uhat,
                                            const float* vec, float pad,
                                            const float* cin, float* coef) {
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int od = OD ? OD : p.out_d;
  const int cp = OD ? (OD | 1) : p.cp;
  for (int item = threadIdx.x / 32; item < c.nb * c.nr; item += warps) {
    const int b = item / c.nr;
    const size_t row = (size_t)b * p.rows + (item - b * c.nr);
    const float* uh = uhat + row * p.rp;
    const float* v = vec + (size_t)b * p.rp;
    float* out = coef + row * p.out_n;
    float m = -INFINITY, dot = 0.f;
    for (int o = lane; o < p.out_n; o += 32) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < od; ++i) x = fmaf(uh[o * cp + i], v[o * cp + i], x);
      if (!VJP && o == 0) x += pad;
      out[o] = x;
      if (VJP) {
        dot = fmaf(x, cin[row * p.out_n + o], dot);
      } else {
        m = fmaxf(m, x);
      }
    }
    if (VJP) {
      dot = warp_sum(dot);
      for (int o = lane; o < p.out_n; o += 32) {
        out[o] = cin[row * p.out_n + o] * (out[o] - dot);
      }
      continue;
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int o = lane; o < p.out_n; o += 32) {
      const float ex = expf(out[o] - m);
      out[o] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int o = lane; o < p.out_n; o += 32) out[o] = out[o] / sum;
  }
}

template <bool VJP>
__device__ __forceinline__ void rows_pass(const ScanPlan& p, const Cta& c,
                                          const float* uhat, const float* vec,
                                          float pad, const float* cin,
                                          float* coef) {
  if (p.out_d == 8) {
    rows_pass_d<VJP, 8>(p, c, uhat, vec, pad, cin, coef);
  } else {
    rows_pass_d<VJP, 0>(p, c, uhat, vec, pad, cin, coef);
  }
}

// The CTA's share of sum_n coef[n,o] uhat[n,o,:] for every (b, oi),
// summed over its rows in order and stored into the inbox of o's owner,
// in this rank's slot: inbox [cluster][bt][caps * out_d].
__device__ __forceinline__ void send_partials(const ScanPlan& p,
                                              const Cta& c,
                                              const float* coef,
                                              const float* uhat,
                                              float* inbox) {
  const int own = p.caps * p.out_d;
  if (p.out_d % 4 == 0) {
    // four neighbouring entries of a capsule a thread, one 16-byte store
    const int quads = p.out_no / 4;
    for (int e = threadIdx.x; e < c.nb * quads; e += blockDim.x) {
      const int b = e / quads;
      const int oi = (e - b * quads) * 4;
      const int o = oi / p.out_d;
      const float* cf = coef + (size_t)b * p.rows * p.out_n + o;
      const float* uh =
          uhat + (size_t)b * p.rows * p.rp + o * p.cp + (oi - o * p.out_d);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < c.nr; ++r) {
        const float cv = cf[(size_t)r * p.out_n];
        const float* x = uh + (size_t)r * p.rp;
        acc.x = fmaf(cv, x[0], acc.x);
        acc.y = fmaf(cv, x[1], acc.y);
        acc.z = fmaf(cv, x[2], acc.z);
        acc.w = fmaf(cv, x[3], acc.w);
      }
      const int q = split_owner(p.out_n, p.cluster, o);
      const int k = oi - split_begin(p.out_n, p.cluster, q) * p.out_d;
      st_peer4(peer_addr(inbox + ((size_t)c.rank * p.bt + b) * own + k, q),
               acc);
    }
    return;
  }
  for (int e = threadIdx.x; e < c.nb * p.out_no; e += blockDim.x) {
    const int b = e / p.out_no;
    const int oi = e - b * p.out_no;
    const int o = oi / p.out_d;
    const float* cf = coef + (size_t)b * p.rows * p.out_n + o;
    const float* uh =
        uhat + (size_t)b * p.rows * p.rp + o * p.cp + (oi - o * p.out_d);
    float acc = 0.f;
    for (int r = 0; r < c.nr; ++r) {
      acc = fmaf(cf[(size_t)r * p.out_n], uh[(size_t)r * p.rp], acc);
    }
    const int q = split_owner(p.out_n, p.cluster, o);
    const int k = oi - split_begin(p.out_n, p.cluster, q) * p.out_d;
    st_peer(peer_addr(inbox + ((size_t)c.rank * p.bt + b) * own + k, q), acc);
  }
}

// An owner's sum of its inbox's slots, in rank order, for owned entry
// (b, k): b * caps * out_d + k.
__device__ __forceinline__ float inbox_sum(const ScanPlan& p,
                                           const float* inbox, int b, int k) {
  const int own = p.caps * p.out_d;
  float s = 0.f;
  for (int q = 0; q < p.cluster; ++q) {
    s += inbox[((size_t)q * p.bt + b) * own + k];
  }
  return s;
}

// The sum over the warp's lanes of each of a[0..7], in 9 shuffles: halves
// of the values go across lanes 16, 8 and 4 apart, then the one left is
// summed across lanes 2 and 1 apart. Lane l returns the sum of a[l >> 2]
// (fixed order: every call gives the same bits).
__device__ __forceinline__ float warp_sum8(const float (&a)[8], int lane) {
  float b[4], c[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float keep = hi16 ? a[k + 4] : a[k];
    const float send = hi16 ? a[k] : a[k + 4];
    b[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float keep = hi8 ? b[k + 2] : b[k];
    const float send = hi8 ? b[k] : b[k + 2];
    c[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float d = (hi4 ? c[1] : c[0]) +
            __shfl_xor_sync(0xffffffffu, hi4 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  return d;
}

// Stores x as owned entry k (capsule o0 + k / out_d, entry k % out_d) of
// vec[b] in every CTA of the cluster.
__device__ __forceinline__ void send_all(const ScanPlan& p, const Cta& c,
                                         float* vec, int b, int k, float x) {
  const int o = k / p.out_d;
  float* at = vec + (size_t)b * p.rp + (size_t)(c.o0 + o) * p.cp +
              (k - o * p.out_d);
  for (int q = 0; q < p.cluster; ++q) st_peer(peer_addr(at, q), x);
}

// ---- host side ----

// Clusters of `cluster` CTAs of `threads` threads of the kernel that the
// card holds at once, each CTA with the most shared memory (one a SM), or
// 0. A 16-CTA cluster
// must fit in one GPC, so this is not 132 / cluster (the H100 read 7 for
// 16, 15 for 8). Cached per cluster size.
inline int max_active_clusters(const void* kernel, int cluster,
                               int threads) {
  static int cached[kMaxCluster + 1];
  if (cached[cluster] > 0) return cached[cluster];
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmemBytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = kMaxSmemBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cached[cluster] = clusters;
  return clusters;
}

// Whether u's rows and W's and bias's slices can go by bulk copies: every
// CTA's slice a multiple of 16 bytes from a 16-byte-aligned address.
inline int scan_bulk_ok(const ScanPlan& p, const float* u, const float* w,
                        const float* bias) {
  return p.in_d % 4 == 0 && p.out_no % 4 == 0 && (uintptr_t)u % 16 == 0 &&
         (uintptr_t)w % 16 == 0 && (uintptr_t)bias % 16 == 0;
}

// [bt, clusters, cluster, rows, w_resident, uhat_bufs, ring, smem bytes]
inline void plan_fields(const ScanPlan& p, int* fields) {
  const int f[8] = {p.bt, p.clusters, p.cluster, p.rows, p.w_resident,
                    p.uhat_bufs, p.ring, (int)scan_smem_bytes(p)};
  for (int i = 0; i < 8; ++i) fields[i] = f[i];
}

// A cluster launch of `kernel` for plan p: the non-portable cluster size
// allowed and the plan's shared memory set first, then `launch(&config)`
// (cudaLaunchKernelEx with the cluster dimension). Returns the first
// error; a refused launch is not retried with a smaller cluster.
template <typename Launch>
inline cudaError_t launch_cluster(const void* kernel, const ScanPlan& p,
                                  int threads, cudaStream_t stream,
                                  Launch launch) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scan_smem_bytes(p));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = scan_smem_bytes(p);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = launch(&cfg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sdr
