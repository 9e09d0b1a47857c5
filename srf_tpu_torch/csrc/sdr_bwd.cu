// Fused reverse-time SDR backward for Hopper, sm_90a: K2.
//
// Replaces the TPU kernel srf_tpu/ops/routing_pallas.py:_sdr_bwd_kernel
// (reached through _pallas_sdr_bwd and the custom VJP _bwd of
// sequential_routing_pallas), for one routing iteration. Same function as
// the plain version srf_tpu_torch/ops/routing.py:sequential_routing_bwd:
//
//   for t in T-1..0, for every utterance b (v_{-1} = 0, carry = 0):
//     recompute  u_hat[n,o,i] = bias[n,o,i] + sum_j W[n,o,i,j] * u[b,t,n,j]
//                c[n,:] = softmax(<u_hat[n,o,:], v_{t-1}[o,:]> (+ PAD mask))
//                s[o,i] = sum_n c[n,o] * u_hat[n,o,i],  v = squash(s)
//     dv     = dvs[b,t] + carry
//     ds     = dv * f(q) + 2 s (sum_i dv s) f'(q),  q = |s[o,:]|^2
//     dc     = <u_hat[n,o,:], ds[o,:]>;  da = c * (dc - sum_o dc * c)
//     du_hat = c * ds + da * v_{t-1}
//     carry  = sum_n da[n,o] * u_hat[n,o,:]            (into step t-1)
//     dW += du_hat (x) u[b,t];  db += du_hat;  du[b,t,n,:] = W[n]^T du_hat
//
// Four launches per call, in order on one stream:
// 1. the prediction kernel (sdr_stream.cuh) recomputes u_hat for every
//    (b, t, n) over all SMs into its own buffer (the forward's u_hat is not
//    kept: it would be a 1.4 GB residual per train step at SRF-TIMIT
//    width; tools/sdr_variants.py measures keeping it);
// 2. sdr_bwd_step_kernel, the reverse-time recurrence: one block per
//    utterance walks t backwards while its producer warp streams u_hat_t
//    through a ring of row chunks (sdr_stream.cuh), twice a step: pass 1
//    rebuilds the logits, c and s, rows spread over the warps; the compute
//    warps then form ds; pass 2 forms dc, the softmax VJP da and the carry.
//    It writes du_hat's factors, c and da [B, T, in_n, out_n] and ds [B, T,
//    out_n * out_d], not du_hat (4x fewer bytes at out_d = 8): du_hat = c
//    ds + da v_{t-1}, and v_{t-1} is the forward's output shifted by one
//    step;
// 3. sdr_bwd_wgrad_kernel, as many blocks as the card holds at once, each
//    taking work items (n, chunk of B*T rows) in turn, about 8 apiece: it
//    rebuilds du_hat from the factors in shared memory a few rows at a time
//    and forms the chunk's partial of dW[n] and db[n] and du[:, n, :] =
//    du_hat W[n], over tiles of W[n] where it does not fit whole
//    (plan_wgrad in sdr_plan.cuh);
// 4. sdr_bwd_reduce_kernel sums the chunks' partials in chunk order.
// No atomics anywhere: every sum has one owner and a fixed order, so two
// calls are bit-equal.
//
// What bounds it on this card: the reverse-time chain in (2), as for K1;
// (1), (3) and (4) run over all SMs and are bound by their bytes and, in
// (3), by shared-memory traffic.
//
// The bf16 variant (sdr_bwd_bf16; template argument BF) is the backward of
// K1's bf16 variant, rounded where autograd through its plain version
// (ops/routing.py:sequential_routing(..., bf16=True)) rounds: the cotangent
// of a bf16 value is bf16. It recomputes u_hat in bf16 as K1's variant does
// and routes against bf16(v_{t-1}) with bf16(c) in s; it rounds dc (the
// cotangent of bf16(c)) and the carry (of bf16(v_{t-1})) to bf16, and
// du_hat = bf16(bf16(c) ds + da bf16(v_{t-1})). It reads u, W and b in
// bf16; dW, db and du are summed in float32 over B x T' and over out
// entries, and the wrapper rounds them to bf16, the cotangents of bf16 W,
// b and u. (JAX's transposed scan sums dW
// and db in bf16 step by step: ROADMAP.md F20.)

#include "sdr_stream.cuh"

namespace {

using sdr::kWarps;
using sdr::RowGeom;
using sdr::Ring;
using sdr::StreamPlan;
using sdr::Wgrad;

constexpr int kWgradThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kReduceBlocks = 264;

// Scratch besides u_hat, in floats from its start: c, da, ds, then the
// weight-gradient partials [chunks, in_n * out_no * in_d + in_n * out_no],
// then, where the plan puts it in global memory, the step kernel's
// per-warp scratch [batch, warp_floats].
struct Scratch {
  size_t c, da, ds, part, warp, total;
};

Scratch scratch_layout(int batch, int seq_len, int in_n, int in_d,
                       const StreamPlan& sp, const Wgrad& p) {
  const RowGeom& g = sp.g;
  const size_t rows = (size_t)batch * seq_len;
  Scratch s;
  s.c = 0;
  s.da = s.c + rows * in_n * g.out_n;
  s.ds = s.da + rows * in_n * g.out_n;
  s.part = s.ds + rows * g.out_no;
  s.warp = (s.part + (size_t)p.chunks * in_n * g.out_no * (in_d + 1) + 3) /
           4 * 4;
  s.total = s.warp + (sp.warp_global ? batch * sdr::warp_floats(g) : 0);
  return s;
}

// warp_g: the per-warp scratch of every block in global memory
// ([batch, warp_floats]) where the plan puts it there (general path only),
// else null
template <bool BF, int D, int NO>
__global__ void __launch_bounds__(sdr::kThreads, 1)
sdr_bwd_step_kernel(const sdr::uhat_t<BF>* __restrict__ uhat,
                    const float* __restrict__ vs,
                    const float* __restrict__ dvs, float* __restrict__ cfac,
                    float* __restrict__ dafac, float* __restrict__ dsfac,
                    float* __restrict__ warp_g, int seq_len, int in_n,
                    RowGeom g, Ring r, int mask_pad) {
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
  float* vp_s = global ? rest : part + kWarps * g.out_no;     // v_{t-1} (BF:
                                                              // bf16(v_{t-1}))
  float* dv_s = vp_s + g.pitch;                               // dvs[t] + carry
  float* ds_s = dv_s + g.pitch;
  float* s_s = ds_s + g.pitch;
  float* lg_all = global ? part + kWarps * g.out_no
                         : s_s + g.pitch;                     // [kWarps, out_n]
  float* c_all = global ? s_s + g.pitch
                        : lg_all + kWarps * g.out_n;          // [in_n, out_n]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t b = blockIdx.x;
  const E* uhat_b = uhat + b * seq_len * in_n * g.pitch;
  const float* vs_b = vs + b * seq_len * g.out_no;
  const float* dvs_b = dvs + b * seq_len * g.out_no;
  float* cfac_b = cfac + b * seq_len * in_n * g.out_n;
  float* dafac_b = dafac + b * seq_len * in_n * g.out_n;
  float* dsfac_b = dsfac + b * seq_len * g.out_no;
  const int last_t = seq_len - 1;

  if (tid == 0) {
    for (int s = 0; s < r.stages; ++s) {
      sdr::mbar_init(full + s, 1);
      sdr::mbar_init(empty + s, kWarps);
    }
    sdr::mbar_fence_init();
  }
  for (int k = tid; k < g.out_no; k += blockDim.x) {
    dv_s[k] = dvs_b[(size_t)last_t * g.out_no + k];
    vp_s[k] = last_t > 0
                  ? sdr::keep<BF>(vs_b[(size_t)(last_t - 1) * g.out_no + k])
                  : 0.f;
  }
  __syncthreads();
  if (warp == kWarps) {
    sdr::produce(uhat_b, ring, full, empty, r, in_n, g.pitch, seq_len, last_t,
                 -1, 2);
    return;
  }

  // pass 1 routes against v_{t-1} and writes c; pass 2 takes the softmax
  // VJP of dc = <u_hat, ds> and writes da
  sdr::Pass<BF> route{ring, full, empty, r, g, in_n, vp_s,
                      mask_pad ? sdr::kPadLogit : 0.f, c_all, nullptr,
                      part + warp * g.out_no, lg_all + warp * g.out_n};
  sdr::Pass<BF> vjp = route;
  vjp.vec = ds_s;
  sdr::Cursor q{0, 0};  // the next chunk, in the producer's order
  for (int t = last_t; t >= 0; --t) {
    // ---- pass 1: the logits, c and s ----
    route.fac = cfac_b + (size_t)t * in_n * g.out_n;
    sdr::warp_pass<BF, D, NO, sdr::kRoute>(route, q, warp, lane);
    sdr::sync_compute();

    // ---- s and the squash backward:
    //      ds = dv f(q) + 2 s (sum_i dv s) f'(q), q = |s[o,:]|^2 ----
    if (g.shift >= 0) {
      for (int base = 0; base < g.out_no; base += sdr::kComputeThreads) {
        const int oi = base + tid;
        const bool in = oi < g.out_no;
        const float s = in ? sdr::sum_partials(part, g.out_no, oi) : 0.f;
        const float dv = in ? dv_s[oi] : 0.f;
        const float sq = sdr::group_sum(s * s, g.shift);
        const float dvs_dot = sdr::group_sum(dv * s, g.shift);
        if (in) {
          const float inv_sqrt = 1.f / sqrtf(sq + sdr::kSquashEps);
          const float ratio = sq / (1.f + sq);
          const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                             0.5f * ratio * (inv_sqrt / (sq + sdr::kSquashEps));
          const float ds = dv * (ratio * inv_sqrt) + 2.f * s * (dvs_dot * dfdq);
          ds_s[oi] = ds;
          dsfac_b[(size_t)t * g.out_no + oi] = ds;
        }
      }
    } else {
      for (int oi = tid; oi < g.out_no; oi += sdr::kComputeThreads) {
        s_s[oi] = sdr::sum_partials(part, g.out_no, oi);
      }
      sdr::sync_compute();
      for (int oi = tid; oi < g.out_no; oi += sdr::kComputeThreads) {
        const int base = (oi / g.out_d) * g.out_d;
        float sq = 0.f, dvs_dot = 0.f;
        for (int i = 0; i < g.out_d; ++i) {
          sq = fmaf(s_s[base + i], s_s[base + i], sq);
          dvs_dot = fmaf(dv_s[base + i], s_s[base + i], dvs_dot);
        }
        const float inv_sqrt = 1.f / sqrtf(sq + sdr::kSquashEps);
        const float ratio = sq / (1.f + sq);
        const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                           0.5f * ratio * (inv_sqrt / (sq + sdr::kSquashEps));
        const float ds =
            dv_s[oi] * (ratio * inv_sqrt) + 2.f * s_s[oi] * (dvs_dot * dfdq);
        ds_s[oi] = ds;
        dsfac_b[(size_t)t * g.out_no + oi] = ds;
      }
    }
    sdr::sync_compute();

    // ---- pass 2: dc, the softmax VJP and the carry ----
    vjp.fac = dafac_b + (size_t)t * in_n * g.out_n;
    sdr::warp_pass<BF, D, NO, sdr::kVjp>(vjp, q, warp, lane);
    sdr::sync_compute();

    // ---- the carry into step t - 1, and that step's dv and v_{t-2}
    //      (BF: the carry is the cotangent of bf16(v_{t-1})) ----
    if (t > 0) {
      for (int oi = tid; oi < g.out_no; oi += sdr::kComputeThreads) {
        dv_s[oi] = sdr::keep<BF>(sdr::sum_partials(part, g.out_no, oi)) +
                   dvs_b[(size_t)(t - 1) * g.out_no + oi];
        vp_s[oi] = t > 1 ? sdr::keep<BF>(vs_b[(size_t)(t - 2) * g.out_no + oi])
                         : 0.f;
      }
    }
    sdr::sync_compute();
  }
}

// Work items (n, k), an in-capsule and a chunk of B*T rows, taken by the
// resident blocks in turn (item = blockIdx.x, + gridDim.x, ...); item (n, k)
// over rows bt of chunk k, for each tile of W[n] (p.o_tile out entries by
// p.j_tile in entries) in order:
//   du_hat[bt,oi] = c[bt,n,o] ds[bt,oi] + da[bt,n,o] v_{t-1}[bt,oi]
//   part[k] dW[n,oi,j] = sum_bt du_hat[bt,oi] u[bt,n,j]
//   part[k] db[n,oi]   = sum_bt du_hat[bt,oi]
//   du[bt,n,j]         = sum_oi du_hat[bt,oi] W[n,oi,j]  (the out tiles'
//                        sums added in tile order by one thread)
// kTiles false: W[n] is one tile (every recipe's geometry), and the tile's
// bounds are constants. BF: du_hat[bt,oi] = bf16(bf16(c) ds + da
// bf16(v_{t-1})), and u and W are bf16 (staged widened to float32).
template <bool BF, bool kTiles>
__global__ void __launch_bounds__(kWgradThreads)
sdr_bwd_wgrad_kernel(const sdr::uhat_t<BF>* __restrict__ u,
                     const sdr::uhat_t<BF>* __restrict__ w,
                     const float* __restrict__ vs,
                     const float* __restrict__ cfac,
                     const float* __restrict__ dafac,
                     const float* __restrict__ dsfac, float* __restrict__ du,
                     float* __restrict__ part, int rows_total, int seq_len,
                     int in_n, int in_d, int out_n, int out_d, Wgrad p) {
  extern __shared__ float4 smem4[];
  const int out_no = out_n * out_d;
  const int d4 = p.j_tile / 4;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float4* w4 = smem4;                  // [o_tile, d4] W[n]'s tile, zero-padded
  float4* acc4 = w4 + p.o_tile * d4;   // [o_tile, d4] its dW partial
  float* w_s = reinterpret_cast<float*>(w4);
  float* acc_s = reinterpret_cast<float*>(acc4);
  float* db_s = acc_s + p.o_tile * p.j_tile;       // [o_tile]
  float* u_s = db_s + sdr::row_pitch(p.o_tile);    // [rows, j_tile], aligned
  float* dh_s = u_s + p.rows * p.j_tile;           // [rows, dh_pitch] du_hat
  const float4* u4 = reinterpret_cast<const float4*>(u_s);
  const size_t per_chunk = (size_t)in_n * out_no * (in_d + 1);

  for (int item = blockIdx.x; item < in_n * p.chunks; item += gridDim.x) {
    const int n = item % in_n;
    const int k = item / in_n;
    const int bt_begin = k * p.rows_per_chunk;
    const int bt_end = min(bt_begin + p.rows_per_chunk, rows_total);
    // the tile of out entries o0..o0+ot-1 and in entries j0..j0+jt-1
    const auto tile = [&](int o0, int ot, int j0, int jt) {
      __syncthreads();  // the previous tile is done with
      for (int e = tid; e < ot * p.j_tile; e += nthr) {
        const int j = e % p.j_tile;
        w_s[e] = j < jt ? sdr::to_f32(w[((size_t)n * out_no + o0 +
                                          e / p.j_tile) * in_d + j0 + j])
                        : 0.f;
        acc_s[e] = 0.f;
      }
      for (int oo = tid; oo < ot; oo += nthr) db_s[oo] = 0.f;

      for (int bt0 = bt_begin; bt0 < bt_end; bt0 += p.rows) {
        const int rows = min(p.rows, bt_end - bt0);
        __syncthreads();  // W staged; the previous rows are done with
        // stage the rows' u (asynchronous copies) and rebuild their du_hat
        // from the factors, a warp per row with lanes along oi
        for (int e = tid; e < rows * p.j_tile; e += nthr) {
          const int r = e / p.j_tile;
          const int j = e % p.j_tile;
          if (j < jt) {
            const auto* src = u + ((size_t)(bt0 + r) * in_n + n) * in_d +
                              j0 + j;
            if constexpr (BF) {
              u_s[e] = sdr::to_f32(*src);  // no 2-byte cp.async
            } else {
              sdr::copy_async(u_s + e, src);
            }
          } else {
            u_s[e] = 0.f;
          }
        }
        for (int r = warp; r < rows; r += nthr / 32) {
          const int bt = bt0 + r;
          const size_t at = ((size_t)bt * in_n + n) * out_n;
          const float* ds = dsfac + (size_t)bt * out_no + o0;
          // v_{t-1}: the forward's output one step back, none at t = 0
          const float* vp = bt % seq_len > 0
                                ? vs + (size_t)(bt - 1) * out_no + o0
                                : nullptr;
#pragma unroll 4
          for (int oo = lane; oo < ot; oo += 32) {
            const int o = (o0 + oo) / out_d;
            const float vprev = vp ? sdr::keep<BF>(vp[oo]) : 0.f;
            dh_s[r * p.dh_pitch + oo] = sdr::keep<BF>(
                fmaf(sdr::keep<BF>(cfac[at + o]), ds[oo],
                     dafac[at + o] * vprev));
          }
        }
        sdr::copy_async_wait();
        __syncthreads();

        // the partial of dW[n]'s tile: entry (oo, 4 j's) owned by one thread
        for (int e = tid; e < ot * d4; e += nthr) {
          const int oo = e / d4;
          const int jg = e % d4;
          float4 a = acc4[e];
          for (int r = 0; r < rows; ++r) {
            const float x = dh_s[r * p.dh_pitch + oo];
            const float4 uu = u4[r * d4 + jg];
            a.x = fmaf(x, uu.x, a.x);
            a.y = fmaf(x, uu.y, a.y);
            a.z = fmaf(x, uu.z, a.z);
            a.w = fmaf(x, uu.w, a.w);
          }
          acc4[e] = a;
        }
        if (j0 == 0) {
          for (int oo = tid; oo < ot; oo += nthr) {
            float s = db_s[oo];
            for (int r = 0; r < rows; ++r) s += dh_s[r * p.dh_pitch + oo];
            db_s[oo] = s;
          }
        }
        // du, a warp per row: lanes along oi, then a warp sum per j
        for (int r = warp; r < rows; r += nthr / 32) {
          const float* dh = dh_s + r * p.dh_pitch;
          float* du_r = du + ((size_t)(bt0 + r) * in_n + n) * in_d + j0;
          for (int jg = 0; jg < d4; ++jg) {
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int oo = lane; oo < ot; oo += 32) {
              const float x = dh[oo];
              const float4 ww = w4[oo * d4 + jg];
              a.x = fmaf(x, ww.x, a.x);
              a.y = fmaf(x, ww.y, a.y);
              a.z = fmaf(x, ww.z, a.z);
              a.w = fmaf(x, ww.w, a.w);
            }
            a.x = sdr::warp_sum(a.x);
            a.y = sdr::warp_sum(a.y);
            a.z = sdr::warp_sum(a.z);
            a.w = sdr::warp_sum(a.w);
            const int j = jg * 4 + lane;
            if (lane < 4 && j < jt) {
              const float x =
                  lane == 0 ? a.x : lane == 1 ? a.y : lane == 2 ? a.z : a.w;
              du_r[j] = o0 == 0 ? x : du_r[j] + x;
            }
          }
        }
      }
      __syncthreads();

      float* dw_k =
          part + k * per_chunk + ((size_t)n * out_no + o0) * in_d + j0;
      for (int e = tid; e < ot * jt; e += nthr) {
        dw_k[(size_t)(e / jt) * in_d + e % jt] =
            acc_s[(e / jt) * p.j_tile + e % jt];
      }
      if (j0 == 0) {
        float* db_k = part + k * per_chunk + (size_t)in_n * out_no * in_d +
                      (size_t)n * out_no + o0;
        for (int oo = tid; oo < ot; oo += nthr) db_k[oo] = db_s[oo];
      }
    };
    if (kTiles) {
      for (int o0 = 0; o0 < out_no; o0 += p.o_tile) {
        for (int j0 = 0; j0 < in_d; j0 += p.j_tile) {
          tile(o0, min(p.o_tile, out_no - o0), j0, min(p.j_tile, in_d - j0));
        }
      }
    } else {
      tile(0, out_no, 0, in_d);
    }
  }
}

// The weight-gradient kernel's instance for a plan.
template <bool BF>
inline auto wgrad_kernel(const Wgrad& p, int in_d, int out_no) {
  return p.o_tile < out_no || p.j_tile < in_d
             ? sdr_bwd_wgrad_kernel<BF, true>
             : sdr_bwd_wgrad_kernel<BF, false>;
}

// dW and db: the chunks' partials summed in chunk order.
__global__ void __launch_bounds__(kReduceThreads)
sdr_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                      float* __restrict__ db, int chunks, int dw_size,
                      int db_size) {
  const int per_chunk = dw_size + db_size;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < per_chunk;
       e += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < chunks; ++k) sum += part[(size_t)k * per_chunk + e];
    if (e < dw_size) {
      dw[e] = sum;
    } else {
      db[e - dw_size] = sum;
    }
  }
}

// Weight-gradient blocks resident on the current device at once, or -1.
template <bool BF>
int wgrad_slots(int in_d, int out_no) {
  Wgrad p;
  sdr::plan_wgrad(1, 1, in_d, out_no, 0, &p);
  const size_t smem = sdr::wgrad_smem_floats(p) * sizeof(float);
  const auto kernel = wgrad_kernel<BF>(p, in_d, out_no);
  int device, sms, per_sm;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kWgradThreads, smem) != cudaSuccess ||
      per_sm < 1) {
    return -1;
  }
  return sms * per_sm;
}

// The plans of a call: the step kernel's and the weight gradient's (for
// the card's resident blocks). False if the geometry does not fit.
template <bool BF>
bool plan_call(int batch, int seq_len, int in_n, int in_d, int out_n,
               int out_d, StreamPlan* sp, Wgrad* p, int* slots) {
  if (batch < 1 || seq_len < 1 ||
      !sdr::plan_bwd(in_n, in_d, out_n, out_d, sp, BF ? 2 : 4)) {
    return false;
  }
  *slots = wgrad_slots<BF>(in_d, sp->g.out_no);
  if (*slots < 1) return false;
  sdr::plan_wgrad(batch * seq_len, in_n, in_d, sp->g.out_no, *slots, p);
  return true;
}

template <bool BF>
int launch(const sdr::uhat_t<BF>* u, const sdr::uhat_t<BF>* w,
           const sdr::uhat_t<BF>* bias, const float* vs, const float* dvs,
           sdr::uhat_t<BF>* uhat,
           float* scratch, float* du, float* dw, float* db, int batch,
           int seq_len, int in_n, int in_d, int out_n, int out_d,
           int mask_pad, void* stream) {
  StreamPlan sp;
  Wgrad p;
  int slots;
  if (!plan_call<BF>(batch, seq_len, in_n, in_d, out_n, out_d, &sp, &p,
                     &slots) ||
      (uintptr_t)uhat % 16 != 0 || (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const RowGeom& g = sp.g;
  const int rows_total = batch * seq_len;
  const Scratch at = scratch_layout(batch, seq_len, in_n, in_d, sp, p);
  cudaStream_t s = (cudaStream_t)stream;

  cudaError_t err = sdr::launch_predict(u, w, bias, uhat, rows_total, in_n,
                                        in_d, g.out_no, s);
  if (err != cudaSuccess) return (int)err;

  const size_t step_smem = sdr::bwd_smem_bytes(sp, in_n);
  const auto step_kernel = SDR_PICK(sdr_bwd_step_kernel, BF, sp);
  err = cudaFuncSetAttribute(step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)step_smem);
  if (err != cudaSuccess) return (int)err;
  step_kernel<<<batch, sdr::kThreads, step_smem, s>>>(
      uhat, vs, dvs, scratch + at.c, scratch + at.da, scratch + at.ds,
      sp.warp_global ? scratch + at.warp : nullptr, seq_len, in_n, g, sp.r,
      mask_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t wgrad_smem = sdr::wgrad_smem_floats(p) * sizeof(float);
  const auto wgrad = wgrad_kernel<BF>(p, in_d, g.out_no);
  err = cudaFuncSetAttribute(wgrad,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wgrad_smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = in_n * p.chunks < slots ? in_n * p.chunks : slots;
  wgrad<<<blocks, kWgradThreads, wgrad_smem, s>>>(
      u, w, vs, scratch + at.c, scratch + at.da, scratch + at.ds, du,
      scratch + at.part, rows_total, seq_len, in_n, in_d, out_n, out_d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int dw_size = in_n * g.out_no * in_d;
  sdr_bwd_reduce_kernel<<<kReduceBlocks, kReduceThreads, 0, s>>>(
      scratch + at.part, dw, db, p.chunks, dw_size, in_n * g.out_no);
  return (int)cudaGetLastError();
}

// The weight-gradient plan of a call whose factors are given (K2-tp): false
// if the geometry has none on this card.
bool plan_wgrad_call(int batch, int seq_len, int in_n, int in_d, int out_n,
                     int out_d, Wgrad* p, int* slots) {
  if (batch < 1 || seq_len < 1 || in_n < 1 || in_d < 1 || out_n < 1 ||
      out_d < 1) {
    return false;
  }
  *slots = wgrad_slots<false>(in_d, out_n * out_d);
  if (*slots < 1) return false;
  sdr::plan_wgrad(batch * seq_len, in_n, in_d, out_n * out_d, *slots, p);
  return true;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the step kernel needs for this geometry,
// or -1 if the geometry does not fit.
int sdr_bwd_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  return sdr::bwd_smem_bytes(in_n, in_d, out_n, out_d);
}

// Floats of the scratch buffer sdr_bwd takes besides u_hat (du_hat's
// factors, the weight gradient's partials and, where the plan puts it in
// global memory, the step kernel's per-warp scratch), or -1 if the
// geometry does not fit.
long long sdr_bwd_scratch_floats(int batch, int seq_len, int in_n, int in_d,
                                 int out_n, int out_d) {
  StreamPlan sp;
  Wgrad p;
  int slots;
  if (!plan_call<false>(batch, seq_len, in_n, in_d, out_n, out_d, &sp, &p,
                        &slots)) {
    return -1;
  }
  return (long long)scratch_layout(batch, seq_len, in_n, in_d, sp, p).total;
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d], the forward's output vs and its cotangent dvs
// [batch, seq_len, out_n, out_d] -> du (shape of u), dw (of w), db (of
// bias); uhat holds u_hat [batch, seq_len, in_n, pitch] (recomputed here)
// and scratch sdr_bwd_scratch_floats floats, both 16-byte aligned.
// float32, contiguous, on the current device. Launches the four kernels on
// `stream` and returns the first launch error (0 on success); does not
// synchronise.
int sdr_bwd(const float* u, const float* w, const float* bias,
            const float* vs, const float* dvs, float* uhat, float* scratch,
            float* du, float* dw, float* db, int batch, int seq_len,
            int in_n, int in_d, int out_n, int out_d, int mask_pad,
            void* stream) {
  return launch<false>(u, w, bias, vs, dvs, uhat, scratch, du, dw, db, batch,
                       seq_len, in_n, in_d, out_n, out_d, mask_pad, stream);
}

// The bf16 variant: the same arguments, with u, w and bias bf16, vs the
// float32 output of sdr_fwd_bf16, uhat bf16
// [batch, seq_len, in_n, pitch] (pitch: out_n * out_d rounded up to 8)
// and scratch of sdr_bwd_bf16_scratch_floats floats; du, dw and db are the
// float32 sums, which the caller rounds to bf16.
int sdr_bwd_bf16_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  return sdr::bwd_smem_bytes(in_n, in_d, out_n, out_d, 2);
}

long long sdr_bwd_bf16_scratch_floats(int batch, int seq_len, int in_n,
                                      int in_d, int out_n, int out_d) {
  StreamPlan sp;
  Wgrad p;
  int slots;
  if (!plan_call<true>(batch, seq_len, in_n, in_d, out_n, out_d, &sp, &p,
                       &slots)) {
    return -1;
  }
  return (long long)scratch_layout(batch, seq_len, in_n, in_d, sp, p).total;
}

int sdr_bwd_bf16(const void* u, const void* w, const void* bias,
                 const float* vs, const float* dvs, void* uhat,
                 float* scratch, float* du, float* dw, float* db, int batch,
                 int seq_len, int in_n, int in_d, int out_n, int out_d,
                 int mask_pad, void* stream) {
  using B = const __nv_bfloat16*;
  return launch<true>(static_cast<B>(u), static_cast<B>(w),
                      static_cast<B>(bias), vs, dvs,
                      static_cast<__nv_bfloat16*>(uhat), scratch, du, dw, db,
                      batch, seq_len, in_n, in_d, out_n, out_d, mask_pad,
                      stream);
}

// Floats of the partials sdr_bwd_wgrad takes for this geometry on the
// current device, or -1 if it has no plan.
long long sdr_bwd_wgrad_part_floats(int batch, int seq_len, int in_n,
                                    int in_d, int out_n, int out_d) {
  Wgrad p;
  int slots;
  if (!plan_wgrad_call(batch, seq_len, in_n, in_d, out_n, out_d, &p,
                       &slots)) {
    return -1;
  }
  return (long long)p.chunks * in_n * out_n * out_d * (in_d + 1);
}

// K2's weight-gradient and reduction kernels on given factors (K2-tp's
// last two launches, sdr_tp.cu): u [batch, seq_len, in_n, in_d], w
// [in_n, out_n, out_d, in_d], the forward's output vs [batch, seq_len,
// out_n, out_d], du_hat's factors cfac and dafac [batch, seq_len, in_n,
// out_n] and dsfac [batch, seq_len, out_n * out_d], part
// (sdr_bwd_wgrad_part_floats floats) -> du (shape of u: sum over these out
// capsules only), dw (of w), db [in_n, out_n, out_d]. float32,
// contiguous, on the current device; launches on `stream` and returns the
// first launch error.
int sdr_bwd_wgrad(const float* u, const float* w, const float* vs,
                  const float* cfac, const float* dafac, const float* dsfac,
                  float* part, float* du, float* dw, float* db, int batch,
                  int seq_len, int in_n, int in_d, int out_n, int out_d,
                  void* stream) {
  Wgrad p;
  int slots;
  if (!plan_wgrad_call(batch, seq_len, in_n, in_d, out_n, out_d, &p,
                       &slots)) {
    return (int)cudaErrorInvalidValue;
  }
  const int out_no = out_n * out_d;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sdr::wgrad_smem_floats(p) * sizeof(float);
  const auto wgrad = wgrad_kernel<false>(p, in_d, out_no);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = in_n * p.chunks < slots ? in_n * p.chunks : slots;
  wgrad<<<blocks, kWgradThreads, smem, s>>>(
      u, w, vs, cfac, dafac, dsfac, du, part, batch * seq_len, seq_len,
      in_n, in_d, out_n, out_d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int dw_size = in_n * out_no * in_d;
  sdr_bwd_reduce_kernel<<<kReduceBlocks, kReduceThreads, 0, s>>>(
      part, dw, db, p.chunks, dw_size, in_n * out_no);
  return (int)cudaGetLastError();
}

const char* sdr_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
