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
// 3. sdr_bwd_wgrad_kernel, the weight gradient: one block of 16 warps an
//    SM, each taking work items (n, chunk of B*T rows) in turn, about 8
//    apiece, with W[n] whole in shared memory (plan_wgrad in sdr_plan.cuh;
//    every recipe's geometry). For each tile of 20-64 rows it rebuilds
//    du_hat once into shared memory from the tile's factors, which TMA
//    bulk copies (ds and v_{t-1} rows) and cp.async (c, da, u) staged there
//    while the tile before it computed; then half the warps form the dW[n]
//    partial as register-tiled outer products (a thread 1-4 out quads by
//    an in quad, held over the chunk) and the other half du = du_hat W[n]
//    (a thread 4 rows by an in quad over a slice of the out entries, the
//    slices summed in order), both float32 FMAs on the CUDA cores, with
//    no shuffles. Where W[n] does not fit or out_no is not a multiple of 4
//    (no recipe's geometry), sdr_bwd_wgrad_kernel_general takes W[n] in
//    tiles and du_hat a few rows at a time. At SRF-WSJ's (150, 30, 20,
//    20), B=24, T'=248 the tiled path runs at 27 % of the float32 peak
//    (2.38 ms for 42.9 GFLOP, H100 SXM at 700 W): its products issue from
//    registers and shared memory with ~45 % of the SM's FMA slots busy, and
//    the rebuild, the slices' sum and their four block barriers a tile take
//    the rest;
// 4. sdr_bwd_reduce_kernel sums the chunks' partials in chunk order.
// No atomics anywhere: every sum has one owner and a fixed order, so two
// calls are bit-equal.
//
// What bounds it on this card: the reverse-time chain in (2), as for K1;
// (1), (3) and (4) run over all SMs, (1) and (4) bound by their bytes and
// (3) by issuing its FMAs between its tiles' barriers.
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

// SDR_HOST_SHIM (tests/_sdr_tp_host.h) builds the kernels as host C++
// without the launch code below them, so that the CPU tests run the weight
// gradient against its plain version (tests/test_torch_sdr_wgrad_host.py).
#ifndef SDR_HOST_SHIM
#define SDR_BWD_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

using sdr::kWarps;
using sdr::RowGeom;
using sdr::Ring;
using sdr::StreamPlan;
using sdr::Wgrad;

constexpr int kReduceThreads = 256;
constexpr int kReduceBlocks = 264;

// Scratch besides u_hat, in floats from its start: c, da, ds (16-byte
// aligned: the weight gradient bulk-copies its rows), then the
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
  s.ds = (s.da + rows * in_n * g.out_n + 3) / 4 * 4;
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
  SDR_BWD_SMEM(smem4);
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

__device__ __forceinline__ void fma4(float4& a, float s, const float4& v) {
  a.x = fmaf(s, v.x, a.x);
  a.y = fmaf(s, v.y, a.y);
  a.z = fmaf(s, v.z, a.z);
  a.w = fmaf(s, v.w, a.w);
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// Work items (n, k), an in-capsule and a chunk of B*T rows, taken by the
// resident blocks in turn (item = blockIdx.x, + gridDim.x, ...). The tiled
// path (plan_wgrad in sdr_plan.cuh), one block an SM: W[n] staged whole;
// for each tile of p.rows rows bt of chunk k,
//   du_hat[bt,oi] = c[bt,n,o] ds[bt,oi] + da[bt,n,o] v_{t-1}[bt,oi]
// is rebuilt once into shared memory from the tile's factors, which were
// staged there while the tile before it computed (ds and v_{t-1} rows by
// TMA bulk copies, c, da and u by cp.async), each rebuild thread an out
// quad of every p.build_rows-th row (its db partial in registers); then both
// products read it:
//   part[k] dW[n,oi,j] = sum_bt du_hat[bt,oi] u[bt,n,j]: each thread a
//     register tile of MT out quads (strided by p.ogroups, so that a warp's
//     lanes read neighbouring quads of a row) by one quad of in entries,
//     over the rows rs, rs + p.row_split, ... in order;
//   du[bt,n,j] = sum_oi du_hat[bt,oi] W[n,oi,j]: each thread a register
//     tile of kWgradDuRows rows (p.rows / kWgradDuRows apart) by one quad
//     of in entries over its slice of the out quads (ascending), the
//     slices' partials summed in slice order through shared memory.
// No shuffles and no atomics; at an item's end the row groups' dW partials
// and the rebuild threads' db partials are summed in group order.
// BF: du_hat[bt,oi] = bf16(bf16(c) ds + da bf16(v_{t-1})), and u and W are
// bf16 (staged widened to float32, with plain loads).
template <bool BF, int MT>
__global__ void __launch_bounds__(sdr::kWgradThreads, 1)
sdr_bwd_wgrad_kernel(const sdr::uhat_t<BF>* __restrict__ u,
                     const sdr::uhat_t<BF>* __restrict__ w,
                     const float* __restrict__ vs,
                     const float* __restrict__ cfac,
                     const float* __restrict__ dafac,
                     const float* __restrict__ dsfac, float* __restrict__ du,
                     float* __restrict__ part, int rows_total, int seq_len,
                     int in_n, int in_d, int out_n, int out_d, Wgrad p) {
  SDR_BWD_SMEM(smem4);
  constexpr int kThr = sdr::kWgradThreads;
  constexpr int kDuRows = sdr::kWgradDuRows;
  const int out_no = out_n * out_d;
  const int out_q = out_no / 4;
  const int quads = sdr::wgrad_quads(p);
  const int j4 = p.j4;
  const int dh_q = p.dh_pitch / 4;
  const int tid = threadIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // the staged rows
  float4* w4 = smem4 + 1;                         // [out_no][j4] W[n]
  float4* dh4 = w4 + (size_t)out_no * j4;         // [rows][dh_q] du_hat
  float* st_ds = reinterpret_cast<float*>(dh4) + sdr::wgrad_dh_floats(p);
  float* st_vp = st_ds + (size_t)p.rows * out_no;  // row r: v of bt0 + r - 1
  float* st_c = st_vp + (size_t)p.rows * out_no;   // [rows][out_n]
  float* st_da = st_c + sdr::wgrad_stage_cd_floats(p, out_n);
  float4* ubuf = reinterpret_cast<float4*>(
      st_da + sdr::wgrad_stage_cd_floats(p, out_n));  // [2][rows][j4] u
  float4* par4 = dh4;  // partials, once the products' reads of du_hat end
  float* w_s = reinterpret_cast<float*>(w4);
  const bool vec_in = in_d % 4 == 0 && !BF;
  const size_t per_chunk = (size_t)in_n * out_no * (in_d + 1);

  // the rebuild: out quad bq of rows brow, brow + p.build_rows, ...; the
  // out capsule of each of its entries
  const int bq = tid % quads;
  const int brow = tid / quads;
  const bool builds = brow < p.build_rows;
  int bo[4];
  for (int e = 0; e < 4; ++e) bo[e] = min(4 * bq + e, out_no - 1) / out_d;
  // dW (the first kRole threads): out quads og + i * p.ogroups, in quad jw,
  // rows rs + p.row_split m
  constexpr int kRole = sdr::kWgradRoleThreads;
  const int per_rs = p.ogroups * j4;
  const int rs = tid / per_rs;
  const int og = tid % per_rs / j4;
  const int jw = tid % j4;
  const bool dws = tid < kRole && rs < p.row_split;
  // du (the others): rows rg + i * rgroups, in quad ju, out quads of slice
  // ks
  const int utid = tid - kRole;
  const int rgroups = p.rows / kDuRows;
  const int per_ks = rgroups * j4;
  const int ks = utid / per_ks;
  const int rg = utid % per_ks / j4;
  const int ju = utid % j4;
  const bool dus = utid >= 0 && ks < p.ksplit;
  const int q_begin = dus ? sdr::split_begin(out_q, p.ksplit, ks) : 0;
  const int q_end = dus ? sdr::split_begin(out_q, p.ksplit, ks + 1) : 0;

  if (tid == 0) {
    sdr::mbar_init(full, 1);
    sdr::mbar_fence_init();
  }
  __syncthreads();

  // stages the factors of the tile of rows bt .. of item n into shared
  // memory, u into buffer `ub`; one thread issues the bulk copies of the
  // tile's ds rows and v_{t-1} rows (none at bt = 0: t = 0 has none)
  const auto stage = [&](int n, int bt, int bt_stop, float4* ub) {
    const int rows = min(p.rows, bt_stop - bt);
    if (tid == 0) {
      const uint32_t row_bytes = (uint32_t)out_no * sizeof(float);
      const int vp_rows = bt > 0 ? rows : rows - 1;
      sdr::mbar_expect_tx(full, (rows + vp_rows) * row_bytes);
      sdr::bulk_copy(st_ds, dsfac + (size_t)bt * out_no, rows * row_bytes,
                     full);
      if (vp_rows > 0) {
        sdr::bulk_copy(st_vp + (size_t)(rows - vp_rows) * out_no,
                       vs + (size_t)(bt + rows - vp_rows - 1) * out_no,
                       vp_rows * row_bytes, full);
      }
    }
    for (int e = tid; e < rows * out_n; e += kThr) {
      const size_t at = ((size_t)(bt + e / out_n) * in_n + n) * out_n +
                        e % out_n;
      sdr::copy_async(st_c + e, cfac + at);
      sdr::copy_async(st_da + e, dafac + at);
    }
    if (vec_in) {
      for (int e = tid; e < p.rows * j4; e += kThr) {
        const int r = e / j4;
        if (r < rows) {
          sdr::copy_async16(
              ub + e, u + ((size_t)(bt + r) * in_n + n) * in_d + 4 * (e % j4));
        } else {
          ub[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      float* ub_s = reinterpret_cast<float*>(ub);
      for (int e = tid; e < p.rows * j4 * 4; e += kThr) {
        const int r = e / (j4 * 4);
        const int j = e % (j4 * 4);
        const auto* src = u + ((size_t)(bt + r) * in_n + n) * in_d + j;
        if (r >= rows || j >= in_d) {
          ub_s[e] = 0.f;
        } else if constexpr (BF) {
          ub_s[e] = sdr::to_f32(*src);  // no 2-byte cp.async
        } else {
          sdr::copy_async(ub_s + e, src);
        }
      }
    }
  };

  uint32_t phase = 0;  // of `full`
  int tiles = 0;       // this block's tiles so far: u's buffer is tiles % 2
  if (blockIdx.x < in_n * p.chunks) {
    stage(blockIdx.x % in_n, blockIdx.x / in_n * p.rows_per_chunk,
          min((blockIdx.x / in_n + 1) * p.rows_per_chunk, rows_total), ubuf);
  }
  for (int item = blockIdx.x; item < in_n * p.chunks; item += gridDim.x) {
    const int n = item % in_n;
    const int k = item / in_n;
    const int bt_begin = k * p.rows_per_chunk;
    const int bt_end = min(bt_begin + p.rows_per_chunk, rows_total);
    // W[n], its in entries padded to j4 quads with zeros (the previous
    // item's products met the barrier at its end since)
    const sdr::uhat_t<BF>* w_n = w + (size_t)n * out_no * in_d;
    if (vec_in) {
      for (int e = tid; e < out_no * j4; e += kThr) {
        sdr::copy_async16(w4 + e, w_n + 4 * e);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < out_no * j4 * 4; e += kThr) {
        const int j = e % (j4 * 4);
        w_s[e] = j < in_d ? sdr::to_f32(w_n[e / (j4 * 4) * in_d + j]) : 0.f;
      }
    }
    float4 acc[MT][4];
    for (int i = 0; i < MT; ++i) {
      for (int e = 0; e < 4; ++e) acc[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 dbacc = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int bt0 = bt_begin; bt0 < bt_end; bt0 += p.rows, ++tiles) {
      const int rows = min(p.rows, bt_end - bt0);
      const float4* u4 = ubuf + (size_t)(tiles % 2) * p.rows * j4;
      const int t0 = bt0 % seq_len;  // the tile's first step
      // ---- the tile's staged factors have landed: rebuild du_hat (zeros
      //      past `rows` and out_no) ----
      sdr::copy_async_wait();
      sdr::mbar_wait(full, phase);
      phase ^= 1;
      __syncthreads();
      if (builds) {
        for (int r = brow; r < p.rows; r += p.build_rows) {
          float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < rows && bq < out_q) {
            const float4 ds =
                reinterpret_cast<const float4*>(st_ds + r * out_no)[bq];
            // v_{t-1}: the forward's output one step back, none at t = 0
            const int t = t0 + r < seq_len ? t0 + r : (t0 + r) % seq_len;
            const float4 vp =
                t > 0
                    ? reinterpret_cast<const float4*>(st_vp + r * out_no)[bq]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
            const float dsv[4] = {ds.x, ds.y, ds.z, ds.w};
            const float vpv[4] = {vp.x, vp.y, vp.z, vp.w};
            const float* c_r = st_c + r * out_n;
            const float* da_r = st_da + r * out_n;
            float dh[4];
            for (int e = 0; e < 4; ++e) {
              // where out_d is a multiple of 4 the quad is one capsule's
              const int o = out_d % 4 == 0 ? bo[0] : bo[e];
              dh[e] = sdr::keep<BF>(fmaf(sdr::keep<BF>(c_r[o]), dsv[e],
                                         da_r[o] * sdr::keep<BF>(vpv[e])));
            }
            d = make_float4(dh[0], dh[1], dh[2], dh[3]);
            add4(dbacc, d);
          }
          dh4[r * dh_q + bq] = d;
        }
      }
      __syncthreads();

      // the next tile's factors (or the next item's first tile's) into the
      // staging buffers while this tile computes
      if (bt0 + p.rows < bt_end) {
        stage(n, bt0 + p.rows, bt_end, ubuf + (size_t)((tiles + 1) % 2) *
                                                  p.rows * j4);
      } else if (item + gridDim.x < in_n * p.chunks) {
        const int next = item + gridDim.x;
        const int next_begin = next / in_n * p.rows_per_chunk;
        stage(next % in_n, next_begin,
              min(next_begin + p.rows_per_chunk, rows_total),
              ubuf + (size_t)((tiles + 1) % 2) * p.rows * j4);
      }

      // ---- the dW partial: outer products over the rows ----
      if (dws) {
#pragma unroll 2
        for (int r = rs; r < rows; r += p.row_split) {
          const float4 uu = u4[r * j4 + jw];
          const float4* drow = dh4 + r * dh_q + og;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float4 d = drow[i * p.ogroups];
            fma4(acc[i][0], d.x, uu);
            fma4(acc[i][1], d.y, uu);
            fma4(acc[i][2], d.z, uu);
            fma4(acc[i][3], d.w, uu);
          }
        }
      }
      // ---- du's slice partials: du_hat W[n] over the slice's out quads ----
      float4 a[kDuRows];
      for (int i = 0; i < kDuRows; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dus) {
        const float4* d0 = dh4 + rg * dh_q;
#pragma unroll 2
        for (int q = q_begin; q < q_end; ++q) {
          const float4 w0 = w4[(4 * q) * j4 + ju];
          const float4 w1 = w4[(4 * q + 1) * j4 + ju];
          const float4 w2 = w4[(4 * q + 2) * j4 + ju];
          const float4 w3 = w4[(4 * q + 3) * j4 + ju];
#pragma unroll
          for (int i = 0; i < kDuRows; ++i) {
            const float4 d = d0[(size_t)i * rgroups * dh_q + q];
            fma4(a[i], d.x, w0);
            fma4(a[i], d.y, w1);
            fma4(a[i], d.z, w2);
            fma4(a[i], d.w, w3);
          }
        }
      }
      __syncthreads();  // du_hat's reads are done: its region takes them
      if (dus) {
        for (int i = 0; i < kDuRows; ++i) {
          par4[((size_t)ks * p.rows + rg + i * rgroups) * j4 + ju] = a[i];
        }
      }
      __syncthreads();

      // ---- du: the slices' partials summed in slice order ----
      for (int e = tid; e < rows * j4; e += kThr) {
        const int r = e / j4;
        const int jg = e % j4;
        float4 sum = par4[r * j4 + jg];
#pragma unroll 4
        for (int s = 1; s < p.ksplit; ++s) {
          add4(sum, par4[((size_t)s * p.rows + r) * j4 + jg]);
        }
        float* du_r = du + ((size_t)(bt0 + r) * in_n + n) * in_d + 4 * jg;
        const float v[4] = {sum.x, sum.y, sum.z, sum.w};
        for (int jj = 0; jj < 4 && 4 * jg + jj < in_d; ++jj) du_r[jj] = v[jj];
      }
    }
    __syncthreads();  // the last tile's du partials are read
    // ---- the item's partials: the row groups' dW and the rebuild groups' db
    //      after the first summed in group order ----
    float4* dw_par = par4;
    float4* db_par = par4 + (size_t)(p.row_split - 1) * per_rs * MT * 4;
    if (p.row_split > 1 || p.build_rows > 1) {
      if (dws && rs > 0) {
        float4* mine = dw_par + ((size_t)(rs - 1) * per_rs + tid % per_rs) *
                                    MT * 4;
        for (int i = 0; i < MT; ++i) {
          for (int e = 0; e < 4; ++e) mine[i * 4 + e] = acc[i][e];
        }
      }
      if (builds && brow > 0) db_par[(brow - 1) * quads + bq] = dbacc;
      __syncthreads();
      if (dws && rs == 0) {
        for (int g = 1; g < p.row_split; ++g) {
          const float4* theirs =
              dw_par + ((size_t)(g - 1) * per_rs + tid) * MT * 4;
          for (int i = 0; i < MT; ++i) {
            for (int e = 0; e < 4; ++e) add4(acc[i][e], theirs[i * 4 + e]);
          }
        }
      }
      if (builds && brow == 0) {
        for (int g = 1; g < p.build_rows; ++g) {
          add4(dbacc, db_par[(g - 1) * quads + bq]);
        }
      }
    }
    if (dws && rs == 0) {
      float* dw_k = part + k * per_chunk + (size_t)n * out_no * in_d;
      for (int i = 0; i < MT; ++i) {
        const int q = og + i * p.ogroups;
        for (int e = 0; e < 4; ++e) {
          const int oi = 4 * q + e;
          if (q >= out_q || oi >= out_no) continue;
          const float v[4] = {acc[i][e].x, acc[i][e].y, acc[i][e].z,
                              acc[i][e].w};
          for (int jj = 0; jj < 4 && 4 * jw + jj < in_d; ++jj) {
            dw_k[(size_t)oi * in_d + 4 * jw + jj] = v[jj];
          }
        }
      }
    }
    if (builds && brow == 0 && bq < out_q) {
      float* db_k = part + k * per_chunk + (size_t)in_n * out_no * in_d +
                    (size_t)n * out_no;
      const float v[4] = {dbacc.x, dbacc.y, dbacc.z, dbacc.w};
      for (int e = 0; e < 4 && 4 * bq + e < out_no; ++e) {
        db_k[4 * bq + e] = v[e];
      }
    }
    __syncthreads();  // the partials region is read before the next item's
  }
}

// The general path, for a W[n] that does not fit whole beside the tiled
// path's tiles or an out_no that is not a multiple of 4 (no recipe's
// geometry): item (n, k) over rows bt of chunk
// k, for each tile of W[n] (p.o_tile out entries by p.j_tile in entries)
// in order:
//   du_hat[bt,oi] = c[bt,n,o] ds[bt,oi] + da[bt,n,o] v_{t-1}[bt,oi]
//   part[k] dW[n,oi,j] = sum_bt du_hat[bt,oi] u[bt,n,j]
//   part[k] db[n,oi]   = sum_bt du_hat[bt,oi]
//   du[bt,n,j]         = sum_oi du_hat[bt,oi] W[n,oi,j]  (the out tiles'
//                        sums added in tile order by one thread)
// BF as the tiled path.
template <bool BF>
__global__ void __launch_bounds__(sdr::kWgradGeneralThreads)
sdr_bwd_wgrad_kernel_general(const sdr::uhat_t<BF>* __restrict__ u,
                             const sdr::uhat_t<BF>* __restrict__ w,
                             const float* __restrict__ vs,
                             const float* __restrict__ cfac,
                             const float* __restrict__ dafac,
                             const float* __restrict__ dsfac,
                             float* __restrict__ du,
                             float* __restrict__ part, int rows_total,
                             int seq_len, int in_n, int in_d, int out_n,
                             int out_d, Wgrad p) {
  SDR_BWD_SMEM(smem4);
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
    for (int o0 = 0; o0 < out_no; o0 += p.o_tile) {
      for (int j0 = 0; j0 < in_d; j0 += p.j_tile) {
        const int ot = min(p.o_tile, out_no - o0);
        const int jt = min(p.j_tile, in_d - j0);
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
          // stage the rows' u (asynchronous copies) and rebuild their
          // du_hat from the factors, a warp per row with lanes along oi
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

          // the partial of dW[n]'s tile: entry (oo, 4 j's) owned by one
          // thread
          for (int e = tid; e < ot * d4; e += nthr) {
            const int oo = e / d4;
            const int jg = e % d4;
            float4 a = acc4[e];
            for (int r = 0; r < rows; ++r) {
              fma4(a, dh_s[r * p.dh_pitch + oo], u4[r * d4 + jg]);
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
                fma4(a, dh[oo], w4[oo * d4 + jg]);
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
      }
    }
  }
}

// The weight-gradient kernel's instance for a plan, and its threads.
inline int wgrad_threads(const Wgrad& p) {
  return p.tiled ? sdr::kWgradThreads : sdr::kWgradGeneralThreads;
}

template <bool BF>
inline auto wgrad_kernel(const Wgrad& p) {
  if (!p.tiled) return sdr_bwd_wgrad_kernel_general<BF>;
  switch (p.mt) {
    case 1: return sdr_bwd_wgrad_kernel<BF, 1>;
    case 2: return sdr_bwd_wgrad_kernel<BF, 2>;
    case 3: return sdr_bwd_wgrad_kernel<BF, 3>;
    default: return sdr_bwd_wgrad_kernel<BF, 4>;
  }
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

#ifndef SDR_HOST_SHIM
// Weight-gradient blocks resident on the current device at once, or -1.
template <bool BF>
int wgrad_slots(int in_d, int out_n, int out_d) {
  Wgrad p;
  sdr::plan_wgrad(1, 1, in_d, out_n, out_d, 0, &p);
  const size_t smem = sdr::wgrad_smem_floats(p, out_n, out_d) * sizeof(float);
  const auto kernel = wgrad_kernel<BF>(p);
  int device, sms, per_sm;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, wgrad_threads(p), smem) != cudaSuccess ||
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
  *slots = wgrad_slots<BF>(in_d, out_n, out_d);
  if (*slots < 1) return false;
  sdr::plan_wgrad(batch * seq_len, in_n, in_d, out_n, out_d, *slots, p);
  return true;
}

// Whether the tiled path's copies may read these: it bulk-copies rows of
// vs and ds, and where in_d is a multiple of 4 (float32) copies u and W in
// 16 bytes.
template <bool BF>
bool wgrad_aligned(const Wgrad& p, int in_d, const void* u, const void* w,
                   const float* vs, const float* dsfac) {
  const auto at16 = [](const void* x) { return (uintptr_t)x % 16 == 0; };
  return !p.tiled || (at16(vs) && at16(dsfac) &&
                      (BF || in_d % 4 != 0 || (at16(u) && at16(w))));
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
  if (!wgrad_aligned<BF>(p, in_d, u, w, vs, scratch + at.ds)) {
    return (int)cudaErrorInvalidValue;
  }
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

  const size_t wgrad_smem =
      sdr::wgrad_smem_floats(p, out_n, out_d) * sizeof(float);
  const auto wgrad = wgrad_kernel<BF>(p);
  err = cudaFuncSetAttribute(wgrad,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wgrad_smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = in_n * p.chunks < slots ? in_n * p.chunks : slots;
  wgrad<<<blocks, wgrad_threads(p), wgrad_smem, s>>>(
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
template <bool BF>
bool plan_wgrad_call(int batch, int seq_len, int in_n, int in_d, int out_n,
                     int out_d, Wgrad* p, int* slots) {
  if (batch < 1 || seq_len < 1 || in_n < 1 || in_d < 1 || out_n < 1 ||
      out_d < 1) {
    return false;
  }
  *slots = wgrad_slots<BF>(in_d, out_n, out_d);
  if (*slots < 1) return false;
  sdr::plan_wgrad(batch * seq_len, in_n, in_d, out_n, out_d, *slots, p);
  return true;
}

// Floats of the weight gradient's partials (BF: its bf16 instance's) on
// the current device, or -1 if it has no plan.
template <bool BF>
long long wgrad_part_floats(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d) {
  Wgrad p;
  int slots;
  if (!plan_wgrad_call<BF>(batch, seq_len, in_n, in_d, out_n, out_d, &p,
                           &slots)) {
    return -1;
  }
  return (long long)p.chunks * in_n * out_n * out_d * (in_d + 1);
}

// The weight-gradient kernel (BF: its bf16 instance) and the reduction on
// given factors: sdr_bwd_wgrad's launches.
template <bool BF>
int launch_wgrad(const sdr::uhat_t<BF>* u, const sdr::uhat_t<BF>* w,
                 const float* vs, const float* cfac, const float* dafac,
                 const float* dsfac, float* part, float* du, float* dw,
                 float* db, int batch, int seq_len, int in_n, int in_d,
                 int out_n, int out_d, void* stream) {
  Wgrad p;
  int slots;
  if (!plan_wgrad_call<BF>(batch, seq_len, in_n, in_d, out_n, out_d, &p,
                           &slots) ||
      !wgrad_aligned<BF>(p, in_d, u, w, vs, dsfac)) {
    return (int)cudaErrorInvalidValue;
  }
  const int out_no = out_n * out_d;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sdr::wgrad_smem_floats(p, out_n, out_d) * sizeof(float);
  const auto wgrad = wgrad_kernel<BF>(p);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = in_n * p.chunks < slots ? in_n * p.chunks : slots;
  wgrad<<<blocks, wgrad_threads(p), smem, s>>>(
      u, w, vs, cfac, dafac, dsfac, du, part, batch * seq_len, seq_len,
      in_n, in_d, out_n, out_d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int dw_size = in_n * out_no * in_d;
  sdr_bwd_reduce_kernel<<<kReduceBlocks, kReduceThreads, 0, s>>>(
      part, dw, db, p.chunks, dw_size, in_n * out_no);
  return (int)cudaGetLastError();
}

#endif  // SDR_HOST_SHIM

}  // namespace

#ifndef SDR_HOST_SHIM
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
  return wgrad_part_floats<false>(batch, seq_len, in_n, in_d, out_n, out_d);
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
  return launch_wgrad<false>(u, w, vs, cfac, dafac, dsfac, part, du, dw, db,
                             batch, seq_len, in_n, in_d, out_n, out_d,
                             stream);
}

// The bf16 instance (K2-tp-bf16's): u and w bf16, du_hat = bf16(bf16(c) ds
// + da bf16(v_{t-1})) as sdr_bwd_bf16's weight gradient; du, dw and db are
// the float32 sums, which the caller rounds to bf16; part of
// sdr_bwd_wgrad_bf16_part_floats floats.
long long sdr_bwd_wgrad_bf16_part_floats(int batch, int seq_len, int in_n,
                                         int in_d, int out_n, int out_d) {
  return wgrad_part_floats<true>(batch, seq_len, in_n, in_d, out_n, out_d);
}

int sdr_bwd_wgrad_bf16(const void* u, const void* w, const float* vs,
                       const float* cfac, const float* dafac,
                       const float* dsfac, float* part, float* du, float* dw,
                       float* db, int batch, int seq_len, int in_n, int in_d,
                       int out_n, int out_d, void* stream) {
  using B = const __nv_bfloat16*;
  return launch_wgrad<true>(static_cast<B>(u), static_cast<B>(w), vs, cfac,
                            dafac, dsfac, part, du, dw, db, batch, seq_len,
                            in_n, in_d, out_n, out_d, stream);
}

// 1 if the weight gradient takes its tiled path for this geometry (W[n]
// whole, dW in registers: plan_wgrad), 0 if its general path.
int sdr_bwd_wgrad_tiled(int in_d, int out_n, int out_d) {
  Wgrad p;
  sdr::plan_wgrad(1, 1, in_d, out_n, out_d, 0, &p);
  return p.tiled;
}

const char* sdr_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // SDR_HOST_SHIM
