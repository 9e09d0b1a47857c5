// The cluster-scan SDR backward for Hopper, sm_90a: K4.
//
// Replaces the TPU kernel srf_tpu/ops/routing_pallas.py:_sdr_v6_bwd_kernel
// (reached through _pallas_sdr_v6_bwd and the custom VJP _v6_bwd of
// sequential_routing_pallas_scan), for one routing iteration. Same function
// as K2 (sdr_bwd.cu) and the plain version
// srf_tpu_torch/ops/routing.py:sequential_routing_bwd:
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
// What bounds it on this card: as for K3 (sdr_scan_fwd.cu), the chain over
// time; the bytes and FLOPs are small (0.318 ms for the 7 SRF-TIMIT layers
// at B=29, T'=61). K2 writes du_hat's factors through L2 and forms dW in a
// kernel of its own; this is the other choice:
// - The clusters and ownership are K3's (sdr_cluster.cuh): a cluster per
//   batch tile, each CTA a slice of whole in-capsule rows and of out
//   capsules; time runs backwards.
// - A step: the CTA forms u_hat for its rows (the same function as K3's),
//   the logits against v_{t-1} and c; a reduce-scatter gives each owner s
//   on its capsules, where dv = dvs + carry and ds are formed and sent to
//   every CTA; per row dc, da, locally; a second reduce-scatter sums the
//   carry, which stays with the owner of its capsules for step t-1 (only
//   the owner's ds needs it). Three cluster barriers a step.
// - dW and db are summed where they are formed, in the CTA that owns the
//   rows, over its utterances and every step, in shared memory (the WSJ
//   layer 0's slice goes to a global region of its own): no du_hat,
//   factors or per-step partial go through L2. du = W^T du_hat is formed
//   in the step from du_hat and W. Both run between the carry barrier's
//   arrive and its wait: off the chain over time, but not hidden by it.
// - At the end each CTA writes its rows of its cluster's partial of dW and
//   db; a second launch sums the clusters' partials in cluster order. No
//   float atomics: two calls are bit-equal, and so are time blocks.
// - W and dW do not both fit at the first and last TIMIT layers: at
//   (180, 30, 8, 8), 104 KB each a CTA at 16 CTAs, besides u_hat (65 KB)
//   and the rest. The plan keeps dW resident and reads W's slice from L2
//   there (a step reads it twice, for u_hat and du); the middle layers
//   keep both, and a second u_hat buffer, whose next step is formed in the
//   first two barriers' waits. Chosen from the cycles: the window of dW,
//   db and du took the same ~3 kcycles a row of the CTA a step with W in
//   L2 (layer 0) as in shared memory (middle), so splitting over more CTAs
//   would buy nothing the 7 resident clusters allow.
// - What sets its pace as built: as K3, the CTA's passes; the window (du
//   and dW, ~35-45 kcycles of ~80-100 a step at the first and last
//   layers) most, then the prediction, the two row passes and the sends.
//   384 threads a CTA (see kThreads).
// - No wgmma and no TF32, as K3.

#include <cuda_runtime.h>

#include <stdint.h>

#include "sdr_cluster.cuh"

namespace {

using sdr::Cta;
using sdr::ScanPlan;

// Threads a CTA: 384, for up to 168 registers a thread (at 448 and more
// ptxas held the kernel to 128 registers or fewer, and the step's buffers
// and the window's sums spilled); a host rehearsal of the device code may
// build with fewer.
#ifdef SDR_SCAN_THREADS
constexpr int kThreads = SDR_SCAN_THREADS;
#else
constexpr int kThreads = 384;
#endif

constexpr int kReduceThreads = 256;  // reduction kernel
constexpr int kJ = 8;                // in entries a pass of dW
constexpr int kDuSums = 4;           // partial sums of du

__global__ void __launch_bounds__(kThreads, 1)
sdr_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ vs,
                    const float* __restrict__ dvs, float* __restrict__ du,
                    float* scratch, float* partial, ScanPlan p, int mask_pad,
                    int bulk, int vec4) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Cta c = sdr::cta_of(p);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  float* global = scratch + (size_t)blockIdx.x * p.global_floats;
  float* inbox_s = sdr::scan_buf(p, smem, global, sdr::kBInboxS);
  float* inbox_c = sdr::scan_buf(p, smem, global, sdr::kBInboxC);
  float* s_own = sdr::scan_buf(p, smem, global, sdr::kBSOwn);
  float* dv_own = sdr::scan_buf(p, smem, global, sdr::kBDvOwn);
  float* carry = sdr::scan_buf(p, smem, global, sdr::kBCarry);
  float* dvs_own = sdr::scan_buf(p, smem, global, sdr::kBDvs);
  float* ds = sdr::scan_buf(p, smem, global, sdr::kBDs);
  float* vprev = sdr::scan_buf(p, smem, global, sdr::kBVprev);
  float* coef = sdr::scan_buf(p, smem, global, sdr::kBC);
  float* da = sdr::scan_buf(p, smem, global, sdr::kBDa);
  float* dw_acc = sdr::scan_buf(p, smem, global, sdr::kBDw);
  // dW [in_d][rows][out_no] (a warp's lanes on neighbouring entries), db
  const size_t dw_stride = (size_t)p.rows * p.out_no;
  float* db_acc = dw_acc + dw_stride * p.in_d;
  // u_hat of step s at uhat0 + (s % 2) * uhat_gap (two buffers, else one)
  float* uhat0 = sdr::scan_buf(p, smem, global, sdr::kBUhat0);
  const size_t uhat_gap =
      p.uhat_bufs == 2 ? p.off[sdr::kBUhat1] - p.off[sdr::kBUhat0] : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // ring [2], W [1]
  const int own = p.caps * p.out_d;
  const int own_n = c.no * p.out_d;
  const int n_own = c.nb * own_n;  // owned entries (b, k)
  const int entries = c.nr * p.out_no;  // (r, oi) entries of the rows
  const size_t w_floats = (size_t)entries * p.in_d;
  const size_t in_nd = (size_t)p.in_n * p.in_d;
  const float* wr = w + (size_t)c.n0 * p.out_no * p.in_d;
  const float* br = bias + (size_t)c.n0 * p.out_no;
  sdr::URing ring{p.ring ? sdr::scan_buf(p, smem, global, sdr::kBRing)
                        : nullptr,
                 bars, bulk};

  if (tid == 0) {
    sdr::mbar_init(bars, 1);
    sdr::mbar_init(bars + 1, 1);
    sdr::mbar_init(bars + 2, 1);
    sdr::mbar_fence_init();
  }
  __syncthreads();
  if (p.w_resident) {
    float* w_s = sdr::scan_buf(p, smem, global, sdr::kBW);
    float* b_s = w_s + (size_t)p.rows * p.out_no * p.in_d;
    if (bulk) {
      if (tid == 0) {
        const uint32_t w_bytes = (uint32_t)(w_floats * sizeof(float));
        const uint32_t b_bytes = (uint32_t)(entries * sizeof(float));
        sdr::mbar_expect_tx(bars + 2, w_bytes + b_bytes);
        sdr::bulk_copy(w_s, wr, w_bytes, bars + 2);
        sdr::bulk_copy(b_s, br, b_bytes, bars + 2);
      }
    } else {
      for (size_t e = tid; e < w_floats; e += nthr) w_s[e] = wr[e];
      for (int e = tid; e < entries; e += nthr) b_s[e] = br[e];
    }
    wr = w_s;
    br = b_s;
  }
  if (ring.slots) sdr::ring_fill(p, c, ring, u, 0);

  // v_{t-1} and the owned entries of dvs at processing step s, into slot
  // s % 2 of their buffers
  auto load_inputs = [&](int s) {
    const int t = p.seq_len - 1 - s;
    float* vp = vprev + (size_t)(s % 2) * p.bt * p.rp;
    for (int e = tid; e < c.nb * p.out_no; e += nthr) {
      const int b = e / p.out_no;
      const int oi = e - b * p.out_no;
      const int o = oi / p.out_d;
      const size_t row = (size_t)(c.b0 + b) * p.seq_len;
      vp[(size_t)b * p.rp + o * p.cp + oi - o * p.out_d] =
          t > 0 ? vs[(row + t - 1) * p.out_no + oi] : 0.f;
    }
    float* dv_in = dvs_own + (size_t)(s % 2) * p.bt * own;
    for (int e = tid; e < n_own; e += nthr) {
      const int b = e / own_n;
      const int k = e % own_n;
      dv_in[b * own + k] =
          dvs[((size_t)(c.b0 + b) * p.seq_len + t) * p.out_no +
              (size_t)c.o0 * p.out_d + k];
    }
  };
  load_inputs(0);
  for (int e = tid; e < p.bt * own; e += nthr) carry[e] = 0.f;
  for (size_t e = tid; e < dw_stride * (p.in_d + 1); e += nthr) {
    dw_acc[e] = 0.f;
  }
  // every CTA of the cluster has started
  sdr::cluster_arrive();
  sdr::cluster_wait();
  if (p.w_resident && bulk) sdr::mbar_wait(bars + 2, 0);

  const float pad = mask_pad ? sdr::kPadLogit : 0.f;
  const bool du8 = vec4 && p.in_d == 8 && p.out_d == 8;
  int ready = -1;  // the ring block waited for
  for (int s = 0; s < p.seq_len; ++s) {
    const int t = p.seq_len - 1 - s;
    float* uh = uhat0 + (s % 2) * uhat_gap;
    const float* vp = vprev + (size_t)(s % 2) * p.bt * p.rp;
    const float* dv_in = dvs_own + (size_t)(s % 2) * p.bt * own;
    const bool ahead = p.uhat_bufs == 2 && s + 1 < p.seq_len;
    if (ring.slots && s % p.ring == 0 && s + p.ring < p.seq_len) {
      sdr::ring_fill(p, c, ring, u, s / p.ring + 1);
    }
    if (p.uhat_bufs == 1 || s == 0) {
      sdr::predict_rows(p, c, wr, br, sdr::ring_rows(p, c, ring, u, s, &ready),
                        uh, 0, entries, vec4);
    }
    __syncthreads();

    // ---- recompute c, then s by a reduce-scatter ----
    sdr::rows_pass<false>(p, c, uh, vp, pad, nullptr, coef);
    __syncthreads();
    sdr::send_partials(p, c, coef, uh, inbox_s);
    sdr::cluster_arrive();
    if (ahead) {  // the first half of the next step's u_hat
      sdr::predict_rows(p, c, wr, br,
                        sdr::ring_rows(p, c, ring, u, s + 1, &ready),
                        uhat0 + ((s + 1) % 2) * uhat_gap, 0, entries / 2,
                        vec4);
    }
    sdr::cluster_wait();

    // ---- the owner: s in rank order, dv = dvs + carry, ds to every CTA --
    for (int e = tid; e < n_own; e += nthr) {
      const int at = e / own_n * own + e % own_n;
      s_own[at] = sdr::inbox_sum(p, inbox_s, e / own_n, e % own_n);
      dv_own[at] = dv_in[at] + carry[at];
    }
    __syncthreads();
    for (int e = tid; e < n_own; e += nthr) {
      const int b = e / own_n;
      const int k = e % own_n;
      const int base = b * own + k / p.out_d * p.out_d;
      float sq = 0.f, dot = 0.f;
      for (int i = 0; i < p.out_d; ++i) {
        sq = fmaf(s_own[base + i], s_own[base + i], sq);
        dot = fmaf(dv_own[base + i], s_own[base + i], dot);
      }
      const float inv_sqrt = 1.f / sqrtf(sq + sdr::kSquashEps);
      const float ratio = sq / (1.f + sq);
      const float f = ratio * inv_sqrt;
      const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                         0.5f * ratio * (inv_sqrt / (sq + sdr::kSquashEps));
      const int at = b * own + k;
      sdr::send_all(p, c, ds, b, k,
                    dv_own[at] * f + 2.f * s_own[at] * (dot * dfdq));
    }
    sdr::cluster_arrive();
    if (ahead) {  // the second half
      sdr::predict_rows(p, c, wr, br,
                        sdr::ring_rows(p, c, ring, u, s + 1, &ready),
                        uhat0 + ((s + 1) % 2) * uhat_gap, entries / 2,
                        entries, vec4);
    }
    sdr::cluster_wait();

    // ---- per row: da; then the carry by a reduce-scatter ----
    sdr::rows_pass<true>(p, c, uh, ds, 0.f, coef, da);
    __syncthreads();
    sdr::send_partials(p, c, da, uh, inbox_c);
    sdr::cluster_arrive();

    // ---- off the chain: du_hat (in place of u_hat), dW, db, du ----
    __syncthreads();  // every thread is done reading u_hat
    for (int e = tid; e < entries; e += nthr) {
      const int r = e / p.out_no;
      const int oi = e - r * p.out_no;
      const int o = oi / p.out_d;
      const int x = o * p.cp + oi - o * p.out_d;
      const size_t c_step = (size_t)p.rows * p.out_n;
      const size_t h_step = (size_t)p.rows * p.rp;
      const float* cf = coef + (size_t)r * p.out_n + o;
      const float* af = da + (size_t)r * p.out_n + o;
      const float* dsb = ds + x;
      const float* vpb = vp + x;
      float* dh = uh + (size_t)r * p.rp + x;
      for (int b = 0; b < c.nb; ++b) {
        *dh = fmaf(*cf, *dsb, *af * *vpb);
        cf += c_step;
        af += c_step;
        dsb += p.rp;
        vpb += p.rp;
        dh += h_step;
      }
    }
    __syncthreads();
    const sdr::URows ur = sdr::ring_rows(p, c, ring, u, s, &ready);
    // dW[r,oi,:] += sum_b du_hat[b,r,oi] u[b,r,:]; db[r,oi] += sum_b du_hat
    for (int e = tid; e < entries; e += nthr) {
      const int r = e / p.out_no;
      const int oi = e - r * p.out_no;
      const int o = oi / p.out_d;
      const float* dh = uh + (size_t)r * p.rp + o * p.cp + oi - o * p.out_d;
      const float* u_r = ur.base + (size_t)r * p.in_d;
      float dsum = db_acc[e];
      for (int b = 0; b < c.nb; ++b) dsum += dh[(size_t)b * p.rows * p.rp];
      db_acc[e] = dsum;
      for (int j0 = 0; j0 < p.in_d; j0 += kJ) {
        float acc[kJ];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          acc[jj] = j0 + jj < p.in_d ? dw_acc[(j0 + jj) * dw_stride + e] : 0.f;
        }
        if (vec4 && p.in_d == kJ) {
          for (int b = 0; b < c.nb; ++b) {
            const float d = dh[(size_t)b * p.rows * p.rp];
            const float4* u4 =
                reinterpret_cast<const float4*>(u_r + b * ur.b_stride);
            const float4 xa = u4[0], xb = u4[1];
            acc[0] = fmaf(d, xa.x, acc[0]);
            acc[1] = fmaf(d, xa.y, acc[1]);
            acc[2] = fmaf(d, xa.z, acc[2]);
            acc[3] = fmaf(d, xa.w, acc[3]);
            acc[4] = fmaf(d, xb.x, acc[4]);
            acc[5] = fmaf(d, xb.y, acc[5]);
            acc[6] = fmaf(d, xb.z, acc[6]);
            acc[7] = fmaf(d, xb.w, acc[7]);
          }
        } else {
          for (int b = 0; b < c.nb; ++b) {
            const float d = dh[(size_t)b * p.rows * p.rp];
            const float* urow = u_r + b * ur.b_stride + j0;
#pragma unroll
            for (int jj = 0; jj < kJ; ++jj) {
              if (j0 + jj < p.in_d) acc[jj] = fmaf(d, urow[jj], acc[jj]);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < p.in_d) dw_acc[(j0 + jj) * dw_stride + e] = acc[jj];
        }
      }
    }
    // du[b,t,n,j] = sum_oi du_hat[b,r,oi] W[r,oi,j]
    if (du8) {
      // in_d == out_d == 8: a warp per (b, r), a lane per out entry (W's
      // row in two float4s), then the warp sum of all eight j at once
      const int lane = tid % 32;
      for (int item = tid / 32; item < c.nb * c.nr; item += nthr / 32) {
        const int b = item / c.nr;
        const int r = item - b * c.nr;
        const float* dh = uh + ((size_t)b * p.rows + r) * p.rp;
        const float* w_r = wr + (size_t)r * p.out_no * 8;
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 2
        for (int oi = lane; oi < p.out_no; oi += 32) {
          const float d = dh[(oi >> 3) * 9 + (oi & 7)];
          const float4 wa = reinterpret_cast<const float4*>(w_r + oi * 8)[0];
          const float4 wb = reinterpret_cast<const float4*>(w_r + oi * 8)[1];
          acc[0] = fmaf(d, wa.x, acc[0]);
          acc[1] = fmaf(d, wa.y, acc[1]);
          acc[2] = fmaf(d, wa.z, acc[2]);
          acc[3] = fmaf(d, wa.w, acc[3]);
          acc[4] = fmaf(d, wb.x, acc[4]);
          acc[5] = fmaf(d, wb.y, acc[5]);
          acc[6] = fmaf(d, wb.z, acc[6]);
          acc[7] = fmaf(d, wb.w, acc[7]);
        }
        const float mine = sdr::warp_sum8(acc, lane);  // du[.., lane >> 2]
        if (lane % 4 == 0) {
          du[((size_t)(c.b0 + b) * p.seq_len + t) * in_nd +
             (size_t)(c.n0 + r) * 8 + lane / 4] = mine;
        }
      }
    } else {
      // a thread per (b, r, j) (neighbouring lanes on neighbouring j),
      // kDuSums sums over interleaved out capsules added in order at the end
      for (int e = tid; e < c.nb * c.nr * p.in_d; e += nthr) {
        const int br_ = e / p.in_d;
        const int j = e - br_ * p.in_d;
        const int b = br_ / c.nr;
        const int r = br_ - b * c.nr;
        const float* dh = uh + ((size_t)b * p.rows + r) * p.rp;
        const float* w_r = wr + (size_t)r * p.out_no * p.in_d + j;
        float acc[kDuSums];
#pragma unroll
        for (int k = 0; k < kDuSums; ++k) acc[k] = 0.f;
        for (int o0 = 0; o0 < p.out_n; o0 += kDuSums) {
#pragma unroll
          for (int k = 0; k < kDuSums; ++k) {
            const int o = o0 + k;
            if (o < p.out_n) {
              const float* w_o = w_r + (size_t)o * p.out_d * p.in_d;
              for (int i = 0; i < p.out_d; ++i) {
                acc[k] = fmaf(dh[o * p.cp + i], w_o[(size_t)i * p.in_d],
                              acc[k]);
              }
            }
          }
        }
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kDuSums; ++k) sum += acc[k];
        du[((size_t)(c.b0 + b) * p.seq_len + t) * in_nd +
           (size_t)(c.n0 + r) * p.in_d + j] = sum;
      }
    }
    if (s + 1 < p.seq_len) load_inputs(s + 1);
    __syncthreads();  // the window's reads are done before u_hat is rebuilt
    sdr::cluster_wait();
    for (int e = tid; e < n_own; e += nthr) {
      carry[e / own_n * own + e % own_n] =
          sdr::inbox_sum(p, inbox_c, e / own_n, e % own_n);
    }
  }

  // this CTA's rows of its cluster's partial of dW, then of db
  float* dw_part = partial + (size_t)c.tile * p.in_n * p.out_no * (p.in_d + 1);
  float* db_part = dw_part + (size_t)p.in_n * p.out_no * p.in_d;
  for (size_t e = tid; e < w_floats; e += nthr) {
    const size_t entry = e / p.in_d;  // r * out_no + oi
    dw_part[(size_t)c.n0 * p.out_no * p.in_d + e] =
        dw_acc[(e - entry * p.in_d) * dw_stride + entry];
  }
  for (int e = tid; e < entries; e += nthr) {
    db_part[(size_t)c.n0 * p.out_no + e] = db_acc[e];
  }
}

// dW and db: the sum of the clusters' partials, in cluster order; one
// thread per entry
__global__ void __launch_bounds__(kReduceThreads)
sdr_scan_bwd_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ dw, float* __restrict__ db,
                           int clusters, int dw_size, int db_size) {
  const int per_cluster = dw_size + db_size;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < per_cluster;
       e += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < clusters; ++k) {
      sum += partial[(size_t)k * per_cluster + e];
    }
    if (e < dw_size) {
      dw[e] = sum;
    } else {
      db[e - dw_size] = sum;
    }
  }
}

// The plan for this problem on the current device, or false.
bool plan_for(int batch, int seq_len, int in_n, int in_d, int out_n,
              int out_d, int time_block, ScanPlan* p) {
  const int cluster = sdr::cluster_for(in_n);
  const int clusters = sdr::max_active_clusters(
      (const void*)sdr_scan_bwd_kernel, cluster, kThreads);
  return clusters > 0 &&
         sdr::plan_scan(true, batch, seq_len, in_n, in_d, out_n, out_d,
                        time_block, clusters, p);
}

}  // namespace

extern "C" {

// The plan's fields, or -1 if the problem has none:
// [bt, clusters, cluster, rows, w_resident, uhat_bufs, ring, smem bytes].
int sdr_scan_bwd_plan(int batch, int seq_len, int in_n, int in_d, int out_n,
                      int out_d, int time_block, int* fields) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return -1;
  }
  sdr::plan_fields(p, fields);
  return 0;
}

// Bytes of dynamic shared memory the scan kernel needs, or -1.
int sdr_scan_bwd_smem_bytes(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d, int time_block) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return -1;
  }
  return (int)sdr::scan_smem_bytes(p);
}

// Floats of the scratch buffer sdr_scan_bwd needs (the CTAs' buffers that
// do not fit in shared memory, then every cluster's partial of dW and db),
// or -1.
long long sdr_scan_bwd_scratch_floats(int batch, int seq_len, int in_n,
                                      int in_d, int out_n, int out_d,
                                      int time_block) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return -1;
  }
  return (long long)sdr::scan_scratch_floats(p);
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d], the forward's output vs and its cotangent dvs
// [batch, seq_len, out_n, out_d] -> du (shape of u), dw (of w), db (of
// bias); scratch holds sdr_scan_bwd_scratch_floats floats. float32,
// contiguous, on the current device. Launches the cluster scan and the
// reduction on `stream` and returns the first launch error (0 on success);
// does not synchronise.
int sdr_scan_bwd(const float* u, const float* w, const float* bias,
                 const float* vs, const float* dvs, float* du, float* dw,
                 float* db, float* scratch, int batch, int seq_len, int in_n,
                 int in_d, int out_n, int out_d, int mask_pad, int time_block,
                 void* stream) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bulk = sdr::scan_bulk_ok(p, u, w, bias);
  const int vec4 = p.in_d % 4 == 0 && (uintptr_t)u % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* partial =
      scratch + (size_t)p.clusters * p.cluster * p.global_floats;
  cudaError_t err = sdr::launch_cluster(
      (const void*)sdr_scan_bwd_kernel, p, kThreads, s,
      [&](cudaLaunchConfig_t* cfg) {
        return cudaLaunchKernelEx(cfg, sdr_scan_bwd_kernel, u, w, bias, vs,
                                  dvs, du, scratch, partial, p, mask_pad,
                                  bulk, vec4);
      });
  if (err != cudaSuccess) return (int)err;

  const int db_size = in_n * out_n * out_d;
  const int dw_size = db_size * in_d;
  int grid = (dw_size + db_size + kReduceThreads - 1) / kReduceThreads;
  if (grid > 1024) grid = 1024;
  sdr_scan_bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      partial, dw, db, p.clusters, dw_size, db_size);
  return (int)cudaGetLastError();
}

const char* sdr_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
