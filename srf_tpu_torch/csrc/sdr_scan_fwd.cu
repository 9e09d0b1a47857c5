// The cluster-scan SDR forward for Hopper, sm_90a: K3.
//
// Replaces the TPU kernel srf_tpu/ops/routing_pallas.py:_sdr_v6_fwd_kernel
// (step _v6_step; reached through _pallas_sdr_v6 and
// sequential_routing_pallas_scan). It computes K1's function (sdr_fwd.cu),
// the plain version srf_tpu_torch/ops/routing.py:sequential_routing, for any
// num_iter >= 1, PAD mask on or off, any B and T:
//
//   for t in 0..T-1, for every utterance b (v_{-1} = 0):
//     u_hat[n,o,i] = bias[n,o,i] + sum_j W[n,o,i,j] * u[b,t,n,j]
//     logits = 0, v = v_{t-1}
//     num_iter times:
//       logits[n,o] += sum_i u_hat[n,o,i] * v[o,i]   (+ -1e9 at o == 0 on
//                                                     the last layer)
//       c[n,:] = softmax(logits[n,:]);  s[o,i] = sum_n c[n,o] u_hat[n,o,i]
//       v[o,:] = squash(s[o,:])
//     out[b,t] = v
//
// Iteration k's logits are <u_hat, v_{t-1} + v_1 + ... + v_k> (+ k times
// the mask): the kernel keeps that sum of v's (vsum) and never the logits.
//
// What bounds it on this card: the chain over time. Step t needs v_{t-1},
// and the bytes (u, W, bias read once, out written once) and FLOPs are
// small against 3.35 TB/s and 67 TFLOP/s: 0.113 ms for the 7 SRF-TIMIT
// layers at B=29, T'=64. The design (K1 hoists u_hat into a kernel of its
// own and streams it through HBM; this is the other choice):
// - One thread-block cluster per batch tile of bt utterances (plan_scan in
//   sdr_plan.cuh: at B=29 with 7 clusters of 16 CTAs resident at once, bt
//   5 over 6 clusters, 96 SMs). CTA q owns a contiguous slice of whole
//   in-capsule rows (180/16 or 90/16 at TIMIT), so a row's softmax stays
//   in the CTA, and a slice of out capsules.
// - W's and bias's slice stays in shared memory for the whole scan
//   (brought in by TMA bulk copies at launch: 104 / 52 / 109 KB a CTA at
//   the three TIMIT layers), and each step forms u_hat for the CTA's rows
//   and utterances from it: no u_hat goes through HBM or L2, and W is read
//   from L2 once per launch. Where the slice does not fit (the WSJ layer
//   0), W is read from L2 each step.
// - u is staged a time block at a time into a two-slot ring by bulk copies
//   (one thread issues them a block ahead; an mbarrier reports them).
// - s is summed across the cluster by a reduce-scatter through distributed
//   shared memory (sdr_cluster.cuh): each CTA stores its rows' share of
//   each out capsule into the owner's inbox, the owner adds the shares in
//   rank order, squashes, and stores v (vsum) into every CTA. Two cluster
//   barriers an iteration; inside a step each CTA's wait reads only
//   ~0.4-0.5 kcycles on the H100 (tools/sdr_phase_cycles.py).
// - The next step's u_hat, which does not depend on v, is formed in place
//   between each of the last iteration's two barriers' arrive and its wait
//   (once the CTA has sent its partials, nothing reads this step's).
// - What sets its pace as built: the CTA's own passes, not the barriers
//   or the bytes. At the first TIMIT layer a step is ~20-25 kcycles of
//   block 0 (the prediction ~7, the rows' softmax ~5, the partials and
//   their sends ~4, the owners' sums, squash and sends ~3): ~7 % of the
//   SM's float32 FMA rate, with 16 warps a CTA and the loads generic (a
//   buffer may be in global memory).
// - Determinism: every sum has one owner and a fixed order, and
//   time_block only sets how many steps a ring slot stages, so the output
//   is bit-equal across calls and time blocks.
// - No wgmma and no TF32: the contraction depth is in_d = 8, each product
//   of the chain depends on v, and the float32 limits the kernels are held
//   to (rtol 1e-4 / atol 1e-5) exclude TF32.

#include <cuda_runtime.h>

#include <stdint.h>

#include "sdr_cluster.cuh"

namespace {

using sdr::Cta;
using sdr::ScanPlan;

// Threads a CTA: 512, for up to 128 registers a thread (at 1024, 64
// registers, the step's buffers spilled); a host rehearsal of the device
// code may build with fewer.
#ifdef SDR_SCAN_THREADS
constexpr int kThreads = SDR_SCAN_THREADS;
#else
constexpr int kThreads = 512;
#endif

__global__ void __launch_bounds__(kThreads, 1)
sdr_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* scratch, ScanPlan p, int num_iter, int mask_pad,
                    int bulk, int vec4) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Cta c = sdr::cta_of(p);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  float* global = scratch + (size_t)blockIdx.x * p.global_floats;
  float* inbox = sdr::scan_buf(p, smem, global, sdr::kFInbox);
  float* s_own = sdr::scan_buf(p, smem, global, sdr::kFSOwn);
  float* v_own = sdr::scan_buf(p, smem, global, sdr::kFVOwn);
  float* vsum = sdr::scan_buf(p, smem, global, sdr::kFVsum);
  float* coef = sdr::scan_buf(p, smem, global, sdr::kFC);
  float* uh = sdr::scan_buf(p, smem, global, sdr::kFUhat0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // ring [2], W [1]
  const int own = p.caps * p.out_d;
  const int n_own = c.nb * c.no * p.out_d;  // owned entries (b, k)
  const size_t w_floats = (size_t)c.nr * p.out_no * p.in_d;
  const float* wr = w + (size_t)c.n0 * p.out_no * p.in_d;
  const float* br = bias + (size_t)c.n0 * p.out_no;
  sdr::URing ring{p.ring ? sdr::scan_buf(p, smem, global, sdr::kFRing)
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
    float* w_s = sdr::scan_buf(p, smem, global, sdr::kFW);
    float* b_s = w_s + (size_t)p.rows * p.out_no * p.in_d;
    if (bulk) {
      if (tid == 0) {
        const uint32_t w_bytes = (uint32_t)(w_floats * sizeof(float));
        const uint32_t b_bytes = (uint32_t)(c.nr * p.out_no * sizeof(float));
        sdr::mbar_expect_tx(bars + 2, w_bytes + b_bytes);
        sdr::bulk_copy(w_s, wr, w_bytes, bars + 2);
        sdr::bulk_copy(b_s, br, b_bytes, bars + 2);
      }
    } else {
      for (size_t e = tid; e < w_floats; e += nthr) w_s[e] = wr[e];
      for (int e = tid; e < c.nr * p.out_no; e += nthr) b_s[e] = br[e];
    }
    wr = w_s;
    br = b_s;
  }
  if (ring.slots) sdr::ring_fill(p, c, ring, u, 0);
  for (int e = tid; e < p.bt * p.rp; e += nthr) vsum[e] = 0.f;
  for (int e = tid; e < p.bt * own; e += nthr) v_own[e] = 0.f;
  // every CTA of the cluster has started, and the zeros are in place
  sdr::cluster_arrive();
  sdr::cluster_wait();
  if (p.w_resident && bulk) sdr::mbar_wait(bars + 2, 0);

  const float pad = mask_pad ? sdr::kPadLogit : 0.f;
  const int entries = c.nr * p.out_no;  // (r, oi) entries of u_hat
  int ready = -1;                       // the ring block waited for
  for (int s = 0; s < p.seq_len; ++s) {
    const int t = s;
    if (ring.slots && s % p.ring == 0 && s + p.ring < p.seq_len) {
      sdr::ring_fill(p, c, ring, u, s / p.ring + 1);
    }
    if (s == 0) {
      sdr::predict_rows(p, c, wr, br, sdr::ring_rows(p, c, ring, u, s, &ready),
                        uh, 0, entries, vec4);
    }
    __syncthreads();

    for (int it = 0; it < num_iter; ++it) {
      const bool last = it + 1 == num_iter;
      const bool ahead = last && s + 1 < p.seq_len;
      sdr::rows_pass<false>(p, c, uh, vsum, (float)(it + 1) * pad, nullptr,
                            coef);
      __syncthreads();
      sdr::send_partials(p, c, coef, uh, inbox);
      sdr::cluster_arrive();
      if (ahead) {  // the first half of the next step's u_hat, in place
        __syncthreads();  // every thread has sent its partials
        sdr::predict_rows(p, c, wr, br,
                          sdr::ring_rows(p, c, ring, u, s + 1, &ready), uh,
                          0, entries / 2, vec4);
      }
      sdr::cluster_wait();

      // the owner: s of its capsules, in rank order
      for (int e = tid; e < n_own; e += nthr) {
        const int b = e / (c.no * p.out_d);
        const int k = e % (c.no * p.out_d);
        s_own[b * own + k] = sdr::inbox_sum(p, inbox, b, k);
      }
      __syncthreads();
      // v = squash(s); vsum gathers the v's; every CTA gets the new vsum
      for (int e = tid; e < n_own; e += nthr) {
        const int b = e / (c.no * p.out_d);
        const int k = e % (c.no * p.out_d);
        const float* cap = s_own + b * own + k / p.out_d * p.out_d;
        float sq = 0.f;
        for (int i = 0; i < p.out_d; ++i) sq = fmaf(cap[i], cap[i], sq);
        const float v = (sq / (1.f + sq)) *
                        (s_own[b * own + k] / sqrtf(sq + sdr::kSquashEps));
        const float vs = last ? v : v_own[b * own + k] + v;
        v_own[b * own + k] = vs;
        sdr::send_all(p, c, vsum, b, k, vs);
        if (last) {
          out[((size_t)(c.b0 + b) * p.seq_len + t) * p.out_no +
              (size_t)c.o0 * p.out_d + k] = v;
        }
      }
      sdr::cluster_arrive();
      if (ahead) {  // the second half
        sdr::predict_rows(p, c, wr, br,
                          sdr::ring_rows(p, c, ring, u, s + 1, &ready), uh,
                          entries / 2, entries, vec4);
      }
      sdr::cluster_wait();
    }
  }
}

// The plan for this problem on the current device, or false.
bool plan_for(int batch, int seq_len, int in_n, int in_d, int out_n,
              int out_d, int time_block, ScanPlan* p) {
  const int cluster = sdr::cluster_for(in_n);
  const int clusters = sdr::max_active_clusters(
      (const void*)sdr_scan_fwd_kernel, cluster, kThreads);
  return clusters > 0 &&
         sdr::plan_scan(false, batch, seq_len, in_n, in_d, out_n, out_d,
                        time_block, clusters, p);
}

}  // namespace

extern "C" {

// The plan's fields, or -1 if the problem has none:
// [bt, clusters, cluster, rows, w_resident, uhat_bufs, ring, smem bytes].
int sdr_scan_fwd_plan(int batch, int seq_len, int in_n, int in_d, int out_n,
                      int out_d, int time_block, int* fields) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return -1;
  }
  sdr::plan_fields(p, fields);
  return 0;
}

// Bytes of dynamic shared memory the kernel needs for this problem, or -1.
int sdr_scan_fwd_smem_bytes(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d, int time_block) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return -1;
  }
  return (int)sdr::scan_smem_bytes(p);
}

// Floats of the global scratch sdr_scan_fwd needs (the buffers that do not
// fit in shared memory), or -1.
long long sdr_scan_fwd_scratch_floats(int batch, int seq_len, int in_n,
                                      int in_d, int out_n, int out_d,
                                      int time_block) {
  ScanPlan p;
  if (!plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return -1;
  }
  return (long long)sdr::scan_scratch_floats(p);
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d] -> out [batch, seq_len, out_n, out_d]; scratch
// holds sdr_scan_fwd_scratch_floats floats (may be null if that is 0).
// float32, contiguous, on the current device. A cluster launch on `stream`;
// returns its cudaError_t (0 on success) and does not synchronise.
int sdr_scan_fwd(const float* u, const float* w, const float* bias,
                 float* out, float* scratch, int batch, int seq_len, int in_n,
                 int in_d, int out_n, int out_d, int num_iter, int mask_pad,
                 int time_block, void* stream) {
  ScanPlan p;
  if (num_iter < 1 ||
      !plan_for(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bulk = sdr::scan_bulk_ok(p, u, w, bias);
  const int vec4 = p.in_d % 4 == 0 && (uintptr_t)u % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  return (int)sdr::launch_cluster(
      (const void*)sdr_scan_fwd_kernel, p, kThreads, (cudaStream_t)stream,
      [&](cudaLaunchConfig_t* cfg) {
        return cudaLaunchKernelEx(cfg, sdr_scan_fwd_kernel, u, w, bias, out,
                                  scratch, p, num_iter, mask_pad, bulk, vec4);
      });
}

const char* sdr_scan_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
