// SDR forward (sequence-wise dynamic routing) for Hopper, sm_90a: K1.
//
// Replaces the TPU kernel srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel
// (reached through _pallas_sdr and sequential_routing_pallas). Same function
// as the plain version srf_tpu_torch/ops/routing.py:sequential_routing:
//
//   for t in 0..T-1, for every utterance b (v_{-1} = 0):
//     u_hat[n,o,i] = bias[n,o,i] + sum_j W[n,o,i,j] * u[b,t,n,j]
//     logits = 0
//     num_iter times:
//       logits[n,o] += sum_i u_hat[n,o,i] * v[o,i]   (+ -1e9 at o == 0 on
//                                                     the last layer)
//       c[n,:] = softmax(logits[n,:])                over the out capsules
//       s[o,i] = sum_n c[n,o] * u_hat[n,o,i]
//       v[o,:] = squash(s[o,:])
//     out[b,t] = v
//
// What bounds it on this card: the serial dependence over time. Step t
// needs v_{t-1}, and one step is a chain of reductions (over in_d, out_d,
// out_n, in_n, out_d again) that must finish in order. The bytes (u, W,
// bias and out once each) and the FLOPs are tiny against 3.35 TB/s and
// 67 TFLOP/s; what the time is spent on is T dependent steps, each of which
// re-reads W (0.7-1.5 MB at TIMIT width, too big for shared memory) from L2
// and crosses a handful of block barriers.
//
// Design. The TPU kernel walks T as a sequential grid and keeps v in VMEM
// scratch across grid steps; CUDA blocks run in no order, so the time loop
// runs inside the block instead. One block per utterance: rows are
// independent chains. u_t, v, the routing logits and the prediction vectors
// u_hat live in shared memory. u_hat is built one tile of in-capsule rows at
// a time (the softmax is per in-capsule row, and s is a sum over rows), so
// every geometry fits: at TIMIT the whole u_hat fits in one tile (layer 0)
// or two (last layer); WSJ's 720 KB u_hat takes a few. W is read from L2
// once per routing iteration per step. Splitting the in_n rows of one
// utterance across a thread-block cluster, wgmma and TMA are later work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kPadLogit = -1e9f;    // routing.py NEG_INF
constexpr float kSquashEps = 1e-7f;   // squash.py epsilon
// the most dynamic shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;

struct Geometry {
  int in_n, in_d, out_n, out_d;
  int tile_n;  // in-capsule rows of u_hat held in shared memory at once
  int groups;  // partial sums kept per entry of s
  int vec4;    // W rows and u rows can be read as float4
};

// floats of shared memory for u_hat tiles of `rows` in-capsule rows
size_t smem_floats(const Geometry& g, int rows) {
  const size_t out_no = (size_t)g.out_n * g.out_d;
  return (size_t)g.in_n * g.in_d              // u_t
         + 2 * out_no                         // v, s
         + (size_t)g.in_n * g.out_n           // routing logits
         + (size_t)rows * (g.out_n + out_no)  // c and u_hat of one tile
         + (size_t)g.groups * out_no;         // partial sums of s
}

bool plan(int in_n, int in_d, int out_n, int out_d, Geometry* g) {
  if (in_n < 1 || in_d < 1 || out_n < 1 || out_d < 1) return false;
  g->in_n = in_n;
  g->in_d = in_d;
  g->out_n = out_n;
  g->out_d = out_d;
  const int out_no = out_n * out_d;
  g->groups = out_no < kThreads ? kThreads / out_no : 1;
  g->vec4 = 0;
  const size_t budget = kMaxSmemBytes / sizeof(float);
  const size_t fixed = smem_floats(*g, 0);
  const size_t per_row = (size_t)out_n + out_no;
  if (fixed + per_row > budget) return false;
  size_t max_rows = (budget - fixed) / per_row;
  if (max_rows > (size_t)in_n) max_rows = in_n;
  // balance the tiles: ceil(in_n / tiles) rows each
  const int tiles = (in_n + (int)max_rows - 1) / (int)max_rows;
  g->tile_n = (in_n + tiles - 1) / tiles;
  return true;
}

__global__ void __launch_bounds__(kThreads, 1)
sdr_fwd_kernel(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int seq_len, Geometry g, int num_iter, int mask_pad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int in_nd = g.in_n * g.in_d;
  const int out_no = g.out_n * g.out_d;
  const int in_out_n = g.in_n * g.out_n;
  float* u_s = smem;                          // [in_n, in_d]
  float* v_s = u_s + in_nd;                   // [out_n, out_d]
  float* s_s = v_s + out_no;                  // [out_n, out_d]
  float* logit_s = s_s + out_no;              // [in_n, out_n]
  float* c_s = logit_s + in_out_n;            // [tile_n, out_n]
  float* uhat_s = c_s + g.tile_n * g.out_n;   // [tile_n, out_n, out_d]
  float* part_s = uhat_s + g.tile_n * out_no; // [groups, out_n, out_d]

  const float* u_b = u + (size_t)blockIdx.x * seq_len * in_nd;
  float* out_b = out + (size_t)blockIdx.x * seq_len * out_no;

  for (int k = tid; k < out_no; k += nthr) v_s[k] = 0.f;

  for (int t = 0; t < seq_len; ++t) {
    const float* u_t = u_b + (size_t)t * in_nd;
    for (int k = tid; k < in_nd; k += nthr) u_s[k] = u_t[k];
    for (int k = tid; k < in_out_n; k += nthr) logit_s[k] = 0.f;
    __syncthreads();

    for (int it = 0; it < num_iter; ++it) {
      for (int k = tid; k < g.groups * out_no; k += nthr) part_s[k] = 0.f;

      for (int n0 = 0; n0 < g.in_n; n0 += g.tile_n) {
        const int rows = min(g.tile_n, g.in_n - n0);

        // (a) prediction vectors of the tile's rows, one thread per
        //     (n, o, i): u_hat = bias + sum_j W[n,o,i,j] * u_t[n,j]
#pragma unroll 4
        for (int e = tid; e < rows * out_no; e += nthr) {
          const int n = n0 + e / out_no;
          const size_t row = (size_t)n * out_no + e % out_no;
          const float* w_row = w + row * g.in_d;
          const float* u_row = u_s + n * g.in_d;
          float acc = __ldg(bias + row);
          if (g.vec4) {
            const float4* w4 = reinterpret_cast<const float4*>(w_row);
            const float4* u4 = reinterpret_cast<const float4*>(u_row);
            for (int j = 0; j < g.in_d / 4; ++j) {
              const float4 a = __ldg(w4 + j);
              const float4 x = u4[j];
              acc = fmaf(a.x, x.x, acc);
              acc = fmaf(a.y, x.y, acc);
              acc = fmaf(a.z, x.z, acc);
              acc = fmaf(a.w, x.w, acc);
            }
          } else {
            for (int j = 0; j < g.in_d; ++j) {
              acc = fmaf(__ldg(w_row + j), u_row[j], acc);
            }
          }
          uhat_s[e] = acc;
        }
        __syncthreads();

        // (b) agreement with v: logits[n,o] += <u_hat[n,o,:], v[o,:]>
        for (int p = tid; p < rows * g.out_n; p += nthr) {
          const int r = p / g.out_n;
          const int o = p % g.out_n;
          const float* uh = uhat_s + r * out_no + o * g.out_d;
          const float* v = v_s + o * g.out_d;
          float dot = 0.f;
          for (int i = 0; i < g.out_d; ++i) dot = fmaf(uh[i], v[i], dot);
          float* l = logit_s + (n0 + r) * g.out_n + o;
          float logit = *l + dot;
          if (mask_pad && o == 0) logit += kPadLogit;
          *l = logit;
        }
        __syncthreads();

        // (c) coupling coefficients: softmax over the out capsules, one
        //     thread per in-capsule row
        for (int r = tid; r < rows; r += nthr) {
          const float* l = logit_s + (n0 + r) * g.out_n;
          float* c = c_s + r * g.out_n;
          float m = l[0];
          for (int o = 1; o < g.out_n; ++o) m = fmaxf(m, l[o]);
          float sum = 0.f;
          for (int o = 0; o < g.out_n; ++o) {
            const float ex = expf(l[o] - m);
            c[o] = ex;
            sum += ex;
          }
          for (int o = 0; o < g.out_n; ++o) c[o] = c[o] / sum;
        }
        __syncthreads();

        // (d) s[o,i] += sum over the tile's rows of c[n,o] * u_hat[n,o,i];
        //     `groups` partial sums per entry, each owned by one thread
        for (int q = tid; q < g.groups * out_no; q += nthr) {
          const int grp = q / out_no;
          const int oi = q % out_no;
          const int o = oi / g.out_d;
          float acc = part_s[q];
          for (int r = grp; r < rows; r += g.groups) {
            acc = fmaf(c_s[r * g.out_n + o], uhat_s[r * out_no + oi], acc);
          }
          part_s[q] = acc;
        }
        __syncthreads();
      }

      // (e) s = sum of the partial sums
      for (int oi = tid; oi < out_no; oi += nthr) {
        float s = 0.f;
        for (int grp = 0; grp < g.groups; ++grp) s += part_s[grp * out_no + oi];
        s_s[oi] = s;
      }
      __syncthreads();

      // (f) v = squash(s), per out capsule
      for (int oi = tid; oi < out_no; oi += nthr) {
        const float* s = s_s + (oi / g.out_d) * g.out_d;
        float sq = 0.f;
        for (int i = 0; i < g.out_d; ++i) sq = fmaf(s[i], s[i], sq);
        v_s[oi] = (sq / (1.f + sq)) * (s_s[oi] / sqrtf(sq + kSquashEps));
      }
      __syncthreads();
    }

    for (int oi = tid; oi < out_no; oi += nthr) {
      out_b[(size_t)t * out_no + oi] = v_s[oi];
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel needs for this geometry, or -1
// if the geometry does not fit in one block.
int sdr_fwd_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  Geometry g;
  if (!plan(in_n, in_d, out_n, out_d, &g)) return -1;
  return (int)(smem_floats(g, g.tile_n) * sizeof(float));
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d] -> out [batch, seq_len, out_n, out_d]; float32,
// contiguous, on the current device. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
int sdr_fwd(const float* u, const float* w, const float* bias, float* out,
            int batch, int seq_len, int in_n, int in_d, int out_n, int out_d,
            int num_iter, int mask_pad, void* stream) {
  Geometry g;
  if (batch < 1 || seq_len < 1 || num_iter < 1 ||
      !plan(in_n, in_d, out_n, out_d, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  g.vec4 = (in_d % 4 == 0) && ((uintptr_t)w % 16 == 0);
  const size_t smem = smem_floats(g, g.tile_n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdr_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sdr_fwd_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      u, w, bias, out, seq_len, g, num_iter, mask_pad);
  return (int)cudaGetLastError();
}

const char* sdr_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
