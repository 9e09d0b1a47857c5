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
// Two kernels, one launch each per call. The reverse-time recurrence is
// sdr_bwd_step_kernel: as in K1 (sdr_fwd.cu), one block per utterance owns
// the time loop (CUDA blocks have no order, so the TPU kernel's sequential
// grid becomes a loop inside the block), with v_{t-1} read from the saved
// forward output and the dv carry in shared memory. u_hat is rebuilt in
// tiles of in-capsule rows sized from the geometry (K1's tiling): the first
// pass over the tiles rebuilds the logits, c and s (s needs every row); the
// second does the per-row backward (dc, the softmax VJP, du_hat) and the
// sum over rows of the carry, in partial sums as s is in K1. With one tile
// (TIMIT layer 0) u_hat stays in shared memory between the passes.
//
// The step kernel writes du_hat [B, T, in_n, out_n*out_d] to a scratch
// buffer and leaves every sum over B x T to sdr_bwd_wgrad_kernel, one
// block per in-capsule n: it streams du_hat[:, :, n, :] and u[:, :, n, :]
// through shared memory in chunks of rows and forms dW[n] and db[n] (sums
// over B x T, each owned by one thread, so no atomics and a fixed order)
// and du[:, :, n, :] = du_hat W[n] (sums over out_n*out_d). The TPU kernel
// keeps dW/db in VMEM across its grid instead; here a per-utterance
// accumulator would read and write all of W once per step per block, 16x
// the bytes of du_hat.
//
// What bounds it on this card: as for K1, the serial dependence over time
// in the step kernel (one step is a chain of reductions and block barriers,
// and W is re-read from L2 once per step per block); the bytes and FLOPs
// are small against 3.35 TB/s and 67 TFLOP/s. wgmma, TMA, clusters and the
// register cap of __launch_bounds__(1024, 1) are later work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 1024;        // step kernel
constexpr int kWgradThreads = 512;    // weight-gradient kernel
constexpr int kWgradMaxRows = 32;     // rows of du_hat per chunk
constexpr float kPadLogit = -1e9f;    // routing.py NEG_INF
constexpr float kSquashEps = 1e-7f;   // squash.py epsilon
// the most dynamic shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;

struct Geometry {
  int in_n, in_d, out_n, out_d;
  int tile_n;  // in-capsule rows of u_hat held in shared memory at once
  int groups;  // partial sums kept per entry of s and of the carry
  int vec4;    // W rows and u rows can be read as float4
};

// floats of shared memory of the step kernel for tiles of `rows` rows
size_t step_smem_floats(const Geometry& g, int rows) {
  const size_t out_no = (size_t)g.out_n * g.out_d;
  return (size_t)g.in_n * g.in_d              // u_t
         + 4 * out_no                         // v_{t-1}, dv, s, ds
         + (size_t)g.in_n * g.out_n           // c, every row
         + (size_t)rows * (g.out_n + out_no)  // dc/da and u_hat of one tile
         + (size_t)g.groups * out_no;         // partial sums
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
  const size_t fixed = step_smem_floats(*g, 0);
  const size_t per_row = (size_t)out_n + out_no;
  if (fixed + per_row > budget) return false;
  size_t max_rows = (budget - fixed) / per_row;
  if (max_rows > (size_t)in_n) max_rows = in_n;
  // balance the tiles: ceil(in_n / tiles) rows each
  const int tiles = (in_n + (int)max_rows - 1) / (int)max_rows;
  g->tile_n = (in_n + tiles - 1) / tiles;
  return true;
}

// floats of shared memory of the weight-gradient kernel
size_t wgrad_smem_floats(int in_d, int out_no, int rows) {
  return (size_t)out_no * in_d               // W[n]
         + (size_t)out_no * (in_d + 1)       // dW[n] and db[n] sums
         + (size_t)rows * (out_no + in_d);   // a chunk of du_hat and u rows
}

int wgrad_rows(int in_d, int out_no) {
  const size_t budget = kMaxSmemBytes / sizeof(float);
  const size_t fixed = wgrad_smem_floats(in_d, out_no, 0);
  if (fixed + out_no + in_d > budget) return 0;
  const size_t rows = (budget - fixed) / (out_no + in_d);
  return rows < (size_t)kWgradMaxRows ? (int)rows : kWgradMaxRows;
}

// u_hat of the tile's rows n0..n0+rows-1, one thread per (n, o, i)
__device__ void predict_tile(const float* __restrict__ w,
                             const float* __restrict__ bias,
                             const float* u_s, float* uhat_s, int n0,
                             int rows, const Geometry& g) {
  const int out_no = g.out_n * g.out_d;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * out_no; e += blockDim.x) {
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
}

__global__ void __launch_bounds__(kThreads, 1)
sdr_bwd_step_kernel(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ vs,
                    const float* __restrict__ dvs,
                    float* __restrict__ du_hat, int seq_len, Geometry g,
                    int mask_pad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int in_nd = g.in_n * g.in_d;
  const int out_no = g.out_n * g.out_d;
  const int in_out_n = g.in_n * g.out_n;
  const int tiles = (g.in_n + g.tile_n - 1) / g.tile_n;
  float* u_s = smem;                          // [in_n, in_d]
  float* vprev_s = u_s + in_nd;               // [out_n, out_d]
  float* dv_s = vprev_s + out_no;             // [out_n, out_d]
  float* s_s = dv_s + out_no;                 // [out_n, out_d]
  float* ds_s = s_s + out_no;                 // [out_n, out_d]
  float* c_s = ds_s + out_no;                 // [in_n, out_n]
  float* da_s = c_s + in_out_n;               // [tile_n, out_n]
  float* uhat_s = da_s + g.tile_n * g.out_n;  // [tile_n, out_n, out_d]
  float* part_s = uhat_s + g.tile_n * out_no; // [groups, out_n, out_d]

  const size_t b = blockIdx.x;
  const float* u_b = u + b * seq_len * in_nd;
  const float* vs_b = vs + b * seq_len * out_no;
  const float* dvs_b = dvs + b * seq_len * out_no;
  float* duhat_b = du_hat + b * seq_len * g.in_n * out_no;

  for (int k = tid; k < out_no; k += nthr) dv_s[k] = 0.f;  // the carry

  for (int t = seq_len - 1; t >= 0; --t) {
    const float* u_t = u_b + (size_t)t * in_nd;
    for (int k = tid; k < in_nd; k += nthr) u_s[k] = u_t[k];
    for (int k = tid; k < out_no; k += nthr) {
      vprev_s[k] = t > 0 ? vs_b[(size_t)(t - 1) * out_no + k] : 0.f;
      dv_s[k] += dvs_b[(size_t)t * out_no + k];
    }
    for (int k = tid; k < g.groups * out_no; k += nthr) part_s[k] = 0.f;
    __syncthreads();

    // ---- pass 1: rebuild the logits, c and s, tile by tile ----
    for (int n0 = 0; n0 < g.in_n; n0 += g.tile_n) {
      const int rows = min(g.tile_n, g.in_n - n0);
      predict_tile(w, bias, u_s, uhat_s, n0, rows, g);
      __syncthreads();

      // logits[n,o] = <u_hat[n,o,:], v_{t-1}[o,:]> (+ PAD mask)
      for (int p = tid; p < rows * g.out_n; p += nthr) {
        const int r = p / g.out_n;
        const int o = p % g.out_n;
        const float* uh = uhat_s + r * out_no + o * g.out_d;
        const float* v = vprev_s + o * g.out_d;
        float dot = 0.f;
        for (int i = 0; i < g.out_d; ++i) dot = fmaf(uh[i], v[i], dot);
        if (mask_pad && o == 0) dot += kPadLogit;
        c_s[(n0 + r) * g.out_n + o] = dot;
      }
      __syncthreads();

      // c = softmax over the out capsules, in place; a thread per row
      for (int r = tid; r < rows; r += nthr) {
        float* c = c_s + (n0 + r) * g.out_n;
        float m = c[0];
        for (int o = 1; o < g.out_n; ++o) m = fmaxf(m, c[o]);
        float sum = 0.f;
        for (int o = 0; o < g.out_n; ++o) {
          const float ex = expf(c[o] - m);
          c[o] = ex;
          sum += ex;
        }
        for (int o = 0; o < g.out_n; ++o) c[o] = c[o] / sum;
      }
      __syncthreads();

      // s[o,i] += sum over the tile's rows of c[n,o] * u_hat[n,o,i]
      for (int q = tid; q < g.groups * out_no; q += nthr) {
        const int grp = q / out_no;
        const int oi = q % out_no;
        const int o = oi / g.out_d;
        float acc = part_s[q];
        for (int r = grp; r < rows; r += g.groups) {
          acc = fmaf(c_s[(n0 + r) * g.out_n + o], uhat_s[r * out_no + oi],
                     acc);
        }
        part_s[q] = acc;
      }
      __syncthreads();
    }
    for (int oi = tid; oi < out_no; oi += nthr) {
      float s = 0.f;
      for (int grp = 0; grp < g.groups; ++grp) s += part_s[grp * out_no + oi];
      s_s[oi] = s;
    }
    __syncthreads();

    // ---- squash backward: ds = dv f(q) + 2 s (sum_i dv s) f'(q) ----
    for (int oi = tid; oi < out_no; oi += nthr) {
      const int base = (oi / g.out_d) * g.out_d;
      float q = 0.f, dvs_dot = 0.f;
      for (int i = 0; i < g.out_d; ++i) {
        q = fmaf(s_s[base + i], s_s[base + i], q);
        dvs_dot = fmaf(dv_s[base + i], s_s[base + i], dvs_dot);
      }
      const float inv_sqrt = 1.f / sqrtf(q + kSquashEps);
      const float ratio = q / (1.f + q);
      const float f = ratio * inv_sqrt;
      const float dfdq = inv_sqrt / ((1.f + q) * (1.f + q)) -
                         0.5f * ratio * (inv_sqrt / (q + kSquashEps));
      ds_s[oi] = dv_s[oi] * f + 2.f * s_s[oi] * (dvs_dot * dfdq);
    }
    for (int k = tid; k < g.groups * out_no; k += nthr) part_s[k] = 0.f;
    __syncthreads();

    // ---- pass 2: the per-row backward, tile by tile ----
    for (int n0 = 0; n0 < g.in_n; n0 += g.tile_n) {
      const int rows = min(g.tile_n, g.in_n - n0);
      if (tiles > 1) {
        predict_tile(w, bias, u_s, uhat_s, n0, rows, g);
        __syncthreads();
      }

      // dc[n,o] = <u_hat[n,o,:], ds[o,:]>
      for (int p = tid; p < rows * g.out_n; p += nthr) {
        const int r = p / g.out_n;
        const int o = p % g.out_n;
        const float* uh = uhat_s + r * out_no + o * g.out_d;
        const float* ds = ds_s + o * g.out_d;
        float dot = 0.f;
        for (int i = 0; i < g.out_d; ++i) dot = fmaf(uh[i], ds[i], dot);
        da_s[p] = dot;
      }
      __syncthreads();

      // softmax backward, in place: da = c * (dc - sum_o dc * c)
      for (int r = tid; r < rows; r += nthr) {
        const float* c = c_s + (n0 + r) * g.out_n;
        float* da = da_s + r * g.out_n;
        float dot = 0.f;
        for (int o = 0; o < g.out_n; ++o) dot = fmaf(da[o], c[o], dot);
        for (int o = 0; o < g.out_n; ++o) da[o] = c[o] * (da[o] - dot);
      }
      __syncthreads();

      // carry[o,i] += sum over the tile's rows of da[n,o] * u_hat[n,o,i]
      for (int q = tid; q < g.groups * out_no; q += nthr) {
        const int grp = q / out_no;
        const int oi = q % out_no;
        const int o = oi / g.out_d;
        float acc = part_s[q];
        for (int r = grp; r < rows; r += g.groups) {
          acc = fmaf(da_s[r * g.out_n + o], uhat_s[r * out_no + oi], acc);
        }
        part_s[q] = acc;
      }
      // du_hat[n,o,i] = c[n,o] ds[o,i] + da[n,o] v_{t-1}[o,i]
      float* duhat_t = duhat_b + ((size_t)t * g.in_n + n0) * out_no;
      for (int e = tid; e < rows * out_no; e += nthr) {
        const int r = e / out_no;
        const int oi = e % out_no;
        const int o = oi / g.out_d;
        duhat_t[e] = fmaf(c_s[(n0 + r) * g.out_n + o], ds_s[oi],
                          da_s[r * g.out_n + o] * vprev_s[oi]);
      }
      __syncthreads();
    }
    for (int oi = tid; oi < out_no; oi += nthr) {
      float carry = 0.f;
      for (int grp = 0; grp < g.groups; ++grp) {
        carry += part_s[grp * out_no + oi];
      }
      dv_s[oi] = carry;
    }
    __syncthreads();
  }
}

// One block per in-capsule n, over all rows (b, t) in chunks:
//   dW[n,o,i,j] = sum_bt du_hat[bt,n,oi] u[bt,n,j]
//   db[n,o,i]   = sum_bt du_hat[bt,n,oi]
//   du[bt,n,j]  = sum_oi du_hat[bt,n,oi] W[n,oi,j]
__global__ void __launch_bounds__(kWgradThreads)
sdr_bwd_wgrad_kernel(const float* __restrict__ u,
                     const float* __restrict__ w,
                     const float* __restrict__ du_hat,
                     float* __restrict__ du, float* __restrict__ dw,
                     float* __restrict__ db, int rows_total, int in_n,
                     int in_d, int out_no, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n = blockIdx.x;
  const int acc_w = in_d + 1;
  float* w_s = smem;                          // [out_no, in_d]
  float* acc_s = w_s + out_no * in_d;         // [out_no, in_d + 1]
  float* dh_s = acc_s + out_no * acc_w;       // [chunk, out_no]
  float* uc_s = dh_s + chunk * out_no;        // [chunk, in_d]

  const float* w_n = w + (size_t)n * out_no * in_d;
  for (int k = tid; k < out_no * in_d; k += nthr) w_s[k] = w_n[k];
  for (int k = tid; k < out_no * acc_w; k += nthr) acc_s[k] = 0.f;

  for (int bt0 = 0; bt0 < rows_total; bt0 += chunk) {
    const int rows = min(chunk, rows_total - bt0);
    for (int e = tid; e < rows * out_no; e += nthr) {
      const int r = e / out_no;
      dh_s[e] = du_hat[((size_t)(bt0 + r) * in_n + n) * out_no + e % out_no];
    }
    for (int e = tid; e < rows * in_d; e += nthr) {
      const int r = e / in_d;
      uc_s[e] = u[((size_t)(bt0 + r) * in_n + n) * in_d + e % in_d];
    }
    __syncthreads();

    // dW[n] and db[n]: entry (oi, j) of the sums is owned by one thread;
    // j == in_d is db
    for (int q = tid; q < out_no * acc_w; q += nthr) {
      const int oi = q / acc_w;
      const int j = q % acc_w;
      float acc = acc_s[q];
      if (j < in_d) {
        for (int r = 0; r < rows; ++r) {
          acc = fmaf(dh_s[r * out_no + oi], uc_s[r * in_d + j], acc);
        }
      } else {
        for (int r = 0; r < rows; ++r) acc += dh_s[r * out_no + oi];
      }
      acc_s[q] = acc;
    }
    // du[bt, n, j], one thread per (row, j)
    for (int p = tid; p < rows * in_d; p += nthr) {
      const int r = p / in_d;
      const int j = p % in_d;
      const float* dh = dh_s + r * out_no;
      float acc = 0.f;
      for (int oi = 0; oi < out_no; ++oi) {
        acc = fmaf(dh[oi], w_s[oi * in_d + j], acc);
      }
      du[((size_t)(bt0 + r) * in_n + n) * in_d + j] = acc;
    }
    __syncthreads();
  }

  float* dw_n = dw + (size_t)n * out_no * in_d;
  for (int q = tid; q < out_no * acc_w; q += nthr) {
    const int oi = q / acc_w;
    const int j = q % acc_w;
    if (j < in_d) {
      dw_n[oi * in_d + j] = acc_s[q];
    } else {
      db[(size_t)n * out_no + oi] = acc_s[q];
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the step kernel needs for this geometry,
// or -1 if the geometry does not fit (in either kernel).
int sdr_bwd_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  Geometry g;
  if (!plan(in_n, in_d, out_n, out_d, &g)) return -1;
  if (wgrad_rows(in_d, out_n * out_d) < 1) return -1;
  return (int)(step_smem_floats(g, g.tile_n) * sizeof(float));
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d], the forward's output vs and its cotangent dvs
// [batch, seq_len, out_n, out_d] -> du (shape of u), dw (of w), db (of
// bias); du_hat [batch, seq_len, in_n, out_n * out_d] is scratch. float32,
// contiguous, on the current device. Launches both kernels on `stream` and
// returns the first launch error (0 on success); does not synchronise.
int sdr_bwd(const float* u, const float* w, const float* bias,
            const float* vs, const float* dvs, float* du_hat, float* du,
            float* dw, float* db, int batch, int seq_len, int in_n, int in_d,
            int out_n, int out_d, int mask_pad, void* stream) {
  Geometry g;
  if (batch < 1 || seq_len < 1 || !plan(in_n, in_d, out_n, out_d, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  const int out_no = out_n * out_d;
  const int chunk = wgrad_rows(in_d, out_no);
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  g.vec4 = (in_d % 4 == 0) && ((uintptr_t)w % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;

  const size_t step_smem = step_smem_floats(g, g.tile_n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdr_bwd_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)step_smem);
  if (err != cudaSuccess) return (int)err;
  sdr_bwd_step_kernel<<<batch, kThreads, step_smem, s>>>(
      u, w, bias, vs, dvs, du_hat, seq_len, g, mask_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t wgrad_smem =
      wgrad_smem_floats(in_d, out_no, chunk) * sizeof(float);
  err = cudaFuncSetAttribute(sdr_bwd_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wgrad_smem);
  if (err != cudaSuccess) return (int)err;
  sdr_bwd_wgrad_kernel<<<in_n, kWgradThreads, wgrad_smem, s>>>(
      u, w, du_hat, du, dw, db, batch * seq_len, in_n, in_d, out_no, chunk);
  return (int)cudaGetLastError();
}

const char* sdr_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
