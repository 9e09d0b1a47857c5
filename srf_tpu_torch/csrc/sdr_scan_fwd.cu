// Time-blocked, batch-tiled SDR forward for Hopper, sm_90a: K3.
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
// the mask): the kernel keeps that sum of v's (vsum) and never stores the
// logits, so u_hat is built, scored, soft-maxed and folded into s one tile
// of in-capsule rows at a time, and rebuilt for each further iteration.
//
// What makes it K3 and not a second K1 is its structure:
// - Batch tile. One block owns `bt` utterances. Each W row it loads (in_d
//   floats, by one thread) is applied to all of them before it is dropped,
//   so a step reads W from L2 once per block, where K1 reads it once per
//   utterance.
// - Time block. `time_block` steps of u for the block's utterances are
//   staged in shared memory together, and the time loop runs inside the
//   block; v stays in shared memory across the whole scan.
// Padding to the batch tile and to the time block is the kernel's own: the
// last tile holds fewer utterances and the last time block fewer steps.
//
// The tile. plan() takes the largest bt <= 8 (and <= B) for which the
// staged u, v, vsum, s and the partial sums leave room in the 227 KB of
// shared memory for a u_hat row tile such that a step needs at most 6
// tiles, then spreads B evenly over ceil(B / bt) blocks. At the TIMIT
// geometries (in_n, out_n, out_d, in_d), time_block 8, B = 29:
//   (180, 30, 8, 8)  bt 2, 15 blocks, 3 tiles of 60 rows, 226 KB
//   ( 90, 30, 8, 8)  bt 5,  6 blocks, 5 tiles of 18 rows, 226 KB
//   ( 90, 63, 8, 8)  bt 3, 10 blocks, 5 tiles of 18 rows, 211 KB
// Bytes of W (and bias, 1/8 more) each step reads from L2, per routing
// iteration, over the whole batch: blocks x |W|. K1: 29 x |W|.
//   (180, 30, 8, 8)  |W| 1.38 MB: K3 20.7 MB, K1 40.1 MB
//   ( 90, 30, 8, 8)  |W| 0.69 MB: K3  4.1 MB, K1 20.0 MB
//   ( 90, 63, 8, 8)  |W| 1.45 MB: K3 14.5 MB, K1 42.1 MB
//
// What bounds it on this card: as for K1, the serial dependence over time.
// Step t needs v_{t-1}, and a step is a chain of reductions across block
// barriers (4 per row tile per iteration); the bytes and FLOPs are small
// against 3.35 TB/s and 67 TFLOP/s. The batch tile cuts the L2 traffic of
// W by bt, but a block now does bt utterances' arithmetic per step, and
// fewer SMs are busy (15, 6 and 10 of 132 at B = 29 against K1's 29).
// wgmma, TMA and clusters are later work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBatchTile = 8;      // utterances per block at most
constexpr int kMaxTiles = 6;          // u_hat row tiles per step, bt > 1
constexpr float kPadLogit = -1e9f;    // routing.py NEG_INF
constexpr float kSquashEps = 1e-7f;   // squash.py epsilon
// the most dynamic shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;

struct Geometry {
  int in_n, in_d, out_n, out_d;
  int bt;      // utterances per block (the batch tile)
  int tb;      // steps of u staged at once (the time block)
  int tile_n;  // in-capsule rows of u_hat per tile
  int groups;  // partial sums kept per entry of s
  int vec4;    // W rows and u rows can be read as float4
};

// floats of shared memory for u_hat tiles of `rows` in-capsule rows
size_t smem_floats(const Geometry& g, int rows) {
  const size_t out_no = (size_t)g.out_n * g.out_d;
  return (size_t)g.tb * g.bt * g.in_n * g.in_d         // staged u
         + 3 * (size_t)g.bt * out_no                   // v, vsum, s
         + (size_t)rows * g.bt * (g.out_n + out_no)    // c and u_hat tiles
         + (size_t)g.groups * g.bt * out_no;           // partial sums of s
}

// Sets the batch tile `bt` and the row tile for it; returns the number of
// row tiles a step needs, or 0 if not even one row fits.
int fit(Geometry* g, int bt) {
  const int out_no = g->out_n * g->out_d;
  g->bt = bt;
  g->groups = bt * out_no < kThreads ? kThreads / (bt * out_no) : 1;
  const size_t budget = kMaxSmemBytes / sizeof(float);
  const size_t fixed = smem_floats(*g, 0);
  const size_t per_row = (size_t)bt * (g->out_n + out_no);
  if (fixed + per_row > budget) return 0;
  size_t max_rows = (budget - fixed) / per_row;
  if (max_rows > (size_t)g->in_n) max_rows = g->in_n;
  // balance the tiles: ceil(in_n / tiles) rows each
  const int tiles = (g->in_n + (int)max_rows - 1) / (int)max_rows;
  g->tile_n = (g->in_n + tiles - 1) / tiles;
  return tiles;
}

bool plan(int batch, int seq_len, int in_n, int in_d, int out_n, int out_d,
          int time_block, Geometry* g) {
  if (batch < 1 || seq_len < 1 || time_block < 1 || in_n < 1 || in_d < 1 ||
      out_n < 1 || out_d < 1) {
    return false;
  }
  g->in_n = in_n;
  g->in_d = in_d;
  g->out_n = out_n;
  g->out_d = out_d;
  g->tb = time_block < seq_len ? time_block : seq_len;
  g->vec4 = 0;
  int bt = batch < kMaxBatchTile ? batch : kMaxBatchTile;
  for (; bt > 1; --bt) {
    const int tiles = fit(g, bt);
    if (tiles > 0 && tiles <= kMaxTiles) break;
  }
  // the same number of blocks, with the utterances spread evenly over them
  const int blocks = (batch + bt - 1) / bt;
  return fit(g, (batch + blocks - 1) / blocks) > 0;
}

__global__ void __launch_bounds__(kThreads, 1)
sdr_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int batch, int seq_len, Geometry g, int num_iter,
                    int mask_pad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int in_nd = g.in_n * g.in_d;
  const int out_no = g.out_n * g.out_d;
  float* u_s = smem;                                 // [tb, bt, in_n, in_d]
  float* v_s = u_s + (size_t)g.tb * g.bt * in_nd;    // [bt, out_no]
  float* vsum_s = v_s + g.bt * out_no;               // [bt, out_no]
  float* s_s = vsum_s + g.bt * out_no;               // [bt, out_no]
  float* c_s = s_s + g.bt * out_no;                  // [bt, tile_n, out_n]
  float* uhat_s = c_s + g.bt * g.tile_n * g.out_n;   // [bt, tile_n, out_no]
  float* part_s = uhat_s + g.bt * g.tile_n * out_no; // [groups, nb, out_no]

  const int b0 = blockIdx.x * g.bt;
  const int nb = min(g.bt, batch - b0);  // utterances of this block
  const int nb_out = nb * out_no;

  for (int q = tid; q < nb_out; q += nthr) v_s[q] = 0.f;

  for (int t0 = 0; t0 < seq_len; t0 += g.tb) {
    // ---- stage the time block's u: u_s[k][b] = u[b0 + b, t0 + k] ----
    const int steps = min(g.tb, seq_len - t0);
    for (int e = tid; e < steps * nb * in_nd; e += nthr) {
      const int k = e / (nb * in_nd);
      const int b = (e / in_nd) % nb;
      const int x = e % in_nd;
      u_s[((size_t)k * g.bt + b) * in_nd + x] =
          u[((size_t)(b0 + b) * seq_len + t0 + k) * in_nd + x];
    }
    __syncthreads();

    for (int k = 0; k < steps; ++k) {
      const float* uk = u_s + (size_t)k * g.bt * in_nd;
      for (int q = tid; q < nb_out; q += nthr) vsum_s[q] = v_s[q];
      __syncthreads();

      for (int it = 0; it < num_iter; ++it) {
        for (int q = tid; q < g.groups * nb_out; q += nthr) part_s[q] = 0.f;

        for (int n0 = 0; n0 < g.in_n; n0 += g.tile_n) {
          const int rows = min(g.tile_n, g.in_n - n0);

          // (a) prediction vectors of the tile's rows for every utterance
          //     of the block: one thread per (n, o, i) loads W[n,o,i,:] and
          //     bias[n,o,i] once and applies them to all nb utterances
#pragma unroll 4
          for (int e = tid; e < rows * out_no; e += nthr) {
            const int r = e / out_no;
            const int n = n0 + r;
            const size_t row = (size_t)n * out_no + e % out_no;
            const float* w_row = w + row * g.in_d;
            const float bias_e = __ldg(bias + row);
            float acc[kMaxBatchTile];
#pragma unroll
            for (int b = 0; b < kMaxBatchTile; ++b) acc[b] = bias_e;
            if (g.vec4) {
              const float4* w4 = reinterpret_cast<const float4*>(w_row);
              for (int j = 0; j < g.in_d / 4; ++j) {
                const float4 a = __ldg(w4 + j);
#pragma unroll
                for (int b = 0; b < kMaxBatchTile; ++b) {
                  if (b < nb) {
                    const float4 x = reinterpret_cast<const float4*>(
                        uk + b * in_nd + n * g.in_d)[j];
                    acc[b] = fmaf(a.x, x.x, acc[b]);
                    acc[b] = fmaf(a.y, x.y, acc[b]);
                    acc[b] = fmaf(a.z, x.z, acc[b]);
                    acc[b] = fmaf(a.w, x.w, acc[b]);
                  }
                }
              }
            } else {
              for (int j = 0; j < g.in_d; ++j) {
                const float a = __ldg(w_row + j);
#pragma unroll
                for (int b = 0; b < kMaxBatchTile; ++b) {
                  if (b < nb) {
                    acc[b] = fmaf(a, uk[b * in_nd + n * g.in_d + j], acc[b]);
                  }
                }
              }
            }
#pragma unroll
            for (int b = 0; b < kMaxBatchTile; ++b) {
              if (b < nb) uhat_s[(b * g.tile_n + r) * out_no + e % out_no] = acc[b];
            }
          }
          __syncthreads();

          // (b) logits[b,n,o] = <u_hat[b,n,o,:], vsum[b,o,:]> (+ the mask
          //     once per iteration so far)
          for (int p = tid; p < nb * rows * g.out_n; p += nthr) {
            const int b = p / (rows * g.out_n);
            const int r = (p / g.out_n) % rows;
            const int o = p % g.out_n;
            const float* uh = uhat_s + (b * g.tile_n + r) * out_no + o * g.out_d;
            const float* v = vsum_s + b * out_no + o * g.out_d;
            float dot = 0.f;
            for (int i = 0; i < g.out_d; ++i) dot = fmaf(uh[i], v[i], dot);
            if (mask_pad && o == 0) dot += (float)(it + 1) * kPadLogit;
            c_s[(b * g.tile_n + r) * g.out_n + o] = dot;
          }
          __syncthreads();

          // (c) coupling coefficients: softmax over the out capsules, in
          //     place, one thread per (utterance, in-capsule row)
          for (int p = tid; p < nb * rows; p += nthr) {
            float* c = c_s + ((p / rows) * g.tile_n + p % rows) * g.out_n;
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

          // (d) s[b,o,i] += sum over the tile's rows of c * u_hat; `groups`
          //     partial sums per entry, each owned by one thread
          for (int q = tid; q < g.groups * nb_out; q += nthr) {
            const int grp = q / nb_out;
            const int b = (q / out_no) % nb;
            const int oi = q % out_no;
            const int o = oi / g.out_d;
            const float* c = c_s + b * g.tile_n * g.out_n + o;
            const float* uh = uhat_s + b * g.tile_n * out_no + oi;
            float acc = part_s[q];
            for (int r = grp; r < rows; r += g.groups) {
              acc = fmaf(c[r * g.out_n], uh[r * out_no], acc);
            }
            part_s[q] = acc;
          }
          __syncthreads();
        }

        // (e) s = the sum of the partial sums
        for (int q = tid; q < nb_out; q += nthr) {
          float s = 0.f;
          for (int grp = 0; grp < g.groups; ++grp) s += part_s[grp * nb_out + q];
          s_s[q] = s;
        }
        __syncthreads();

        // (f) v = squash(s) per out capsule; vsum gathers the v's the next
        //     iteration's logits agree with
        for (int q = tid; q < nb_out; q += nthr) {
          const float* s = s_s + (q / g.out_d) * g.out_d;
          float sq = 0.f;
          for (int i = 0; i < g.out_d; ++i) sq = fmaf(s[i], s[i], sq);
          const float v = (sq / (1.f + sq)) * (s_s[q] / sqrtf(sq + kSquashEps));
          v_s[q] = v;
          vsum_s[q] += v;
        }
        __syncthreads();
      }

      for (int q = tid; q < nb_out; q += nthr) {
        out[((size_t)(b0 + q / out_no) * seq_len + t0 + k) * out_no +
            q % out_no] = v_s[q];
      }
    }
  }
}

}  // namespace

extern "C" {

// Utterances per block the kernel takes for this problem, or -1 if the
// geometry does not fit in one block's shared memory.
int sdr_scan_fwd_batch_tile(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d, int time_block) {
  Geometry g;
  if (!plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return -1;
  }
  return g.bt;
}

// Bytes of dynamic shared memory the kernel needs for this problem, or -1
// if it does not fit in one block.
int sdr_scan_fwd_smem_bytes(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d, int time_block) {
  Geometry g;
  if (!plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return -1;
  }
  return (int)(smem_floats(g, g.tile_n) * sizeof(float));
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d] -> out [batch, seq_len, out_n, out_d]; float32,
// contiguous, on the current device. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
int sdr_scan_fwd(const float* u, const float* w, const float* bias,
                 float* out, int batch, int seq_len, int in_n, int in_d,
                 int out_n, int out_d, int num_iter, int mask_pad,
                 int time_block, void* stream) {
  Geometry g;
  if (num_iter < 1 ||
      !plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  g.vec4 = (in_d % 4 == 0) && ((uintptr_t)w % 16 == 0);
  const size_t smem = smem_floats(g, g.tile_n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdr_scan_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + g.bt - 1) / g.bt;
  sdr_scan_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      u, w, bias, out, batch, seq_len, g, num_iter, mask_pad);
  return (int)cudaGetLastError();
}

const char* sdr_scan_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
