// Time-blocked, batch-tiled SDR backward for Hopper, sm_90a: K4.
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
// Structure, as K3 (sdr_scan_fwd.cu): one block owns a batch tile of bt
// utterances and walks time backwards in blocks of time_block steps, whose
// u it stages in shared memory together; v_{t-1}, the dv carry, s and ds
// of its utterances live in shared memory. Each step rebuilds u_hat in row
// tiles (each W row loaded once for all bt utterances), in two passes as
// K2: the logits, c and s, then the per-row backward; du is formed in the
// step from the tile's du_hat and W. The last time block holds fewer
// steps; no padded step exists, so none contributes.
//
// What makes it K4 and not a second K2: dW and db are accumulated inside
// the kernel. No du_hat [B, T, in_n, out_n*out_d] goes through HBM and
// there is no separate weight-gradient pass over one. The accumulator is a
// per-block partial of dW and db (W's shape plus bias's: 0.78-1.63 MB at
// TIMIT) in global memory, resident in L2, folded in once per time block
// and not once per step: during a time block each step stages the factors
// of du_hat, c and da [bt, in_n, out_n] and ds and v_{t-1} [bt, out_n *
// out_d], in the block's slice of a scratch buffer; at the block's end one
// thread per (n, o, i) rebuilds du_hat = c ds + da v_{t-1} for every
// (step, utterance) of the time block and adds sum du_hat u[:, n, :] and
// sum du_hat to its entries of the partial. A second launch sums the
// per-block partials in block order into dW and db. No float atomics: each
// sum has one owner and a fixed order, so two calls are bit-equal.
//
// Bytes, against sdr_bwd.cu's argument that a per-step accumulator reads
// and writes all of W once per step per block (at layer 0, (180, 30, 8,
// 8), 2 x 1.55 MB a step for one utterance against du_hat's 2 x 173 KB).
// Per utterance-step at layer 0 with bt 2 and time_block 8:
//   K2: du_hat written and read, 346 KB through HBM;
//   K4: the factors written and read, 2 x 45 KB, plus the partial read and
//       written once per time block, 2 x 1.55 MB / (8 x 2) = 194 KB: 284 KB,
//       all in L2; and once per call the reduction reads 15 x 1.55 MB.
// The partial's share falls as bt x time_block grows.
//
// The tile, chosen as K3's by plan() (u staged for time_block steps, the
// rest per utterance: v_{t-1}, dv, s, ds, c for every row; at most 6 row
// tiles a step for bt > 1). At TIMIT, time_block 8, B = 29:
//   (180, 30, 8, 8)  bt 2, 15 blocks, 5 tiles of 36 rows, 219 KB
//   ( 90, 30, 8, 8)  bt 4,  8 blocks, 5 tiles of 18 rows, 227 KB
//   ( 90, 63, 8, 8)  bt 2, 15 blocks, 4 tiles of 23 rows, 211 KB
// A pass over W reads blocks x |W| over the batch: 20.7, 5.5 and 21.8 MB,
// against K2's 29 x |W|, 40.1, 20.0 and 42.1 MB. A step makes three here
// (the two rebuilds of u_hat and du) and one or two in K2's step kernel.
//
// What bounds it on this card: as for K2, the serial dependence over time
// (a step is two passes of reductions across block barriers); the bytes
// and FLOPs are small against 3.35 TB/s and 67 TFLOP/s. wgmma, TMA and
// clusters are later work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 1024;        // scan kernel
constexpr int kReduceThreads = 256;   // reduction kernel
constexpr int kMaxBatchTile = 8;      // utterances per block at most
constexpr int kMaxTiles = 6;          // u_hat row tiles per step, bt > 1
constexpr int kFoldJ = 8;             // dW entries per thread per fold pass
constexpr float kPadLogit = -1e9f;    // routing.py NEG_INF
constexpr float kSquashEps = 1e-7f;   // squash.py epsilon
// the most dynamic shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;

struct Geometry {
  int in_n, in_d, out_n, out_d;
  int bt;      // utterances per block (the batch tile)
  int tb;      // steps of u staged at once (the time block)
  int tile_n;  // in-capsule rows of u_hat per tile
  int groups;  // partial sums kept per entry of s and of the carry
  int vec4;    // W rows and u rows can be read as float4
};

// floats of shared memory for u_hat tiles of `rows` in-capsule rows
size_t smem_floats(const Geometry& g, int rows) {
  const size_t out_no = (size_t)g.out_n * g.out_d;
  return (size_t)g.tb * g.bt * g.in_n * g.in_d         // staged u
         + 4 * (size_t)g.bt * out_no                   // v_{t-1}, dv, s, ds
         + (size_t)g.bt * g.in_n * g.out_n             // c, every row
         + (size_t)rows * g.bt * (g.out_n + out_no)    // dc/da, u_hat tiles
         + (size_t)g.groups * g.bt * out_no;           // partial sums
}

// floats one (step, utterance) stages for the fold: c, da, ds, v_{t-1}
__host__ __device__ size_t step_floats(const Geometry& g) {
  return 2 * (size_t)g.in_n * g.out_n + 2 * (size_t)g.out_n * g.out_d;
}

// floats of one block's partial of dW and db
__host__ __device__ size_t partial_floats(const Geometry& g) {
  return (size_t)g.in_n * g.out_n * g.out_d * (g.in_d + 1);
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
  const int blocks = (batch + bt - 1) / bt;
  return fit(g, (batch + blocks - 1) / blocks) > 0;
}

// u_hat of the tile's rows n0..n0+rows-1 for the nb utterances of uk
// ([bt, in_n, in_d]): one thread per (n, o, i) loads W[n,o,i,:] and
// bias[n,o,i] once and applies them to all of them
__device__ void predict_tile(const float* __restrict__ w,
                             const float* __restrict__ bias, const float* uk,
                             float* uhat_s, int n0, int rows, int nb,
                             const Geometry& g) {
  const int out_no = g.out_n * g.out_d;
  const int in_nd = g.in_n * g.in_d;
  for (int e = threadIdx.x; e < rows * out_no; e += blockDim.x) {
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
          if (b < nb) acc[b] = fmaf(a, uk[b * in_nd + n * g.in_d + j], acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kMaxBatchTile; ++b) {
      if (b < nb) uhat_s[(b * g.tile_n + r) * out_no + e % out_no] = acc[b];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sdr_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ vs,
                    const float* __restrict__ dvs, float* __restrict__ du,
                    float* stage, float* partial, int batch, int seq_len,
                    Geometry g, int mask_pad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int in_nd = g.in_n * g.in_d;
  const int out_no = g.out_n * g.out_d;
  const int in_out_n = g.in_n * g.out_n;
  const int tiles = (g.in_n + g.tile_n - 1) / g.tile_n;
  float* u_s = smem;                                 // [tb, bt, in_n, in_d]
  float* vprev_s = u_s + (size_t)g.tb * g.bt * in_nd;  // [bt, out_no]
  float* dv_s = vprev_s + g.bt * out_no;             // [bt, out_no]
  float* s_s = dv_s + g.bt * out_no;                 // [bt, out_no]
  float* ds_s = s_s + g.bt * out_no;                 // [bt, out_no]
  float* c_s = ds_s + g.bt * out_no;                 // [bt, in_n, out_n]
  float* da_s = c_s + g.bt * in_out_n;               // [bt, tile_n, out_n]
  float* uhat_s = da_s + g.bt * g.tile_n * g.out_n;  // [bt, tile_n, out_no]
  float* part_s = uhat_s + g.bt * g.tile_n * out_no; // [groups, nb, out_no]

  const int b0 = blockIdx.x * g.bt;
  const int nb = min(g.bt, batch - b0);  // utterances of this block
  const int nb_out = nb * out_no;
  const size_t sf = step_floats(g);
  // this block's staged factors [tb, bt] x (c, da, ds, v_{t-1}) and its
  // partial of dW [in_n, out_no, in_d] then db [in_n, out_no]
  float* stage_blk = stage + blockIdx.x * (size_t)g.tb * g.bt * sf;
  float* dw_part = partial + blockIdx.x * partial_floats(g);
  float* db_part = dw_part + (size_t)in_out_n * g.out_d * g.in_d;

  for (int q = tid; q < nb_out; q += nthr) dv_s[q] = 0.f;  // the carry

  const int n_tblocks = (seq_len + g.tb - 1) / g.tb;
  for (int kb = n_tblocks - 1; kb >= 0; --kb) {
    // ---- stage the time block's u: u_s[k][b] = u[b0 + b, t0 + k] ----
    const int t0 = kb * g.tb;
    const int steps = min(g.tb, seq_len - t0);
    for (int e = tid; e < steps * nb * in_nd; e += nthr) {
      const int k = e / (nb * in_nd);
      const int b = (e / in_nd) % nb;
      const int x = e % in_nd;
      u_s[((size_t)k * g.bt + b) * in_nd + x] =
          u[((size_t)(b0 + b) * seq_len + t0 + k) * in_nd + x];
    }

    for (int k = steps - 1; k >= 0; --k) {
      const int t = t0 + k;
      const float* uk = u_s + (size_t)k * g.bt * in_nd;
      float* stage_k = stage_blk + (size_t)k * g.bt * sf;
      for (int q = tid; q < nb_out; q += nthr) {
        const size_t bt_row = (size_t)(b0 + q / out_no) * seq_len;
        vprev_s[q] = t > 0 ? vs[(bt_row + t - 1) * out_no + q % out_no] : 0.f;
        dv_s[q] += dvs[(bt_row + t) * out_no + q % out_no];
      }
      for (int q = tid; q < g.groups * nb_out; q += nthr) part_s[q] = 0.f;
      __syncthreads();

      // ---- pass 1: rebuild the logits, c and s, tile by tile ----
      for (int n0 = 0; n0 < g.in_n; n0 += g.tile_n) {
        const int rows = min(g.tile_n, g.in_n - n0);
        predict_tile(w, bias, uk, uhat_s, n0, rows, nb, g);
        __syncthreads();

        // logits[b,n,o] = <u_hat[b,n,o,:], v_{t-1}[b,o,:]> (+ PAD mask)
        for (int p = tid; p < nb * rows * g.out_n; p += nthr) {
          const int b = p / (rows * g.out_n);
          const int r = (p / g.out_n) % rows;
          const int o = p % g.out_n;
          const float* uh = uhat_s + (b * g.tile_n + r) * out_no + o * g.out_d;
          const float* v = vprev_s + b * out_no + o * g.out_d;
          float dot = 0.f;
          for (int i = 0; i < g.out_d; ++i) dot = fmaf(uh[i], v[i], dot);
          if (mask_pad && o == 0) dot += kPadLogit;
          c_s[(b * g.in_n + n0 + r) * g.out_n + o] = dot;
        }
        __syncthreads();

        // c = softmax over the out capsules, in place; a thread per row
        for (int p = tid; p < nb * rows; p += nthr) {
          float* c = c_s + ((p / rows) * g.in_n + n0 + p % rows) * g.out_n;
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

        // s[b,o,i] += sum over the tile's rows of c * u_hat
        for (int q = tid; q < g.groups * nb_out; q += nthr) {
          const int grp = q / nb_out;
          const int b = (q / out_no) % nb;
          const int oi = q % out_no;
          const float* c = c_s + (b * g.in_n + n0) * g.out_n + oi / g.out_d;
          const float* uh = uhat_s + b * g.tile_n * out_no + oi;
          float acc = part_s[q];
          for (int r = grp; r < rows; r += g.groups) {
            acc = fmaf(c[r * g.out_n], uh[r * out_no], acc);
          }
          part_s[q] = acc;
        }
        __syncthreads();
      }
      for (int q = tid; q < nb_out; q += nthr) {
        float s = 0.f;
        for (int grp = 0; grp < g.groups; ++grp) s += part_s[grp * nb_out + q];
        s_s[q] = s;
      }
      __syncthreads();

      // ---- squash backward: ds = dv f(q) + 2 s (sum_i dv s) f'(q); stage
      //      ds, v_{t-1} and c for the fold ----
      for (int q = tid; q < nb_out; q += nthr) {
        const int base = (q / g.out_d) * g.out_d;
        float sq = 0.f, dvs_dot = 0.f;
        for (int i = 0; i < g.out_d; ++i) {
          sq = fmaf(s_s[base + i], s_s[base + i], sq);
          dvs_dot = fmaf(dv_s[base + i], s_s[base + i], dvs_dot);
        }
        const float inv_sqrt = 1.f / sqrtf(sq + kSquashEps);
        const float ratio = sq / (1.f + sq);
        const float f = ratio * inv_sqrt;
        const float dfdq = inv_sqrt / ((1.f + sq) * (1.f + sq)) -
                           0.5f * ratio * (inv_sqrt / (sq + kSquashEps));
        const float ds = dv_s[q] * f + 2.f * s_s[q] * (dvs_dot * dfdq);
        ds_s[q] = ds;
        float* st = stage_k + (q / out_no) * sf + 2 * in_out_n + q % out_no;
        st[0] = ds;
        st[out_no] = vprev_s[q];
      }
      for (int e = tid; e < nb * in_out_n; e += nthr) {
        stage_k[(e / in_out_n) * sf + e % in_out_n] = c_s[e];
      }
      for (int q = tid; q < g.groups * nb_out; q += nthr) part_s[q] = 0.f;
      __syncthreads();

      // ---- pass 2: the per-row backward, tile by tile ----
      for (int n0 = 0; n0 < g.in_n; n0 += g.tile_n) {
        const int rows = min(g.tile_n, g.in_n - n0);
        if (tiles > 1) {
          predict_tile(w, bias, uk, uhat_s, n0, rows, nb, g);
          __syncthreads();
        }

        // dc[b,n,o] = <u_hat[b,n,o,:], ds[b,o,:]>
        for (int p = tid; p < nb * rows * g.out_n; p += nthr) {
          const int b = p / (rows * g.out_n);
          const int r = (p / g.out_n) % rows;
          const int o = p % g.out_n;
          const float* uh = uhat_s + (b * g.tile_n + r) * out_no + o * g.out_d;
          const float* ds = ds_s + b * out_no + o * g.out_d;
          float dot = 0.f;
          for (int i = 0; i < g.out_d; ++i) dot = fmaf(uh[i], ds[i], dot);
          da_s[(b * g.tile_n + r) * g.out_n + o] = dot;
        }
        __syncthreads();

        // softmax backward, in place: da = c * (dc - sum_o dc * c)
        for (int p = tid; p < nb * rows; p += nthr) {
          const int b = p / rows;
          const int r = p % rows;
          const float* c = c_s + (b * g.in_n + n0 + r) * g.out_n;
          float* da = da_s + (b * g.tile_n + r) * g.out_n;
          float dot = 0.f;
          for (int o = 0; o < g.out_n; ++o) dot = fmaf(da[o], c[o], dot);
          for (int o = 0; o < g.out_n; ++o) da[o] = c[o] * (da[o] - dot);
        }
        __syncthreads();

        // carry[b,o,i] += sum over the tile's rows of da * u_hat
        for (int q = tid; q < g.groups * nb_out; q += nthr) {
          const int grp = q / nb_out;
          const int b = (q / out_no) % nb;
          const int oi = q % out_no;
          const float* da = da_s + b * g.tile_n * g.out_n + oi / g.out_d;
          const float* uh = uhat_s + b * g.tile_n * out_no + oi;
          float acc = part_s[q];
          for (int r = grp; r < rows; r += g.groups) {
            acc = fmaf(da[r * g.out_n], uh[r * out_no], acc);
          }
          part_s[q] = acc;
        }
        // stage da for the fold
        for (int p = tid; p < nb * rows * g.out_n; p += nthr) {
          const int b = p / (rows * g.out_n);
          const int r = (p / g.out_n) % rows;
          stage_k[b * sf + in_out_n + (n0 + r) * g.out_n + p % g.out_n] =
              da_s[(b * g.tile_n + r) * g.out_n + p % g.out_n];
        }
        // du[b,t,n,j] = sum_oi du_hat[b,n,oi] W[n,oi,j], du_hat = c ds +
        // da v_{t-1}; one thread per (b, n, j)
        for (int p = tid; p < nb * rows * g.in_d; p += nthr) {
          const int b = p / (rows * g.in_d);
          const int r = (p / g.in_d) % rows;
          const int j = p % g.in_d;
          const int n = n0 + r;
          const float* c = c_s + (b * g.in_n + n) * g.out_n;
          const float* da = da_s + (b * g.tile_n + r) * g.out_n;
          const float* ds = ds_s + b * out_no;
          const float* vp = vprev_s + b * out_no;
          const float* w_nj = w + (size_t)n * out_no * g.in_d + j;
          float acc = 0.f;
          for (int oi = 0; oi < out_no; ++oi) {
            const int o = oi / g.out_d;
            const float dh = fmaf(c[o], ds[oi], da[o] * vp[oi]);
            acc = fmaf(dh, __ldg(w_nj + (size_t)oi * g.in_d), acc);
          }
          du[((size_t)(b0 + b) * seq_len + t) * in_nd + n * g.in_d + j] = acc;
        }
        __syncthreads();
      }
      for (int q = tid; q < nb_out; q += nthr) {
        float carry = 0.f;
        for (int grp = 0; grp < g.groups; ++grp) {
          carry += part_s[grp * nb_out + q];
        }
        dv_s[q] = carry;
      }
      __syncthreads();
    }

    // ---- fold the time block into the block's partial of dW and db: one
    //      thread per (n, o, i), over the block's steps and utterances ----
    const bool first = kb == n_tblocks - 1;
    for (int e = tid; e < in_out_n * g.out_d; e += nthr) {
      const int n = e / out_no;
      const int oi = e % out_no;
      const int c_at = n * g.out_n + oi / g.out_d;
      for (int j0 = 0; j0 < g.in_d; j0 += kFoldJ) {
        float acc[kFoldJ];
#pragma unroll
        for (int jj = 0; jj < kFoldJ; ++jj) acc[jj] = 0.f;
        float acc_b = 0.f;
        for (int k = 0; k < steps; ++k) {
          for (int b = 0; b < nb; ++b) {
            const float* st = stage_blk + ((size_t)k * g.bt + b) * sf;
            const float dh = fmaf(st[c_at], st[2 * in_out_n + oi],
                                  st[in_out_n + c_at] *
                                      st[2 * in_out_n + out_no + oi]);
            acc_b += dh;
            const float* uu =
                u_s + ((size_t)k * g.bt + b) * in_nd + n * g.in_d + j0;
#pragma unroll
            for (int jj = 0; jj < kFoldJ; ++jj) {
              if (j0 + jj < g.in_d) acc[jj] = fmaf(dh, uu[jj], acc[jj]);
            }
          }
        }
        float* dw_e = dw_part + (size_t)e * g.in_d + j0;
#pragma unroll
        for (int jj = 0; jj < kFoldJ; ++jj) {
          if (j0 + jj < g.in_d) dw_e[jj] = (first ? 0.f : dw_e[jj]) + acc[jj];
        }
        if (j0 == 0) db_part[e] = (first ? 0.f : db_part[e]) + acc_b;
      }
    }
    __syncthreads();
  }
}

// dW and db: the sum of the blocks' partials, in block order; one thread
// per entry
__global__ void __launch_bounds__(kReduceThreads)
sdr_scan_bwd_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ dw, float* __restrict__ db,
                           int blocks, int dw_size, int db_size) {
  const int per_block = dw_size + db_size;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < per_block;
       e += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int blk = 0; blk < blocks; ++blk) {
      sum += partial[(size_t)blk * per_block + e];
    }
    if (e < dw_size) {
      dw[e] = sum;
    } else {
      db[e - dw_size] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Utterances per block the kernel takes for this problem, or -1 if the
// geometry does not fit in one block's shared memory.
int sdr_scan_bwd_batch_tile(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d, int time_block) {
  Geometry g;
  if (!plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return -1;
  }
  return g.bt;
}

// Bytes of dynamic shared memory the scan kernel needs for this problem,
// or -1 if it does not fit in one block.
int sdr_scan_bwd_smem_bytes(int batch, int seq_len, int in_n, int in_d,
                            int out_n, int out_d, int time_block) {
  Geometry g;
  if (!plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return -1;
  }
  return (int)(smem_floats(g, g.tile_n) * sizeof(float));
}

// Floats of the scratch buffer sdr_scan_bwd needs (every block's staged
// factors, then every block's partial of dW and db), or -1.
long long sdr_scan_bwd_scratch_floats(int batch, int seq_len, int in_n,
                                      int in_d, int out_n, int out_d,
                                      int time_block) {
  Geometry g;
  if (!plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return -1;
  }
  const long long blocks = (batch + g.bt - 1) / g.bt;
  return blocks * ((long long)g.tb * g.bt * step_floats(g) +
                   (long long)partial_floats(g));
}

// u [batch, seq_len, in_n, in_d], w [in_n, out_n, out_d, in_d],
// bias [in_n, out_n, out_d], the forward's output vs and its cotangent dvs
// [batch, seq_len, out_n, out_d] -> du (shape of u), dw (of w), db (of
// bias); scratch holds sdr_scan_bwd_scratch_floats floats. float32,
// contiguous, on the current device. Launches the scan kernel and the
// reduction on `stream` and returns the first launch error (0 on success);
// does not synchronise.
int sdr_scan_bwd(const float* u, const float* w, const float* bias,
                 const float* vs, const float* dvs, float* du, float* dw,
                 float* db, float* scratch, int batch, int seq_len, int in_n,
                 int in_d, int out_n, int out_d, int mask_pad, int time_block,
                 void* stream) {
  Geometry g;
  if (!plan(batch, seq_len, in_n, in_d, out_n, out_d, time_block, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  g.vec4 = (in_d % 4 == 0) && ((uintptr_t)w % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (batch + g.bt - 1) / g.bt;
  float* partial = scratch + (size_t)blocks * g.tb * g.bt * step_floats(g);

  const size_t smem = smem_floats(g, g.tile_n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdr_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sdr_scan_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      u, w, bias, vs, dvs, du, scratch, partial, batch, seq_len, g,
      mask_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int db_size = in_n * out_n * out_d;
  const int dw_size = db_size * in_d;
  int grid = (dw_size + db_size + kReduceThreads - 1) / kReduceThreads;
  if (grid > 1024) grid = 1024;
  sdr_scan_bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      partial, dw, db, blocks, dw_size, db_size);
  return (int)cudaGetLastError();
}

const char* sdr_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
