// The launch plans of the SDR forward (sdr_fwd.cu, K1) and backward
// (sdr_bwd.cu, K2): what each kernel keeps in shared memory for a capsule
// geometry, and the tiles it takes where that does not fit whole. Host code
// without CUDA's headers, so that any C++17 compiler can check which
// geometries the kernels take (tests/test_torch_routing_redesign.py does).
//
// Every geometry fits somewhere: the prediction kernel and the weight
// gradient tile W[n] over its out and in entries; the recurrence kernels
// keep their per-warp scratch (partial sums and logits) in global memory
// where it does not fit beside one ring slot. What bounds a geometry is
// what a recurrence block must hold: K1 two out vectors and one row of
// u_hat_t, K2 four out vectors, one row and c of every row.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SDR_HOST_DEVICE __host__ __device__
#else
#define SDR_HOST_DEVICE
#endif

namespace sdr {

// the most dynamic shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;
constexpr size_t kMaxSmemFloats = kMaxSmemBytes / sizeof(float);
// compute warps: with the producer, 16 warps a block, for which ptxas
// allows 128 registers a thread (with 16 compute warps, 17 in all, it
// allowed 96, and the register path spilled)
constexpr int kWarps = 15;
constexpr int kComputeThreads = kWarps * 32;
constexpr int kThreads = kComputeThreads + 32;  // and one producer warp
constexpr int kMinStages = 3;                   // ring slots to aim for
constexpr int kPredictThreads = 256;
constexpr int kPredictRows = 64;  // u rows staged at once, at most
constexpr int kPredictRowsPerBlock = 128;
constexpr int kWgradMaxRows = 16;  // du_hat rows rebuilt at once, at most
// weight-gradient work items (an in-capsule and a chunk of B*T rows) per
// resident block: the last round of items leaves at most 1/8 idle
constexpr int kItemsPerSlot = 8;

SDR_HOST_DEVICE inline int row_pitch(int out_no) {
  return (out_no + 3) / 4 * 4;
}

// log2(out_d) if out_d is a power of two <= 32 (the squash sums over
// shuffle groups), else -1 (a thread per entry sums its capsule)
inline int group_shift(int out_d) {
  for (int s = 0; s <= 5; ++s) {
    if (out_d == (1 << s)) return s;
  }
  return -1;
}

struct RowGeom {
  int out_n, out_d, out_no, pitch;
  int shift;  // group_shift(out_d)
};

inline RowGeom row_geom(int out_n, int out_d) {
  RowGeom g;
  g.out_n = out_n;
  g.out_d = out_d;
  g.out_no = out_n * out_d;
  g.pitch = row_pitch(g.out_no);
  g.shift = group_shift(out_d);
  return g;
}

// Out capsules per lane of the register path for this geometry (1 or 2),
// or 0 where the geometry takes warp_pass_rows (one row per warp per
// chunk). The register path is built for the capsule dims the recipes use:
// 8 (TIMIT) and 20 (WSJ).
inline int lane_caps(const RowGeom& g) {
  const int per_lane = (g.out_n + 31) / 32;
  if (g.out_d == 8 && per_lane <= 2) return per_lane;
  if (g.out_d == 20 && per_lane == 1) return 1;
  return 0;
}

// Rows per warp per chunk of the register path: as many as its registers
// hold (two independent chains or more to interleave).
SDR_HOST_DEVICE constexpr int lane_rows(int d, int no) {
  return d * no <= 8 ? 4 : d * no <= 16 ? 2 : 1;
}

// Rows per warp per chunk for this geometry.
inline int pass_rows(const RowGeom& g) {
  const int no = lane_caps(g);
  return no ? lane_rows(g.out_d, no) : 1;
}

// The ring: `stages` slots of `chunk` in-capsule rows of u_hat_t each.
struct Ring {
  int chunk, stages, chunks_per_pass;
};

// Chooses the ring for `fixed_bytes` of other shared memory and `per_warp`
// rows per warp per chunk: chunks of kWarps * per_warp rows, halved while
// fewer than kMinStages slots fit, then as many slots as fit, up to two
// passes' worth. False if not one row fits.
inline bool plan_ring(int in_n, int pitch, int per_warp, size_t fixed_bytes,
                      Ring* r) {
  const size_t row_bytes = (size_t)pitch * sizeof(float);
  const size_t bar_bytes = 2 * sizeof(uint64_t);  // a slot's two barriers
  if (fixed_bytes + row_bytes + bar_bytes > kMaxSmemBytes) return false;
  const size_t room = kMaxSmemBytes - fixed_bytes;
  int chunk = kWarps * per_warp;
  while (chunk > 1 && kMinStages * (chunk * row_bytes + bar_bytes) > room) {
    chunk = chunk > kWarps ? chunk / 2 : chunk - 1;
  }
  if (chunk > in_n) chunk = in_n;
  r->chunk = chunk;
  r->chunks_per_pass = (in_n + chunk - 1) / chunk;
  size_t stages = room / (chunk * row_bytes + bar_bytes);
  const size_t most = 2 * (size_t)r->chunks_per_pass;
  if (stages > most) stages = most;
  r->stages = (int)stages;
  return true;
}

inline size_t ring_bytes(const Ring& r, int pitch) {
  return (size_t)r.stages * r.chunk * pitch * sizeof(float) +
         2 * (size_t)r.stages * sizeof(uint64_t);
}

// Floats of a recurrence block's per-warp scratch: the partial sums
// [kWarps, out_no] and the general path's logits [kWarps, out_n], rounded
// up to a multiple of 4.
SDR_HOST_DEVICE inline size_t warp_floats(const RowGeom& g) {
  return ((size_t)kWarps * (g.out_no + g.out_n) + 3) / 4 * 4;
}

// The prediction kernel's tiles: W[n] is staged o_tile out entries by
// j_tile in entries at a time, with `rows` rows of u (a multiple of 4).
struct PredictPlan {
  int o_tile, j_tile, rows;
};

inline size_t predict_smem_floats(const PredictPlan& p) {
  return (size_t)p.j_tile * p.o_tile + p.o_tile +
         (size_t)(p.rows + 3) * p.j_tile;
}

// All of W[n] and kPredictRows rows where they fit (every recipe's
// geometry); else fewer out entries (down to 32), then fewer rows (down to
// 4), then fewer in entries.
inline PredictPlan plan_predict(int in_d, int out_no) {
  PredictPlan p{out_no, in_d, kPredictRows};
  while (predict_smem_floats(p) > kMaxSmemFloats) {
    if (p.o_tile > 32) {
      p.o_tile = (p.o_tile + 1) / 2;
    } else if (p.rows > 4) {
      p.rows /= 2;
    } else {
      p.j_tile = (p.j_tile + 1) / 2;
    }
  }
  return p;
}

inline size_t predict_smem_bytes(const PredictPlan& p) {
  return predict_smem_floats(p) * sizeof(float);
}

// A recurrence kernel's plan: its ring, and where its per-warp scratch
// lives. A geometry whose scratch is in global memory takes the general
// path (SDR_PICK), whose partial sums are not written as float4s.
struct StreamPlan {
  RowGeom g;
  Ring r;
  bool warp_global;
};

// Shared memory of a recurrence kernel besides the ring: `vectors` out
// vectors, `rows_c` rows of c, and the per-warp scratch unless it is in
// global memory.
inline size_t stream_fixed_bytes(const StreamPlan& p, int vectors,
                                 size_t rows_c) {
  return ((size_t)vectors * p.g.pitch + rows_c * p.g.out_n +
          (p.warp_global ? 0 : warp_floats(p.g))) *
         sizeof(float);
}

inline bool plan_stream(int in_n, int in_d, int out_n, int out_d,
                        int vectors, bool keeps_c, StreamPlan* p) {
  if (in_n < 1 || in_d < 1 || out_n < 1 || out_d < 1 ||
      (size_t)out_n * out_d > kMaxSmemFloats) {
    return false;
  }
  p->g = row_geom(out_n, out_d);
  const size_t rows_c = keeps_c ? (size_t)in_n : 0;
  for (int global = 0; global < 2; ++global) {
    p->warp_global = global;
    if (plan_ring(in_n, p->g.pitch, global ? 1 : pass_rows(p->g),
                  stream_fixed_bytes(*p, vectors, rows_c), &p->r)) {
      return true;
    }
  }
  return false;
}

// K1's recurrence keeps the agreement vector and s.
constexpr int kFwdVectors = 2;
inline bool plan_fwd(int in_n, int in_d, int out_n, int out_d,
                     StreamPlan* p) {
  return plan_stream(in_n, in_d, out_n, out_d, kFwdVectors, false, p);
}

inline size_t fwd_smem_bytes(const StreamPlan& p) {
  return stream_fixed_bytes(p, kFwdVectors, 0) + ring_bytes(p.r, p.g.pitch);
}

// K2's reverse-time recurrence keeps v_{t-1}, dv, ds, s and c of every row.
constexpr int kBwdVectors = 4;
inline bool plan_bwd(int in_n, int in_d, int out_n, int out_d,
                     StreamPlan* p) {
  return plan_stream(in_n, in_d, out_n, out_d, kBwdVectors, true, p);
}

inline size_t bwd_smem_bytes(const StreamPlan& p, int in_n) {
  return stream_fixed_bytes(p, kBwdVectors, in_n) +
         ring_bytes(p.r, p.g.pitch);
}

// Bytes of dynamic shared memory the recurrence kernel of K1 or K2 takes
// for a geometry, or -1 if it does not fit.
inline int fwd_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  StreamPlan p;
  return plan_fwd(in_n, in_d, out_n, out_d, &p) ? (int)fwd_smem_bytes(p)
                                                : -1;
}

inline int bwd_smem_bytes(int in_n, int in_d, int out_n, int out_d) {
  StreamPlan p;
  return plan_bwd(in_n, in_d, out_n, out_d, &p) ? (int)bwd_smem_bytes(p, in_n)
                                                : -1;
}

// K2's weight-gradient kernel: W[n] and the partial of dW[n] in tiles of
// o_tile out entries by j_tile in entries (a multiple of 4), du_hat rebuilt
// `rows` rows at a time, over `chunks` chunks of rows_per_chunk B*T rows.
struct Wgrad {
  int o_tile, j_tile;
  int dh_pitch;  // a du_hat row in shared memory: o_tile, made odd
  int rows;
  int chunks, rows_per_chunk;
};

inline size_t wgrad_smem_floats(const Wgrad& p) {
  return 2 * (size_t)p.o_tile * p.j_tile + row_pitch(p.o_tile) +
         (size_t)p.rows * (p.j_tile + p.dh_pitch);
}

// All of W[n] and kWgradMaxRows rows where they fit (every recipe's
// geometry); else fewer rows (down to 4), then fewer out entries (down to
// 32), then fewer in entries. `slots`: the blocks the card holds at once
// (0: one chunk).
inline void plan_wgrad(int rows_total, int in_n, int in_d, int out_no,
                       int slots, Wgrad* p) {
  p->o_tile = out_no;
  p->j_tile = (in_d + 3) / 4 * 4;
  p->rows = kWgradMaxRows;
  for (;;) {
    p->dh_pitch = p->o_tile % 2 ? p->o_tile : p->o_tile + 1;
    if (wgrad_smem_floats(*p) <= kMaxSmemFloats) break;
    if (p->rows > 4) {
      p->rows /= 2;
    } else if (p->o_tile > 32) {
      p->o_tile = (p->o_tile + 1) / 2;
    } else {
      p->j_tile = (p->j_tile / 2 + 3) / 4 * 4;
    }
  }
  int chunks = (kItemsPerSlot * slots + in_n - 1) / in_n;
  if (chunks < 1) chunks = 1;
  if (chunks > rows_total) chunks = rows_total;
  p->rows_per_chunk = (rows_total + chunks - 1) / chunks;
  p->chunks = (rows_total + p->rows_per_chunk - 1) / p->rows_per_chunk;
}

}  // namespace sdr
