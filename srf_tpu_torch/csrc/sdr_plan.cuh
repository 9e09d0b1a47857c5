// The launch plans of the SDR forward (sdr_fwd.cu, K1) and backward
// (sdr_bwd.cu, K2): what each kernel keeps in shared memory for a capsule
// geometry, and the tiles it takes where that does not fit whole; and of
// the cluster scan (sdr_scan_fwd.cu, K3; sdr_scan_bwd.cu, K4): the batch
// tile, the cluster, each CTA's rows and what it keeps in shared memory
// (plan_scan, at the end). Host code without CUDA's headers, so that any
// C++17 compiler can check which geometries the kernels take
// (tests/test_torch_routing_redesign.py and
// tests/test_torch_routing_scan_cluster.py do).
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
// allowed 96, and the register path spilled); the host build of the
// device code (SDR_HOST_SHIM, CPU tests) runs 2, each lane a thread
#ifdef SDR_HOST_SHIM
constexpr int kWarps = 2;
#else
constexpr int kWarps = 15;
#endif
constexpr int kComputeThreads = kWarps * 32;
constexpr int kThreads = kComputeThreads + 32;  // and one producer warp
constexpr int kMinStages = 3;                   // ring slots to aim for
// the prediction kernel (plan_predict): threads a block, at most (for
// which ptxas allows 128 registers a thread); quads of in entries of W a
// thread keeps in registers (in_d <= 20 in one tile: every recipe's);
// stages of the ring of units' u rows (two ahead of the one computed) and
// their floats, at most; rows a unit, at most; out quads an out tile keeps
// where out tiles split a small call
constexpr int kPredictMaxThreads = 512;
constexpr int kPredictMaxJq = 5;
constexpr int kPredictStages = 3;
constexpr int kPredictStageFloats = 4096;
constexpr int kPredictRows = 16;
constexpr int kPredictMinQuads = 32;

SDR_HOST_DEVICE inline int row_pitch(int out_no) {
  return (out_no + 3) / 4 * 4;
}

// The pitch of a u_hat row of `esize`-byte entries (4: float32, 2: the bf16
// variants' u_hat): out_no rounded up to 16 bytes' worth of entries.
SDR_HOST_DEVICE inline int row_pitch(int out_no, int esize) {
  const int per16 = 16 / esize;
  return (out_no + per16 - 1) / per16 * per16;
}

// log2(out_d) if out_d is a power of two <= 32 (the squash sums over
// shuffle groups), else -1 (a thread per entry sums its capsule)
inline int group_shift(int out_d) {
  for (int s = 0; s <= 5; ++s) {
    if (out_d == (1 << s)) return s;
  }
  return -1;
}

// pitch: entries of a u_hat row (and floats of an out vector in shared
// memory); esize: bytes of a u_hat entry, 4 (float32) or 2 (bf16)
struct RowGeom {
  int out_n, out_d, out_no, pitch;
  int shift;  // group_shift(out_d)
  int esize;
};

inline RowGeom row_geom(int out_n, int out_d, int esize = 4) {
  RowGeom g;
  g.out_n = out_n;
  g.out_d = out_d;
  g.out_no = out_n * out_d;
  g.pitch = row_pitch(g.out_no, esize);
  g.shift = group_shift(out_d);
  g.esize = esize;
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
inline bool plan_ring(int in_n, size_t row_bytes, int per_warp,
                      size_t fixed_bytes, Ring* r) {
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

inline size_t ring_bytes(const Ring& r, const RowGeom& g) {
  return (size_t)r.stages * r.chunk * g.pitch * g.esize +
         2 * (size_t)r.stages * sizeof(uint64_t);
}

// Floats of a recurrence block's per-warp scratch: the partial sums
// [kWarps, out_no] and the general path's logits [kWarps, out_n], rounded
// up to a multiple of 4.
SDR_HOST_DEVICE inline size_t warp_floats(const RowGeom& g) {
  return ((size_t)kWarps * (g.out_no + g.out_n) + 3) / 4 * 4;
}

// The prediction kernel's plan (sdr_stream.cuh). A block of o_quads *
// groups threads, a thread an out quad (4 out entries) of one of `groups`
// neighbouring in-capsules, keeps the quad's rows of W[n] in registers, jq
// quads of in entries (j_tile of them real, the rest -0), and its bias.
// The work is `units` units (out tile, group of in-capsules, tile of
// tile_rows B*T rows), n-major within an out tile; block b of `blocks`
// takes the contiguous run of units [b * units / blocks, (b + 1) * units /
// blocks), its u rows staged into a ring of kPredictStages stages of
// shared memory ahead of the unit it computes, and reloads its W registers
// only where the run moves to another (out tile, group). A row of a unit
// reads groups * in_d contiguous u entries and writes groups * pitch
// contiguous u_hat entries. Its tiled path takes in_d in one tile of in
// entries (predict_tiled); the general path (in_d > 4 * kPredictMaxJq)
// walks the run once per tile of j_tile in entries, each adding its share
// to the u_hat entries it wrote for the tiles before.
struct PredictPlan {
  int jq, j_tile;
  int o_tiles, o_quads;   // out tiles, out quads a tile
  int groups, n_groups;   // in-capsules a unit; their groups
  int tile_rows, row_tiles;  // rows a unit; units an (out tile, group)
  long long units;
  int blocks;
};

// Whether the prediction takes in_d in one tile of in entries (its tiled
// path).
inline bool predict_tiled(int in_d) { return in_d <= 4 * kPredictMaxJq; }

inline int predict_threads(const PredictPlan& p) {
  return p.o_quads * p.groups;
}

// Floats of a stage of the ring: a unit's u rows [tile_rows][groups] of jq
// float4s each.
SDR_HOST_DEVICE inline int predict_stage_floats(const PredictPlan& p) {
  return p.tile_rows * p.groups * p.jq * 4;
}

inline size_t predict_smem_bytes(const PredictPlan& p) {
  return (size_t)kPredictStages * predict_stage_floats(p) * sizeof(float);
}

// Of the group sizes from most / 2 + 1 to most, the one that leaves the
// fewest idle in-capsule slots in the last group (the larger on a tie).
inline int predict_groups(int in_n, int most) {
  int best = most, idle = -1;
  for (int g = most; g > most / 2; --g) {
    const int left = (in_n + g - 1) / g * g - in_n;
    if (idle < 0 || left < idle) {
      best = g;
      idle = left;
    }
  }
  return best;
}

// The plan of a call of rows_total B*T rows on a card that holds `slots`
// blocks at once. Out tiles: as few as keep a block within
// kPredictMaxThreads threads. Groups of in-capsules: as large as fit
// beside the out quads and in a stage (a unit of one row), no more than
// in_n. A unit: up to kPredictRows rows, as many as a stage holds. Where
// that leaves fewer units than slots (a small call: a streaming push, a
// short batch, a shard's few out capsules), units take fewer rows, then
// groups fewer in-capsules, then out tiles fewer out quads (down to
// kPredictMinQuads), until every slot has a unit. `esize`: bytes of a
// u_hat entry (4, or 2 for the bf16 instance).
inline void plan_predict(int rows_total, int in_n, int in_d, int out_no,
                         int esize, int slots, PredictPlan* p) {
  *p = PredictPlan{};
  const int quads = row_pitch(out_no, esize) / 4;
  const int jq = (in_d + 3) / 4;
  p->jq = jq < kPredictMaxJq ? jq : kPredictMaxJq;
  p->j_tile = in_d < 4 * p->jq ? in_d : 4 * p->jq;
  if (slots < 1) slots = 1;
  int o_tiles = (quads + kPredictMaxThreads - 1) / kPredictMaxThreads;
  int row_cap = kPredictRows, group_cap = in_n;
  for (;;) {
    p->o_quads = (quads + o_tiles - 1) / o_tiles;
    p->o_tiles = (quads + p->o_quads - 1) / p->o_quads;
    int most = kPredictMaxThreads / p->o_quads;
    if (most > kPredictStageFloats / (4 * p->jq)) {
      most = kPredictStageFloats / (4 * p->jq);
    }
    if (most > group_cap) most = group_cap;
    p->groups = predict_groups(in_n, most);
    p->n_groups = (in_n + p->groups - 1) / p->groups;
    int rows = kPredictStageFloats / (p->groups * 4 * p->jq);
    if (rows > row_cap) rows = row_cap;
    if (rows > rows_total) rows = rows_total;
    p->tile_rows = rows;
    p->row_tiles = (rows_total + p->tile_rows - 1) / p->tile_rows;
    p->units = (long long)p->o_tiles * p->n_groups * p->row_tiles;
    if (p->units >= slots) break;
    if (p->tile_rows > 1) {
      row_cap = (p->tile_rows + 1) / 2;
    } else if (p->groups > 1) {
      group_cap = (p->groups + 1) / 2;
    } else if (p->o_quads >= 2 * kPredictMinQuads) {
      ++o_tiles;
    } else {
      break;
    }
  }
  p->blocks = p->units < slots ? (int)p->units : slots;
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
                        int vectors, bool keeps_c, int esize, StreamPlan* p) {
  if (in_n < 1 || in_d < 1 || out_n < 1 || out_d < 1 ||
      (size_t)out_n * out_d > kMaxSmemFloats) {
    return false;
  }
  // the bf16 variants' prediction kernel takes all of in_d in one tile (it
  // rounds the finished sum, so it cannot carry a partial sum in u_hat)
  if (esize == 2 && !predict_tiled(in_d)) return false;
  p->g = row_geom(out_n, out_d, esize);
  const size_t rows_c = keeps_c ? (size_t)in_n : 0;
  for (int global = 0; global < 2; ++global) {
    p->warp_global = global;
    if (plan_ring(in_n, (size_t)p->g.pitch * esize,
                  global ? 1 : pass_rows(p->g),
                  stream_fixed_bytes(*p, vectors, rows_c), &p->r)) {
      return true;
    }
  }
  return false;
}

// K1's recurrence keeps the agreement vector and s. `esize` is the bytes
// of a u_hat entry: 4, or 2 for the bf16 variant.
constexpr int kFwdVectors = 2;
inline bool plan_fwd(int in_n, int in_d, int out_n, int out_d,
                     StreamPlan* p, int esize = 4) {
  return plan_stream(in_n, in_d, out_n, out_d, kFwdVectors, false, esize, p);
}

inline size_t fwd_smem_bytes(const StreamPlan& p) {
  return stream_fixed_bytes(p, kFwdVectors, 0) + ring_bytes(p.r, p.g);
}

// K2's reverse-time recurrence keeps v_{t-1}, dv, ds, s and c of every row.
constexpr int kBwdVectors = 4;
inline bool plan_bwd(int in_n, int in_d, int out_n, int out_d,
                     StreamPlan* p, int esize = 4) {
  return plan_stream(in_n, in_d, out_n, out_d, kBwdVectors, true, esize, p);
}

inline size_t bwd_smem_bytes(const StreamPlan& p, int in_n) {
  return stream_fixed_bytes(p, kBwdVectors, in_n) + ring_bytes(p.r, p.g);
}

// Bytes of dynamic shared memory the recurrence kernel of K1 or K2 (or of
// their bf16 variants, esize 2) takes for a geometry, or -1 if it does not
// fit.
inline int fwd_smem_bytes(int in_n, int in_d, int out_n, int out_d,
                          int esize = 4) {
  StreamPlan p;
  return plan_fwd(in_n, in_d, out_n, out_d, &p, esize)
             ? (int)fwd_smem_bytes(p)
             : -1;
}

inline int bwd_smem_bytes(int in_n, int in_d, int out_n, int out_d,
                          int esize = 4) {
  StreamPlan p;
  return plan_bwd(in_n, in_d, out_n, out_d, &p, esize)
             ? (int)bwd_smem_bytes(p, in_n)
             : -1;
}

// K2's weight-gradient kernel (sdr_bwd.cu). Its tiled path, taken where
// W[n] fits whole beside a tile of rows and out_no is a multiple of 4
// (every recipe's geometry): one block of kWgradThreads an SM holds W[n]
// as [out entries][j4] float4s (in entries padded to a multiple of 4 with
// zeros), rebuilds du_hat `rows` rows at a time into shared memory
// ([rows][dh_pitch], each of `build_rows` thread groups a row in turn, a
// thread an out quad of it and db's sum over those rows) from the tile's
// factors, which were staged into shared memory while the tile before it
// computed; then half the threads form the dW[n] partial, each a register
// tile of mt out quads (strided by `ogroups` quads) by one quad of in
// entries, over the rows r = rs, rs + row_split, ..., while the other half
// form du = du_hat W[n], a product split over `ksplit` slices of the out
// quads, each thread a register tile of kWgradDuRows rows by one quad of in
// entries, the slices' partials summed in slice order in shared memory
// (over du_hat, whose reads are done). The general path (for a W[n] that
// does not fit) takes W[n] in tiles of o_tile out entries by j_tile in
// entries and du_hat `rows` rows at a time, kWgradGeneralThreads a block.
// Both take `chunks` chunks of rows_per_chunk B*T rows, one work item (n,
// chunk) at a time.
constexpr int kWgradThreads = 512;         // 16 warps, one block an SM
// of which the first half forms dW and the second du (each role keeps its
// own register tile)
constexpr int kWgradRoleThreads = kWgradThreads / 2;
constexpr int kWgradGeneralThreads = 256;
constexpr int kWgradMaxMt = 4;      // dW out quads a thread, at most
constexpr int kWgradDuRows = 4;     // du rows a thread
constexpr int kWgradMaxTileRows = 64;
constexpr int kWgradMaxRows = 16;   // the general path's du_hat rows, at most
// weight-gradient work items (an in-capsule and a chunk of B*T rows) per
// resident block: the last round of items leaves at most 1/8 idle
constexpr int kItemsPerSlot = 8;

struct Wgrad {
  int tiled;     // 1: the tiled path, 0: the general path
  int rows;      // du_hat rows a tile
  int dh_pitch;  // floats a du_hat row in shared memory
  // the tiled path
  int j4;          // quads of in entries
  int mt;          // dW out quads a thread
  int ogroups;     // threads along the out quads (mt * ogroups >= quads)
  int row_split;   // dW's thread groups over rows
  int build_rows;  // the rebuild's thread groups over rows
  int ksplit;      // du's slices of the out quads
  // the general path
  int o_tile, j_tile;
  int chunks, rows_per_chunk;
};

// Out quads of the tiled path's rows of du_hat (those past out_no zero).
SDR_HOST_DEVICE inline int wgrad_quads(const Wgrad& p) {
  return p.mt * p.ogroups;
}

// The tiled path's region of du_hat, in floats; after a tile's products
// it holds du's slice partials, and at an item's end the partials of dW's
// row groups and of db's rebuild groups after the first.
SDR_HOST_DEVICE inline size_t wgrad_dh_floats(const Wgrad& p) {
  const size_t dh = (size_t)p.rows * p.dh_pitch;
  const size_t du = (size_t)p.ksplit * p.rows * p.j4 * 4;
  const size_t ends =
      (size_t)(p.row_split - 1) * p.ogroups * p.j4 * p.mt * 16 +
      (size_t)(p.build_rows - 1) * wgrad_quads(p) * 4;
  const size_t most = dh > du ? dh : du;
  return most > ends ? most : ends;
}

// The tiled path's staged c (or da) rows, in floats.
SDR_HOST_DEVICE inline size_t wgrad_stage_cd_floats(const Wgrad& p,
                                                    int out_n) {
  return ((size_t)p.rows * out_n + 3) / 4 * 4;
}

// The general path's shared memory in floats: W[n]'s tile and its dW
// partial, db's, the rows of u and of du_hat.
inline size_t wgrad_general_floats(const Wgrad& p) {
  return 2 * (size_t)p.o_tile * p.j_tile + row_pitch(p.o_tile) +
         (size_t)p.rows * (p.j_tile + p.dh_pitch);
}

// A plan's shared memory in floats; the tiled path's, in order: the staged
// factors' mbarrier (4 floats), W[n], the du_hat region, the staged ds and
// v_{t-1} rows, the staged c and da rows, and two buffers of u rows.
inline size_t wgrad_smem_floats(const Wgrad& p, int out_n, int out_d) {
  const int out_no = out_n * out_d;
  if (!p.tiled) return wgrad_general_floats(p);
  return 4 + (size_t)out_no * p.j4 * 4 + wgrad_dh_floats(p) +
         2 * (size_t)p.rows * out_no + 2 * wgrad_stage_cd_floats(p, out_n) +
         2 * (size_t)p.rows * p.j4 * 4;
}

// The tiled path's thread layout for `rows` rows a tile. dW's (mt,
// row_split): of those that keep at least 9/10 of the most threads busy,
// the one with the fewest row groups' partials to add at an item's end
// ((row_split - 1) * mt). False if none has at most kWgradMaxMt out quads
// a thread, or the geometry is not the tiled path's.
inline bool wgrad_tiled_layout(int in_d, int out_no, int rows, Wgrad* p) {
  if (out_no % 4 != 0) return false;
  const int out_q = out_no / 4;
  p->j4 = (in_d + 3) / 4;
  int busy[kWgradMaxMt + 1] = {0}, split[kWgradMaxMt + 1] = {0};
  int most = 0;
  for (int mt = 1; mt <= kWgradMaxMt; ++mt) {
    const int groups = (out_q + mt - 1) / mt * p->j4;
    split[mt] = kWgradRoleThreads / groups < rows
                    ? kWgradRoleThreads / groups
                    : rows;
    busy[mt] = split[mt] * groups;
    if (busy[mt] > most) most = busy[mt];
  }
  int cost = -1;
  for (int mt = 1; mt <= kWgradMaxMt; ++mt) {
    if (most == 0 || 10 * busy[mt] < 9 * most) continue;
    if (cost < 0 || (split[mt] - 1) * mt < cost) {
      cost = (split[mt] - 1) * mt;
      p->mt = mt;
      p->ogroups = (out_q + mt - 1) / mt;
      p->row_split = split[mt];
    }
  }
  const int du_groups = rows / kWgradDuRows * p->j4;
  if (most == 0 || du_groups > kWgradRoleThreads ||
      wgrad_quads(*p) > kWgradThreads) {
    return false;
  }
  p->tiled = 1;
  p->rows = rows;
  p->build_rows = kWgradThreads / wgrad_quads(*p);
  if (p->build_rows > rows) p->build_rows = rows;
  p->ksplit = kWgradRoleThreads / du_groups;
  if (p->ksplit > out_q) p->ksplit = out_q;
  // rows kept 4 floats apart modulo 8: a row's quad and the next rows' fall
  // in other banks, for float4 reads across rows
  p->dh_pitch = wgrad_quads(*p) * 4;
  if (p->dh_pitch % 8 == 0) p->dh_pitch += 4;
  return true;
}

// The general path's tiles: all of W[n] and kWgradMaxRows rows where they
// fit; else fewer rows (down to 4), then fewer out entries (down to 32),
// then fewer in entries.
inline void wgrad_general_tiles(int in_d, int out_no, Wgrad* p) {
  p->tiled = 0;
  p->o_tile = out_no;
  p->j_tile = (in_d + 3) / 4 * 4;
  p->rows = kWgradMaxRows;
  for (;;) {
    p->dh_pitch = p->o_tile % 2 ? p->o_tile : p->o_tile + 1;
    if (wgrad_general_floats(*p) <= kMaxSmemFloats) break;
    if (p->rows > 4) {
      p->rows /= 2;
    } else if (p->o_tile > 32) {
      p->o_tile = (p->o_tile + 1) / 2;
    } else {
      p->j_tile = (p->j_tile / 2 + 3) / 4 * 4;
    }
  }
}

// The plan: the tiled path with the most rows a tile (a multiple of
// kWgradDuRows, at most kWgradMaxTileRows) whose shared memory fits, else
// the general path. `slots`: the blocks the card holds at once (0: one
// chunk).
inline void plan_wgrad(int rows_total, int in_n, int in_d, int out_n,
                       int out_d, int slots, Wgrad* p) {
  *p = Wgrad{};
  bool found = false;
  for (int rows = kWgradMaxTileRows; rows >= kWgradDuRows && !found;
       rows -= kWgradDuRows) {
    found = wgrad_tiled_layout(in_d, out_n * out_d, rows, p) &&
            wgrad_smem_floats(*p, out_n, out_d) <= kMaxSmemFloats;
  }
  if (!found) wgrad_general_tiles(in_d, out_n * out_d, p);
  int chunks = (kItemsPerSlot * slots + in_n - 1) / in_n;
  if (chunks < 1) chunks = 1;
  if (chunks > rows_total) chunks = rows_total;
  p->rows_per_chunk = (rows_total + chunks - 1) / chunks;
  p->chunks = (rows_total + p->rows_per_chunk - 1) / p->rows_per_chunk;
}

// ---- The cluster scan (K3, K4) ----
//
// One cluster of `cluster` CTAs per batch tile of `bt` utterances. CTA q
// owns the in-capsule rows split_begin(in_n, cluster, q) .. split_begin(..,
// q + 1) - 1 (whole rows, so a row's softmax over out capsules stays in the
// CTA) and the out capsules split_begin(out_n, cluster, q) ..: their sums
// over the cluster (s; K4's carry) reach it in its inbox, one slot per
// source rank, and it sends the results back to every CTA. Every buffer of
// a CTA has an offset in floats; those that peers write through
// distributed shared memory must be in shared memory, the others go there
// in priority order while they fit and to a per-CTA region of a global
// scratch buffer after that. W's and bias's slice and the second u_hat
// buffer are kept only where they fit (else W is read from L2 and the
// next step's prediction is not overlapped with the cluster barriers).

constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kScanBars = 8;      // floats reserved for three mbarriers

// Part q's first item when n items are split into `parts` contiguous parts
// as evenly as they go (the first n % parts parts take one more).
SDR_HOST_DEVICE inline int split_begin(int n, int parts, int q) {
  const int base = n / parts, extra = n % parts;
  return q * base + (q < extra ? q : extra);
}

// The part that item i falls in.
SDR_HOST_DEVICE inline int split_owner(int n, int parts, int i) {
  const int base = n / parts, extra = n % parts;
  const int wide = extra * (base + 1);
  return i < wide ? i / (base + 1) : extra + (i - wide) / base;
}

// K3's buffers, in the order they claim shared memory; peers store into
// the first two, which must be there.
enum ScanFwdBuf {
  kFInbox,   // [cluster][bt][caps * out_d] partials of s, from each rank
  kFVsum,    // [bt][rp] v_{t-1} + v_1 + ... (sent by the owners)
  kFSOwn,    // [bt][caps * out_d] s of the owned capsules
  kFVOwn,    // [bt][caps * out_d] sum of the v's of the owned capsules
  kFC,       // [bt][rows][out_n] coupling coefficients
  kFRing,    // [2][ring][bt][rows][in_d] staged u
  kFW,       // [rows][out_no][in_d] W, then [rows][out_no] bias
  kFUhat0,   // [bt][rows][rp] u_hat (the next step's, formed in place
             // once the last iteration has sent its partials)
  kFBufs
};
constexpr int kFMust = kFVsum + 1;

// K4's buffers, in the order they claim shared memory; peers store into
// the first three.
enum ScanBwdBuf {
  kBInboxS,  // [cluster][bt][caps * out_d] partials of s
  kBInboxC,  // [cluster][bt][caps * out_d] partials of the carry
  kBDs,      // [bt][rp] ds (sent by the owners)
  kBSOwn,    // [bt][caps * out_d] s of the owned capsules
  kBDvOwn,   // [bt][caps * out_d] dv of the owned capsules
  kBCarry,   // [bt][caps * out_d] the carry into step t - 1
  kBDvs,     // [2][bt][caps * out_d] dvs of the owned capsules, prefetched
  kBVprev,   // [2][bt][rp] v_{t-1}, prefetched
  kBC,       // [bt][rows][out_n] c
  kBDa,      // [bt][rows][out_n] da
  kBDw,      // [in_d][rows][out_no] dW, then [rows][out_no] db
  kBUhat0,   // [bt][rows][rp] u_hat, then du_hat
  kBRing,    // [2][ring][bt][rows][in_d] staged u
  kBW,       // [rows][out_no][in_d] W, then [rows][out_no] bias
  kBUhat1,   // [bt][rows][rp] u_hat of the next step
  kBBufs
};
constexpr int kBMust = kBDs + 1;

constexpr int kMaxScanBufs = kBBufs;

// Floats between out capsules in a row of u_hat or an out vector in shared
// memory: out_d made odd, so that a warp's lanes, one per out capsule,
// read 32 different banks.
SDR_HOST_DEVICE inline int cap_pitch(int out_d) { return out_d | 1; }

struct ScanPlan {
  int backward;
  int batch, seq_len, in_n, in_d, out_n, out_d, out_no;
  int cp, rp;      // cap_pitch(out_d), and a row's floats: out_n * cp
  int bt;          // utterances a cluster
  int clusters;    // batch tiles
  int cluster;     // CTAs a cluster
  int rows;        // most in-capsule rows a CTA owns
  int caps;        // most out capsules a CTA owns
  int ring;        // steps of u a ring slot stages (0: u read from global)
  int w_resident;  // W's and bias's slice in shared memory
  int uhat_bufs;   // K4 with 2: the next step's u_hat formed in the
                   // barrier waits (K3 always forms it in place there)
  size_t off[kMaxScanBufs];  // floats from the start of the region
  int in_smem[kMaxScanBufs];
  size_t smem_floats;    // dynamic shared memory, mbarriers included
  size_t global_floats;  // global scratch of one CTA
};

inline size_t round4(size_t floats) { return (floats + 3) / 4 * 4; }

// Floats of each buffer for this plan's bt, rows, caps and ring.
inline void scan_sizes(const ScanPlan& p, size_t* sz) {
  const size_t own = (size_t)p.bt * p.caps * p.out_d;
  const size_t vec = (size_t)p.bt * p.rp;
  const size_t coef = (size_t)p.bt * p.rows * p.out_n;
  const size_t ring = 2 * (size_t)p.ring * p.bt * p.rows * p.in_d;
  const size_t w = (size_t)p.rows * p.out_no * (p.in_d + 1);
  const size_t uhat = (size_t)p.bt * p.rows * p.rp;
  if (!p.backward) {
    const size_t s[kFBufs] = {p.cluster * own, vec, own, own, coef,
                              ring, w, uhat};
    for (int i = 0; i < kFBufs; ++i) sz[i] = round4(s[i]);
  } else {
    const size_t s[kBBufs] = {p.cluster * own, p.cluster * own, vec, own,
                              own, own, 2 * own, 2 * vec, coef, coef, w,
                              uhat, ring, w, uhat};
    for (int i = 0; i < kBBufs; ++i) sz[i] = round4(s[i]);
  }
}

// Places the buffers for the plan's bt, rows, caps and ring: the first
// `must` in shared memory (false if they do not fit), W and the second
// u_hat buffer there or nowhere, the others there or in global scratch.
inline bool scan_layout(ScanPlan* p) {
  const int bufs = p->backward ? kBBufs : kFBufs;
  const int must = p->backward ? kBMust : kFMust;
  const int w_buf = p->backward ? kBW : kFW;
  const int ring_buf = p->backward ? kBRing : kFRing;
  const int uhat1 = p->backward ? kBUhat1 : kFBufs;  // K3 has one
  size_t sz[kMaxScanBufs];
  scan_sizes(*p, sz);
  size_t smem = kScanBars, global = 0;
  p->w_resident = 0;
  p->uhat_bufs = 1;
  for (int i = 0; i < bufs; ++i) {
    if (sz[i] == 0 || smem + sz[i] <= kMaxSmemFloats) {
      p->off[i] = smem;
      p->in_smem[i] = 1;
      smem += sz[i];
      if (i == w_buf) p->w_resident = 1;
      if (i == uhat1) p->uhat_bufs = 2;
    } else if (i < must) {
      return false;
    } else {
      p->off[i] = global;
      p->in_smem[i] = 0;
      if (i != w_buf && i != uhat1 && i != ring_buf) global += sz[i];
    }
  }
  p->smem_floats = smem;
  p->global_floats = global;
  return true;
}

// CTAs a cluster: one per in-capsule row up to 16.
SDR_HOST_DEVICE inline int cluster_for(int in_n) {
  return in_n < kMaxCluster ? in_n : kMaxCluster;
}

// The plan for B utterances of T steps: the cluster is min(in_n, 16) CTAs
// (fewer only where the inboxes would not fit);
// the batch is cut into as many tiles as `max_active_clusters` clusters
// hold at once, each of ceil(B / tiles) utterances (fewer where the
// buffers that must be in shared memory do not fit); the ring stages as
// many of `time_block` steps as fit beside the buffers before it (at least
// one, else none: u is then read from global memory).
inline bool plan_scan(bool backward, int batch, int seq_len, int in_n,
                      int in_d, int out_n, int out_d, int time_block,
                      int max_active_clusters, ScanPlan* p) {
  if (batch < 1 || seq_len < 1 || in_n < 1 || in_d < 1 || out_n < 1 ||
      out_d < 1 || time_block < 1 || max_active_clusters < 1) {
    return false;
  }
  p->backward = backward;
  p->batch = batch;
  p->seq_len = seq_len;
  p->in_n = in_n;
  p->in_d = in_d;
  p->out_n = out_n;
  p->out_d = out_d;
  p->out_no = out_n * out_d;
  p->cp = cap_pitch(out_d);
  p->rp = out_n * p->cp;
  const int steps = time_block < seq_len ? time_block : seq_len;
  // the largest cluster, and the largest tile, whose inboxes and sent
  // vectors fit (every rank has an inbox slot at every owner)
  int bt = 0;
  for (p->cluster = cluster_for(in_n); p->cluster > 0; --p->cluster) {
    p->rows = (in_n + p->cluster - 1) / p->cluster;
    p->caps = (out_n + p->cluster - 1) / p->cluster;
    p->ring = 0;
    for (bt = (batch + max_active_clusters - 1) / max_active_clusters;
         bt > 0; --bt) {
      p->bt = bt;
      if (scan_layout(p)) break;
    }
    if (bt > 0) break;
  }
  if (bt < 1) return false;
  p->clusters = (batch + bt - 1) / bt;
  p->bt = (batch + p->clusters - 1) / p->clusters;
  // the longest ring that stays in shared memory, else none
  for (p->ring = steps; p->ring > 0; --p->ring) {
    if (scan_layout(p) && p->in_smem[backward ? kBRing : kFRing]) break;
  }
  if (p->ring == 0) scan_layout(p);
  return true;
}

inline size_t scan_smem_bytes(const ScanPlan& p) {
  return p.smem_floats * sizeof(float);
}

// Global scratch of a whole launch, in floats: every CTA's region, and for
// K4 the clusters' partials of dW and db.
inline size_t scan_scratch_floats(const ScanPlan& p) {
  const size_t ctas = (size_t)p.clusters * p.cluster;
  size_t floats = ctas * p.global_floats;
  if (p.backward) {
    floats += (size_t)p.clusters * p.in_n * p.out_no * (p.in_d + 1);
  }
  return floats;
}

}  // namespace sdr
