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
                        int vectors, bool keeps_c, int esize, StreamPlan* p) {
  if (in_n < 1 || in_d < 1 || out_n < 1 || out_d < 1 ||
      (size_t)out_n * out_d > kMaxSmemFloats) {
    return false;
  }
  // the bf16 variants' prediction kernel takes all of in_d in one tile (it
  // rounds the finished sum, so it cannot carry a partial sum in u_hat)
  if (esize == 2 && plan_predict(in_d, out_n * out_d).j_tile < in_d) {
    return false;
  }
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
