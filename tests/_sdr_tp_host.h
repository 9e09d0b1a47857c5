// Host C++ stand-ins for what srf_tpu_torch/csrc/sdr_tp.cu takes from CUDA
// (and, through it, sdr_stream.cuh's ring and warp passes), so that its
// kernels build with g++ and run on the CPU (tests/test_torch_sdr_tp.py);
// sdr_bwd.cu's kernels build with it too (tests/test_torch_sdr_wgrad_host.py:
// its asynchronous copies are copies, `__ldg` a read), and sdr_stream.cuh's
// prediction kernel (tests/test_torch_sdr_predict_host.py):
//
//   g++ -std=c++20 -shared -fPIC -pthread -x c++ -DSDR_TP_HOST
//       -include tests/_sdr_tp_host.h srf_tpu_torch/csrc/sdr_tp.cu
//
// Every CUDA thread is a std::thread. A plain launch (the host loop's step
// kernels) runs its blocks one after another; a cooperative launch (the
// persistent kernels) runs all its blocks at once, as the card holds them
// all resident, so that their exchange through flags can make progress.
// __syncthreads and the compute warps' named barrier are std::barriers over
// the block's threads; a warp's shuffles and votes go through a per-warp
// std::barrier and slots. An mbarrier is its phase, expected and pending
// arrivals and transaction bytes, packed in its 8 bytes under one mutex; a
// bulk copy is a memcpy that then completes its bytes. The flags' atomics
// are std::atomic_ref, and a wait yields. SDR_HOST_SHIM tells
// sdr_stream.cuh and sdr_plan.cuh that this header supplies the primitives
// (and kWarps 2, so a block is 96 threads). Streams are ignored.

#pragma once

#define SDR_HOST_SHIM

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct Dim { unsigned x = 0, y = 0, z = 0; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline int min(int a, int b) { return a < b ? a : b; }

// bf16: sdr_stream.cuh's bf16 helpers and the prediction kernel's bf16
// instance (the split kernels are float32)
struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) {
  return h.bits;
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return float2{__bfloat162float(h.x), __bfloat162float(h.y)};
}

namespace sdr_tp_host {

// A warp's shuffle slots and barrier.
struct Warp {
  std::barrier<> bar{32};
  float f[32];
  int i[32];
};

// A block's shared memory, barriers and warps.
struct Block {
  std::vector<float4> smem;
  std::barrier<> all;
  std::barrier<> compute;
  std::vector<std::unique_ptr<Warp>> warps;
  Block(int threads, int compute_threads, long long smem_bytes)
      : smem((smem_bytes + 15) / 16 + 1), all(threads),
        compute(compute_threads < threads ? compute_threads : threads) {
    for (int w = 0; w < (threads + 31) / 32; ++w) {
      warps.emplace_back(new Warp);
    }
  }
};

inline thread_local Dim thread_index;
inline thread_local Dim block_index;
inline thread_local Block* block = nullptr;
inline Dim block_dim;
inline Dim grid_dim;

inline void run_block(Block& blk, unsigned bx, unsigned by,
                      const std::function<void()>& body,
                      std::vector<std::thread>& threads) {
  for (unsigned t = 0; t < block_dim.x; ++t) {
    threads.emplace_back([&blk, &body, bx, by, t] {
      thread_index.x = t;
      block_index.x = bx;
      block_index.y = by;
      block = &blk;
      body();
    });
  }
}

// A plain launch: its blocks one after another.
inline void launch(int grid, int block_threads, long long smem_bytes,
                   const std::function<void()>& body) {
  grid_dim = Dim{(unsigned)grid, 1, 1};
  block_dim = Dim{(unsigned)block_threads, 1, 1};
  for (int b = 0; b < grid; ++b) {
    Block blk(block_threads, block_threads, smem_bytes);
    std::vector<std::thread> threads;
    run_block(blk, b, 0, body, threads);
    for (auto& th : threads) th.join();
  }
}

// A cooperative launch: every block of the (gx, gy) grid at once.
inline void coop_launch(int gx, int gy, int block_threads, int compute,
                        long long smem_bytes,
                        const std::function<void()>& body) {
  grid_dim = Dim{(unsigned)gx, (unsigned)gy, 1};
  block_dim = Dim{(unsigned)block_threads, 1, 1};
  std::vector<std::unique_ptr<Block>> blocks;
  std::vector<std::thread> threads;
  for (int y = 0; y < gy; ++y) {
    for (int x = 0; x < gx; ++x) {
      blocks.emplace_back(new Block(block_threads, compute, smem_bytes));
      run_block(*blocks.back(), x, y, body, threads);
    }
  }
  for (auto& th : threads) th.join();
}

inline Warp& warp() { return *block->warps[thread_index.x / 32]; }

inline std::mutex& mbar_mutex() {
  static std::mutex m;
  return m;
}

// mbarrier state in its 8 bytes: phase bit 63, expected arrivals bits
// 40-55, pending arrivals bits 24-39, transaction bytes bits 0-23
inline uint64_t mbar_pack(uint64_t phase, uint64_t expected,
                          uint64_t pending, uint64_t tx) {
  return phase << 63 | expected << 40 | pending << 24 | tx;
}

// Under the mutex: `arrivals` arrivals and `tx` bytes more expected (tx < 0:
// bytes completed); flips the phase when both reach 0.
inline void mbar_update(uint64_t* bar, int arrivals, long long tx) {
  std::lock_guard<std::mutex> lock(mbar_mutex());
  const uint64_t s = *bar;
  uint64_t phase = s >> 63, expected = (s >> 40) & 0xffff;
  uint64_t pending = ((s >> 24) & 0xffff) - arrivals;
  uint64_t bytes = (uint64_t)((long long)(s & 0xffffff) + tx);
  if (pending == 0 && bytes == 0) {
    phase ^= 1;
    pending = expected;
  }
  *bar = mbar_pack(phase, expected, pending, bytes);
}

}  // namespace sdr_tp_host

#define threadIdx sdr_tp_host::thread_index
#define blockIdx sdr_tp_host::block_index
#define blockDim sdr_tp_host::block_dim
#define gridDim sdr_tp_host::grid_dim
#define __syncthreads() sdr_tp_host::block->all.arrive_and_wait()

inline void __syncwarp() { sdr_tp_host::warp().bar.arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float x, int off) {
  auto& w = sdr_tp_host::warp();
  const int lane = threadIdx.x % 32;
  w.f[lane] = x;
  w.bar.arrive_and_wait();
  const float y = w.f[lane ^ off];
  w.bar.arrive_and_wait();
  return y;
}

inline bool __all_sync(unsigned, bool p) {
  auto& w = sdr_tp_host::warp();
  const int lane = threadIdx.x % 32;
  w.i[lane] = p;
  w.bar.arrive_and_wait();
  bool all = true;
  for (int k = 0; k < 32; ++k) all = all && w.i[k];
  w.bar.arrive_and_wait();
  return all;
}

// sdr_stream.cuh's ring primitives
namespace sdr {
inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(sdr_tp_host::mbar_mutex());
  *bar = sdr_tp_host::mbar_pack(0, count, count, 0);
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) { sdr_tp_host::mbar_update(bar, 1, 0); }
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (;;) {
    uint64_t s;
    {
      std::lock_guard<std::mutex> lock(sdr_tp_host::mbar_mutex());
      s = *bar;
    }
    if ((s >> 63) != parity) return;
    std::this_thread::yield();
  }
}
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  sdr_tp_host::mbar_update(bar, 1, bytes);
}
inline void bulk_copy(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  sdr_tp_host::mbar_update(bar, 0, -(long long)bytes);
}
inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}
inline void sync_compute() { sdr_tp_host::block->compute.arrive_and_wait(); }
inline void copy_async(float* dst, const float* src) { *dst = *src; }
inline void copy_async16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}
inline void copy_async_wait() {}
inline void copy_async_zfill(float* dst, const float* src, bool valid) {
  *dst = valid ? *src : 0.f;
}
inline void copy_async16_zfill(float* dst, const float* src, bool valid) {
  if (valid) {
    std::memcpy(dst, src, 16);
  } else {
    std::memset(dst, 0, 16);
  }
}
inline void copy_async_commit() {}
template <int N>
inline void copy_async_wait_pending() {}
}  // namespace sdr

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
template <typename T>
inline void __stcs(T* p, T v) {
  *p = v;
}

// sdr_tp.cu's exchange primitives
inline unsigned long long load_acquire(const unsigned long long* p) {
  return std::atomic_ref<unsigned long long>(
             *const_cast<unsigned long long*>(p))
      .load(std::memory_order_acquire);
}
inline void store_release(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).store(v, std::memory_order_release);
}
inline unsigned long long status_word(const unsigned long long* p) {
  return std::atomic_ref<unsigned long long>(
             *const_cast<unsigned long long*>(p))
      .load(std::memory_order_acquire);
}
inline bool status_claim(unsigned long long* p) {
  unsigned long long zero = 0;
  return std::atomic_ref<unsigned long long>(*p).compare_exchange_strong(
      zero, 1ULL);
}
inline unsigned long long now_ns() {
  return (unsigned long long)std::chrono::duration_cast<
             std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline void fence_system() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void backoff() { std::this_thread::yield(); }
inline float2 load_peer(const float2* p) { return *p; }

#define SDR_BWD_SMEM(name) \
  float4* name = sdr_tp_host::block->smem.data()
#define SDR_PREDICT_SMEM(name) \
  float4* name = sdr_tp_host::block->smem.data()
#define SDR_TP_SMEM(name) \
  float* name = reinterpret_cast<float*>(sdr_tp_host::block->smem.data())
#define SDR_TP_LAUNCH(kernel, grid, block, smem, stream, ...) \
  sdr_tp_host::launch(grid, block, smem, [&]() { kernel(__VA_ARGS__); })
#define SDR_TP_COOP_LAUNCH(kernel, gx, gy, block, smem, stream, ...)      \
  (sdr_tp_host::coop_launch(gx, gy, block, sdr::kComputeThreads, smem,     \
                            [&]() { kernel(__VA_ARGS__); }),               \
   cudaSuccess)

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
inline int cudaGetLastError() { return cudaSuccess; }
inline int cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline const char* cudaGetErrorString(int err) {
  return err ? "invalid argument" : "no error";
}
