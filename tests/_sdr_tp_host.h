// Host C++ stand-ins for what srf_tpu_torch/csrc/sdr_tp.cu takes from CUDA,
// so that its kernels build with g++ and run on the CPU
// (tests/test_torch_sdr_tp.py):
//
//   g++ -std=c++20 -shared -fPIC -pthread -x c++ -DSDR_TP_HOST
//       -include tests/_sdr_tp_host.h srf_tpu_torch/csrc/sdr_tp.cu
//
// A launch runs its blocks one after another; a block's threads are
// std::threads, and __syncthreads is a std::barrier over them. Dynamic
// shared memory is one buffer per launch. Streams are ignored.

#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)

struct Dim { unsigned x = 0; };

namespace sdr_tp_host {
inline thread_local Dim thread_index;
inline thread_local Dim block_index;
inline Dim block_dim;
inline Dim grid_dim;
inline std::vector<float> shared;
inline std::barrier<>* block_barrier = nullptr;

inline void launch(int grid, int block, long long smem_bytes,
                   const std::function<void()>& body) {
  grid_dim.x = grid;
  block_dim.x = block;
  for (int b = 0; b < grid; ++b) {
    shared.assign((smem_bytes + 3) / 4 + 1, 0.f);
    std::barrier<> bar(block);
    block_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, b, t] {
        thread_index.x = t;
        block_index.x = b;
        body();
      });
    }
    for (auto& th : threads) th.join();
    block_barrier = nullptr;
  }
}
}  // namespace sdr_tp_host

#define threadIdx sdr_tp_host::thread_index
#define blockIdx sdr_tp_host::block_index
#define blockDim sdr_tp_host::block_dim
#define gridDim sdr_tp_host::grid_dim
#define __syncthreads() sdr_tp_host::block_barrier->arrive_and_wait()

#define SDR_TP_SMEM(name) float* name = sdr_tp_host::shared.data()
#define SDR_TP_LAUNCH(kernel, grid, block, smem, stream, ...) \
  sdr_tp_host::launch(grid, block, smem, [&]() { kernel(__VA_ARGS__); })

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
