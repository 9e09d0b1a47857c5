// K5: one-pass inverted dropout from an in-kernel counter-based PRNG.
//
// Replaces the TPU kernel srf_tpu/ops/dropout_pallas.py:_mask_kernel
// (pl.pallas_call at :65), which draws its mask from the TPU core's
// hardware PRNG inside the apply pass and regenerates it in the backward.
// Hopper has no such PRNG, so each element's uniform uint32 comes from
// Philox4x32-10 keyed by the host seed, counted by the element's row-major
// index: element i takes word i % 4 of Philox((i / 4, 0), seed). The stream
// is a function of (seed, i) alone, not of the grid, so the backward (the
// same launch on the cotangent) regenerates the forward's mask, and the
// plain PyTorch version (srf_tpu_torch/ops/dropout.py:fused_dropout_plain)
// gives the same bits.
//
// out[i] = x[i] * scale where bits(i) >= threshold, else 0.
//
// Bound: bytes. It reads x once and writes out once (8 bytes an element);
// one Philox (10 rounds, two 32x32-bit multiplies each) serves 4 elements,
// ~1/8 of an FMA-equivalent op a byte, far below the card's balance point.
// Design: a grid-stride loop over groups of 4 elements, one float4 load,
// one Philox and one float4 store a group, with enough 256-thread blocks
// to fill every SM; a scalar path for a misaligned pointer and for the
// n % 4 tail. Indices are 64-bit (a CNN-TIMIT activation is 1.1e8
// elements).
//
// The bf16 variant (fused_dropout_bf16) runs K5 on bf16 tensors, as the
// JAX kernel runs in x's dtype (out_shape = x2d.dtype) under --tpu-bf16:
// the same Philox stream per element index, 8 elements (16 bytes, two
// Philox calls) a vector, and x * scale taken in float32 and rounded to
// bf16 once, which is bf16 arithmetic for a single product. Bound: bytes,
// 4 an element.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 round multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // key increments (Weyl constants)
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint4 philox4x32_10(uint64_t group, uint64_t seed) {
  uint32_t c0 = static_cast<uint32_t>(group);
  uint32_t c1 = static_cast<uint32_t>(group >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float apply_mask(float v, uint32_t bits,
                                            uint32_t threshold, float scale) {
  return bits >= threshold ? v * scale : 0.0f;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
fused_dropout_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int64_t n, uint64_t seed, uint32_t threshold,
                     float scale) {
  const int64_t groups = (n + 3) / 4;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += step) {
    const uint4 bits = philox4x32_10(static_cast<uint64_t>(g), seed);
    const int64_t i = 4 * g;
    if (kAligned && i + 4 <= n) {
      float4 v = __ldg(reinterpret_cast<const float4*>(x) + g);
      v.x = apply_mask(v.x, bits.x, threshold, scale);
      v.y = apply_mask(v.y, bits.y, threshold, scale);
      v.z = apply_mask(v.z, bits.z, threshold, scale);
      v.w = apply_mask(v.w, bits.w, threshold, scale);
      reinterpret_cast<float4*>(out)[g] = v;
    } else {
      const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
      for (int j = 0; j < 4 && i + j < n; ++j) {
        out[i + j] = apply_mask(x[i + j], words[j], threshold, scale);
      }
    }
  }
}

__device__ __forceinline__ __nv_bfloat16 apply_mask(__nv_bfloat16 v,
                                                    uint32_t bits,
                                                    uint32_t threshold,
                                                    float scale) {
  return __float2bfloat16_rn(
      bits >= threshold ? __bfloat162float(v) * scale : 0.0f);
}

// The bf16 kernel: a grid-stride loop over vectors of 8 elements (two
// Philox groups of 4), one 16-byte load and store a vector; a scalar path
// for a misaligned pointer and for the n % 8 tail.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
fused_dropout_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          __nv_bfloat16* __restrict__ out, int64_t n,
                          uint64_t seed, uint32_t threshold, float scale) {
  const int64_t vectors = (n + 7) / 8;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       h < vectors; h += step) {
    const uint4 lo = philox4x32_10(static_cast<uint64_t>(2 * h), seed);
    const uint4 hi = philox4x32_10(static_cast<uint64_t>(2 * h + 1), seed);
    const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w,
                               hi.x, hi.y, hi.z, hi.w};
    const int64_t i = 8 * h;
    if (kAligned && i + 8 <= n) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + h);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = apply_mask(e[j], words[j], threshold, scale);
      }
      reinterpret_cast<uint4*>(out)[h] = v;
    } else {
      for (int j = 0; j < 8 && i + j < n; ++j) {
        out[i + j] = apply_mask(x[i + j], words[j], threshold, scale);
      }
    }
  }
}

// Blocks for `units` work items of one thread each, at most kBlocksPerSm a
// multiprocessor of the current device; 0 with *err set on failure.
int64_t grid_blocks(int64_t units, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  }
  if (*err != cudaSuccess) return 0;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return blocks > cap ? cap : blocks;
}

}  // namespace

// x and out: n float32 on the current device; launched on `stream`, no
// synchronisation. Returns the launch's cudaError_t (0 on success).
extern "C" int fused_dropout(const float* x, float* out, int64_t n,
                             uint64_t seed, uint32_t threshold, float scale,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  cudaError_t err;
  const int64_t blocks = grid_blocks((n + 3) / 4, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    fused_dropout_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(x, out, n, seed, threshold, scale);
  } else {
    fused_dropout_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(x, out, n, seed, threshold, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 variant: x and out n bf16 values on the current device, the
// same stream of bits; launched on `stream`, no synchronisation.
extern "C" int fused_dropout_bf16(const void* x, void* out, int64_t n,
                                  uint64_t seed, uint32_t threshold,
                                  float scale, cudaStream_t stream) {
  if (n <= 0) return 0;
  cudaError_t err;
  const int64_t blocks = grid_blocks((n + 7) / 8, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    fused_dropout_bf16_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                      0, stream>>>(xb, ob, n, seed, threshold,
                                                   scale);
  } else {
    fused_dropout_bf16_kernel<false><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
        xb, ob, n, seed, threshold, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
