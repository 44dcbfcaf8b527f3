// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 storage (dtype code 0 or 1 at the
// C entry points) and computes in float32.  rt<T>(x) rounds a float32 value
// through T, so the kernels round where the JAX kernels cast to the working
// type (a no-op at float32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace iic {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr float kNeg = -1e30f;    // the beam's dead-lane sentinel (NEG)

// The decode megakernel's early exit (step.cu iic_decode_capture): a chain
// kernel given a `live` word returns at once when it reads 0.  Null for
// every other caller.
__device__ __forceinline__ bool skip(const int* live) {
  return live != nullptr && *live == 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float rt(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Lets kernel take more than 48 KB of dynamic shared memory.
template <typename K_>
static int allow_smem(K_ kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace iic
