// Shared helpers for the port's CUDA kernels (plain C ABI, loaded with
// ctypes by transfer_em_tpu_torch/kernels/__init__.py).
//
// Every exported entry point launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so that the
// Python wrapper can raise on a launch that CUDA refused.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tem {

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, like torch
}

// LeakyReLU as the JAX package writes it: where(v >= 0, v, v * slope).
__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : __fmul_rn(v, slope);
}

// The conv kernels' fused LeakyReLU: the f32 sum rounded to T first, then
// the activation on that value (rounded again when stored), which is what
// a conv in T followed by a LeakyReLU in T computes.  In bf16 this follows
// the JAX package's default path (fast_conv off: lax.conv, then
// nn.leaky_relu with the slope rounded to bf16), which its bf16 training
// runs, and deliberately NOT the Pallas kernel this ports (_tconv3_kernel,
// pallas_conv.py:111-114: LeakyReLU(0.3) on the f32 sum, one rounding):
// the two differ on about half of the negative outputs by one bf16 step
// (tests/test_torch_bf16_train.py pins which one the port matches).  For
// float the first rounding changes nothing.
template <typename T>
__device__ __forceinline__ float conv_leaky(float v, float slope) {
  return leaky(to_f32<T>(from_f32<T>(v)), slope);
}

// Grid for a grid-stride loop over n items with 256-thread blocks.
inline unsigned int grid_for(long long n, long long per_thread = 1) {
  long long threads = (n + per_thread - 1) / per_thread;
  long long blocks = (threads + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // 32 blocks per H100 SM
  return static_cast<unsigned int>(blocks);
}

}  // namespace tem
