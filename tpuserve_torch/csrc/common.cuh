// Small helpers shared by the port's CUDA kernels (plain C interface,
// compiled by nvcc for sm_90a and bound from Python with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace tpuserve {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
// round to nearest even, as a bf16 cast does in JAX and PyTorch
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Exact conversion of a small non-negative integer (< 2^23) to float: one
// integer OR and one float subtract instead of the slower I2F instruction.
__device__ __forceinline__ float small_u2f(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace tpuserve
