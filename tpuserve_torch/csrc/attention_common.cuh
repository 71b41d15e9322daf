// Pieces shared by the decode-attention kernels (decode_attention.cu,
// decode_attention_multi.cu): the block shape, the cache kinds and how one
// lane reads its four values of a cache row.
#pragma once

#include "common.cuh"

namespace tpuserve {
namespace attn {

constexpr int HD = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;  // rows a warp loads before it computes on them
constexpr float NEG_INF = -1e30f;

enum Kind { KV_INT8 = 0, KV_INT4 = 1, KV_BF16 = 2, KV_F32 = 3 };

__device__ __forceinline__ float load_scale(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One lane's 4 values of a cache row: 4 bytes (int8, packed int4), 4 bf16
// or 4 f32.
template <int KIND> struct RowWord { using T = uint32_t; };
template <> struct RowWord<KV_BF16> { using T = uint2; };
template <> struct RowWord<KV_F32> { using T = float4; };

// off: the row segment's first element (byte for int8/int4), a multiple of 4
template <int KIND>
__device__ __forceinline__ typename RowWord<KIND>::T load_word(const void* base, size_t off,
                                                               int lane) {
  return reinterpret_cast<const typename RowWord<KIND>::T*>(base)[off / 4 + lane];
}

template <int KIND>
__device__ __forceinline__ void word_floats(const typename RowWord<KIND>::T& w, float (&x)[4]) {
  if constexpr (KIND == KV_BF16) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = __bfloat162float(h[c]);
  } else if constexpr (KIND == KV_F32) {
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
  }
}

}  // namespace attn
}  // namespace tpuserve
