// Pieces shared by the Hopper attention kernels (decode_attention_hopper.cu,
// decode_attention_grouped_hopper.cu, attention_probes.cu): the cp.async
// copies, ldmatrix, mma.sync on int8 and bf16, the exact int8 and int4 to
// bf16 conversions and the ring tile of the decode-attention core (a
// stage: TR cache rows of ROW_B bytes, then the tile's staged scales).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace tpuserve {
namespace hopper {

constexpr int TR = 64;            // cache rows of a ring tile
constexpr int ROW_B = 144;        // tile row stride: a unit's 128 bytes + 16 (conflict-free)
constexpr int SC_W = 68;          // words of a staged scale row (64 f32, or 33 bf16 pairs)
constexpr int TILE_B = TR * ROW_B;
constexpr int STAGE_B = TILE_B + 4 * SC_W * 4;  // data, then ks lo/hi, vs lo/hi
constexpr int QS_B = 144;         // q code row stride
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the A fragment's nibble halves as int8 codes (biased, 0..15); NOOP keeps
// the raw bytes for both
template <bool NOOP>
__device__ __forceinline__ void nibbles(const uint32_t (&a)[4], uint32_t (&lo)[4],
                                        uint32_t (&hi)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    lo[x] = NOOP ? a[x] : (a[x] & 0x0F0F0F0Fu);
    hi[x] = NOOP ? a[x] : ((a[x] >> 4) & 0x0F0F0F0Fu);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Signed int8 bytes I and J of w (I the low half) as bf16x2, exactly: each
// byte, biased by 128, becomes the low mantissa bits of 2^23, and the float
// subtraction of 2^23 + 128 gives the code.
template <int I, int J>
__device__ __forceinline__ uint32_t s8_to_bf16x2(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | I)) - 8388736.0f;
  const float hi = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | J)) - 8388736.0f;
  return pack_bf16(lo, hi);
}

// Biased nibble codes (0..15, one a byte) I and J of w as the bf16x2 of
// code - 8, exactly: 0x43 over a byte is the bf16 of 128 + code.
template <int I, int J>
__device__ __forceinline__ uint32_t u4_to_bf16x2(uint32_t w) {
  const uint32_t h = __byte_perm(w, 0x43434343u, (I | 4 << 4 | J << 8 | 5 << 12));
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h),
                                   __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

}  // namespace hopper
}  // namespace tpuserve
