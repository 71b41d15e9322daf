// Pieces shared by the Hopper attention kernels (decode_attention_hopper.cu,
// decode_attention_grouped_hopper.cu, attention_probes.cu): the cp.async
// copies, ldmatrix, mma.sync on int8 and bf16, the exact int8 and int4 to
// bf16 conversions, the ring tile of the decode-attention kernels (a stage:
// TR cache rows of a kv unit, then the tile's staged scales) and the score
// and P@V tiles of the float caches (bf16 on the tensor cores, f32 on the
// CUDA cores).
#pragma once

#include <cuda_bf16.h>

#include "attention_common.cuh"
#include "common.cuh"

namespace tpuserve {
namespace hopper {

constexpr int TR = 64;            // cache rows of a ring tile
constexpr int SC_W = 68;          // words of a staged scale row (64 f32, or 33 bf16 pairs)
constexpr size_t SMEM_LIMIT = 227 * 1024;

// Row strides of a ring tile at head_dim HD (128 or 256), each a row of one
// kv unit + 16 bytes (conflict-free): int8 or packed int4 HD bytes (144 at
// 128), bf16 2 * HD (272), f32 4 * HD (528); a staged q row takes the
// cache's stride (int8 codes: HD + 16), an f32 one row_f32 / 4 floats
__host__ __device__ constexpr int row_b(int hd) { return hd + 16; }
__host__ __device__ constexpr int row_bf16(int hd) { return 2 * hd + 16; }
__host__ __device__ constexpr int row_f32(int hd) { return 4 * hd + 16; }

// A ring tile's row stride and a stage's bytes for a cache kind (the
// wrappers in ops/decode_attention.py mirror them): TR rows, then 4 staged
// scale rows (ks lo/hi, vs lo/hi)
__host__ __device__ constexpr int tile_row_b(int kind, int hd) {
  return kind == attn::KV_F32 ? row_f32(hd) : kind == attn::KV_BF16 ? row_bf16(hd) : row_b(hd);
}
__host__ __device__ constexpr int stage_b(int kind, int hd) {
  return TR * tile_row_b(kind, hd) + 4 * SC_W * 4;
}

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

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---- float caches. Fragment layouts are mma.sync m16n8k16's: a score tile
// has the cache rows on M and the query rows on N; a P@V tile has hd on M,
// the query rows on N and the cache rows on K. A thread holds acc[n][e] at
// M row g + 8 * (e >> 1), N column n * 8 + 2t + (e & 1) (g = lane / 4, t =
// lane % 4); the f32 forms compute the same elements on the CUDA cores.

// Scores of cache rows row0 .. row0 + 15 of a bf16 stage (A by ldmatrix)
// against NT n-tiles of bf16 query rows staged row_bf16(HD) apart (B), in
// `pieces` pieces piece_b bytes apart whose products are summed (an f32 q
// as hi + mid + lo: each product is exact in f32); f32 sums.
template <int NT, int HD>
__device__ __forceinline__ void scores_bf16(float (&acc)[NT][4], const unsigned char* st, int row0,
                                            const unsigned char* qs, int pieces, int piece_b,
                                            int lane) {
  constexpr int ROW_BF16 = row_bf16(HD);
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, st + (row0 + (lane & 7) + (mat & 1) * 8) * ROW_BF16 + 32 * kk + (mat >> 1) * 16);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc) {
      if (pc >= pieces) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const unsigned char* q = qs + pc * piece_b + (n * 8 + g) * ROW_BF16 + 32 * kk + 4 * t;
        mma_bf16(acc[n], a[0], a[1], a[2], a[3], ld_u32(q), ld_u32(q + 16));
      }
    }
  }
}

// The same elements from an f32 stage and f32 query rows row_f32(HD) / 4
// floats apart, by FMA (no TF32)
template <int NT, int HD>
__device__ __forceinline__ void scores_f32(float (&acc)[NT][4], const unsigned char* st, int row0,
                                           const float* qf, int lane) {
  constexpr int ROW_F32 = row_f32(HD), QF_W = ROW_F32 / 4;
  const int g = lane >> 2, t = lane & 3;
  const float* k0 = reinterpret_cast<const float*>(st + (row0 + g) * ROW_F32);
  const float* k1 = reinterpret_cast<const float*>(st + (row0 + g + 8) * ROW_F32);
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(k0 + d);
    const float4 y = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 q = *reinterpret_cast<const float4*>(qf + (n * 8 + 2 * t + e) * QF_W + d);
        acc[n][e] = fmaf(x.w, q.w, fmaf(x.z, q.z, fmaf(x.y, q.y, fmaf(x.x, q.x, acc[n][e]))));
        acc[n][2 + e] =
            fmaf(y.w, q.w, fmaf(y.z, q.z, fmaf(y.y, q.y, fmaf(y.x, q.x, acc[n][2 + e]))));
      }
  }
}

// P @ V of a bf16 stage's TR rows for hd rows HD / 4 * warp .. + HD / 4 - 1
// (MC = HD / 64 m16 chunks c): V read in place by ldmatrix.trans (A), P
// bf16 rows pstride apart from column pcol0 (B; query rows past prow_max
// read row prow_max: they only fill dropped columns); f32 sums
template <int NT, int HD>
__device__ __forceinline__ void pv_bf16(float (&acc)[HD / 64][NT][4], const unsigned char* st,
                                        const __nv_bfloat16* p, int pstride, int pcol0,
                                        int prow_max, int warp, int lane) {
  constexpr int ROW_BF16 = row_bf16(HD), MC = HD / 64;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < TR / 16; ++ks) {
    uint32_t pl[NT], ph[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* pr = p + min(n * 8 + g, prow_max) * pstride + pcol0 + 16 * ks + 2 * t;
      pl[n] = ld_u32(pr);
      ph[n] = ld_u32(pr + 8);
    }
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      uint32_t a[4];
      ldsm_x4_trans(a, st + (16 * ks + (lane & 7) + (mat >> 1) * 8) * ROW_BF16 +
                           (warp * (HD / 4) + 16 * c + (mat & 1) * 8) * 2);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_bf16(acc[c][n], a[0], a[1], a[2], a[3], pl[n], ph[n]);
    }
  }
}

// The same elements from an f32 stage and f32 P rows, by FMA. P and V are
// zero past the rows a block reads, so all TR rows are summed.
template <int NT, int HD>
__device__ __forceinline__ void pv_f32(float (&acc)[HD / 64][NT][4], const unsigned char* st,
                                       const float* p, int pstride, int pcol0, int prow_max,
                                       int warp, int lane) {
  constexpr int ROW_F32 = row_f32(HD), MC = HD / 64;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < TR; k += 4) {
    float4 pv[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        pv[n][e] = *reinterpret_cast<const float4*>(
            p + min(n * 8 + 2 * t + e, prow_max) * pstride + pcol0 + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* vr =
          reinterpret_cast<const float*>(st + (k + kk) * ROW_F32) + warp * (HD / 4) + g;
      float vv[2 * MC];   // hd 8j + g of the warp's HD / 4
#pragma unroll
      for (int j = 0; j < 2 * MC; ++j) vv[j] = vr[8 * j];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 q4 = pv[n][e];
          const float pk = kk == 0 ? q4.x : kk == 1 ? q4.y : kk == 2 ? q4.z : q4.w;
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            acc[c][n][e] = fmaf(pk, vv[2 * c], acc[c][n][e]);
            acc[c][n][2 + e] = fmaf(pk, vv[2 * c + 1], acc[c][n][2 + e]);
          }
        }
    }
  }
}

}  // namespace hopper
}  // namespace tpuserve
