// Fused dequant + matmul: out[B, N] = x[B, K] @ dequant(W)[K, N].
//
// Replaces tpuserve/ops/quant_matmul.py::_kernel (all three branches):
//   - int4: W packed uint8 [K/2, N], split-half per scale group (packed row
//     r of group g holds element g*gs + r in its low nibble and element
//     g*gs + gs/2 + r in its high nibble); the nibbles stay biased in
//     [0, 15] and the -8 is folded as  x.c - 8*rowsum(x)  per group;
//   - int8: W int8 [K, N]; a group may span many K chunks (gs = K);
//   - W4A8: x arrives quantized to int8 per row, the dots are integer
//     (__dp4a, int32 accumulation) against the biased nibbles, the -8 fold
//     is done in int32, and the caller multiplies the per-row scale.
// Scales are f32 [G, N]; each group's partial sum is scaled in f32 and
// accumulated in f32, as in the TPU kernel.
//
// Bound on the H100: bytes at decode. At B <= 64 every weight byte is used
// for at most 2*64 operations, far below the ~295 operations per byte where
// the tensor cores, not the memory, become the limit. Design: one block per
// 64-column N tile covering up to 64 rows of x, walking K chunk by chunk,
// so every weight byte is read from device memory once per call with
// coalesced 16-byte loads along N. x chunks are staged in shared memory and
// reused by all 64 columns. When the N tiles alone would leave SMs idle
// (narrow N, long K), K is split across blocks by whole scale groups: each
// split writes f32 partial sums to a workspace and a second small kernel
// adds them in split order. bf16 activations (the serving path) multiply on
// the tensor cores with mma.sync (codes converted to bf16 in registers);
// f32 activations multiply on the CUDA cores in f32, and W4A8 with __dp4a.
// wgmma, TMA and a pipelined K loop are later work.
#include "common.cuh"

namespace {

using tpuserve::small_u2f;
using tpuserve::store_f32;

constexpr int TN = 64;        // output columns per block
constexpr int THREADS = 128;  // 8 column groups x 16 row groups
constexpr int XS = 132;       // x tile row stride: 128 values + pad against bank conflicts
constexpr int WT = 68;        // W4A8 transposed weight tile row stride in bytes

// ---------------------------------------------------------------- f32 x
template <int BITS, int RPT>
__global__ void __launch_bounds__(THREADS)
qmm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out,
               int B, int K, int N, int gs, int gps) {
  constexpr int ROWS = 16 * RPT;
  constexpr int MAXW = (BITS == 4) ? 64 : 128;  // weight rows per chunk
  __shared__ float xs[ROWS * XS];
  __shared__ __align__(16) uint8_t ws[MAXW * TN];

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // columns n0 + tx*8 .. +7
  const int ty = tid >> 3;  // rows b0 + ty + 16*i
  const int n0 = blockIdx.x * TN;
  const int b0 = blockIdx.y * ROWS;
  const int half = gs / 2;
  const int wrows = (BITS == 4) ? half : gs;  // weight rows per group
  const int cw = wrows < MAXW ? wrows : MAXW;
  const int chunks = wrows / cw;
  const int groups = K / gs;
  const int xw = (BITS == 4) ? 2 * cw : cw;   // x values staged per row
  const bool col_ok = (n0 + tx * 8) < N;      // N % 16 == 0: all 8 or none
  // K split: this block's scale groups; split z writes its own [B, N] slab
  const int g0 = blockIdx.z * gps;
  const int g1 = min(groups, g0 + gps);
  out += (size_t)blockIdx.z * B * N;

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int g = g0; g < g1; ++g) {
    float part[RPT][8];
    float rsum[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      rsum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {
      const int r0 = c * cw;
      __syncthreads();  // previous chunk's readers are done
      for (int idx = tid; idx < ROWS * xw; idx += THREADS) {
        const int row = idx / xw;
        const int j = idx - row * xw;
        int k;
        int slot = j;
        if (BITS == 4) {
          // low nibbles pair with x[g*gs + r], high nibbles with x[g*gs + gs/2 + r]
          k = (j < cw) ? g * gs + r0 + j : g * gs + half + r0 + (j - cw);
          slot = (j < cw) ? j : 64 + (j - cw);
        } else {
          k = g * gs + r0 + j;
        }
        const int b = b0 + row;
        xs[row * XS + slot] = (b < B) ? x[(size_t)b * K + k] : 0.f;
      }
      for (int idx = tid; idx < cw * 4; idx += THREADS) {
        const int r = idx >> 2;
        const int q = idx & 3;
        const int col = n0 + q * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col < N)
          v = *reinterpret_cast<const uint4*>(w + (size_t)(g * wrows + r0 + r) * N + col);
        *reinterpret_cast<uint4*>(&ws[r * TN + q * 16]) = v;
      }
      __syncthreads();
      for (int r = 0; r < cw; ++r) {
        const uint2 wv = *reinterpret_cast<const uint2*>(&ws[r * TN + tx * 8]);
        float wa[8], wb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = (j < 4) ? wv.x : wv.y;
          const uint32_t byte = (word >> (8 * (j & 3))) & 0xFFu;
          if (BITS == 4) {
            wa[j] = small_u2f(byte & 0xFu);  // biased codes in [0, 15]
            wb[j] = small_u2f(byte >> 4);
          } else {
            wa[j] = small_u2f(byte ^ 0x80u) - 128.0f;  // int8 code, exact
            wb[j] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int row = ty + 16 * i;
          const float xl = xs[row * XS + r];
          if (BITS == 4) {
            const float xh = xs[row * XS + 64 + r];
            rsum[i] += xl + xh;
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] += xl * wa[j] + xh * wb[j];
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] += xl * wa[j];
          }
        }
      }
    }
    if (col_ok) {
      float sc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j] = scale[(size_t)g * N + n0 + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = (BITS == 4) ? part[i][j] - 8.0f * rsum[i] : part[i][j];
          acc[i][j] += p * sc[j];
        }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty + 16 * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)b * N + n0 + tx * 8 + j] = acc[i][j];
  }
}

// ---------------------------------------------------------------- W4A8
template <int RPT>
__global__ void __launch_bounds__(THREADS)
qmm_w4a8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                int B, int K, int N, int gs, int gps) {
  constexpr int ROWS = 16 * RPT;
  // per row: 64 low-half bytes, then 64 high-half bytes (+4 pad)
  __shared__ __align__(16) int8_t xs[ROWS * XS];
  // weights transposed to [column][packed row] so that 4 consecutive packed
  // rows of one column form one 32-bit word for __dp4a
  __shared__ __align__(16) uint8_t wt[TN * WT];

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // columns n0 + tx + 8*j (interleaved: conflict-free)
  const int ty = tid >> 3;  // rows b0 + ty + 16*i
  const int n0 = blockIdx.x * TN;
  const int b0 = blockIdx.y * ROWS;
  const int half = gs / 2;
  const int cw = half < 64 ? half : 64;
  const int chunks = half / cw;
  const int groups = K / gs;
  const int g0 = blockIdx.z * gps;
  const int g1 = min(groups, g0 + gps);
  out += (size_t)blockIdx.z * B * N;

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int g = g0; g < g1; ++g) {
    int part[RPT][8];
    int xsum[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      xsum[i] = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0;
    }
    for (int c = 0; c < chunks; ++c) {
      const int r0 = c * cw;
      __syncthreads();
      for (int idx = tid; idx < ROWS * 2 * cw; idx += THREADS) {
        const int row = idx / (2 * cw);
        const int j = idx - row * 2 * cw;
        const int k = (j < cw) ? g * gs + r0 + j : g * gs + half + r0 + (j - cw);
        const int slot = (j < cw) ? j : 64 + (j - cw);
        const int b = b0 + row;
        xs[row * XS + slot] = (b < B) ? x[(size_t)b * K + k] : (int8_t)0;
      }
      for (int idx = tid; idx < cw * 4; idx += THREADS) {
        const int r = idx >> 2;
        const int q = idx & 3;
        const int col = n0 + q * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col < N)
          v = *reinterpret_cast<const uint4*>(w + (size_t)(g * half + r0 + r) * N + col);
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          wt[(q * 16 + e) * WT + r] = (uint8_t)((words[e >> 2] >> (8 * (e & 3))) & 0xFFu);
      }
      __syncthreads();
      for (int r4 = 0; r4 < cw / 4; ++r4) {
        int xl[RPT], xh[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int row = ty + 16 * i;
          xl[i] = *reinterpret_cast<const int*>(&xs[row * XS + 4 * r4]);
          xh[i] = *reinterpret_cast<const int*>(&xs[row * XS + 64 + 4 * r4]);
          xsum[i] = __dp4a(xl[i], 0x01010101, xsum[i]);
          xsum[i] = __dp4a(xh[i], 0x01010101, xsum[i]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(&wt[(tx + 8 * j) * WT + 4 * r4]);
          const int lo = (int)(word & 0x0F0F0F0Fu);         // biased codes, 4 rows
          const int hi = (int)((word >> 4) & 0x0F0F0F0Fu);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            part[i][j] = __dp4a(xl[i], lo, part[i][j]);
            part[i][j] = __dp4a(xh[i], hi, part[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 8 * j;
      if (col >= N) continue;
      const float sc = scale[(size_t)g * N + col];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][j] += (float)(part[i][j] - 8 * xsum[i]) * sc;
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty + 16 * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 8 * j;
      if (col < N) out[(size_t)b * N + col] = acc[i][j];
    }
  }
}

// out[i] = sum over splits of ws[split][i], added in split order
template <typename OT>
__global__ void reduce_splits_kernel(const float* __restrict__ ws, OT* __restrict__ out,
                                     int splits, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[(size_t)k * n + i];
    store_f32(&out[i], s);
  }
}

template <typename OT>
void launch_reduce(const float* ws, void* out, int splits, long long n, cudaStream_t st) {
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_splits_kernel<OT><<<(unsigned)blocks, 256, 0, st>>>(ws, (OT*)out, splits, n);
}

// ---------------------------------------------------------------- bf16 x, tensor cores
// bf16 activations, int4 or int8 weights, any group size that is a multiple
// of 16: the weight codes are converted to bf16 in shared memory order and
// multiplied on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate). Codes and bf16 activations are exact in bf16, so every
// product is exact and the group sums differ from the plain version only in
// their order; the -8 fold and the group scale stay in f32 per group. A
// group is walked in chunks of min(gs, 128) values of K (int4: half as many
// packed rows, whose low and high nibbles pair with two runs of x values).
// GS = 128 (the serving path) makes the group size a compile-time constant,
// so every tile loop unrolls; GS = 0 reads it from gs at run time.
constexpr int MMA_TN = 128;      // output columns per block: 8 warps x 16
constexpr int MMA_THREADS = 256;
constexpr int MMA_XS = 136;      // x tile row stride in bf16 (68 words: conflict-free A loads)
constexpr int MMA_WS = 144;      // weight tile row stride in bytes (rows 2 apart: banks 8 apart)

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BITS, int GS, typename OT>
__global__ void __launch_bounds__(MMA_THREADS)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scale, OT* __restrict__ out,
               int B, int K, int N, int gs, int gps) {
  constexpr int MAXW = (BITS == 4) ? 64 : 128;  // weight rows per chunk
  __shared__ __align__(16) __nv_bfloat16 xs[64 * MMA_XS];
  __shared__ __align__(16) uint8_t ws[MAXW * MMA_WS];
  __shared__ float rs[64];  // per-row sum of this group's x (int4 fold)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;   // mma groupID
  const int tq = lane & 3;     // mma threadID_in_group
  const int n0 = blockIdx.x * MMA_TN;
  const int b0 = blockIdx.y * 64;
  if (GS) gs = GS;
  const int half = gs / 2;
  const int wrows = (BITS == 4) ? half : gs;  // weight rows per group
  const int kc = min(gs, 128);                 // x values per row per chunk (% 16 == 0)
  const int cw = (BITS == 4) ? kc / 2 : kc;    // weight rows per chunk
  const int chunks = wrows / cw;
  const int groups = K / gs;
  const int g0 = blockIdx.z * gps;
  const int g1 = min(groups, g0 + gps);
  out += (size_t)blockIdx.z * B * N;
  const int wc = warp * 16;    // this warp's first column in the tile

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int g = g0; g < g1; ++g) {
    float part[4][2][4];
    for (int c = 0; c < chunks; ++c) {
      const int r0 = c * cw;
      __syncthreads();  // the previous chunk's readers are done
      // x tile: 64 rows x kc bf16, 16-byte loads (gs % 16 == 0); int4 puts
      // x[g*gs + r0 ..] in columns [0, cw) and x[g*gs + gs/2 + r0 ..] in [cw, 2cw)
      const int pieces = kc / 8;
      for (int idx = tid; idx < 64 * pieces; idx += MMA_THREADS) {
        const int row = idx / pieces;
        const int j = (idx - row * pieces) * 8;
        const int k = (BITS == 4 && j >= cw) ? g * gs + half + r0 + (j - cw) : g * gs + r0 + j;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (b0 + row < B) v = *reinterpret_cast<const uint4*>(x + (size_t)(b0 + row) * K + k);
        *reinterpret_cast<uint4*>(&xs[row * MMA_XS + j]) = v;
      }
      // weight tile: cw rows x 128 bytes
      for (int idx = tid; idx < cw * 8; idx += MMA_THREADS) {
        const int r = idx >> 3;
        const int col = n0 + (idx & 7) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col < N) v = *reinterpret_cast<const uint4*>(w + (size_t)(g * wrows + r0 + r) * N + col);
        *reinterpret_cast<uint4*>(&ws[r * MMA_WS + (idx & 7) * 16]) = v;
      }
      __syncthreads();
      if (BITS == 4) {  // row sums, over the group's chunks: 4 threads per row
        const int row = tid >> 2;
        const int per = kc / 4;
        float t = 0.f;
#pragma unroll 8
        for (int k = 0; k < per; ++k) t += __bfloat162float(xs[row * MMA_XS + (tid & 3) * per + k]);
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        if ((tid & 3) == 0) rs[row] = (c == 0) ? t : rs[row] + t;
        __syncthreads();
      }
      if (c == 0) {  // the group's sums start here
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
      }
#pragma unroll 2
      for (int st = 0; st < kc / 16; ++st) {
        const int k0 = st * 16 + tq * 2;  // this thread's first k in the step
        uint32_t bf[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = wc + nt * 8 + gid;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k0 + (e & 1) + (e >> 1) * 8;
            if (BITS == 4) {  // k < cw: low nibble of packed row k, else high nibble of row k-cw
              const bool lo = kk < cw;
              const uint32_t byte = ws[(lo ? kk : kk - cw) * MMA_WS + col];
              v[e] = small_u2f(lo ? (byte & 0xFu) : (byte >> 4));
            } else {
              v[e] = (float)(int8_t)ws[kk * MMA_WS + col];
            }
          }
          bf[nt][0] = bf16x2_bits(v[0], v[1]);
          bf[nt][1] = bf16x2_bits(v[2], v[3]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* xr = &xs[(mt * 16 + gid) * MMA_XS + k0];
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(xr);
          af[1] = *reinterpret_cast<const uint32_t*>(xr + 8 * MMA_XS);
          af[2] = *reinterpret_cast<const uint32_t*>(xr + 8);
          af[3] = *reinterpret_cast<const uint32_t*>(xr + 8 * MMA_XS + 8);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(part[mt][nt], af, bf[nt]);
        }
      }
    }
    // group epilogue: -8 fold and scale in f32
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + wc + nt * 8 + tq * 2;
      if (col >= N) continue;
      const float s0 = scale[(size_t)g * N + col];
      const float s1 = scale[(size_t)g * N + col + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = part[mt][nt][i];
          if (BITS == 4) p -= 8.0f * rs[mt * 16 + gid + (i >> 1) * 8];
          acc[mt][nt][i] += p * ((i & 1) ? s1 : s0);
        }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = n0 + wc + nt * 8 + tq * 2;
    if (col >= N) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + mt * 16 + gid + h * 8;
        if (b >= B) continue;
        store_f32(&out[(size_t)b * N + col], acc[mt][nt][2 * h]);
        store_f32(&out[(size_t)b * N + col + 1], acc[mt][nt][2 * h + 1]);
      }
  }
}

template <int BITS, int GS>
void launch_mma(const void* x, const void* w, const void* s, void* out, int B, int K, int N,
                int gs, int gps, int splits, float* ws, cudaStream_t st) {
  dim3 grid((N + MMA_TN - 1) / MMA_TN, (B + 63) / 64, splits);
  if (splits == 1) {
    qmm_mma_kernel<BITS, GS, __nv_bfloat16><<<grid, MMA_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)s, (__nv_bfloat16*)out,
        B, K, N, gs, gps);
    return;
  }
  qmm_mma_kernel<BITS, GS, float><<<grid, MMA_THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)s, ws, B, K, N, gs, gps);
  launch_reduce<__nv_bfloat16>(ws, out, splits, (long long)B * N, st);
}

template <int BITS>
void launch_mma_gs(const void* x, const void* w, const void* s, void* out, int B, int K, int N,
                   int gs, int gps, int splits, float* ws, cudaStream_t st) {
  if (gs == 128)
    launch_mma<BITS, 128>(x, w, s, out, B, K, N, gs, gps, splits, ws, st);
  else
    launch_mma<BITS, 0>(x, w, s, out, B, K, N, gs, gps, splits, ws, st);
}

// splits == 1: straight into out; else f32 partials into ws, then the sum
template <int BITS>
void launch_f32(const void* x, const void* w, const void* s, void* out, int B, int K, int N,
                int gs, int gps, int splits, float* ws, cudaStream_t st) {
  float* dst = splits > 1 ? ws : (float*)out;
  if (B <= 16) {
    dim3 grid((N + TN - 1) / TN, (B + 15) / 16, splits);
    qmm_f32_kernel<BITS, 1><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const uint8_t*)w, (const float*)s, dst, B, K, N, gs, gps);
  } else {
    dim3 grid((N + TN - 1) / TN, (B + 63) / 64, splits);
    qmm_f32_kernel<BITS, 4><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const uint8_t*)w, (const float*)s, dst, B, K, N, gs, gps);
  }
  if (splits > 1) launch_reduce<float>(ws, out, splits, (long long)B * N, st);
}

}  // namespace

// x_kind: 0 = float32 x and out, 1 = bfloat16 x and out, 2 = int8 x (W4A8,
// float32 out before the row scale). K is split into `splits` runs of `gps`
// scale groups; with splits > 1, `workspace` holds splits*B*N floats.
// bf16 x takes the tensor-core kernel and needs gs % 16 == 0.
// Returns a cudaError_t code.
extern "C" int tpuserve_quant_matmul(const void* x, const void* w, const void* scale,
                                     void* out, int B, int K, int N, int gs, int bits,
                                     int x_kind, int gps, int splits, void* workspace,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (splits < 1 || (splits > 1 && workspace == nullptr)) return (int)cudaErrorInvalidValue;
  float* ws = (float*)workspace;
  if (x_kind == 1) {  // bf16 x: tensor cores
    if (gs % 16 != 0) return (int)cudaErrorInvalidValue;
    if (bits == 4)
      launch_mma_gs<4>(x, w, scale, out, B, K, N, gs, gps, splits, ws, st);
    else if (bits == 8)
      launch_mma_gs<8>(x, w, scale, out, B, K, N, gs, gps, splits, ws, st);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (x_kind == 2) {
    if (bits != 4) return (int)cudaErrorInvalidValue;
    float* dst = splits > 1 ? ws : (float*)out;
    const int rows = B <= 16 ? 16 : 64;
    dim3 grid((N + TN - 1) / TN, (B + rows - 1) / rows, splits);
    if (B <= 16)
      qmm_w4a8_kernel<1><<<grid, THREADS, 0, st>>>((const int8_t*)x, (const uint8_t*)w,
                                                   (const float*)scale, dst, B, K, N, gs, gps);
    else
      qmm_w4a8_kernel<4><<<grid, THREADS, 0, st>>>((const int8_t*)x, (const uint8_t*)w,
                                                   (const float*)scale, dst, B, K, N, gs, gps);
    if (splits > 1) launch_reduce<float>(ws, out, splits, (long long)B * N, st);
    return (int)cudaGetLastError();
  }
  if (x_kind != 0) return (int)cudaErrorInvalidValue;
  if (bits == 4)
    launch_f32<4>(x, w, scale, out, B, K, N, gs, gps, splits, ws, st);
  else if (bits == 8)
    launch_f32<8>(x, w, scale, out, B, K, N, gs, gps, splits, ws, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
