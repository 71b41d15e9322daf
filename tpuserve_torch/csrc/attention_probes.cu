// Probes of the decode-attention diagnostic ladder
// (tpuserve_torch/scripts/sweep_attention.py): how fast the card streams an
// int8 K/V cache in the attention's access pattern, with and without the
// attention's dots.
//
// Replaces the Pallas kernels of scripts/sweep_attention.py: dma_bound.kern
// and dma_wide.kern (2-D and 3-D) by tpuserve_probe_colsum, dot_only.kern
// by tpuserve_probe_dot_only. The TPU probes write the last block's first
// row (a value of no meaning); each probe here computes a function of every
// byte it streams, so that no load can be dropped.
//
// colsum: int32 column sums [128] over every 128-byte row segment of K and
// of V, each block summing one contiguous chunk of both and adding its sums
// to the output with atomics (integer sums: the order does not matter).
// Bound: bytes. A thread loads 16 bytes at a time, UNROLL loads in flight,
// neighbouring threads on neighbouring addresses; it owns 16 columns and
// adds its bytes in 16-bit lanes (two columns a 32-bit add, flushed to int32
// every FLUSH loads), so that the adds stay far below the load rate.
// Block order: BY_SLOT = false walks the chunks of the flat [rows, width]
// view in one grid dimension (dma_wide 2-D); BY_SLOT = true takes a grid of
// (chunks of a slot, slots) (dma_bound, dma_wide 3-D).
//
// dot_only: out[s, m, :] = sum over every row r of [S, R, 128] of
// bf16(1e-6 * (qi[s, m] . k[s, r])) * v[s, r, :], f32 accumulation: the
// attention's two dots over every query row and every cache row, without
// softmax or head matching. Bound: its operations, on the CUDA cores here
// (the f32 P@V reads each V value from shared memory once per query row;
// tensor cores would take the P@V off them). A
// block takes rows_per_block rows of one slot in tiles of DT rows: a thread
// owns a K row and runs its int8 dots against the query codes in shared
// memory; the tile's V rows are converted to f32 once into shared memory
// (converting per query row made the int-to-float conversions the limit);
// then each thread accumulates 16 output columns of a query row over the
// tile (columns g*4 + 32*k + e, so that the 8 column groups of a warp read
// 128 consecutive bytes). Blocks add their partial sums to the output with
// float atomics.
//
// colsum_strided: replaces scripts/diag_bw.py::copy_kernel (:78), in the
// three forms its modes call (pcopy :137, pcopy4d :165, pdyn :201; the
// make_pallas calls :92 and :99 are reached by no mode). A block sums `rows`
// runs of run_bytes at a stride of row_stride bytes into int32 column sums
// [hd], hd any multiple of 16 up to 256 (copy_kernel's reshape(-1, hd)),
// over K and V alike, and adds them to the output with atomics; the TPU
// kernel writes each block's sums over the last one's. With positions, the
// blocks x past max(positions[slot], 0) / live_div read nothing (pdyn's
// clamped index map: the TPU re-reads the live block, which its pipeline
// skips). Bound: bytes. The loads and the 16-bit lane sums are colsum's;
// a thread keeps one 16-column group (a multiple of hd / 16 threads load,
// the rest idle), walking the block's flattened 16-byte units with its row
// and offset advanced by constant steps, not divided out per load.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int PT = 256;     // threads a block
constexpr int UNROLL = 4;   // 16-byte loads in flight a thread
constexpr int FLUSH = 128;  // loads between flushes of the 16-bit lanes (128 * 255 < 65536)
constexpr int HDP = 128;    // bytes of a row segment (head_dim of an int8 cache)

// adds the 16 signed bytes of w, biased by 128, into 16-bit lane sums
__device__ __forceinline__ void add_biased(const uint4& w, uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const uint32_t x[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] += x[q] & 0x00FF00FFu;         // bytes 0 and 2 of word q
    hi[q] += (x[q] >> 8) & 0x00FF00FFu;  // bytes 1 and 3
  }
}

__device__ __forceinline__ void flush(uint32_t (&lo)[4], uint32_t (&hi)[4], int (&sums)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sums[4 * q + 0] += (int)(lo[q] & 0xFFFFu);
    sums[4 * q + 2] += (int)(lo[q] >> 16);
    sums[4 * q + 1] += (int)(hi[q] & 0xFFFFu);
    sums[4 * q + 3] += (int)(hi[q] >> 16);
    lo[q] = hi[q] = 0;
  }
}

template <bool BY_SLOT>
__global__ void __launch_bounds__(PT) colsum_kernel(const int8_t* k, const int8_t* v, int* out,
                                                    long long chunk_bytes, long long slot_bytes) {
  __shared__ int col[HDP];
  const int tid = threadIdx.x;
  if (tid < HDP) col[tid] = 0;
  const size_t start = BY_SLOT ? (size_t)blockIdx.y * slot_bytes + (size_t)blockIdx.x * chunk_bytes
                               : (size_t)blockIdx.x * chunk_bytes;
  const long long n16 = chunk_bytes / 16;  // 16-byte units; unit u holds columns (u % 8) * 16 ..
  int sums[16] = {};
  uint32_t lo[4] = {}, hi[4] = {};
  int loads = 0, since = 0;
  for (int t = 0; t < 2; ++t) {
    const uint4* p = reinterpret_cast<const uint4*>((t ? v : k) + start);
    for (long long u = tid; u < n16; u += (long long)PT * UNROLL) {
      uint4 w[UNROLL];
#pragma unroll
      for (int r = 0; r < UNROLL; ++r)
        if (u + r * PT < n16) w[r] = p[u + r * PT];
#pragma unroll
      for (int r = 0; r < UNROLL; ++r)
        if (u + r * PT < n16) {
          add_biased(w[r], lo, hi);
          ++loads;
          ++since;
        }
      if (since >= FLUSH - UNROLL) {
        flush(lo, hi, sums);
        since = 0;
      }
    }
  }
  flush(lo, hi, sums);
  // lanes l, l ^ 8, l ^ 16, l ^ 24 own the same columns
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    int s = sums[e] - 128 * loads;
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    sums[e] = s;
  }
  __syncthreads();  // col is zeroed
  const int lane = tid & 31;
  if (lane < 8) {
#pragma unroll
    for (int e = 0; e < 16; ++e) atomicAdd(&col[lane * 16 + e], sums[e]);
  }
  __syncthreads();
  if (tid < HDP) atomicAdd(&out[tid], col[tid]);
}

constexpr int DT = 64;        // rows of a dot_only tile
constexpr int MAX_PAIRS = 4;  // (query row, 16-column group) pairs a thread: M <= 128

// floats of dot_only's P tile [M][DT + 1], rounded up so that the query
// codes after it start on a 16-byte boundary
__host__ __device__ inline size_t p_tile_floats(int M) {
  return ((size_t)M * (DT + 1) + 3) / 4 * 4;
}

__global__ void __launch_bounds__(PT) dot_only_kernel(const int8_t* qi, const int8_t* k,
                                                      const int8_t* v, float* out, int M, int R,
                                                      int rows_per_block) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float* vt = reinterpret_cast<float*>(dsm);                     // [DT][128] V values
  float* pt = vt + (size_t)DT * HDP;                             // [M][DT + 1] P
  int8_t* q8 = reinterpret_cast<int8_t*>(pt + p_tile_floats(M));  // [M][128]
  const int tid = threadIdx.x;
  const int slot = blockIdx.y;
  const size_t r_begin = (size_t)blockIdx.x * rows_per_block;
  const int8_t* kb = k + ((size_t)slot * R + r_begin) * HDP;
  const int8_t* vb = v + ((size_t)slot * R + r_begin) * HDP;
  for (int u = tid; u < M * HDP / 16; u += PT)
    reinterpret_cast<uint4*>(q8)[u] =
        reinterpret_cast<const uint4*>(qi + (size_t)slot * M * HDP)[u];

  const int pairs = M * 8;
  float acc[MAX_PAIRS][16];
#pragma unroll
  for (int pp = 0; pp < MAX_PAIRS; ++pp)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[pp][e] = 0.f;

  for (int r0 = 0; r0 < rows_per_block; r0 += DT) {
    __syncthreads();  // q8 loaded; the last tile's vt and pt read
    for (int u = tid; u < DT * HDP / 16; u += PT) {
      const uint4 w = reinterpret_cast<const uint4*>(vb + (size_t)r0 * HDP)[u];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<float4*>(vt)[u * 4 + q] = make_float4(
            (float)(int8_t)(ws[q] & 0xFFu), (float)(int8_t)((ws[q] >> 8) & 0xFFu),
            (float)(int8_t)((ws[q] >> 16) & 0xFFu), (float)(int8_t)(ws[q] >> 24));
    }
    // scores: thread owns row i of the tile and query rows m0, m0 + PT / DT, ...
    {
      const int i = tid % DT;
      const uint4* kp = reinterpret_cast<const uint4*>(kb + (size_t)(r0 + i) * HDP);
      uint4 kw[HDP / 16];
#pragma unroll
      for (int c = 0; c < HDP / 16; ++c) kw[c] = kp[c];
      for (int m = tid / DT; m < M; m += PT / DT) {
        const int4* qp = reinterpret_cast<const int4*>(q8 + (size_t)m * HDP);
        int d = 0;
#pragma unroll
        for (int c = 0; c < HDP / 16; ++c) {
          const int4 qq = qp[c];
          d = __dp4a(qq.x, (int)kw[c].x, d);
          d = __dp4a(qq.y, (int)kw[c].y, d);
          d = __dp4a(qq.z, (int)kw[c].z, d);
          d = __dp4a(qq.w, (int)kw[c].w, d);
        }
        pt[(size_t)m * (DT + 1) + i] = __bfloat162float(__float2bfloat16_rn((float)d * 1e-6f));
      }
    }
    __syncthreads();
    // P @ V: pair pp = (m, column group g), columns g*4 + 32*k + e
#pragma unroll
    for (int pp = 0; pp < MAX_PAIRS; ++pp) {
      const int pair = tid + pp * PT;
      if (pair >= pairs) break;
      const int m = pair >> 3, g = pair & 7;
      for (int i = 0; i < DT; ++i) {
        const float p = pt[(size_t)m * (DT + 1) + i];
        const float4* vr = reinterpret_cast<const float4*>(vt + (size_t)i * HDP);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 x = vr[g + 8 * k];
          acc[pp][4 * k + 0] += p * x.x;
          acc[pp][4 * k + 1] += p * x.y;
          acc[pp][4 * k + 2] += p * x.z;
          acc[pp][4 * k + 3] += p * x.w;
        }
      }
    }
  }
#pragma unroll
  for (int pp = 0; pp < MAX_PAIRS; ++pp) {
    const int pair = tid + pp * PT;
    if (pair >= pairs) break;
    const int m = pair >> 3, g = pair & 7;
    float* o = out + ((size_t)slot * M + m) * HDP + g * 4;
#pragma unroll
    for (int e = 0; e < 16; ++e) atomicAdd(o + 32 * (e >> 2) + (e & 3), acc[pp][e]);
  }
}

constexpr int MAX_HD = 256;  // widest row segment colsum_strided takes

struct StridedArgs {
  long long slot_stride, group_stride, block_stride, row_stride;  // bytes
  int rows, run_bytes, hd, live_div;
  const int* pos;  // [slots] or null
};

__global__ void __launch_bounds__(PT) colsum_strided_kernel(const int8_t* k, const int8_t* v,
                                                            int* out, StridedArgs a) {
  __shared__ int col[MAX_HD];
  const int jb = blockIdx.x, slot = blockIdx.z;
  if (a.pos != nullptr && jb > max(a.pos[slot], 0) / a.live_div) return;  // the whole block
  const int tid = threadIdx.x;
  for (int c = tid; c < a.hd; c += PT) col[c] = 0;
  const int ncg = a.hd / 16;              // 16-column groups of a row segment
  const int active = (PT / ncg) * ncg;    // loading threads: unit U has group U % ncg
  const long long upr = a.run_bytes / 16; // 16-byte units of a run
  const long long total = upr * a.rows;
  const long long dr = active / upr, du = active % upr;  // (row, unit) step of `active` units
  const size_t base = (size_t)slot * a.slot_stride + (size_t)blockIdx.y * a.group_stride +
                      (size_t)jb * a.block_stride;
  int sums[16] = {};
  uint32_t lo[4] = {}, hi[4] = {};
  int loads = 0, since = 0;
  if (tid < active) {
    for (int t = 0; t < 2; ++t) {
      const int8_t* p = (t ? v : k) + base;
      long long row = tid / upr, u = tid % upr;
      for (long long U = tid; U < total; U += (long long)active * UNROLL) {
        uint4 w[UNROLL];
        int n = 0;
#pragma unroll
        for (int r = 0; r < UNROLL; ++r) {
          if (U + (long long)r * active < total) {
            w[r] = *reinterpret_cast<const uint4*>(p + row * a.row_stride + u * 16);
            n = r + 1;
          }
          row += dr;
          u += du;
          if (u >= upr) {
            u -= upr;
            ++row;
          }
        }
#pragma unroll
        for (int r = 0; r < UNROLL; ++r)
          if (r < n) {
            add_biased(w[r], lo, hi);
            ++loads;
            ++since;
          }
        if (since >= FLUSH - UNROLL) {
          flush(lo, hi, sums);
          since = 0;
        }
      }
    }
  }
  flush(lo, hi, sums);
#pragma unroll
  for (int e = 0; e < 16; ++e) sums[e] -= 128 * loads;
  const int lane = tid & 31;
  const bool pow2 = (32 % ncg) == 0;  // every lane loads; lanes l, l + ncg, ... share columns
  if (pow2) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      for (int o = ncg; o < 32; o <<= 1) sums[e] += __shfl_xor_sync(0xffffffffu, sums[e], o);
  }
  __syncthreads();  // col is zeroed
  if (tid < active && (!pow2 || lane < ncg)) {
    const int cg = tid % ncg;
#pragma unroll
    for (int e = 0; e < 16; ++e) atomicAdd(&col[cg * 16 + e], sums[e]);
  }
  __syncthreads();
  for (int c = tid; c < a.hd; c += PT) atomicAdd(&out[c], col[c]);
}

}  // namespace

// Column sums [hd] int32 (out, zeroed by the caller) over k and v: block
// (x, y, z) of the grid (blocks_x, groups, slots) sums `rows` runs of
// run_bytes, row_stride apart, from z * slot_stride + y * group_stride +
// x * block_stride; with pos ([slots] int32), blocks x > max(pos[z], 0) /
// live_div read nothing. hd is a multiple of 16 up to 256 and divides
// run_bytes; the offsets are multiples of 16. Returns a cudaError_t code.
extern "C" int tpuserve_probe_colsum_strided(const void* k, const void* v, void* out,
                                             const int* pos, long long slot_stride,
                                             long long group_stride, long long block_stride,
                                             long long row_stride, int rows, int run_bytes,
                                             int hd, int live_div, int blocks_x, int groups,
                                             int slots, void* stream) {
  if (blocks_x <= 0 || groups <= 0 || slots <= 0 || rows <= 0) return 0;
  if (hd <= 0 || hd % 16 || hd > MAX_HD || run_bytes <= 0 || run_bytes % hd ||
      (slot_stride | group_stride | block_stride | row_stride) % 16 ||
      (pos != nullptr && live_div <= 0))
    return (int)cudaErrorInvalidValue;
  StridedArgs a;
  a.slot_stride = slot_stride; a.group_stride = group_stride; a.block_stride = block_stride;
  a.row_stride = row_stride; a.rows = rows; a.run_bytes = run_bytes; a.hd = hd;
  a.live_div = live_div; a.pos = pos;
  colsum_strided_kernel<<<dim3(blocks_x, groups, slots), PT, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), (int*)out, a);
  return (int)cudaGetLastError();
}

// Column sums [128] int32 (out, zeroed by the caller) over k and v: chunks
// of chunk_bytes (a multiple of 128 * 16); by_slot: grid (chunks_x, slots)
// with slots slot_bytes apart, else grid (chunks_x). Returns a cudaError_t.
extern "C" int tpuserve_probe_colsum(const void* k, const void* v, void* out,
                                     long long chunk_bytes, long long slot_bytes, int chunks_x,
                                     int slots, int by_slot, void* stream) {
  if (chunks_x <= 0 || slots <= 0) return 0;
  if (chunk_bytes <= 0 || chunk_bytes % (HDP * 16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  if (by_slot)
    colsum_kernel<true><<<dim3(chunks_x, slots), PT, 0, st>>>(kp, vp, (int*)out, chunk_bytes,
                                                              slot_bytes);
  else
    colsum_kernel<false><<<dim3(chunks_x), PT, 0, st>>>(kp, vp, (int*)out, chunk_bytes, 0);
  return (int)cudaGetLastError();
}

// dot_only over qi [S, M, 128] int8 and k/v [S, R, 128] int8 into out
// [S, M, 128] f32 (zeroed by the caller); rows_per_block divides R and is a
// multiple of 64; M <= 128. Returns a cudaError_t code.
extern "C" int tpuserve_probe_dot_only(const void* qi, const void* k, const void* v, void* out,
                                       int S, int M, int R, int rows_per_block, void* stream) {
  if (S <= 0) return 0;
  if (M <= 0 || M > MAX_PAIRS * PT / 8 || rows_per_block <= 0 || rows_per_block % DT ||
      R % rows_per_block)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)DT * HDP + p_tile_floats(M)) * sizeof(float) + (size_t)M * HDP;
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(dot_only_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dot_only_kernel<<<dim3(R / rows_per_block, S), PT, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(qi), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), (float*)out, M, R, rows_per_block);
  return (int)cudaGetLastError();
}
