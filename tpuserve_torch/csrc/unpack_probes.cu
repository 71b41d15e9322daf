// The int4 nibble-unpack microbenchmark (tpuserve_torch/scripts/
// unpack_microbench.py): one packed int8 stream x [N, W2] read by kernels
// that differ only in what they compute on each block, so that their rates
// show what the unpack costs on top of the stream.
//
// Replaces the Pallas kernels of scripts/unpack_microbench.py, all called
// through build() (:153): _k_stream_raw (:52), _k_dot_raw (:62),
// _k_unpack_cur (:75), _k_unpack_hi (:95) and _k_unpack_i8 (:119). They are
// one kernel template here, unpack_probe_kernel<VARIANT, MT>:
//
//   STREAM_RAW  out[0, 0] = sum of every byte of x + n_blocks * seed;
//   DOT_RAW     s = q . x_r (q int8 [M, W2], every row r of x);
//   UNPACK_CUR  s = q . lo + q . hi - 8 * sum(q), lo = b & 15, hi = b >> 4
//               (arithmetic), each byte widened to 32 bits, masked and
//               shifted, and narrowed again (the TPU's production sequence);
//   UNPACK_I8   the same s, the nibbles cut four bytes an instruction on
//               32-bit words (lo = w & 0x0F0F0F0F; hi + 8 = ((w >> 4) &
//               0x0F0F0F0F) ^ 0x08080808, one shift and one lop3), which is
//               what the flat decode-attention kernel does for K; the fold
//               takes the 8 back: s = q . lo + q . (hi + 8) - 16 * sum(q);
//   UNPACK_HI   the same s from two dots: the raw signed byte b = 16 hi + lo
//               is dotted directly and only hi (as hi + 8, the same two
//               instructions) is materialised, lo being recovered as
//               d_b - 16 d_h: s = d_b - 15 * q . (hi + 8) + 112 * sum(q).
//
// Every variant but STREAM_RAW folds every row: out[m, c] = sum over the
// rows r = c (mod 128) of s[m, r], plus n_blocks * seed. The TPU kernels keep
// s[:, :128] of each 256-row block, so rows 128-255 of a block feed nothing;
// here every byte reaches the output, so no load can be dropped. At 128-row
// blocks the two functions are the same. All sums are exact integers: int32
// in the tensor cores' accumulators over at most flush_every groups of 128
// rows (one row a residue; |s| <= 2^14 W2 a row for any int8 inputs), then
// 64-bit integer atomics into the output (int64 [M, 128]; the TPU adds
// into f32).
//
// Bound on the H100: bytes. At the script's shape (x 537 MB, M = 32) the
// dots are 34 GOP (DOT_RAW) or 69 GOP (two dots) against 0.16 ms of bytes,
// so they run on the tensor cores (mma.sync m16n8k32, s8 x s8 -> s32): on
// dp4a they would take longer than the bytes and hide the unpack they are
// there to measure. Design: one block of 8 warps per SM, each block a
// contiguous run of 128-row groups. Warp w owns the 32 residues [32 (w % 4),
// +32) of the fold and takes every other group of its block (w / 4): its
// accumulators are the fold itself, four n-tiles of 8 rows by M query rows.
// Since a dot sums over k in any order, a lane reads 16 consecutive bytes of
// its row (four lanes cover 64 bytes of one row) and feeds them to two
// k32 steps; q is laid out in shared memory once per block in the same k
// order, as fragments that a warp reads with conflict-free 16-byte loads.
// Each warp keeps the loads of the next three 64-byte chunks in flight
// while it computes on the current one.
#include "common.cuh"

namespace {

enum Variant { STREAM_RAW = 0, DOT_RAW = 1, UNPACK_CUR = 2, UNPACK_HI = 3, UNPACK_I8 = 4 };

constexpr int UP_WARPS = 8;
constexpr int UP_THREADS = UP_WARPS * 32;
constexpr int GROUP = 128;          // rows of a group: one per residue of the fold
constexpr int CHUNK = 64;           // bytes of a row a warp reads per step
constexpr int NT = 4;               // n-tiles of 8 rows: the 32 rows of a warp in a group

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The TPU's production unpack, byte by byte: widen to 32 bits with the
// sign, & 15 and >> 4 (arithmetic), narrow each back into its byte. Written
// in PTX so that the compiler does not fold it into the word-wide form.
__device__ __forceinline__ void unpack_cur(uint32_t w, uint32_t& lo, uint32_t& hi) {
  asm("{\n\t.reg .s32 b, l, h;\n\t"
      "bfe.s32 b, %2, 0, 8;\n\tand.b32 %0, b, 15;\n\tshr.s32 %1, b, 4;\n\t"
      "bfe.s32 b, %2, 8, 8;\n\tand.b32 l, b, 15;\n\tshr.s32 h, b, 4;\n\t"
      "bfi.b32 %0, l, %0, 8, 8;\n\tbfi.b32 %1, h, %1, 8, 8;\n\t"
      "bfe.s32 b, %2, 16, 8;\n\tand.b32 l, b, 15;\n\tshr.s32 h, b, 4;\n\t"
      "bfi.b32 %0, l, %0, 16, 8;\n\tbfi.b32 %1, h, %1, 16, 8;\n\t"
      "bfe.s32 b, %2, 24, 8;\n\tand.b32 l, b, 15;\n\tshr.s32 h, b, 4;\n\t"
      "bfi.b32 %0, l, %0, 24, 8;\n\tbfi.b32 %1, h, %1, 24, 8;\n\t}"
      : "=r"(lo), "=r"(hi)
      : "r"(w));
}

// hi + 8 of each byte (hi = b >> 4 arithmetic, in [-8, 7]): the unsigned
// high nibble with its top bit flipped
__device__ __forceinline__ uint32_t hi_biased(uint32_t w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

__device__ __forceinline__ uint4 load_stream(const int8_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

template <int V, int MT>
__global__ void __launch_bounds__(UP_THREADS, 1)
unpack_probe_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ q,
                    long long* __restrict__ out, long long n_groups, int w2,
                    long long seed_total, int flush_every) {
  extern __shared__ __align__(16) unsigned char dsm[];
  constexpr int RR = 2 * MT;  // row octets of q: rows rr * 8 + lane / 4
  uint4* sq = reinterpret_cast<uint4*>(dsm);  // [w2 / CHUNK][RR][32] fragments of q
  __shared__ int s_qsum[16 * MT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;   // mma groupID: the row of an n-tile, of an m-tile
  const int tq = lane & 3;    // threadID_in_group: which 16 bytes of the chunk
  const int n_chunks = w2 / CHUNK;

  if (V != STREAM_RAW) {
    for (int i = tid; i < n_chunks * RR * 32; i += UP_THREADS) {
      const int ln = i & 31, rr = (i >> 5) % RR, c = i / (32 * RR);
      sq[i] = *reinterpret_cast<const uint4*>(q + (size_t)(rr * 8 + (ln >> 2)) * w2 + c * CHUNK +
                                              (ln & 3) * 16);
    }
    for (int m = warp; m < 16 * MT; m += UP_WARPS) {
      int s = 0;
      for (int i = lane; i < w2 / 4; i += 32)
        s = __dp4a(reinterpret_cast<const int*>(q + (size_t)m * w2)[i], 0x01010101, s);
      s = tpuserve::warp_sum(s);
      if (lane == 0) s_qsum[m] = s;
    }
    __syncthreads();
  }

  // this block's groups, and this warp's share: every other one
  const long long g_begin = n_groups * blockIdx.x / gridDim.x;
  const long long g_end = n_groups * (blockIdx.x + 1) / gridDim.x;
  const int quarter = warp & 3;
  const int half = warp >> 2;

  int acc[MT][NT][4], acc2[MT][NT][4];  // acc2: UNPACK_HI's d_h
  int ssum = 0;                         // STREAM_RAW
  long long stotal = 0;
  int since = 0;                        // groups summed since the last flush

  auto zero = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = acc2[mt][nt][e] = 0;
  };
  // add the accumulators and the fold's sum(q) terms of `groups` groups (one
  // row a group for each residue) to the output
  auto flush = [&](int groups) {
    if constexpr (V == STREAM_RAW) {
      stotal += ssum;
      ssum = 0;
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = mt * 16 + gq + (e >= 2 ? 8 : 0);
          const long long qs = s_qsum[m];
          long long fold = 0;
          if (V == UNPACK_CUR) fold = -8 * qs;
          if (V == UNPACK_I8) fold = -16 * qs;
          if (V == UNPACK_HI) fold = 112 * qs;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int res = quarter * 32 + nt * 8 + tq * 2 + (e & 1);
            long long val = (long long)acc[mt][nt][e] + fold * groups;
            if (V == UNPACK_HI) val -= 15LL * acc2[mt][nt][e];
            atomicAdd(reinterpret_cast<unsigned long long*>(out + (size_t)m * GROUP + res),
                      (unsigned long long)val);
          }
        }
      zero();
    }
  };
  zero();

  for (long long grp = g_begin + half; grp < g_end; grp += 2) {
    // lane's row of n-tile nt: grp * 128 + quarter * 32 + nt * 8 + gq
    const int8_t* rowp = x + ((size_t)grp * GROUP + quarter * 32 + gq) * w2 + tq * 16;
    // chunk c of the lane's four rows: 16 bytes each
    auto load_chunk = [&](uint4 (&b)[NT], int c) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[nt] = load_stream(rowp + (size_t)nt * 8 * w2 + (size_t)c * CHUNK);
    };
    auto compute_chunk = [&](const uint4 (&b)[NT], int c) {
      if (V == STREAM_RAW) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          ssum = __dp4a((int)b[nt].x, 0x01010101, ssum);
          ssum = __dp4a((int)b[nt].y, 0x01010101, ssum);
          ssum = __dp4a((int)b[nt].z, 0x01010101, ssum);
          ssum = __dp4a((int)b[nt].w, 0x01010101, ssum);
        }
      } else {
        uint4 a[RR];
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) a[rr] = sq[((size_t)c * RR + rr) * 32 + lane];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // step 0 takes words x, y of the lane's 16 bytes; step 1 z, w
          const uint32_t wb[4] = {b[nt].x, b[nt].y, b[nt].z, b[nt].w};
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            const uint32_t w0 = wb[2 * st], w1 = wb[2 * st + 1];
            // the B operands of the step's one or two dots, unpacked once
            // for all m-tiles
            uint32_t p0 = w0, p1 = w1, r0 = 0, r1 = 0;
            if (V == UNPACK_CUR) {
              unpack_cur(w0, p0, r0);
              unpack_cur(w1, p1, r1);
            } else if (V == UNPACK_I8) {
              p0 = w0 & 0x0F0F0F0Fu;
              p1 = w1 & 0x0F0F0F0Fu;
              r0 = hi_biased(w0);
              r1 = hi_biased(w1);
            } else if (V == UNPACK_HI) {
              r0 = hi_biased(w0);
              r1 = hi_biased(w1);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint4& ra = a[2 * mt];
              const uint4& rb = a[2 * mt + 1];
              const uint32_t a0 = st ? ra.z : ra.x, a2 = st ? ra.w : ra.y;
              const uint32_t a1 = st ? rb.z : rb.x, a3 = st ? rb.w : rb.y;
              mma_s8(acc[mt][nt], a0, a1, a2, a3, p0, p1);
              if (V == UNPACK_CUR || V == UNPACK_I8) mma_s8(acc[mt][nt], a0, a1, a2, a3, r0, r1);
              if (V == UNPACK_HI) mma_s8(acc2[mt][nt], a0, a1, a2, a3, r0, r1);
            }
          }
        }
      }
    };
    // four buffers in turn, each refilled as soon as it is used, so that
    // three chunks stay in flight while one is computed on (a rotation by
    // register copies would wait for the loads it copies)
    uint4 b0[NT], b1[NT], b2[NT], b3[NT];
    load_chunk(b0, 0);
    if (1 < n_chunks) load_chunk(b1, 1);
    if (2 < n_chunks) load_chunk(b2, 2);
    for (int c = 0; c < n_chunks; c += 4) {
      if (c + 3 < n_chunks) load_chunk(b3, c + 3);
      compute_chunk(b0, c);
      if (c + 1 >= n_chunks) break;
      if (c + 4 < n_chunks) load_chunk(b0, c + 4);
      compute_chunk(b1, c + 1);
      if (c + 2 >= n_chunks) break;
      if (c + 5 < n_chunks) load_chunk(b1, c + 5);
      compute_chunk(b2, c + 2);
      if (c + 3 >= n_chunks) break;
      if (c + 6 < n_chunks) load_chunk(b2, c + 6);
      compute_chunk(b3, c + 3);
    }
    if (++since == flush_every) {
      flush(since);
      since = 0;
    }
  }
  flush(since);

  if (V == STREAM_RAW) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) stotal += __shfl_xor_sync(0xffffffffu, stotal, o);
    if (lane == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(out), (unsigned long long)stotal);
  }
  // the blocks' n_blocks * seed, once
  if (blockIdx.x == 0 && seed_total != 0) {
    if (V == STREAM_RAW) {
      if (tid == 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(out), (unsigned long long)seed_total);
    } else {
      for (int i = tid; i < 16 * MT * GROUP; i += UP_THREADS)
        atomicAdd(reinterpret_cast<unsigned long long*>(out + i), (unsigned long long)seed_total);
    }
  }
}

template <int V, int MT>
int launch(const void* x, const void* q, void* out, long long n_groups, int w2,
           long long seed_total, int grid, cudaStream_t st) {
  size_t smem = 0;  // q's fragments; stream_raw reads no q
  if constexpr (V != STREAM_RAW) {
    smem = (size_t)16 * MT * w2;
    static size_t opted_in = 0;
    if (smem > opted_in) {
      cudaError_t e = cudaFuncSetAttribute(unpack_probe_kernel<V, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted_in = smem;
    }
  }
  // int32 sums of a warp stay exact for flush_every groups: |s| <= 128 *
  // 128 * w2 a row (two-dot variants less), one row a group and residue
  const int flush_every = (int)(0x7FFFFFFFLL / (16384LL * w2)) > 1
                              ? (int)(0x7FFFFFFFLL / (16384LL * w2)) : 1;
  unpack_probe_kernel<V, MT><<<grid, UP_THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(q), static_cast<long long*>(out),
      n_groups, w2, seed_total, flush_every);
  return (int)cudaGetLastError();
}

template <int V>
int launch_m(const void* x, const void* q, void* out, long long n_groups, int w2, int m,
             long long seed_total, int grid, cudaStream_t st) {
  switch (m) {
    case 16: return launch<V, 1>(x, q, out, n_groups, w2, seed_total, grid, st);
    case 32: return launch<V, 2>(x, q, out, n_groups, w2, seed_total, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One pass of the microbenchmark's `variant` (0 stream_raw, 1 dot_raw, 2
// unpack_cur, 3 unpack_hi, 4 unpack_i8) over x [n_rows, w2] int8 with q
// [m, w2] int8 (m 16 or 32; read by all but stream_raw), adding into out
// int64 [m, 128] (zeroed by the caller); seed_total = n_blocks * seed is
// added to every output (stream_raw: to out[0, 0]). n_rows is a multiple
// of 128, w2 of 64 and at most 227 KB / m. Returns a cudaError_t code.
extern "C" int tpuserve_unpack_probe(const void* x, const void* q, void* out, long long n_rows,
                                     int w2, int m, int variant, long long seed_total, int grid,
                                     void* stream) {
  if (n_rows <= 0) return 0;
  if (n_rows % GROUP || w2 <= 0 || w2 % CHUNK || grid <= 0 || (size_t)m * w2 > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long n_groups = n_rows / GROUP;
  if (grid > n_groups) grid = (int)n_groups;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case STREAM_RAW: return launch_m<STREAM_RAW>(x, q, out, n_groups, w2, m, seed_total, grid, st);
    case DOT_RAW: return launch_m<DOT_RAW>(x, q, out, n_groups, w2, m, seed_total, grid, st);
    case UNPACK_CUR: return launch_m<UNPACK_CUR>(x, q, out, n_groups, w2, m, seed_total, grid, st);
    case UNPACK_HI: return launch_m<UNPACK_HI>(x, q, out, n_groups, w2, m, seed_total, grid, st);
    case UNPACK_I8: return launch_m<UNPACK_I8>(x, q, out, n_groups, w2, m, seed_total, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
