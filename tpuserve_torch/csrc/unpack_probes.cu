// The int4 nibble-unpack microbenchmark (tpuserve_torch/scripts/
// unpack_microbench.py): one packed int8 stream x [N, W2] read by kernels
// that differ only in what they compute on each block, so that their rates
// show what the unpack costs on top of the stream.
//
// Replaces the Pallas kernels of scripts/unpack_microbench.py, all called
// through build() (:153): _k_stream_raw (:52), _k_dot_raw (:62),
// _k_unpack_cur (:75), _k_unpack_hi (:95) and _k_unpack_i8 (:119). They are
// one kernel template here, unpack_probe_kernel<VARIANT, MN>:
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
// in the tensor cores' accumulators over at most flush_chunks k-chunks of
// 128 bytes (a chunk adds at most 2^21 to a row's sum for any int8 inputs),
// then 64-bit integer atomics into the output (int64 [M, 128]; the TPU adds
// into f32).
//
// Bound on the H100: bytes. At the script's shape (x 537 MB, M = 32) the
// dots are 34 GOP (DOT_RAW) or 69 GOP (two dots) against 0.16 ms of bytes:
// 0.017-0.035 ms at the int8 tensor-core peak. Design, for Hopper:
//   - TMA ring: one producer thread keeps up to 8 stages of x in flight,
//     each a 2-D box of 128 rows x 128 bytes (one group, one k-chunk) with
//     the 128-byte swizzle, one mbarrier a stage (full, and empty for the
//     way back). No consumer thread spends a register or an instruction on
//     the stream. A box past W2 (W2 % 128 == 64) arrives zero-filled, and a
//     zero byte adds nothing to any dot below, since q's columns there are
//     zero too.
//   - wgmma int8 with swapped operands: x's rows on M (a pair of consumer
//     warpgroups, one m64 tile each, covers a stage's 128-row group), q's
//     M rows on N (16 or 32), 32 bytes of k a step. Row r of a group is
//     residue r of the fold, so a warpgroup's accumulator is its half of
//     the fold (64 residues x M), carried from stage to stage and flushed
//     every flush_chunks stages with the -8 sum(q)-style terms of the
//     groups whose last chunk the pair took.
//   - Two such pairs take the stages in turn (16 consumer warps), so that
//     one pair unpacks while the other's wgmmas run. ptxas serialises the
//     wgmmas with A from registers (its C7513 note: non-wgmma instructions
//     define their input registers; the SASS has a wait after each one,
//     which scripts/unpack_ablate.py counts), so a warp's own unpack and
//     tensor work never overlap: with one pair the two added up, though
//     either alone kept the stream's rate.
//   - DOT_RAW reads A (x) and B (q) from shared memory. STREAM_RAW is a
//     dot of x with a tile of ones (N = 8), exact, one column kept.
//   - The three unpack variants load their A fragments from the swizzled
//     stage with ldmatrix (one x4 a k-step: exactly the int8 fragment),
//     unpack them in registers with their own instruction mix (cur's
//     byte-wise bfe/and/shr/bfi, i8's word-wide lop3, hi's one shift and
//     xor) and issue wgmma with A from registers.
//   - q: where it fits beside a ring of 4 or more stages, the block loads all
//     of it once by TMA (one [M, 128] swizzled box a k-chunk), in the layout
//     the B descriptor reads; otherwise each stage brings its k-chunk of q
//     beside the x box (q is L2-resident). One kernel, chosen by shape.
//   - One persistent block an SM walks a contiguous run of groups; its
//     flush adds into the output with 64-bit integer atomics.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace tpuserve::hopper;

enum Variant { STREAM_RAW = 0, DOT_RAW = 1, UNPACK_CUR = 2, UNPACK_HI = 3, UNPACK_I8 = 4 };

constexpr int GROUP = 128;             // rows of a group: one per residue of the fold
constexpr int CHUNK = 64;              // W2 is a multiple of this
constexpr int BOX = 128;               // bytes of k a stage holds: one swizzle row
constexpr int X_TILE = GROUP * BOX;    // one stage of x: 16 KB
constexpr int WG = 128;                // threads of a warpgroup
constexpr int PAIR = 2 * WG;           // two m64 tiles: one group, one stage
constexpr int CONSUMERS = 2 * PAIR;    // two pairs, taking the stages in turn
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MIN_RESIDENT_STAGES = 4;   // q stays in shared memory only beside this many
constexpr int ONES = 8 * BOX;            // STREAM_RAW's B: 8 rows of ones
constexpr int SMEM_LIMIT = 232448;       // a block's shared memory on the H100
constexpr int STATIC_SMEM = 256;         // s_qsum, with room to spare

struct Args {
  long long* out;
  const int8_t* q;
  long long n_groups, seed_total;
  int w2, m, n_kc, flush_chunks, stages, stage_bytes, q_resident, off_q, off_ones, off_bars;
};

// wgmma m64nNk32, s8 x s8 -> s32, accumulating into d; A from shared memory
// (SS) or from registers (RS), B from shared memory
template <int N> struct Wg;
template <> struct Wg<8> {
  __device__ __forceinline__ static void ss(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <> struct Wg<16> {
  __device__ __forceinline__ static void ss(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
  __device__ __forceinline__ static void rs(int* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct Wg<32> {
  __device__ __forceinline__ static void ss(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
  __device__ __forceinline__ static void rs(int* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

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

// the int8 A fragment of k-step u for this lane's warp (rows r0..r0+15 of
// the swizzled 128-byte-row stage): lanes 0-15 address k bytes 32u..32u+15
// of rows r0 + (lane % 16), lanes 16-31 the next 16 bytes; register i holds
// row gid (+8 for i odd), bytes 4 tq (+16 for i >= 2), as wgmma reads it
__device__ __forceinline__ void load_frag(uint32_t (&r)[4], uint32_t stage, int r0, int u,
                                          int lane) {
  const int row = r0 + (lane & 15);
  const int chunk = 2 * u + (lane >> 4);
  const uint32_t addr = stage + row * BOX + ((chunk ^ (row & 7)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int V, int MN>
__global__ void __launch_bounds__(THREADS, 1)
unpack_probe_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap qmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + a.off_bars);  // full, empty, q
  __shared__ int s_qsum[32];
  constexpr int NACC = MN / 2;  // accumulator registers of an m64nMN tile a thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int S = a.stages;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[S + s]), PAIR);
    }
    mbar_init(smem_u32(&bars[2 * S]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (V == STREAM_RAW) {
    if (tid < ONES / 4) reinterpret_cast<uint32_t*>(smem + a.off_ones)[tid] = 0x01010101u;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // wgmma reads it
  } else {
    for (int m = tid >> 5; m < a.m; m += THREADS / 32) {
      int s = 0;
      for (int i = lane; i < a.w2 / 4; i += 32)
        s = __dp4a(reinterpret_cast<const int*>(a.q + (size_t)m * a.w2)[i], 0x01010101, s);
      s = tpuserve::warp_sum(s);
      if (lane == 0) s_qsum[m] = s;
    }
  }
  __syncthreads();

  const long long g_begin = a.n_groups * blockIdx.x / gridDim.x;
  const long long g_end = a.n_groups * (blockIdx.x + 1) / gridDim.x;
  const long long total = (g_end - g_begin) * a.n_kc;
  const bool q_stage = V != STREAM_RAW && !a.q_resident;  // q's k-chunk rides in each stage

  if (tid >= CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (tid == CONSUMERS) {
      if (V != STREAM_RAW && a.q_resident) {
        const uint32_t qbar = smem_u32(&bars[2 * S]);
        mbar_expect_tx(qbar, a.n_kc * a.m * BOX);
        for (int c = 0; c < a.n_kc; ++c)
          tma_2d(smem_u32(smem + a.off_q + c * a.m * BOX), &qmap, qbar, c * BOX, 0);
      }
      for (long long it = 0; it < total; ++it) {
        const int s = (int)(it % S);
        if (it >= S) mbar_wait(smem_u32(&bars[S + s]), (uint32_t)((it / S) - 1) & 1);
        const uint32_t full = smem_u32(&bars[s]);
        const uint32_t base = smem_u32(smem + (size_t)s * a.stage_bytes);
        const int c = (int)(it % a.n_kc);
        const int row = (int)((g_begin + it / a.n_kc) * GROUP);
        mbar_expect_tx(full, X_TILE + (q_stage ? a.m * BOX : 0));
        tma_2d(base, &xmap, full, c * BOX, row);
        if (q_stage) tma_2d(base + X_TILE, &qmap, full, c * BOX, 0);
      }
    }
    return;
  }

  // consumer pair `pair` takes stages pair, pair + 2, ...; its warpgroup wg
  // rows wg * 64 .. + 63 of the stage's group (residues)
  const int pair = tid / PAIR;
  const int wg = (tid % PAIR) / WG;
  const int warp = (tid % WG) >> 5;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  const int r0 = wg * 64 + warp * 16;  // this warp's 16 rows of the stage

  int acc[NACC], acc2[NACC];  // acc2: UNPACK_HI's d_h
  long long stotal = 0;       // STREAM_RAW
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = acc2[i] = 0;
  };
  // add the accumulators and the fold's sum(q) terms of `groups` groups (one
  // row a group for each residue: the groups whose last k-chunk this pair
  // took) to the output; register 4j + e holds residue r0 + gid (+8 for
  // e >= 2) and query row 8j + 2tq + (e & 1)
  auto flush = [&](int groups) {
    fence_regs<NACC>(acc);
    fence_regs<NACC>(acc2);
    if constexpr (V == STREAM_RAW) {
      if (tq == 0) stotal += (long long)acc[0] + acc[2];
    } else {
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int m = 8 * (i / 4) + 2 * tq + (i & 1);
        const int res = r0 + gid + ((i & 2) ? 8 : 0);
        const long long qs = s_qsum[m];
        long long val = acc[i];
        if (V == UNPACK_CUR) val -= 8 * qs * groups;
        if (V == UNPACK_I8) val -= 16 * qs * groups;
        if (V == UNPACK_HI) val += 112 * qs * groups - 15LL * acc2[i];
        atomicAdd(reinterpret_cast<unsigned long long*>(a.out + (size_t)m * GROUP + res),
                  (unsigned long long)val);
      }
    }
    zero();
  };
  zero();

  if (V != STREAM_RAW && a.q_resident) mbar_wait(smem_u32(&bars[2 * S]), 0);
  int chunks = 0, ended = 0;  // k-chunks summed since the last flush; groups they ended
  // One stage of this pair. The shared-memory wgmmas (stream_raw, dot_raw)
  // stay in flight until the pair's next stage; the ones with A from
  // registers ptxas waits for one by one. The unpack variants' A operands
  // alternate between two register sets (p, r), so that a stage never
  // writes the registers of the pair's previous stage.
  auto stage = [&](long long it, uint32_t (&p)[4][4], uint32_t (&r)[4][4]) {
    const int s = (int)(it % S);
    const int c = (int)(it % a.n_kc);
    mbar_wait(smem_u32(&bars[s]), (uint32_t)(it / S) & 1);
    const uint32_t xs = smem_u32(smem + (size_t)s * a.stage_bytes);
    const uint32_t bs = V == STREAM_RAW ? smem_u32(smem + a.off_ones)
                        : q_stage       ? xs + X_TILE
                                        : smem_u32(smem + a.off_q + c * a.m * BOX);
    if constexpr (V == STREAM_RAW || V == DOT_RAW) {
      fence_regs<NACC>(acc);
      wg_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Wg<V == STREAM_RAW ? 8 : MN>::ss(acc, desc_sw128(xs + wg * 64 * BOX + 32 * u),
                                         desc_sw128(bs + 32 * u));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t w[4];
        load_frag(w, xs, r0, u, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (V == UNPACK_CUR) {
            unpack_cur(w[i], p[u][i], r[u][i]);
          } else if (V == UNPACK_I8) {
            p[u][i] = w[i] & 0x0F0F0F0Fu;
            r[u][i] = hi_biased(w[i]);
          } else {  // UNPACK_HI: the raw byte and hi + 8
            p[u][i] = w[i];
            r[u][i] = hi_biased(w[i]);
          }
        }
      }
      fence_regs<16>(&p[0][0]);
      fence_regs<16>(&r[0][0]);
      fence_regs<NACC>(acc);
      fence_regs<NACC>(acc2);
      wg_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t db = desc_sw128(bs + 32 * u);
        Wg<MN>::rs(acc, p[u], db);
        Wg<MN>::rs(V == UNPACK_HI ? acc2 : acc, r[u], db);
      }
    }
    wg_commit();
    // the pair's last stage's wgmmas are done: its buffer goes back
    wg_wait<1>();
    if (it >= 2) mbar_arrive(smem_u32(&bars[S + (int)((it - 2) % S)]));
    ended += c == a.n_kc - 1;
    if (++chunks == a.flush_chunks) {
      wg_wait0();
      flush(ended);
      chunks = ended = 0;
    }
  };
  uint32_t pa[4][4], ra[4][4], pb[4][4], rb[4][4];
  for (long long it = pair; it < total; it += 4) {
    stage(it, pa, ra);
    if (it + 2 < total) stage(it + 2, pb, rb);
  }
  wg_wait0();
  if (chunks > 0) flush(ended);

  if (V == STREAM_RAW) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) stotal += __shfl_xor_sync(0xffffffffu, stotal, o);
    if (lane == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.out), (unsigned long long)stotal);
  }
  // the blocks' n_blocks * seed, once
  if (blockIdx.x == 0 && a.seed_total != 0) {
    if (V == STREAM_RAW) {
      if (tid == 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.out), (unsigned long long)a.seed_total);
    } else {
      for (int i = tid; i < a.m * GROUP; i += CONSUMERS)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.out + i),
                  (unsigned long long)a.seed_total);
    }
  }
}

template <int V, int MN>
int launch(const CUtensorMap& xm, const CUtensorMap& qm, const Args& a, int grid, size_t smem,
           cudaStream_t st) {
  auto kern = unpack_probe_kernel<V, MN>;
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  kern<<<grid, THREADS, smem, st>>>(xm, qm, a);
  return (int)cudaGetLastError();
}

template <int V>
int launch_m(const CUtensorMap& xm, const CUtensorMap& qm, const Args& a, int grid, size_t smem,
             cudaStream_t st) {
  switch (a.m) {
    case 16: return launch<V, 16>(xm, qm, a, grid, smem, st);
    case 32: return launch<V, 32>(xm, qm, a, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One pass of the microbenchmark's `variant` (0 stream_raw, 1 dot_raw, 2
// unpack_cur, 3 unpack_hi, 4 unpack_i8) over x [n_rows, w2] int8 with q
// [m, w2] int8 (m 16 or 32; read by all but stream_raw), adding into out
// int64 [m, 128] (zeroed by the caller); seed_total = n_blocks * seed is
// added to every output (stream_raw: to out[0, 0]). n_rows is a multiple
// of 128, w2 of 64 and at most 227 KB / m; x and q are 16-byte aligned.
// `grid` blocks at most. Returns a cudaError_t code.
extern "C" int tpuserve_unpack_probe(const void* x, const void* q, void* out, long long n_rows,
                                     int w2, int m, int variant, long long seed_total, int grid,
                                     void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  if (n_rows % GROUP || n_rows / GROUP > 0x7FFFFFFFLL / GROUP || w2 <= 0 || w2 % CHUNK ||
      grid <= 0 || (m != 16 && m != 32) || (size_t)m * w2 > 227 * 1024 || variant < 0 ||
      variant > UNPACK_I8)
    return bad;
  Args a;
  a.out = static_cast<long long*>(out);
  a.q = static_cast<const int8_t*>(q);
  a.n_groups = n_rows / GROUP;
  a.seed_total = seed_total;
  a.w2 = w2;
  a.m = m;
  a.n_kc = (w2 + BOX - 1) / BOX;
  // int32 sums of a thread stay exact for flush_chunks k-chunks: a chunk
  // adds at most 128 * 128 * 128 to a row's sum (two-dot variants less)
  a.flush_chunks = (int)(0x7FFFFFFFLL / (16384LL * BOX));
  // shared memory: [ring][q, when resident][ones][barriers], 1024-aligned
  const int q_chunk = m * BOX;
  const int q_all = a.n_kc * q_chunk;
  const int room = SMEM_LIMIT - STATIC_SMEM - 1024 - ONES - (2 * MAX_STAGES + 1) * 8;
  a.q_resident = variant != STREAM_RAW && q_all + MIN_RESIDENT_STAGES * X_TILE <= room;
  a.stage_bytes = X_TILE + (variant != STREAM_RAW && !a.q_resident ? q_chunk : 0);
  const int ring_room = room - (a.q_resident ? q_all : 0);
  a.stages = ring_room / a.stage_bytes < MAX_STAGES ? ring_room / a.stage_bytes : MAX_STAGES;
  if (a.stages < 4) return bad;  // each pair holds up to two stages
  a.off_q = a.stages * a.stage_bytes;
  a.off_ones = a.off_q + (a.q_resident ? q_all : 0);
  a.off_bars = a.off_ones + ONES;
  const size_t smem = 1024 + (size_t)a.off_bars + (2 * MAX_STAGES + 1) * 8;

  CUtensorMap xm, qm;
  if (!encode(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, w2, n_rows, w2, BOX, GROUP,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, q ? q : x, w2, m, w2, BOX, m,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  if (grid > a.n_groups) grid = (int)a.n_groups;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case STREAM_RAW: return launch<STREAM_RAW, 8>(xm, qm, a, grid, smem, st);
    case DOT_RAW: return launch_m<DOT_RAW>(xm, qm, a, grid, smem, st);
    case UNPACK_CUR: return launch_m<UNPACK_CUR>(xm, qm, a, grid, smem, st);
    case UNPACK_HI: return launch_m<UNPACK_HI>(xm, qm, a, grid, smem, st);
    default: return launch_m<UNPACK_I8>(xm, qm, a, grid, smem, st);
  }
}
