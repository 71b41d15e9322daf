// Fused dequant + matmul: out[B, N] = x[B, K] @ dequant(W)[K, N].
//
// Replaces tpuserve/ops/quant_matmul.py::_kernel (all three branches):
//   - int4: W packed uint8 [K/2, N], split-half per scale group (packed row
//     r of group g holds element g*gs + r in its low nibble and element
//     g*gs + gs/2 + r in its high nibble), codes biased by 8;
//   - int8: W int8 [K, N]; a group may span many K chunks (gs = K);
//   - W4A8: x arrives quantized to int8 per row, the dots are integer
//     (int32 accumulation) against the codes, the -8 fold is exact, and the
//     per-row scale multiplies the output.
// Scales are f32 [G, N]; each group's partial sum is scaled in f32 and
// accumulated in f32, as in the TPU kernel.
//
// Bound on the H100 at decode: bytes and tensor-core operations nearly
// alike. A byte of int4 weights holds two weights, so at B = 64 it carries
// 4*64 = 256 bf16 operations (B = 72: 288), close to the card's ridge of
// ~295 operations per byte (989 TFLOP/s over 3.35 TB/s): streaming the
// weights at full rate needs the tensor cores at 75-85% of their peak.
//
// Paths:
//   - bf16 activations (the serving path), every group int4 or int8
//     weights take: qmm_wgmma_kernel in namespace hop below, built for
//     Hopper: wgmma with the weights as A from registers and x as B from
//     shared memory, a TMA ring fed by one producer thread, every weight
//     byte read from device memory once for B <= 256 and from shared memory
//     once, split K reduced in the same launch in a fixed order
//     (tpuserve_quant_matmul_bf16);
//   - W4A8, every even group: qmm_a8_kernel, the same ring and split on
//     int8 wgmma (tpuserve_quant_matmul_a8);
//   - f32 activations, every group bf16 x takes: the same kernel on three
//     bf16 pieces of x (split_x_kernel: x = hi + mid + lo, each piece the
//     top 16 bits of what is left, exact for every finite x of magnitude
//     at least 2^-110 and for zeros); each k16 step issues one wgmma a
//     piece on the same weight fragments into the one f32 sum, so the
//     weights are read from device memory once, as for bf16 x, and every
//     product (piece times code) is exact; out is f32.
// Groups whose k-steps (16 values bf16, 32 int8) do not end where a group
// does take masked steps on the Hopper kernels (the GS = -2 and A8_MASKED
// instances).
#include "common.cuh"
#include "hopper.cuh"

#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace {

using tpuserve::small_u2f;

// ---------------------------------------------------------------- rows to int8
// W4A8's activations: x [B, K] to int8 codes and f32 scales, one block a
// row (tpuserve/quant/core.py::quantize_activation, which the JAX package
// leaves to XLA): s = max(absmax / 127, 1e-8), q = clamp(rint(x / s),
// -127, 127), with IEEE divisions as PyTorch's, so the codes and scales
// are bitwise those of the plain version. Bound by bytes: x is read twice
// (the second pass mostly from L1/L2), the codes written once.
// IDX: the codes go out in the masked steps' layout (ops/quant_matmul.py::
// stage_x_index): code p of a row is that of x[idx[p]], 0 where idx[p] ==
// K; W codes a row. Without, W = K in order, in a loop of its own: the
// index's test in every step cost the W4A8 g128 step 0.8% (PERF.md section 6).
template <typename T, bool IDX>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     int K, const int* __restrict__ idx, int W) {
  __shared__ float s_max[8];
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * W;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(tpuserve::to_f32(xr[k])));
  m = tpuserve::warp_max(m);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = s_max[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) m = fmaxf(m, s_max[w]);
  const float sc = fmaxf(__fdiv_rn(m, 127.0f), 1e-8f);
  auto code = [&](int k) {
    const float v = rintf(__fdiv_rn(tpuserve::to_f32(xr[k]), sc));
    return (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
  };
  if (IDX) {
    for (int p = threadIdx.x; p < W; p += blockDim.x) {
      const int k = idx[p];
      qr[p] = k < K ? code(k) : (int8_t)0;
    }
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x) qr[k] = code(k);
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = sc;
}

// bf16 x [B, K] in the masked steps' layout: out[b, p] = x[b, idx[p]], 0
// where idx[p] == K (ops/quant_matmul.py::stage_x_index); a thread an
// element, grid (W / 256, B). Bound by bytes.
__global__ void __launch_bounds__(256)
stage_x_kernel(const uint16_t* __restrict__ x, const int* __restrict__ idx,
               uint16_t* __restrict__ out, int K, int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= W) return;
  const int k = idx[p];
  out[(size_t)blockIdx.y * W + p] = k < K ? x[(size_t)blockIdx.y * K + k] : (uint16_t)0;
}

// f32 x [B, K] as three bf16 pieces out [3, B, W]: piece 0 (hi) is x's top
// 16 bits, piece 1 (mid) the top 16 bits of r = x - hi, piece 2 (lo) those
// of r - mid. Each difference is exact in f32, and for |x| >= 2^-110 (and
// zeros) lo has no bits left below its top 16, so hi + mid + lo == x
// bitwise; a zero difference keeps x's sign, so -0.0 gives three -0.0.
// Below 2^-110 the bits under bf16's finest step (2^-133) are dropped.
// With idx (the masked steps' layout, as stage_x_kernel): piece p of
// out[b, q] splits x[b, idx[q]], 0 where idx[q] == K; else W = K in order.
// A thread an element, grid (W / 256, B). Bound by bytes.
__global__ void __launch_bounds__(256)
split_x_kernel(const float* __restrict__ x, const int* __restrict__ idx,
               uint16_t* __restrict__ out, int B, int K, int W) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= W) return;
  const int k = idx ? idx[q] : q;
  const float v = k < K ? x[(size_t)blockIdx.y * K + k] : 0.f;
  const uint32_t sign = __float_as_uint(v) & 0x80000000u;
  uint32_t w = __float_as_uint(v);
  const size_t plane = (size_t)B * W;
  uint16_t* o = out + (size_t)blockIdx.y * W + q;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const uint32_t top = w & 0xFFFF0000u;
    o[p * plane] = (uint16_t)(top >> 16);
    const float rest = __uint_as_float(w) - __uint_as_float(top);
    w = rest == 0.f ? sign : __float_as_uint(rest);
  }
}

// ---------------------------------------------------------------- bf16 x, Hopper
// bf16 activations, int4 or int8 weights, swapped operands: the kernel
// computes out^T = W^T . x^T with wgmma, the weight columns as its M and the
// batch rows as its N (BT, a multiple of 8 up to 128 a warpgroup; two batch
// warpgroups share the weights for B up to 256). So one pass over the
// weights serves the whole batch. A consumer warpgroup covers 64 columns
// (one m64 tile); a block has two consumer warpgroups.
//
// Stage: 64 packed int4 rows (128 values of K) or 64 int8 rows of each
// consumer warpgroup's columns, the x values they multiply and the group
// scales they need, brought by TMA into a ring of up to 8 shared-memory
// stages that one producer thread keeps full (mbarriers full/empty).
//   - weights: box [64 rows, 64 columns] uint8, 64-byte swizzle (a warp's
//     loads of four rows hit distinct banks);
//   - x: int4 two boxes [rows, 64 values] bf16 (128-byte swizzle): for a
//     group of 128 or more, the values that meet the stage's low nibbles
//     and the ones that meet its high nibbles (gs/2 further on); for a
//     group that divides 128, the stage's 128 values in order. int8: one box;
//   - scales: box [groups in the stage, columns] f32.
// A (the weights) comes from registers: a thread converts the bytes of its
// two adjacent columns in rows 2tq, 2tq+1 of an 8-row octet
// with one PRMT and one HSUB2 per bf16 pair, after a LOP3 (and a shift) per
// word: the nibble goes under a bf16 exponent (0x43: 128 + code) and 136 is
// subtracted, which leaves code - 8, exact. So every product x * (c - 8)
// is exact in the tensor core and the group's f32 sum equals
// x.c - 8*rowsum(x) (the TPU kernel's fold) up to the order of the f32
// additions. Each octet is read from shared memory once: its low nibbles
// feed one k16 step and its high nibbles the step gs/2 values further on
// (for gs = 16, the two halves of one step). Each group's wgmma sum goes
// into `part` and is then scaled in f32 into `acc` (acc += part *
// scale[g, col]).
//
// Groups a 64-row stage cannot tile (int4 48, 80, 96, 112, 144, ...; int8
// 48, 80, 96, ...: any multiple of 16 values; `odd` below) take stages cut
// along their groups instead: a stage holds as many whole groups as fit in
// 64 weight rows (x in order from the first one), or one piece of at most
// 64 rows of a larger group (the last piece shorter). Where a group's int4
// half (gs/2) is no multiple of 16, a k16 step takes low nibbles of one
// octet and high nibbles of another: the fragment is built per 8 values of
// K from the octet the pack puts there, and the k16 step is taken in x's
// order, so that x stays one descriptor.
//
// Groups whose k16 steps would cross a group's end (int4: any even group
// of no multiple of 16 values; int8: any group of none; masked_stage,
// the GS = -2 instances) take the same stages, whole groups with x in
// order or pieces of one group, x gathered by the wrapper into one aligned
// run of 128 values a stage (int8 weights: 64), and every k16 step at a
// fixed position of its x box, so that x stays one descriptor a step. A
// step that holds values of more than one group (or of a group's two
// nibble halves, or past the piece or K) is issued once for each group it
// touches, its A fragment built per K value from the packed row and nibble
// the pack puts there, with the bf16 of 0 for every K value outside that
// group: each group's sum stays its own, and is scaled into `acc` in group
// order.
//
// Split K in one launch: grid.y splits the stages; each split writes its f32
// tile to a workspace, and the last split of a tile to arrive (a per-tile
// counter) adds the splits in split order and writes the output, so two
// calls give the same bits. A group larger than a split's K range splits
// too: its scale multiplies each split's partial sum.
namespace hop {

using namespace tpuserve::hopper;

constexpr int WG_THREADS = 128;
constexpr int STAGE_ROWS = 64;        // weight rows per stage

constexpr int COLS = 64;              // output columns per consumer warpgroup
constexpr int W_BYTES = STAGE_ROWS * COLS;  // one warpgroup's weight box
constexpr int MAX_STAGES = 8;

constexpr int MAX_THREADS = 2 * WG_THREADS + 32;  // two consumer warpgroups and the producer

struct Args {
  void* out;           // [B, N]: bf16, or f32 (qmm_a8_kernel may write either)
  const float* row_scale;  // [B] multiplied into each output row (qmm_a8_kernel)
  float* ws;           // [splits, B, N] when splits > 1
  int* counters;       // per output tile, zero between calls
  int B, K, N, gs, sps, total, splits, stages, nwg_n, nwg_b;
  int gr;              // scale groups a stage holds (whole groups), else 1
  int spg;             // stages a group spans (pieces of one group), else 1
  int odd;             // the group is cut by the stages as above
  int off_x, off_sc, stage_bytes, tx_bytes, xbox_bytes;
  int piece_bytes;     // a piece's x boxes in a stage (f32 x: three pieces, their
                       // rows B apart in x's map)
};

// Where stage t starts: its first weight row, its first scale group and the
// K positions of its two x boxes (int4: the values that meet the low
// nibbles, then the high ones; whole groups: the stage's values in order).
// Masked groups read x as the wrapper lays it out (ops/quant_matmul.py::
// stage_x_index): the same values, each stage's from a 16-byte aligned
// start, since a TMA box's start along K must be (a box at an odd K offset
// stopped the kernel with an illegal instruction on the card).
template <bool MASKED>
__device__ __forceinline__ void stage_origin(const Args& a, int bits, int gs, int t, int& r0,
                                             int& grp, int& klo, int& khi) {
  const int rpg = bits == 4 ? gs / 2 : gs;  // weight rows a group
  if (a.spg == 1) {                         // a.gr whole groups
    grp = t * a.gr;
    r0 = grp * rpg;
    klo = grp * gs;
    khi = klo + 64;
  } else {                                  // piece t % spg of one group
    grp = t / a.spg;
    const int pc = t - grp * a.spg;
    r0 = grp * rpg + pc * STAGE_ROWS;
    klo = grp * gs + pc * STAGE_ROWS;
    khi = klo + rpg;
  }
  if (MASKED) {  // x gathered by the wrapper: stage t's values at t * (64 a box)
    klo = t * 64 * (bits == 4 ? 2 : 1);
    khi = klo + 64;
  }
}

// The producer thread: keeps the ring full for the block's nst stages
// (weights and scales of each column warpgroup, then x; two x boxes for
// int4 weights, for each of x's P pieces). MASKED: x laid out for the
// masked steps.
template <int BITS, bool MASKED, int P>
__device__ __forceinline__ void produce(const Args& a, uint8_t* smem, uint64_t* bars,
                                        const CUtensorMap* qmap, const CUtensorMap* smap,
                                        const CUtensorMap* xmap, int gs, int st0, int nst,
                                        int col_blk, int row_blk) {
  for (int it = 0; it < nst; ++it) {
    const int s = it % a.stages;
    const uint32_t full = smem_u32(&bars[s]);
    if (it >= a.stages) mbar_wait(smem_u32(&bars[a.stages + s]), ((it / a.stages) - 1) & 1);
    const uint32_t base = smem_u32(smem + (size_t)s * a.stage_bytes);
    mbar_expect_tx(full, a.tx_bytes);
    int r0, grp, klo, khi;
    stage_origin<MASKED>(a, BITS, gs, st0 + it, r0, grp, klo, khi);
    for (int w = 0; w < a.nwg_n; ++w) {
      tma_2d(base + w * W_BYTES, qmap, full, col_blk + w * COLS, r0);
      tma_2d(base + a.off_sc + w * a.gr * COLS * 4, smap, full, col_blk + w * COLS, grp);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t xs = base + a.off_x + p * a.piece_bytes;
      tma_2d(xs, xmap, full, klo, p * a.B + row_blk);
      if (BITS == 4) tma_2d(xs + a.xbox_bytes, xmap, full, khi, p * a.B + row_blk);
    }
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// The consumers' output: acc holds, for this thread, columns col, col + 1
// and batch rows b0 + 8j (+1). With splits > 1 this split's tile goes to the
// workspace, and the last split of the tile to arrive adds all of them in
// split order. RS: each row times a.row_scale (W4A8) before the rounding.
template <int BT, typename OT, bool RS>
__device__ __forceinline__ void write_out(const Args& a, const float* acc, int col, int b0,
                                          int ncons, int* s_last) {
  OT* out = reinterpret_cast<OT*>(a.out);
  auto rs = [&](int b) {
    if constexpr (RS) return a.row_scale[b];
    return 1.0f;
  };
  if (a.splits == 1) {
    if (col >= a.N) return;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int b = b0 + 8 * j;
      if (b < a.B) {
        const float r = rs(b);
        store2(out + (size_t)b * a.N + col, acc[4 * j] * r, acc[4 * j + 2] * r);
      }
      if (b + 1 < a.B) {
        const float r = rs(b + 1);
        store2(out + (size_t)(b + 1) * a.N + col, acc[4 * j + 1] * r, acc[4 * j + 3] * r);
      }
    }
    return;
  }
  float* ws = a.ws + (size_t)blockIdx.y * a.B * a.N;
  if (col < a.N) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int b = b0 + 8 * j;
      if (b < a.B)
        *reinterpret_cast<float2*>(ws + (size_t)b * a.N + col) = make_float2(acc[4 * j], acc[4 * j + 2]);
      if (b + 1 < a.B)
        *reinterpret_cast<float2*>(ws + (size_t)(b + 1) * a.N + col) =
            make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  }
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"r"(ncons * WG_THREADS) : "memory");
  const int tile = blockIdx.x + gridDim.x * blockIdx.z;
  if (threadIdx.x == 0) *s_last = atomicAdd(&a.counters[tile], 1) == a.splits - 1;
  asm volatile("bar.sync 1, %0;" ::"r"(ncons * WG_THREADS) : "memory");
  if (!*s_last) return;
  __threadfence();
  if (col < a.N) {
    for (int b = b0; b < min(a.B, b0 + BT); b += 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (b + h >= a.B) break;
        float lo = 0.f, hi = 0.f;
        for (int sp = 0; sp < a.splits; ++sp) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(
              a.ws + ((size_t)sp * a.B + b + h) * a.N + col));
          lo += v.x;
          hi += v.y;
        }
        const float r = rs(b + h);
        store2(out + (size_t)(b + h) * a.N + col, lo * r, hi * r);
      }
    }
  }
  if (threadIdx.x == 0) a.counters[tile] = 0;  // ready for the next call
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// bf16 pair (code - 8) of two nibbles held in bytes of m: sel 0x4140 takes
// bytes 0 and 1 (column c0), 0x4342 bytes 2 and 3 (column c1)
__device__ __forceinline__ uint32_t nib_pair(uint32_t m, uint32_t sel) {
  const uint32_t v = prmt(m, 0x43434343u, sel);  // 128 + code in each half
  const uint32_t c = 0x43084308u;                // 136.0, 136.0
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

// bf16 pair of two int8 codes in bytes lo_byte and lo_byte + 1 of w
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int lo_byte) {
  const float f0 = small_u2f(((w >> (8 * lo_byte)) & 0xFFu) ^ 0x80u) - 128.0f;
  const float f1 = small_u2f(((w >> (8 * lo_byte + 8)) & 0xFFu) ^ 0x80u) - 128.0f;
  __nv_bfloat162 r = __floats2bfloat162_rn(f0, f1);  // exact: |code| <= 128
  return *reinterpret_cast<uint32_t*>(&r);
}

// The thread's bytes of an octet (rows r, r + 1 with r = R + 2tq; columns
// c0, c0 + 1) as [ (r,c0), (r+1,c0), (r,c1), (r+1,c1) ]. The weight box is
// 64 bytes a row with the 64-byte swizzle: 16-byte chunk ^= (row / 2) % 4.
__device__ __forceinline__ uint32_t octet_word(const uint8_t* wt, int r, int warp, int gid) {
  const int off = r * 64 + ((warp ^ ((r >> 1) & 3)) << 4) + 2 * gid;
  const uint32_t a = *reinterpret_cast<const uint16_t*>(wt + off);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(wt + off + 64);
  return prmt(a, b, 0x5140u);
}

template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct Wgmma<72> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
        "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

// acc += part * scale[group, column]: an m64 tile's accumulators hold, for
// this thread, column c (i % 4 < 2, scale s0) and c + 1 (i % 4 >= 2, s1)
template <int BT>
__device__ __forceinline__ void scale_into(float* acc, const float* part, float s0, float s1) {
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    acc[4 * j + 0] += part[4 * j + 0] * s0;
    acc[4 * j + 1] += part[4 * j + 1] * s0;
    acc[4 * j + 2] += part[4 * j + 2] * s1;
    acc[4 * j + 3] += part[4 * j + 3] * s1;
  }
}

template <int BT>
__device__ __forceinline__ void close_group(float* acc, float* part, const float* sc_row, int c0) {
  wg_wait0();
  fence_regs<BT / 2>(part);
  const float2 s = *reinterpret_cast<const float2*>(sc_row + c0);
  scale_into<BT>(acc, part, s.x, s.y);
}

__device__ __forceinline__ void fence_frag(uint32_t* af) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(af[i]));
}

// x's boxes in a stage, as wgmma descriptors: value p (0..127) of piece pc
// (of P) lies in box p / 64 of that piece, 32 bytes a k16 step. P = 3:
// f32 x as three bf16 pieces, each multiplied by the same A fragments.
template <int P>
struct XBoxes {
  static constexpr int pieces = P;
  uint32_t xb;
  int xbox_bytes, piece_bytes;
  __device__ __forceinline__ uint64_t operator()(int p, int pc = 0) const {
    return desc_sw128(xb + pc * piece_bytes + (p >> 6) * xbox_bytes + (p & 63) * 2);
  }
};

// one k16 step at x value p (af2 == nullptr) or two (the second at p2) on the
// same accumulators, one wgmma a piece of x each, then commit
template <int BT, typename XD>
__device__ __forceinline__ void issue(float* part, uint32_t* af, const XD& xd, int p,
                                      int accumulate, uint32_t* af2 = nullptr, int p2 = 0) {
  fence_frag(af);
  if (af2) fence_frag(af2);
  fence_regs<BT / 2>(part);
  wg_fence();
#pragma unroll
  for (int pc = 0; pc < XD::pieces; ++pc) Wgmma<BT>::mma(part, af, xd(p, pc), pc > 0 || accumulate);
  if (af2) {
#pragma unroll
    for (int pc = 0; pc < XD::pieces; ++pc) Wgmma<BT>::mma(part, af2, xd(p2, pc), 1);
  }
  wg_commit();
}

// int4, one g128 group a stage: its four 16-row units, the stage's bytes
// loaded first; the group's sum into `part` (fresh), left in flight
template <int BT, typename XD>
__device__ __forceinline__ void g128_stage(float* part, const uint8_t* wt, const XD& xd, int warp,
                                           int gid, int tq) {
  uint32_t w[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    w[2 * u] = octet_word(wt, 16 * u + 2 * tq, warp, gid);
    w[2 * u + 1] = octet_word(wt, 16 * u + 8 + 2 * tq, warp, gid);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t l0 = w[2 * u] & 0x0F0F0F0Fu, l1 = w[2 * u + 1] & 0x0F0F0F0Fu;
    const uint32_t h0 = (w[2 * u] >> 4) & 0x0F0F0F0Fu, h1 = (w[2 * u + 1] >> 4) & 0x0F0F0F0Fu;
    uint32_t alo[4] = {nib_pair(l0, 0x4140u), nib_pair(l0, 0x4342u), nib_pair(l1, 0x4140u),
                       nib_pair(l1, 0x4342u)};
    uint32_t ahi[4] = {nib_pair(h0, 0x4140u), nib_pair(h0, 0x4342u), nib_pair(h1, 0x4140u),
                       nib_pair(h1, 0x4342u)};
    // box 0 holds the x of the low nibbles, box 1 that of the high ones
    issue<BT>(part, alo, xd, 16 * u, u > 0, ahi, 64 + 16 * u);
  }
}

// Half of a k16 fragment (8 values of K) for an odd group: the low (sh 0) or
// high (sh 4) nibbles of the octet at weight row `row`, as the pair of
// registers of columns c0 and c1; zeros where the octet lies past the piece.
__device__ __forceinline__ void nib_half(uint32_t* af, const uint8_t* wt, int row, int sh,
                                         bool valid, int warp, int gid, int tq) {
  if (!valid) {
    af[0] = af[1] = 0u;
    return;
  }
  const uint32_t w = (octet_word(wt, row + 2 * tq, warp, gid) >> sh) & 0x0F0F0F0Fu;
  af[0] = nib_pair(w, 0x4140u);
  af[1] = nib_pair(w, 0x4342u);
}

// The 16 int8 rows from `row` as a k16 fragment
__device__ __forceinline__ void i8_frag(uint32_t* af, const uint8_t* wt, int row, int warp,
                                        int gid, int tq) {
  const uint32_t w0 = octet_word(wt, row + 2 * tq, warp, gid);
  const uint32_t w1 = octet_word(wt, row + 8 + 2 * tq, warp, gid);
  af[0] = i8_pair(w0, 0);
  af[1] = i8_pair(w0, 2);
  af[2] = i8_pair(w1, 0);
  af[3] = i8_pair(w1, 2);
}

// Up to 8 k16 steps (fragments fr, x values px of the stage) on the same
// accumulators, the first adding to them or not, issued together and
// committed as one group (one wgmma a step and piece of x). The fragments
// are all built before the first wgmma and stay live (keep_frags) until the
// group has been waited for: a wgmma reads its A registers after it is
// issued, so none of them may be written again before then.
template <int BT, typename XDesc>
__device__ __forceinline__ void issue_batch(float* part, uint32_t (&fr)[8][4], const int* px,
                                            int n, int accumulate, const XDesc& xdesc) {
#pragma unroll
  for (int s = 0; s < 8; ++s) fence_frag(fr[s]);
  fence_regs<BT / 2>(part);
  wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int pc = 0; pc < XDesc::pieces; ++pc)
      if (s < n) Wgmma<BT>::mma(part, fr[s], xdesc(px[s], pc), s > 0 || pc > 0 || accumulate);
  }
  wg_commit();
}

__device__ __forceinline__ void keep_frags(uint32_t (&fr)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) fence_frag(fr[s]);
}

// One stage of an odd group size (Args::odd): whole groups, each its k16
// steps in x's order and then its flush, or a piece of one group, its low
// nibbles against x box 0 and its high ones against box 1 (int8: its rows
// against box 0), flushed where the group (or the block's split) ends.
template <int BITS, int BT, typename XDesc>
__device__ __forceinline__ void odd_stage(const Args& a, float* acc, float* part, int& accumulate,
                                          const uint8_t* wt, const float* sc, const XDesc& xdesc,
                                          int gs, int t, bool last, int warp, int gid, int tq,
                                          int c0) {
  const int rpg = BITS == 4 ? gs / 2 : gs;
  uint32_t fr[8][4];
  int px[8];
  if (a.spg == 1) {  // whole groups (gs <= 128 int4, <= 64 int8): at most 8 k16 steps each
    const int ng = min(a.gr, a.K / gs - t * a.gr);
    const int hq = rpg / 8;  // octets a group holds
    for (int j = 0; j < ng; ++j) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s < gs / 16) {
          if (BITS == 4) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * s + h;  // 8 values of K: low nibbles of octet q, or high of q - hq
              nib_half(fr[s] + 2 * h, wt, j * rpg + 8 * (q < hq ? q : q - hq), q < hq ? 0 : 4,
                       true, warp, gid, tq);
            }
          } else {
            i8_frag(fr[s], wt, j * gs + 16 * s, warp, gid, tq);
          }
          px[s] = j * gs + 16 * s;
        }
      }
      issue_batch<BT>(part, fr, px, gs / 16, 0, xdesc);
      close_group<BT>(acc, part, sc + j * COLS, c0);
      keep_frags(fr);
    }
    accumulate = 0;
    return;
  }
  const int pc = t % a.spg;
  const int rows = min(STAGE_ROWS, rpg - pc * STAGE_ROWS);  // a multiple of 8 (int8: 16)
  int n;
  if (BITS == 4) {  // step s: 16 rows from 16 (s / 2), low (s even) or high nibbles
    n = 2 * ((rows + 15) / 16);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s < n) {
        const int R = 16 * (s >> 1), sh = 4 * (s & 1);
        nib_half(fr[s], wt, R, sh, true, warp, gid, tq);
        nib_half(fr[s] + 2, wt, R + 8, sh, R + 8 < rows, warp, gid, tq);
        px[s] = sh ? 64 + R : R;
      }
    }
  } else {
    n = rows / 16;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < n) {
        i8_frag(fr[s], wt, 16 * s, warp, gid, tq);
        px[s] = 16 * s;
      }
    }
  }
  issue_batch<BT>(part, fr, px, n, accumulate, xdesc);
  accumulate = 1;
  if (pc == a.spg - 1 || last) {
    close_group<BT>(acc, part, sc, c0);
    accumulate = 0;
  }
  wg_wait0();
  keep_frags(fr);
}

// The two columns' codes at one K value of a masked step (c0 in byte 0,
// c1 in byte 1): enc = weight row << 3 | the nibble's shift (int4: 0 low,
// 4 high), or -1 for a K value outside the group being issued, which takes
// the code of a zero product (int4: 8, the bias; int8: 0).
// The load always reads a row of the box, and the code is selected after.
template <int BITS>
__device__ __forceinline__ uint32_t code_pair(const uint8_t* wt, int enc, int warp, int gid) {
  const bool live = enc >= 0;
  const int row = live ? enc >> 3 : 0;
  const uint32_t w = *reinterpret_cast<const uint16_t*>(
      wt + row * 64 + ((warp ^ ((row >> 1) & 3)) << 4) + 2 * gid);
  if (BITS == 4) return live ? (w >> (enc & 7)) & 0x0F0Fu : 0x0808u;
  return live ? w : 0u;
}

// The k16 fragment at x position p of a masked stage, 8 values of K (rows
// 2tq, 2tq + 1 of each half step) at a time: with FAST, where all 8 lie in
// one half of the group (both ends valid, 7 rows apart on one nibble: the
// same test in every thread), one octet read as in the odd-group path;
// else a pair of K values at a time, each from where(k) (code_pair's enc).
// FAST pays in the pieces of a large group, where nearly every half step
// passes the test; in whole small groups its branch cost more than it
// saved (PERF.md section 6).
template <int BITS, bool FAST, typename Where>
__device__ __forceinline__ void masked_frag(uint32_t* af, const uint8_t* wt, int p, Where where,
                                            int warp, int gid, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e0 = where(p + 8 * h), e7 = where(p + 8 * h + 7);
    uint32_t m;
    if (FAST && e0 >= 0 && e7 - e0 == 7 << 3) {
      const uint32_t w = octet_word(wt, (e0 >> 3) + 2 * tq, warp, gid);
      m = BITS == 4 ? (w >> (e0 & 7)) & 0x0F0F0F0Fu : w;
    } else {
      const int k = p + 8 * h + 2 * tq;
      m = prmt(code_pair<BITS>(wt, where(k), warp, gid),
               code_pair<BITS>(wt, where(k + 1), warp, gid), 0x5140u);
    }
    af[2 * h] = BITS == 4 ? nib_pair(m, 0x4140u) : i8_pair(m, 0);
    af[2 * h + 1] = BITS == 4 ? nib_pair(m, 0x4342u) : i8_pair(m, 2);
  }
}

// One stage of a masked group size (the GS = -2 instances): whole groups,
// each its k16 steps floor(lo / 16) .. ceil(hi / 16) - 1 of the stage's x
// masked to its values [lo, hi) and then its flush, or a piece of one group, its
// low nibbles against x box 0 and its high ones against box 1 (int8: its
// rows against box 0), masked past the piece's rows and flushed where the
// group (or the block's split) ends. Each group's batch is waited for
// before the next one's fragments are built.
template <int BITS, int BT, typename XDesc>
__device__ __forceinline__ void masked_stage(const Args& a, float* acc, float* part,
                                             int& accumulate, const uint8_t* wt, const float* sc,
                                             const XDesc& xdesc, int gs, int t, bool last, int warp,
                                             int gid, int tq, int c0) {
  const int rpg = BITS == 4 ? gs / 2 : gs;
  uint32_t fr[8][4];
  int px[8];
  if (a.spg == 1) {  // whole groups: gs <= 128 int4, <= 64 int8, so at most 8 k16 steps each
    const int ng = min(a.gr, a.K / gs - t * a.gr);
    for (int j = 0; j < ng; ++j) {
      const int lo = j * gs, s0 = lo >> 4, n = ((lo + gs + 15) >> 4) - s0;
      auto where = [&](int k) {
        const int r = k - lo;
        const int hi = BITS == 4 && r >= rpg;  // the high nibbles hold the group's second half
        const int enc = BITS == 4 ? (j * rpg + r - hi * rpg) << 3 | hi << 2 : k << 3;
        return (unsigned)r < (unsigned)gs ? enc : -1;
      };
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s < n) {
          px[s] = 16 * (s0 + s);
          masked_frag<BITS, false>(fr[s], wt, px[s], where, warp, gid, tq);
        }
      }
      issue_batch<BT>(part, fr, px, n, 0, xdesc);
      close_group<BT>(acc, part, sc + j * COLS, c0);
      keep_frags(fr);
    }
    accumulate = 0;
    return;
  }
  const int pc = t % a.spg;
  const int rows = min(STAGE_ROWS, rpg - pc * STAGE_ROWS);
  auto where = [&](int k) {  // box k / 64: int4 low (0) or high (1) nibbles of row k % 64
    const int r = k & 63;
    return r < rows ? r << 3 | (BITS == 4 ? (k >> 6) << 2 : 0) : -1;
  };
  const int per = (rows + 15) >> 4;  // k16 steps a box
  const int n = BITS == 4 ? 2 * per : per;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s < n) {
      px[s] = BITS == 4 ? (s & 1) * 64 + 16 * (s >> 1) : 16 * s;
      masked_frag<BITS, true>(fr[s], wt, px[s], where, warp, gid, tq);
    }
  }
  issue_batch<BT>(part, fr, px, n, accumulate, xdesc);
  accumulate = 1;
  if (pc == a.spg - 1 || last) {
    close_group<BT>(acc, part, sc, c0);
    accumulate = 0;
  }
  wg_wait0();
  keep_frags(fr);
}

// GS = 128 fixes the group size at compile time; GS = 0 reads a.gs (groups
// the 64-row stage tiles); GS = -1 reads a.gs for the odd groups, GS = -2
// for the masked ones. P: x's bf16 pieces, 1 (bf16 x, bf16 out) or 3 (f32
// x split by split_x_kernel, f32 out).
template <int BITS, int GS, int BT, int P>
__global__ void __launch_bounds__(MAX_THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap smap,
                 const __grid_constant__ CUtensorMap xmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)a.stages * a.stage_bytes);
  __shared__ int s_last;
  const int ncons = a.nwg_n * a.nwg_b;
  const int wg = threadIdx.x / WG_THREADS;
  const int gs = GS > 0 ? GS : a.gs;
  const int st0 = blockIdx.y * a.sps;
  const int nst = min(a.total, st0 + a.sps) - st0;
  const int col_blk = blockIdx.x * COLS * a.nwg_n;
  const int row_blk = blockIdx.z * BT * a.nwg_b;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);                                // full
      mbar_init(smem_u32(&bars[a.stages + s]), ncons * WG_THREADS);    // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == ncons) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == ncons * WG_THREADS)
      produce<BITS, GS == -2, P>(a, smem, bars, &qmap, &smap, &xmap, gs, st0, nst, col_blk,
                                 row_blk);
    return;
  }

  // consumer warpgroup (wn, wb): columns wn*64.., batch rows wb*BT..
  const int wn = wg % a.nwg_n;
  const int wb = wg / a.nwg_n;
  const int tid = threadIdx.x & (WG_THREADS - 1);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  const int c0 = warp * 16 + 2 * gid;  // A rows gid, gid + 8 of this warp: columns c0, c0 + 1

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;

  if constexpr (BITS == 4 && GS == 128 && BT <= 72) {
    // g128, the serving path: every stage is one group. Two group sums in
    // turn, so that a stage's wgmmas run while the next stage converts;
    // a stage is scaled into acc and released one stage later.
    float p0[BT / 2], p1[BT / 2];
    const float* sc_prev = nullptr;
    int s_prev = 0;
    auto stage = [&](int it, float* cur, float* prev) {
      const int s = it % a.stages;
      mbar_wait(smem_u32(&bars[s]), (it / a.stages) & 1);
      const uint8_t* base = smem + (size_t)s * a.stage_bytes;
      g128_stage<BT>(cur, base + wn * W_BYTES,
                     XBoxes<P>{smem_u32(base + a.off_x) + wb * BT * 128, a.xbox_bytes,
                               a.piece_bytes},
                     warp, gid, tq);
      if (it > 0) {
        wg_wait<4>();  // the previous stage's four groups are done
        fence_regs<BT / 2>(prev);
        const float2 sp = *reinterpret_cast<const float2*>(sc_prev + c0);
        scale_into<BT>(acc, prev, sp.x, sp.y);
        mbar_arrive(smem_u32(&bars[a.stages + s_prev]));
      }
      sc_prev = reinterpret_cast<const float*>(base + a.off_sc + wn * a.gr * COLS * 4);
      s_prev = s;
    };
    for (int it = 0; it < nst; it += 2) {
      stage(it, p0, p1);
      if (it + 1 < nst) stage(it + 1, p1, p0);
    }
    wg_wait0();
    const float2 sp = *reinterpret_cast<const float2*>(sc_prev + c0);
    if (nst & 1) {
      fence_regs<BT / 2>(p0);
      scale_into<BT>(acc, p0, sp.x, sp.y);
    } else {
      fence_regs<BT / 2>(p1);
      scale_into<BT>(acc, p1, sp.x, sp.y);
    }
    mbar_arrive(smem_u32(&bars[a.stages + s_prev]));
  } else {
    float part[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) part[i] = 0.f;
    int accumulate = 0;

    for (int it = 0; it < nst; ++it) {
      const int s = it % a.stages;
      mbar_wait(smem_u32(&bars[s]), (it / a.stages) & 1);
      const uint8_t* base = smem + (size_t)s * a.stage_bytes;
      const uint8_t* wt = base + wn * W_BYTES;
      const float* sc = reinterpret_cast<const float*>(base + a.off_sc + wn * a.gr * COLS * 4);
      const bool closes = it == nst - 1 ||
          ((st0 + it + 1) * STAGE_ROWS) % (BITS == 4 ? gs / 2 : gs) == 0;
      const XBoxes<P> xdesc{smem_u32(base + a.off_x) + wb * BT * 128, a.xbox_bytes,
                            a.piece_bytes};
      if constexpr (GS == -2) {
        masked_stage<BITS, BT>(a, acc, part, accumulate, wt, sc, xdesc, gs, st0 + it,
                               it == nst - 1, warp, gid, tq, c0);
      } else if constexpr (GS == -1) {
        odd_stage<BITS, BT>(a, acc, part, accumulate, wt, sc, xdesc, gs, st0 + it,
                            it == nst - 1, warp, gid, tq, c0);
      } else if (BITS == 4 && gs != 16) {
        const int half = gs / 2;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int R = 16 * u;
          const uint32_t w0 = octet_word(wt, R + 2 * tq, warp, gid);
          const uint32_t w1 = octet_word(wt, R + 8 + 2 * tq, warp, gid);
          const uint32_t l0 = w0 & 0x0F0F0F0Fu, l1 = w1 & 0x0F0F0F0Fu;
          const uint32_t h0 = (w0 >> 4) & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
          uint32_t alo[4] = {nib_pair(l0, 0x4140u), nib_pair(l0, 0x4342u),
                             nib_pair(l1, 0x4140u), nib_pair(l1, 0x4342u)};
          uint32_t ahi[4] = {nib_pair(h0, 0x4140u), nib_pair(h0, 0x4342u),
                             nib_pair(h1, 0x4140u), nib_pair(h1, 0x4342u)};
          // gs >= 128: box 0 holds the low nibbles' x, box 1 the high ones';
          // gs < 128: the stage's x in order, group g at g*gs
          const int g = gs >= 128 ? 0 : R / half;
          const int plo = gs >= 128 ? R : g * gs + (R - g * half);
          const int phi = gs >= 128 ? 64 + R : plo + half;
          issue<BT>(part, alo, xdesc, plo, accumulate, ahi, phi);
          accumulate = 1;
          if (gs < 128 && (R + 16) % half == 0) {
            close_group<BT>(acc, part, sc + g * COLS, c0);
            accumulate = 0;
          }
        }
        if (gs >= 128 && closes) {
          close_group<BT>(acc, part, sc, c0);
          accumulate = 0;
        }
      } else if (BITS == 4) {  // gs == 16: an octet is a group, its halves one k16 step
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint32_t w0 = octet_word(wt, 8 * u + 2 * tq, warp, gid);
          const uint32_t l0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
          uint32_t af[4] = {nib_pair(l0, 0x4140u), nib_pair(l0, 0x4342u),
                            nib_pair(h0, 0x4140u), nib_pair(h0, 0x4342u)};
          issue<BT>(part, af, xdesc, 16 * u, 0);
          close_group<BT>(acc, part, sc + u * COLS, c0);
        }
      } else {  // int8: 16 rows a k16 step
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int R = 16 * u;
          uint32_t af[4];
          i8_frag(af, wt, R, warp, gid, tq);
          issue<BT>(part, af, xdesc, R, accumulate);
          accumulate = 1;
          if (gs < 64 && (R + 16) % gs == 0) {
            close_group<BT>(acc, part, sc + (R / gs) * COLS, c0);
            accumulate = 0;
          }
        }
        if (gs >= 64 && closes) {
          close_group<BT>(acc, part, sc, c0);
          accumulate = 0;
        }
      }
      wg_wait0();  // the stage's x has been read
      mbar_arrive(smem_u32(&bars[a.stages + s]));
    }
  }

  using OT = std::conditional_t<P == 1, __nv_bfloat16, float>;
  write_out<BT, OT, false>(a, acc, col_blk + wn * COLS + c0, row_blk + wb * BT + 2 * tq, ncons,
                           &s_last);
}

// ---------------------------------------------------------------- W4A8, Hopper
// int4 weights against int8 x (tpuserve/ops/quant_matmul.py::_kernel, the
// act_int8 branch): for each group and output, the int32 dot of x with the
// codes minus 8, converted to f32, times the group's scale, summed over the
// groups in f32; the output row then times its activation scale (the
// caller's multiply in the TPU path, done here before the output's
// rounding). x comes from quantize_rows_kernel.
//
// Bound on the H100 at decode: bytes, as the bf16 path; the int8 tensor
// cores give twice the bf16 rate, and a byte of weights costs one LOP3 (and
// a shift) a nibble pair instead of the bf16 path's PRMT and HSUB2.
//
// The ring, swap-AB, split and output of qmm_wgmma_kernel, on wgmma
// m64nNk32.s32.s8.s8 (N: 16, 32, 64, 80 or 128; integer wgmma has no n72):
//   - x: two int8 boxes [rows, 64 values], 64-byte swizzle, K-major as
//     wgmma needs an 8-bit B operand; the stages are those of the bf16 path
//     (whole groups with x in order, or pieces of one group with box 0
//     against the low nibbles and box 1 against the high ones); in
//     groups of a multiple of 32 every k32 step lies in one group, and
//     other even groups take masked k32 steps (as the bf16 kernel's masked
//     k16 steps, a8_masked_frag), each group's int32 sum its own;
//   - A from registers: ldmatrix.x4.trans gives a lane two adjacent columns
//     of two adjacent rows a matrix; the lanes' row addresses are arranged
//     so that two PRMTs turn matrices (0, 1) and (2, 3) into the four codes
//     of K 4tq..4tq+3 of column c0 and of c1 (the k32 fragment), and the
//     8 rows of each matrix fall on 8 distinct bank groups of the swizzled
//     weight box;
//   - codes: one LOP3 (and a shift for the low nibbles) makes
//     ((nibble << 4) ^ 0x80) = 16 * (code - 8) as s8, exact; the int32 sums
//     are 16 times the TPU kernel's x.c - 8*rowsum(x), taken back at the
//     group's flush (|sum| < 2^31 for any group under 2^17 values);
//   - a split ends only where a group does, so each group's int32 sum is
//     whole before its scale (the wrapper's plan);
//   - all of a batch's A fragments are built before its first wgmma and
//     stay live until it has been waited for: a wgmma reads its A registers
//     after it is issued, and ptxas does not keep a loop from rewriting
//     them in the meantime;
//   - g128 (the serving groups, one a stage) runs two group sums in turn,
//     as the bf16 kernel's g128 path: a stage's wgmmas in flight while the
//     next stage loads and converts; its flush converts the int32 sums
//     without I2F (a8_flush).
template <int N> struct WgmmaS8;
template <> struct WgmmaS8<16> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct WgmmaS8<32> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct WgmmaS8<64> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct WgmmaS8<80> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39}, "
        "{%40, %41, %42, %43}, %44, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};
template <> struct WgmmaS8<128> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

// The k32 fragment of the 16-row blocks ra (K 0-15 of the step) and rb
// (K 16-31) of the weight box: ldmatrix.x4.trans, lane L addressing row
// L % 8 of matrix L / 8. A lane receives rows 2tq, 2tq + 1 of each matrix
// at its two columns; matrix rows 2a, 2a + 1 are the block's rows
// 4a + {0, 1} or 4a + {2, 3} (the first pair in matrix 0 for a < 2, in
// matrix 1 for a >= 2), so that a matrix's 8 rows fall on 8 distinct bank
// groups of the 64-byte swizzle, and two PRMTs a block (sel0, sel1: by tq)
// give the bytes of rows 4tq..4tq+3 of column c0 and of c1.
__device__ __forceinline__ void a8_load(uint32_t (&f)[4], uint32_t wt, int ra, int rb, int warp,
                                        int lane, uint32_t sel0, uint32_t sel1) {
  const int m = lane >> 3, j = lane & 7;
  const int row = (m < 2 ? ra : rb) + 4 * (j >> 1) + 2 * ((j >> 2) ^ (m & 1)) + (j & 1);
  const uint32_t addr = wt + row * 64 + ((warp ^ ((row >> 1) & 3)) << 4);
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
  f[0] = prmt(r[0], r[1], sel0);
  f[1] = prmt(r[0], r[1], sel1);
  f[2] = prmt(r[2], r[3], sel0);
  f[3] = prmt(r[2], r[3], sel1);
}

// 16 * (code - 8) as s8 in each byte: the low nibbles (sh 4) or the high
// ones (sh 0) of four packed bytes
__device__ __forceinline__ uint32_t codes16(uint32_t w, int sh) {
  return ((w << sh) & 0xF0F0F0F0u) ^ 0x80808080u;
}

// The k32 fragment at x position p of a masked stage (W4A8): the codes of
// the thread's K values 4tq..4tq + 3 and 16 + 4tq.. of columns c0 and c1,
// each from where(k) (code_pair's enc; code 8 outside the group, a zero
// product), as 16 * (code - 8) in s8.
// Where the step's 16 values of K at 16h lie in one half of the group (the
// same test as masked_frag's, in every thread), one 16-row block read as
// a8_load reads it, with ldmatrix.x2; else four K values at a time.
template <typename Where>
__device__ __forceinline__ void a8_masked_frag(uint32_t (&f)[4], const uint8_t* wt, uint32_t wts,
                                               int p, Where where, int warp, int lane, int gid,
                                               int tq, uint32_t sel0, uint32_t sel1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e0 = where(p + 16 * h), e15 = where(p + 16 * h + 15);
    if (e0 >= 0 && e15 - e0 == 15 << 3) {
      const int j = lane & 7, m = (lane >> 3) & 1;  // a8_load's rows of matrices 0 and 1
      const int row = (e0 >> 3) + 4 * (j >> 1) + 2 * ((j >> 2) ^ m) + (j & 1);
      uint32_t r0, r1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
                   : "=r"(r0), "=r"(r1)
                   : "r"(wts + row * 64 + ((warp ^ ((row >> 1) & 3)) << 4)));
      f[2 * h] = codes16(prmt(r0, r1, sel0), (e0 & 7) ? 0 : 4);
      f[2 * h + 1] = codes16(prmt(r0, r1, sel1), (e0 & 7) ? 0 : 4);
      continue;
    }
    const int k = p + 16 * h + 4 * tq;
    const uint32_t ab = prmt(code_pair<4>(wt, where(k), warp, gid),
                             code_pair<4>(wt, where(k + 1), warp, gid), 0x5140u);
    const uint32_t cd = prmt(code_pair<4>(wt, where(k + 2), warp, gid),
                             code_pair<4>(wt, where(k + 3), warp, gid), 0x5140u);
    f[2 * h] = codes16(prmt(ab, cd, 0x5410u), 4);      // column c0, K k..k + 3
    f[2 * h + 1] = codes16(prmt(ab, cd, 0x7632u), 4);  // column c1
  }
}

// The int32 group sum part = 16 v (v the TPU kernel's x.c - 8*rowsum(x))
// scaled into acc: acc += v * scale. With |part| < 2^22 (groups of up to
// 258 values) the conversion is exact without I2F, whose rate is a quarter
// of an add's: part added to the bits of 1.5 * 2^23 is that float plus
// part, and the 16 goes into the scale (exact: a power of two), so the
// product is the same real number as v * scale and rounds alike.
template <int BT, bool SMALL>
__device__ __forceinline__ void a8_flush(float* acc, int* part, const float* sc_row, int c0) {
  const float2 sv = *reinterpret_cast<const float2*>(sc_row + c0);
  if (SMALL) {
    const float s0 = sv.x * 0.0625f, s1 = sv.y * 0.0625f;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = __int_as_float(part[4 * j + e] + 0x4B400000) - 12582912.0f;
        acc[4 * j + e] += f * (e < 2 ? s0 : s1);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      acc[4 * j + 0] += (float)(part[4 * j + 0] >> 4) * sv.x;
      acc[4 * j + 1] += (float)(part[4 * j + 1] >> 4) * sv.x;
      acc[4 * j + 2] += (float)(part[4 * j + 2] >> 4) * sv.y;
      acc[4 * j + 3] += (float)(part[4 * j + 3] >> 4) * sv.y;
    }
  }
}

// One g128 stage (one group, x in order: box 0 against the low nibbles,
// box 1 against the high ones): two ldmatrix.x4 give the 64 rows, whose
// low and high nibbles make the four k32 fragments, issued into `part`
// (fresh) and left in flight.
template <int BT>
__device__ __forceinline__ void a8_g128_stage(int* part, uint32_t (&fr)[4][4], uint32_t wt,
                                              uint32_t xb, int xbox_bytes, int warp, int lane,
                                              uint32_t sel0, uint32_t sel1) {
  uint32_t raw[2][4];
  a8_load(raw[0], wt, 0, 16, warp, lane, sel0, sel1);
  a8_load(raw[1], wt, 32, 48, warp, lane, sel0, sel1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // step i: rows 32 (i % 2).., low (i < 2) or high nibbles
#pragma unroll
    for (int r = 0; r < 4; ++r) fr[i][r] = codes16(raw[i & 1][r], i < 2 ? 4 : 0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) fence_regs<4>(fr[i]);
  fence_regs<BT / 2>(part);
  wg_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    WgmmaS8<BT>::mma(part, fr[i], desc_sw64(xb + (i >> 1) * xbox_bytes + 32 * (i & 1)), i > 0);
  wg_commit();
}

// MODE A8_G128: groups of 128 (a stage is one group), run as the bf16
// kernel's g128 path: two group sums in turn, a stage's wgmmas in flight
// while the next stage converts, each flushed and released one stage
// later. A8_GENERAL: any group of a multiple of 32 values. A8_MASKED: the
// other even groups, in masked k32 steps.
enum { A8_GENERAL, A8_G128, A8_MASKED };

template <int BT, int MODE, typename OT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
qmm_a8_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap smap,
              const __grid_constant__ CUtensorMap xmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)a.stages * a.stage_bytes);
  __shared__ int s_last;
  const int ncons = a.nwg_n * a.nwg_b;
  const int wg = threadIdx.x / WG_THREADS;
  const int gs = a.gs;
  const int st0 = blockIdx.y * a.sps;
  const int nst = min(a.total, st0 + a.sps) - st0;
  const int col_blk = blockIdx.x * COLS * a.nwg_n;
  const int row_blk = blockIdx.z * BT * a.nwg_b;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);                                // full
      mbar_init(smem_u32(&bars[a.stages + s]), ncons * WG_THREADS);    // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == ncons) {
    if (threadIdx.x == ncons * WG_THREADS)
      produce<4, MODE == A8_MASKED, 1>(a, smem, bars, &qmap, &smap, &xmap, gs, st0, nst,
                                       col_blk, row_blk);
    return;
  }

  const int wn = wg % a.nwg_n;
  const int wb = wg / a.nwg_n;
  const int tid = threadIdx.x & (WG_THREADS - 1);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  const int c0 = warp * 16 + 2 * gid;
  const uint32_t sel0 = tq < 2 ? 0x6420u : 0x2064u;
  const uint32_t sel1 = tq < 2 ? 0x7531u : 0x3175u;
  const int rpg = gs / 2;

  float acc[BT / 2];
  int part[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    acc[i] = 0.f;
    part[i] = 0;
  }
  int accumulate = 0;

  if constexpr (MODE == A8_G128 && BT <= 80) {
    int p1[BT / 2];
    uint32_t f0[4][4], f1[4][4];
    const float* sc_prev = nullptr;
    int s_prev = 0;
    auto stage = [&](int it, int* cur, uint32_t (&fc)[4][4], int* prev, uint32_t (&fp)[4][4]) {
      const int s = it % a.stages;
      mbar_wait(smem_u32(&bars[s]), (it / a.stages) & 1);
      const uint8_t* base = smem + (size_t)s * a.stage_bytes;
      a8_g128_stage<BT>(cur, fc, smem_u32(base + wn * W_BYTES),
                        smem_u32(base + a.off_x) + wb * BT * 64, a.xbox_bytes, warp, lane, sel0,
                        sel1);
      if (it > 0) {
        wg_wait<1>();  // the previous stage's group is done
        fence_regs<BT / 2>(prev);
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_regs<4>(fp[i]);
        a8_flush<BT, true>(acc, prev, sc_prev, c0);
        mbar_arrive(smem_u32(&bars[a.stages + s_prev]));
      }
      sc_prev = reinterpret_cast<const float*>(base + a.off_sc + wn * COLS * 4);
      s_prev = s;
    };
    for (int it = 0; it < nst; it += 2) {
      stage(it, part, f0, p1, f1);
      if (it + 1 < nst) stage(it + 1, p1, f1, part, f0);
    }
    wg_wait0();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_regs<4>(f0[i]);
      fence_regs<4>(f1[i]);
    }
    // (a branch each, not a pointer chosen at run time: that would put both
    // sums in local memory, where the async wgmma cannot write them)
    if (nst & 1) {
      fence_regs<BT / 2>(part);
      a8_flush<BT, true>(acc, part, sc_prev, c0);
    } else {
      fence_regs<BT / 2>(p1);
      a8_flush<BT, true>(acc, p1, sc_prev, c0);
    }
    mbar_arrive(smem_u32(&bars[a.stages + s_prev]));
  } else {
  for (int it = 0; it < nst; ++it) {
    const int s = it % a.stages;
    mbar_wait(smem_u32(&bars[s]), (it / a.stages) & 1);
    const uint8_t* base = smem + (size_t)s * a.stage_bytes;
    const uint32_t wt = smem_u32(base + wn * W_BYTES);
    const float* sc = reinterpret_cast<const float*>(base + a.off_sc + wn * a.gr * COLS * 4);
    const uint32_t xb = smem_u32(base + a.off_x) + wb * BT * 64;
    // x value p (0..127) of the stage: box p / 64, 32 bytes a k32 step
    auto xdesc = [&](int p) { return desc_sw64(xb + (p >> 6) * a.xbox_bytes + (p & 63)); };
    // up to 4 k32 steps: step s takes the 16-row blocks ra[s] (K 0-15) and
    // rb[s] (K 16-31, zeros unless vb[s]), low (sh 4) or high (sh 0)
    // nibbles, against x from px[s]; all built before the first is issued,
    // kept live until they are waited for (a wgmma reads its A registers
    // after it is issued)
    uint32_t fr[4][4];
    int px[4];
    auto issue_steps = [&](int n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_regs<4>(fr[i]);
      fence_regs<BT / 2>(part);
      wg_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n) WgmmaS8<BT>::mma(part, fr[i], xdesc(px[i]), i > 0 || accumulate);
      wg_commit();
      accumulate = 1;
    };
    auto run = [&](int n, const int* ra, const int* sa, const int* rb, const int* sb,
                   const bool* vb) {
      uint32_t raw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < n) {
          // the low and high nibbles of the same rows come from one load
          if (i == 0 || ra[i] != ra[i - 1] || rb[i] != rb[i - 1] || vb[i] != vb[i - 1])
            a8_load(raw, wt, ra[i], vb[i] ? rb[i] : ra[i], warp, lane, sel0, sel1);
          fr[i][0] = codes16(raw[0], sa[i]);
          fr[i][1] = codes16(raw[1], sa[i]);
          fr[i][2] = vb[i] ? codes16(raw[2], sb[i]) : 0u;
          fr[i][3] = vb[i] ? codes16(raw[3], sb[i]) : 0u;
        }
      }
      issue_steps(n);
    };
    // the group's int32 sum (16 times the TPU kernel's) into f32, scaled
    auto flush = [&](const float* sc_row) {
      wg_wait0();
      fence_regs<BT / 2>(part);
      if (gs <= 256)
        a8_flush<BT, true>(acc, part, sc_row, c0);
      else
        a8_flush<BT, false>(acc, part, sc_row, c0);
      accumulate = 0;
    };
    int ra[4], sa[4], rb[4], sb[4];
    bool vb[4];
    const int t = st0 + it;
    const uint8_t* wtp = base + wn * W_BYTES;
    if (MODE == A8_MASKED && a.spg == 1) {
      // whole groups of no multiple of 32 values (gs <= 128), x in order:
      // group j's k32 steps floor(lo / 32) .. ceil(hi / 32) - 1 masked to
      // its values [lo, hi)
      const int ng = min(a.gr, a.K / gs - t * a.gr);
      for (int j = 0; j < ng; ++j) {
        const int lo = j * gs, s0 = lo >> 5, n = ((lo + gs + 31) >> 5) - s0;
        auto where = [&](int k) {
          const int r = k - lo;
          const int hi = r >= rpg;
          const int enc = (j * rpg + r - hi * rpg) << 3 | hi << 2;
          return (unsigned)r < (unsigned)gs ? enc : -1;
        };
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < n) {
            px[i] = 32 * (s0 + i);
            a8_masked_frag(fr[i], wtp, wt, px[i], where, warp, lane, gid, tq, sel0, sel1);
          }
        }
        issue_steps(n);
        flush(sc + j * COLS);
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_regs<4>(fr[i]);
      }
    } else if (MODE == A8_MASKED) {  // a piece: lows against box 0, highs against box 1
      const int pc = t % a.spg;
      const int rows = min(STAGE_ROWS, rpg - pc * STAGE_ROWS);
      auto where = [&](int k) {
        const int r = k & 63;
        return r < rows ? r << 3 | (k >> 6) << 2 : -1;
      };
      const int n = 2 * ((rows + 31) >> 5);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < n) {
          px[i] = (i & 1) * 64 + 32 * (i >> 1);
          a8_masked_frag(fr[i], wtp, wt, px[i], where, warp, lane, gid, tq, sel0, sel1);
        }
      }
      issue_steps(n);
      if (pc == a.spg - 1 || it == nst - 1) flush(sc);
    } else if (a.spg == 1) {  // whole groups (gs <= 128), x in order: gs / 32 k32 steps each
      const int ng = min(a.gr, a.K / gs - t * a.gr);
      const int hq = rpg / 16;  // 16-row blocks a group holds
      for (int j = 0; j < ng; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // K 32m..32m+31 of the group: lows of block q, or highs of q - hq;
          // where gs % 64 == 0 the steps go lows and highs of the same rows
          // in turn (m = 0, hq/2, 1, hq/2 + 1), so that they share a load
          const int m = rpg % 32 ? i : (i >> 1) + (i & 1) * (hq >> 1);
          const int q = 2 * m;
          ra[i] = j * rpg + 16 * (q < hq ? q : q - hq);
          sa[i] = q < hq ? 4 : 0;
          rb[i] = j * rpg + 16 * (q + 1 < hq ? q + 1 : q + 1 - hq);
          sb[i] = q + 1 < hq ? 4 : 0;
          vb[i] = true;
          px[i] = j * gs + 32 * m;
        }
        run(gs / 32, ra, sa, rb, sb, vb);
        flush(sc + j * COLS);
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_regs<4>(fr[i]);
      }
    } else {  // a piece of one group: lows against box 0, highs against box 1
      const int pc = t % a.spg;
      const int rows = min(STAGE_ROWS, rpg - pc * STAGE_ROWS);  // a multiple of 16
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows 32 (i / 2).., low (i even) or high nibbles
        const int R = 32 * (i >> 1);
        ra[i] = R;
        rb[i] = R + 16;
        vb[i] = R + 16 < rows;
        sa[i] = sb[i] = (i & 1) ? 0 : 4;
        px[i] = (i & 1) ? 64 + R : R;
      }
      run(2 * ((rows + 31) / 32), ra, sa, rb, sb, vb);
      if (pc == a.spg - 1 || it == nst - 1) flush(sc);
    }
    wg_wait0();  // the stage's x has been read
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_regs<4>(fr[i]);
    mbar_arrive(smem_u32(&bars[a.stages + s]));
  }
  }

  write_out<BT, OT, true>(a, acc, col_blk + wn * COLS + c0, row_blk + wb * BT + 2 * tq, ncons,
                          &s_last);
}

// The weight's two maps depend only on its pointers and shape: built once
// per weight and kept (a serving step makes 129 calls on a fixed set).
struct WeightKey {
  const void* q;
  const void* s;
  int bits, K, N, gs;
  bool operator==(const WeightKey& o) const {
    return q == o.q && s == o.s && bits == o.bits && K == o.K && N == o.N && gs == o.gs;
  }
};
struct WeightKeyHash {
  size_t operator()(const WeightKey& k) const {
    return std::hash<const void*>()(k.q) ^ (std::hash<const void*>()(k.s) << 1) ^
           ((size_t)k.N * 31 + (size_t)k.K * 7 + (size_t)k.gs * 3 + (size_t)k.bits);
  }
};
struct WeightMaps {
  CUtensorMap q, s;
};

bool weight_maps(const WeightKey& key, int gr, WeightMaps* out) {
  static std::mutex mu;
  static std::unordered_map<WeightKey, WeightMaps, WeightKeyHash> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  const uint64_t rows = key.bits == 4 ? key.K / 2 : key.K;
  WeightMaps m;
  // 64-byte weight rows with the 64-byte swizzle that octet_word reads
  if (!encode(&m.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, key.q, key.N, rows, key.N, COLS, STAGE_ROWS,
              CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&m.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, key.s, key.N, key.K / key.gs,
              (uint64_t)key.N * 4, COLS, gr, CU_TENSOR_MAP_SWIZZLE_NONE))
    return false;
  if (cache.size() >= 4096) cache.clear();  // weights freed and reallocated
  cache.emplace(key, m);
  *out = m;
  return true;
}

template <typename Kern>
int launch_with(Kern kern, size_t& opted_in, const WeightMaps& wm, const CUtensorMap& xm,
                const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int threads = a.nwg_n * a.nwg_b * WG_THREADS + 32;
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  kern<<<grid, threads, smem, st>>>(wm.q, wm.s, xm, a);
  return (int)cudaGetLastError();
}

template <int BITS, int GS, int BT, int P>
int launch_wgmma(const WeightMaps& wm, const CUtensorMap& xm, const Args& a, dim3 grid,
                 size_t smem, cudaStream_t st) {
  static size_t opted_in = 0;
  return launch_with(qmm_wgmma_kernel<BITS, GS, BT, P>, opted_in, wm, xm, a, grid, smem, st);
}

template <int BT, int MODE, typename OT>
int launch_a8(const WeightMaps& wm, const CUtensorMap& xm, const Args& a, dim3 grid, size_t smem,
              cudaStream_t st) {
  static size_t opted_in = 0;
  return launch_with(qmm_a8_kernel<BT, MODE, OT>, opted_in, wm, xm, a, grid, smem, st);
}

template <int BITS, int GS, int P>
int launch_bt(int bt, const WeightMaps& wm, const CUtensorMap& xm, const Args& a, dim3 grid,
              size_t smem, cudaStream_t st) {
  switch (bt) {
    case 16: return launch_wgmma<BITS, GS, 16, P>(wm, xm, a, grid, smem, st);
    case 32: return launch_wgmma<BITS, GS, 32, P>(wm, xm, a, grid, smem, st);
    case 64: return launch_wgmma<BITS, GS, 64, P>(wm, xm, a, grid, smem, st);
    case 72: return launch_wgmma<BITS, GS, 72, P>(wm, xm, a, grid, smem, st);
    case 128: return launch_wgmma<BITS, GS, 128, P>(wm, xm, a, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the instance for the group (and, for int4, g128's own), x in P pieces
template <int P>
int launch_group(int bits, int gs, bool masked, const Args& a, int bt, const WeightMaps& wm,
                 const CUtensorMap& xm, dim3 grid, size_t smem, cudaStream_t st) {
  if (bits == 8)
    return masked  ? launch_bt<8, -2, P>(bt, wm, xm, a, grid, smem, st)
           : a.odd ? launch_bt<8, -1, P>(bt, wm, xm, a, grid, smem, st)
                   : launch_bt<8, 0, P>(bt, wm, xm, a, grid, smem, st);
  if (gs == 128) return launch_bt<4, 128, P>(bt, wm, xm, a, grid, smem, st);
  return masked  ? launch_bt<4, -2, P>(bt, wm, xm, a, grid, smem, st)
         : a.odd ? launch_bt<4, -1, P>(bt, wm, xm, a, grid, smem, st)
                 : launch_bt<4, 0, P>(bt, wm, xm, a, grid, smem, st);
}

template <int MODE, typename OT>
int launch_a8_bt(int bt, const WeightMaps& wm, const CUtensorMap& xm, const Args& a, dim3 grid,
                 size_t smem, cudaStream_t st) {
  switch (bt) {
    case 16: return launch_a8<16, MODE, OT>(wm, xm, a, grid, smem, st);
    case 32: return launch_a8<32, MODE, OT>(wm, xm, a, grid, smem, st);
    case 64: return launch_a8<64, MODE, OT>(wm, xm, a, grid, smem, st);
    case 80: return launch_a8<80, MODE, OT>(wm, xm, a, grid, smem, st);
    case 128: return launch_a8<128, MODE, OT>(wm, xm, a, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The stages of K for `bits`-bit weights in groups of gs (any group that
// divides K): a.gr whole groups a stage where a group's weight rows
// fit in one, else a.spg pieces a group; a.odd where neither divides the
// other. The wrapper's plan (ops/quant_matmul.py::stage_plan) is the same.
void plan_stages(Args& a, int bits, int K, int gs) {
  const int rpg = bits == 4 ? gs / 2 : gs;
  const int groups = K / gs;
  if (rpg <= STAGE_ROWS) {
    a.gr = STAGE_ROWS / rpg;
    a.spg = 1;
    a.total = (groups + a.gr - 1) / a.gr;
  } else {
    a.gr = 1;
    a.spg = (rpg + STAGE_ROWS - 1) / STAGE_ROWS;
    a.total = groups * a.spg;
  }
  a.odd = STAGE_ROWS % rpg != 0 && rpg % STAGE_ROWS != 0;
}

// What both entries set up alike: the stages, the ring's layout in shared
// memory (per stage: the weight boxes, nbox x boxes of xbox_bytes for each
// of x's pieces, the scale boxes), the weight's maps and the grid. Returns
// a cudaError_t code (0: ready to launch).
int prepare(Args& a, size_t& smem, WeightMaps& wm, dim3& grid, const void* q, const void* scale,
            void* out, void* workspace, void* counters, int B, int K, int N, int gs, int bits,
            int nwg_n, int nwg_b, int bx, int nbox, int xbox_bytes, int pieces, int sps,
            int splits) {
  const int bad = (int)cudaErrorInvalidValue;
  a.out = out;
  a.row_scale = nullptr;
  a.ws = (float*)workspace;
  a.counters = (int*)counters;
  a.B = B; a.K = K; a.N = N; a.gs = gs; a.sps = sps; a.splits = splits;
  a.nwg_n = nwg_n; a.nwg_b = nwg_b;
  plan_stages(a, bits, K, gs);
  if (sps < 1 || splits != (a.total + sps - 1) / sps) return bad;
  if (splits > 1 && (workspace == nullptr || counters == nullptr)) return bad;
  a.xbox_bytes = xbox_bytes;
  a.piece_bytes = nbox * xbox_bytes;
  a.off_x = nwg_n * W_BYTES;
  a.off_sc = a.off_x + pieces * a.piece_bytes;
  const int sc_bytes = nwg_n * a.gr * COLS * 4;
  a.stage_bytes = (a.off_sc + sc_bytes + 1023) / 1024 * 1024;
  a.tx_bytes = a.off_sc + sc_bytes;
  const int budget = 232448 - 1024 - 256 - 2 * MAX_STAGES * 8;
  a.stages = min(MAX_STAGES, budget / a.stage_bytes);
  if (a.stages < 2) return bad;
  smem = 1024 + (size_t)a.stages * a.stage_bytes + 2 * a.stages * 8;
  if (!weight_maps({q, scale, bits, K, N, gs}, a.gr, &wm)) return bad;
  grid = dim3((N + COLS * nwg_n - 1) / (COLS * nwg_n), splits, (B + bx - 1) / bx);
  return 0;
}

}  // namespace hop

}  // namespace

// bf16 x [B, K] (16-byte aligned rows; for a group of no multiple of 16
// values, [B, stages * 128] (bits 8: * 64) as ops/quant_matmul.py::
// stage_x_index gathers it) and out [B, N] bf16; or, pieces 3, f32 x as
// split_x_kernel's three bf16 pieces [3, B, that width] and out [B, N]
// f32. q packed uint8 [K/2, N] (bits 4) or int8 [K, N] (bits 8); scale
// f32 [K/gs, N]; N % 16 == 0; gs divides K (even for bits 4). bt: the
// batch tile (16, 32, 64, 72 or 128); nwg_n column and nwg_b batch
// warpgroups a block (bt * nwg_b <= 256; more rows take more blocks along
// grid.z); sps stages a split and splits = ceil(stages / sps) (stages as
// plan_stages counts them); with splits > 1, workspace holds splits*B*N
// floats and counters one zeroed int per output tile. One launch. Returns
// a cudaError_t code.
extern "C" int tpuserve_quant_matmul_bf16(const void* x, const void* q, const void* scale,
                                          void* out, void* workspace, void* counters, int B,
                                          int K, int N, int gs, int bits, int bt, int nwg_n,
                                          int nwg_b, int sps, int splits, int pieces,
                                          void* stream) {
  using namespace hop;
  const int bad = (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if ((bits != 4 && bits != 8) || gs <= 0 || (bits == 4 && gs % 2) || K % gs || N % 16 ||
      nwg_n < 1 || nwg_b < 1 || (pieces != 1 && pieces != 3))
    return bad;
  const int bx = bt * nwg_b;
  if (bx > 256) return bad;
  Args a;
  size_t smem;
  WeightMaps wm;
  dim3 grid;
  const int rc = prepare(a, smem, wm, grid, q, scale, out, workspace, counters, B, K, N, gs, bits,
                         nwg_n, nwg_b, bx, bits == 4 ? 2 : 1, bx * 128, pieces, sps, splits);
  if (rc) return rc;
  const bool masked = gs % 16 != 0;
  // x's row: K values, or (masked) the gathered stages, 64 values a box. The
  // pieces are one map of pieces * B rows: a box's rows past a piece's B
  // read the next piece's, which meet only output rows past B (never
  // written), and past the last piece arrive as zeros.
  const uint64_t xw = masked ? (uint64_t)a.total * 64 * (bits == 4 ? 2 : 1) : K;
  CUtensorMap xm;
  if (!encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, xw, (uint64_t)pieces * B, xw * 2, 64, bx,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  cudaStream_t st = (cudaStream_t)stream;
  return pieces == 1 ? launch_group<1>(bits, gs, masked, a, bt, wm, xm, grid, smem, st)
                     : launch_group<3>(bits, gs, masked, a, bt, wm, xm, grid, smem, st);
}

// W4A8: int8 x [B, K] (for a group of no multiple of 32 values, [B, stages
// * 128] as stage_x_index gathers it), with its f32 row scales [B]
// (multiplied into each output row); out [B, N] f32 (out_bf16 0) or bf16
// (1, rounded after the row scale); q packed uint8 [K/2, N]; scale f32
// [K/gs, N]; N % 16 == 0; gs even, dividing K. bt: 16, 32, 64, 80 or 128; the rest as
// tpuserve_quant_matmul_bf16. One launch. Returns a cudaError_t code.
extern "C" int tpuserve_quant_matmul_a8(const void* x, const void* q, const void* scale,
                                        const void* row_scale, void* out, void* workspace,
                                        void* counters, int B, int K, int N, int gs, int out_bf16,
                                        int bt, int nwg_n, int nwg_b, int sps, int splits,
                                        void* stream) {
  using namespace hop;
  const int bad = (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (gs <= 0 || gs % 2 || K % gs || N % 16 || nwg_n < 1 || nwg_b < 1 || !row_scale) return bad;
  const int bx = bt * nwg_b;
  if (bx > 256) return bad;
  Args a;
  size_t smem;
  WeightMaps wm;
  dim3 grid;
  const int rc = prepare(a, smem, wm, grid, q, scale, out, workspace, counters, B, K, N, gs, 4,
                         nwg_n, nwg_b, bx, 2, bx * 64, 1, sps, splits);
  if (rc) return rc;
  if (sps % a.spg) return bad;  // a split ends where a group does
  a.row_scale = (const float*)row_scale;
  const bool masked = gs % 32 != 0;
  const uint64_t xw = masked ? (uint64_t)a.total * 128 : K;  // as the bf16 entry's
  CUtensorMap xm;
  if (!encode(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, xw, B, xw, 64, bx,
              CU_TENSOR_MAP_SWIZZLE_64B))
    return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (masked)
    return out_bf16 ? launch_a8_bt<A8_MASKED, __nv_bfloat16>(bt, wm, xm, a, grid, smem, st)
                    : launch_a8_bt<A8_MASKED, float>(bt, wm, xm, a, grid, smem, st);
  if (!out_bf16)  // f32 activations: the general path serves g128 too
    return launch_a8_bt<A8_GENERAL, float>(bt, wm, xm, a, grid, smem, st);
  return gs == 128 ? launch_a8_bt<A8_G128, __nv_bfloat16>(bt, wm, xm, a, grid, smem, st)
                   : launch_a8_bt<A8_GENERAL, __nv_bfloat16>(bt, wm, xm, a, grid, smem, st);
}

// x [B, K] float32 (x_kind 0) or bfloat16 (1) to int8 q [B, W] and f32
// scale [B]: W = K in order (idx null), or the W positions idx gives (int32,
// K for a zero). Returns a cudaError_t code.
extern "C" int tpuserve_quantize_rows(const void* x, void* q, void* scale, int B, int K,
                                      int x_kind, const void* idx, int W, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || (x_kind != 0 && x_kind != 1) || (idx ? W <= 0 : W != K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  int8_t* qo = (int8_t*)q;
  float* so = (float*)scale;
  if (x_kind == 1) {
    const auto* xb = (const __nv_bfloat16*)x;
    if (ix)
      quantize_rows_kernel<__nv_bfloat16, true><<<B, 256, 0, st>>>(xb, qo, so, K, ix, W);
    else
      quantize_rows_kernel<__nv_bfloat16, false><<<B, 256, 0, st>>>(xb, qo, so, K, ix, W);
  } else {
    const auto* xf = (const float*)x;
    if (ix)
      quantize_rows_kernel<float, true><<<B, 256, 0, st>>>(xf, qo, so, K, ix, W);
    else
      quantize_rows_kernel<float, false><<<B, 256, 0, st>>>(xf, qo, so, K, ix, W);
  }
  return (int)cudaGetLastError();
}

// f32 x [B, K] to three bf16 pieces out [3, B, W]: W = K in order (idx
// null), or the W positions idx gives (int32, K for a zero). Returns a
// cudaError_t code.
extern "C" int tpuserve_split_x(const void* x, const void* idx, void* out, int B, int K, int W,
                                void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || W <= 0 || (!idx && W != K) || B > 65535) return (int)cudaErrorInvalidValue;
  split_x_kernel<<<dim3((W + 255) / 256, B), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (uint16_t*)out, B, K, W);
  return (int)cudaGetLastError();
}

// bf16 x [B, K] to out [B, W] by idx (int32 [W], K for a zero). Returns a
// cudaError_t code.
extern "C" int tpuserve_stage_x(const void* x, const void* idx, void* out, int B, int K, int W,
                                void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || W <= 0 || !idx || B > 65535) return (int)cudaErrorInvalidValue;
  stage_x_kernel<<<dim3((W + 255) / 256, B), 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const int*)idx, (uint16_t*)out, K, W);
  return (int)cudaGetLastError();
}
