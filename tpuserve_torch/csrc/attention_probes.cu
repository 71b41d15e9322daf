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
// softmax or head matching. Bound: bytes (K and V, 2 x 67 MB at the sweep's
// shape, against 4.3 G int8 and 4.3 G bf16 operations). Both dots run on
// the tensor cores (mma.sync), behind a cp.async ring: a block takes a run
// of 64-row tiles of one slot and 32 query rows; each stage holds a tile's
// K and V rows, issued together, D_STAGES - 1 tiles ahead. Scores: query
// rows on M (the q codes stay in registers as A fragments), a warp's 16
// cache rows on N, int8 m16n8k32, exact; P = bf16(1e-6 * score) goes to
// shared memory. P @ V: query rows on M, a warp's 32 output columns on N,
// the tile's rows on K, bf16 m16n8k16 with f32 sums: V's int8 codes are
// exact in bf16. There is no 8-bit ldmatrix.trans; ldmatrix.trans of the
// int8 tile as b16 hands a thread two adjacent columns of two adjacent
// rows, so its even and odd columns become two n tiles, converted to bf16
// by PRMT and a float subtraction (each V value once a block). The grid
// fills the card with two blocks an SM (ops/attention_probes.py); blocks
// add their partial sums to out with float4 atomics.
//
// colsum_strided: replaces scripts/diag_bw.py::copy_kernel (:78), in the
// three forms its modes call (pcopy :137, pcopy4d :165, pdyn :201; the
// make_pallas calls :92 and :99 are reached by no mode). A TPU block sums
// `rows` runs of run_bytes at a stride of row_stride bytes into int32
// column sums [hd], hd any multiple of 16 up to 256 (copy_kernel's
// reshape(-1, hd)), over K and V alike, and adds them to the output with
// atomics; the TPU kernel writes each block's sums over the last one's.
// With positions, the TPU blocks x past max(positions[slot], 0) / live_div
// read nothing (pdyn's clamped index map: the TPU re-reads the live block,
// which its pipeline skips). Bound: bytes. The CUDA grid is not the TPU's:
// each TPU block is cut into CTAs of consecutive rows (the wrapper's plan
// fills the card with several CTAs an SM), and a CTA streams its bytes by
// bulk asynchronous copies into a 4-stage ring of 16 KB stages (mbarrier
// completion; contiguous rows as one run in 16 KB pieces, strided runs one
// copy each), while 8 consumer warps sum each stage from shared memory in
// colsum's 16-bit lanes. The sums are exact, so any order gives the same
// bits.
#include <cuda_bf16.h>

#include "attention_hopper.cuh"
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

// ---- dot_only: a block takes tiles_per_block tiles of DT rows of one slot
// and query rows q0 .. q0 + 31 (grid.z: groups of DQ rows).
constexpr int DT = 64;        // cache rows of a tile
constexpr int DQ = 32;        // query rows of a block (two m16 tiles; rows past M are zero)
constexpr int D_STAGES = 4;   // ring depth: K and V tiles of one stage
constexpr int D_THREADS = 128;
constexpr int D_ROW = 144;    // K, V and q row stride in shared memory (conflict-free ldmatrix)
constexpr int D_TILE = DT * D_ROW;
constexpr int D_STAGE = 2 * D_TILE;
constexpr int D_PS = DT + 8;  // bf16 elements of a P row (144 bytes)
constexpr size_t D_SMEM = (size_t)D_STAGES * D_STAGE + DQ * D_ROW + DQ * D_PS * 2;

__global__ void __launch_bounds__(D_THREADS, 2) dot_only_kernel(
    const int8_t* qi, const int8_t* k, const int8_t* v, float* out, int M, int R,
    int tiles_per_block) {
  using namespace tpuserve::hopper;
  extern __shared__ __align__(128) unsigned char dsm[];
  unsigned char* ring = dsm;
  unsigned char* qs = ring + D_STAGES * D_STAGE;                          // [DQ][D_ROW]
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(qs + DQ * D_ROW);  // [DQ][D_PS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  const int slot = blockIdx.y, q0 = blockIdx.z * DQ, nq = min(DQ, M - q0);
  const int tile0 = blockIdx.x * tiles_per_block;
  const int n_tiles = min(tiles_per_block, R / DT - tile0);
  const int8_t* kb = k + ((size_t)slot * R + (size_t)tile0 * DT) * HDP;
  const int8_t* vb = v + ((size_t)slot * R + (size_t)tile0 * DT) * HDP;

  // tile tt: its K and V rows into stage tt % D_STAGES, one commit group
  auto issue = [&](int tt) {
    if (tt < n_tiles) {
      unsigned char* st = ring + (tt % D_STAGES) * D_STAGE;
      const size_t off = (size_t)tt * DT * HDP;
#pragma unroll
      for (int e = 0; e < DT * 8 / D_THREADS; ++e) {
        const int c = tid + e * D_THREADS, row = c >> 3, piece = c & 7;
        cp_async16(st + row * D_ROW + piece * 16, kb + off + row * HDP + piece * 16, 16);
        cp_async16(st + D_TILE + row * D_ROW + piece * 16, vb + off + row * HDP + piece * 16, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < D_STAGES - 1; ++p) issue(p);

  // the group's query codes (zero past M), then each m16 tile's A fragments
  for (int c = tid; c < DQ * 8; c += D_THREADS) {
    const int row = c >> 3, piece = c & 7;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (row < nq)
      w = reinterpret_cast<const uint4*>(qi + ((size_t)slot * M + q0 + row) * HDP)[piece];
    *reinterpret_cast<uint4*>(qs + row * D_ROW + piece * 16) = w;
  }
  __syncthreads();
  uint32_t qa[2][4][4];  // [m tile][k32 step]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(qa[m][kk], qs + (16 * m + (lane & 7) + (mat & 1) * 8) * D_ROW + 32 * kk +
                             (mat >> 1) * 16);

  // out columns 32 * warp + 16 * c + 4 * t + e of query rows 16 * m + g (+ 8)
  float acc[2][2][2][4] = {};  // [m tile][16-byte column chunk c][even, odd columns][c frag]

  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();  // tile tt landed; every warp is done with tile tt - 1 and P
    issue(tt + D_STAGES - 1);
    const unsigned char* st = ring + (tt % D_STAGES) * D_STAGE;

    // scores of the tile's rows 16 * warp .. +15 (two n8 tiles) against the
    // 32 query rows (two m16 tiles), int8 on the tensor cores, exact; then
    // P = bf16(1e-6 * score) into shared memory
    int sacc[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t kf[4];  // b0, b1 of n tile 0, then of n tile 1
      ldsm_x4(kf, st + (16 * warp + (lane & 7) + (mat >> 1) * 8) * D_ROW + 32 * kk +
                      (mat & 1) * 16);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_s8(sacc[m][n], qa[m][kk], kf[2 * n], kf[2 * n + 1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // |score| < 2^22: 1.5 * 2^23 + score is exact, and so is the subtraction
          const float s0 = __int_as_float(0x4B400000 + sacc[m][n][2 * h]) - 12582912.0f;
          const float s1 = __int_as_float(0x4B400000 + sacc[m][n][2 * h + 1]) - 12582912.0f;
          *reinterpret_cast<uint32_t*>(pt + (16 * m + g + 8 * h) * D_PS + 16 * warp + 8 * n +
                                       2 * t) = pack_bf16(s0 * 1e-6f, s1 * 1e-6f);
        }
    __syncthreads();  // P complete

    // P @ V on bf16 tensor cores: query rows on M, this warp's 32 columns on
    // N, the tile's rows on K. ldmatrix.trans of the int8 tile as b16 gives
    // a thread bytes (2t, 2g), (2t, 2g+1), (2t+1, 2g), (2t+1, 2g+1) of an
    // 8x16-byte block: its even and odd columns are two n8 tiles, converted
    // to bf16 exactly.
    const unsigned char* vt = st + D_TILE;
#pragma unroll
    for (int ks = 0; ks < DT / 16; ++ks) {
      uint32_t pa[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4(pa[m], pt + (16 * m + (lane & 7) + (mat & 1) * 8) * D_PS + 16 * ks +
                           (mat >> 1) * 8);
      uint32_t vr[4];  // rows 16ks + 0..7 and 8..15 of chunk 0, then of chunk 1
      ldsm_x4_trans(vr, vt + (16 * ks + (lane & 7) + (mat & 1) * 8) * D_ROW + 32 * warp +
                            (mat >> 1) * 16);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t e0 = s8_to_bf16x2<0, 2>(vr[2 * c]), e1 = s8_to_bf16x2<0, 2>(vr[2 * c + 1]);
        const uint32_t o0 = s8_to_bf16x2<1, 3>(vr[2 * c]), o1 = s8_to_bf16x2<1, 3>(vr[2 * c + 1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][c][0], pa[m][0], pa[m][1], pa[m][2], pa[m][3], e0, e1);
          mma_bf16(acc[m][c][1], pa[m][0], pa[m][1], pa[m][2], pa[m][3], o0, o1);
        }
      }
    }
  }

  // the block's partial sums into out: four consecutive columns a float4
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + g + 8 * h;
      if (row >= nq) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float* o = out + ((size_t)slot * M + q0 + row) * HDP + 32 * warp + 16 * c + 4 * t;
        const float4 x = make_float4(acc[m][c][0][2 * h], acc[m][c][1][2 * h],
                                     acc[m][c][0][2 * h + 1], acc[m][c][1][2 * h + 1]);
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
        atomicAdd(reinterpret_cast<float4*>(o), x);  // one vector atomic (sm_90)
#else
        atomicAdd(o, x.x); atomicAdd(o + 1, x.y); atomicAdd(o + 2, x.z); atomicAdd(o + 3, x.w);
#endif
      }
    }
}

constexpr int MAX_HD = 256;   // widest row segment colsum_strided takes
constexpr int CS_CONS = 256;  // colsum_strided's consumer threads; one producer warp after them
constexpr int CS_STAGE = 16384;  // bytes a ring stage holds
constexpr int CS_STAGES = 4;     // ring stages: 64 KB a block, three blocks an SM
constexpr int CS_SMEM = CS_STAGES * CS_STAGE;

struct StridedArgs {
  long long slot_stride, group_stride, block_stride, row_stride;  // bytes
  int rows, run_bytes, hd, live_div;
  int rpc, cpb;    // rows a CTA, CTAs a TPU block (ops/attention_probes.py::diag_copy_plan)
  const int* pos;  // [slots] or null
};

__device__ __forceinline__ uint32_t sm32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, 16-byte aligned both ends) from global to
// shared memory, completing on the mbarrier's transaction count
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A CTA's bytes of one tensor: nrun runs of rb bytes, rs apart (rows r0..r1
// of its TPU block; one run where the rows are contiguous). A stage holds
// CS_STAGE / rb whole runs, or, for a longer run, one piece of it of `piece`
// bytes (a multiple of hd, so that every stage starts on a row segment).
struct CtaRuns {
  long long rs, rb;
  int nrun, rps, ppr, piece;
  __device__ CtaRuns(const StridedArgs& a, int r0, int r1) {
    const bool contiguous = a.row_stride == a.run_bytes;
    nrun = contiguous ? 1 : r1 - r0;
    rb = contiguous ? (long long)(r1 - r0) * a.run_bytes : a.run_bytes;
    rs = contiguous ? 0 : a.row_stride;
    piece = CS_STAGE / a.hd * a.hd;
    rps = rb <= CS_STAGE ? (int)(CS_STAGE / rb) : 1;
    ppr = rb <= CS_STAGE ? 1 : (int)((rb + piece - 1) / piece);
  }
  __device__ int stages() const { return rb <= CS_STAGE ? (nrun + rps - 1) / rps : nrun * ppr; }
};

// Column sums of a TPU block's rows r0..r1 (block (jb, group, slot) of the
// TPU's grid) over K and V: a producer thread streams them by bulk copies
// into a ring of CS_STAGES stages (K's stages, then V's), CS_CONS consumer
// threads sum each stage's 16-byte units into 16-bit lane sums (the unit's
// column group is its index modulo hd / 16: every stage starts on a row
// segment and holds whole ones), flushed to int32 and added to out.
__global__ void __launch_bounds__(CS_CONS + 32) colsum_strided_kernel(const int8_t* k,
                                                                      const int8_t* v, int* out,
                                                                      StridedArgs a) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t bars[2 * CS_STAGES];
  __shared__ int bytes_of[CS_STAGES];
  __shared__ int col[MAX_HD];
  const int jb = blockIdx.x / a.cpb, slot = blockIdx.z;
  if (a.pos != nullptr && jb > max(a.pos[slot], 0) / a.live_div) return;  // the whole block
  const int r0 = (blockIdx.x - jb * a.cpb) * a.rpc;
  const int r1 = min(a.rows, r0 + a.rpc);
  const CtaRuns cr(a, r0, r1);
  const int n = cr.stages();
  const int tid = threadIdx.x;
  for (int c = tid; c < a.hd; c += blockDim.x) col[c] = 0;
  if (tid == 0) {
    for (int s = 0; s < CS_STAGES; ++s) {
      bar_init(sm32(&bars[s]), 1);                       // full: the producer's arrival
      bar_init(sm32(&bars[CS_STAGES + s]), CS_CONS);     // empty: every consumer's
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const size_t base = (size_t)slot * a.slot_stride + (size_t)blockIdx.y * a.group_stride +
                      (size_t)jb * a.block_stride + (size_t)r0 * a.row_stride;
  const int ncg = a.hd / 16;               // 16-column groups of a row segment
  const int active = (CS_CONS / ncg) * ncg;  // summing threads: unit U has group U % ncg
  int sums[16] = {};
  int loads = 0;
  if (tid >= CS_CONS) {  // the producer warp: one thread issues the copies
    if (tid == CS_CONS) {
      for (int it = 0; it < 2 * n; ++it) {
        const int s = it % CS_STAGES, j = it < n ? it : it - n;
        const int8_t* src = (it < n ? k : v) + base;
        if (it >= CS_STAGES) bar_wait(sm32(&bars[CS_STAGES + s]), ((it / CS_STAGES) - 1) & 1);
        const uint32_t dst = sm32(ring + s * CS_STAGE), full = sm32(&bars[s]);
        if (cr.rb <= CS_STAGE) {  // whole runs
          const int first = j * cr.rps, cnt = min(cr.rps, cr.nrun - first);
          bytes_of[s] = cnt * (int)cr.rb;
          bar_expect_tx(full, cnt * (uint32_t)cr.rb);
          for (int i = 0; i < cnt; ++i)
            bulk_g2s(dst + i * (uint32_t)cr.rb, src + (first + i) * cr.rs, (uint32_t)cr.rb, full);
        } else {                  // one piece of a run
          const int run = j / cr.ppr;
          const long long off = (long long)(j - run * cr.ppr) * cr.piece;
          const int len = (int)min((long long)cr.piece, cr.rb - off);
          bytes_of[s] = len;
          bar_expect_tx(full, len);
          bulk_g2s(dst, src + run * cr.rs + off, len, full);
        }
      }
    }
  } else {
    uint32_t lo[4] = {}, hi[4] = {};
    int since = 0;
    for (int it = 0; it < 2 * n; ++it) {
      const int s = it % CS_STAGES;
      bar_wait(sm32(&bars[s]), (it / CS_STAGES) & 1);
      const int units = bytes_of[s] / 16;
      const uint4* st = reinterpret_cast<const uint4*>(ring + s * CS_STAGE);
      if (tid < active) {
        for (int u = tid; u < units; u += active) {
          add_biased(st[u], lo, hi);
          ++loads;
          if (++since == FLUSH) {
            flush(lo, hi, sums);
            since = 0;
          }
        }
      }
      bar_arrive(sm32(&bars[CS_STAGES + s]));
    }
    flush(lo, hi, sums);
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) sums[e] -= 128 * loads;
  const int lane = tid & 31;
  const bool pow2 = (32 % ncg) == 0;  // lanes l, l + ncg, ... of a warp share columns
  if (pow2 && tid < CS_CONS) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      for (int o = ncg; o < 32; o <<= 1) sums[e] += __shfl_xor_sync(0xffffffffu, sums[e], o);
  }
  if (tid < active && (!pow2 || lane < ncg)) {
    const int cg = tid % ncg;
#pragma unroll
    for (int e = 0; e < 16; ++e) atomicAdd(&col[cg * 16 + e], sums[e]);
  }
  __syncthreads();
  for (int c = tid; c < a.hd; c += blockDim.x) atomicAdd(&out[c], col[c]);
}

}  // namespace

// Column sums [hd] int32 (out, zeroed by the caller) over k and v: TPU
// block (x, y, z) of the grid (blocks_x, groups, slots) sums `rows` runs of
// run_bytes, row_stride apart, from z * slot_stride + y * group_stride +
// x * block_stride; with pos ([slots] int32), blocks x > max(pos[z], 0) /
// live_div read nothing. Each TPU block is cut into cpb CTAs of rpc rows
// (the CUDA grid is (blocks_x * cpb, groups, slots)). hd is a multiple of
// 16 up to 256 and divides run_bytes; k, v and the offsets are multiples
// of 16 bytes. Returns a cudaError_t code.
extern "C" int tpuserve_probe_colsum_strided(const void* k, const void* v, void* out,
                                             const int* pos, long long slot_stride,
                                             long long group_stride, long long block_stride,
                                             long long row_stride, int rows, int run_bytes,
                                             int hd, int live_div, int blocks_x, int groups,
                                             int slots, int rpc, int cpb, void* stream) {
  if (blocks_x <= 0 || groups <= 0 || slots <= 0 || rows <= 0) return 0;
  if (hd <= 0 || hd % 16 || hd > MAX_HD || run_bytes <= 0 || run_bytes % hd ||
      (slot_stride | group_stride | block_stride | row_stride) % 16 ||
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) ||
      (pos != nullptr && live_div <= 0) || rpc <= 0 || cpb <= 0 ||
      (long long)rpc * cpb < rows || (long long)rpc * (cpb - 1) >= rows ||
      (long long)blocks_x * cpb > 0x7fffffff || groups > 65535 || slots > 65535)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(colsum_strided_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CS_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  StridedArgs a;
  a.slot_stride = slot_stride; a.group_stride = group_stride; a.block_stride = block_stride;
  a.row_stride = row_stride; a.rows = rows; a.run_bytes = run_bytes; a.hd = hd;
  a.live_div = live_div; a.rpc = rpc; a.cpb = cpb; a.pos = pos;
  colsum_strided_kernel<<<dim3(blocks_x * cpb, groups, slots), CS_CONS + 32, CS_SMEM,
                          (cudaStream_t)stream>>>(static_cast<const int8_t*>(k),
                                                  static_cast<const int8_t*>(v), (int*)out, a);
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
// [S, M, 128] f32 (zeroed by the caller): grid (ceil(R / 64 /
// tiles_per_block), S, ceil(M / 32)); R is a multiple of 64. Returns a
// cudaError_t code.
extern "C" int tpuserve_probe_dot_only(const void* qi, const void* k, const void* v, void* out,
                                       int S, int M, int R, int tiles_per_block, void* stream) {
  if (S <= 0 || M <= 0) return 0;
  if (R <= 0 || R % DT || tiles_per_block <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(qi) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(dot_only_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int blocks_x = (R / DT + tiles_per_block - 1) / tiles_per_block;
  dot_only_kernel<<<dim3(blocks_x, S, (M + DQ - 1) / DQ), D_THREADS, D_SMEM,
                    (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(qi), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), (float*)out, M, R, tiles_per_block);
  return (int)cudaGetLastError();
}
