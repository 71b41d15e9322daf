// The grouped decode attention's kernel template and its launches, a
// template over the head_dim HD (128 or 256): the design notes and the C
// entry are in decode_attention_grouped_hopper.cu, which builds head_dim
// 128's instances; decode_attention_grouped_hopper_hd256.cu builds 256's
// (two translation units, so that nvcc builds them at once).
#pragma once

#include "attention_common.cuh"
#include "attention_hopper.cuh"

namespace tpuserve {
namespace grouped {

using namespace tpuserve::attn;
using namespace tpuserve::hopper;
using tpuserve::warp_sum;

// Ring depth and blocks an SM (the register cap with them) at head_dim 128
template <int NT> struct GRing {
  static constexpr int STAGES = 3;
  static constexpr int BLOCKS = NT == 1 ? 4 : 3;
};
// At head_dim 256 a block holds twice the accumulators (the register cap of
// 2 blocks an SM, 1 for a float window) and an f32 stage is 67.6 KB (2
// stages)
template <int KIND, int NT, int HD> struct GRingHd {
  static constexpr bool WIDE = HD > 128, FLOAT = KIND == KV_BF16 || KIND == KV_F32;
  static constexpr int STAGES = WIDE && KIND == KV_F32 ? 2 : GRing<NT>::STAGES;
  static constexpr int BLOCKS = WIDE ? (FLOAT ? 1 : 2) : GRing<NT>::BLOCKS;
};
constexpr int G_RG = 32;   // query rows of one block (a row group)

struct GArgs {
  const void* q;
  const unsigned char* k;   // window base: (slot, row, unit) at slot * slot_stride + row * row_stride + unit * HD
  const unsigned char* v;
  const void* ks;           // scales: (slot, head, row) at slot * ss_slot + head * ss_head + row
  const void* vs;
  const int* pos;           // [S], -1 = inactive
  float* out;
  float* ws;                // splits > 1: partials
  int* counters;            // splits > 1: one zeroed int per (slot, unit)
  long long slot_stride, ss_slot, ss_head;
  int q_bf16, sc_bf16;
  int S, H, Hkv, win, bl, row_stride, nq, splits, bps, rgroups;
};

__host__ __device__ inline int pad_tiles(int bl) { return (bl + TR - 1) / TR * TR; }

// Bytes of the staged q of a padded row: int8 codes; a bf16 cache's q in
// three bf16 pieces (hi, mid, lo; one for a bf16 q), [3][RP] rows; f32 q
__host__ __device__ constexpr int gq_row_b(int kind, int hd) {
  return kind == KV_F32 ? row_f32(hd) : kind == KV_BF16 ? 3 * row_bf16(hd) : row_b(hd);
}

// Dynamic shared memory (ops/decode_attention.py::grouped_smem_bytes
// mirrors it): the ring, q [RP][gq_row_b], scores f32 [nr][blp + 4] and P
// bf16 [nr][blp + 8] of a group's nr query rows only (nr = min(nq, 32); the
// mma's padding rows of P are read from row nr - 1: they only fill output
// columns that are dropped; an f32 cache keeps P in the score rows), the
// block's V scales [2][blp] f32, six per-row statistics [RP], two
// [WARPS][RP] partials.
__host__ __device__ inline size_t grouped_smem(int kind, int hd, int stages, int rp, int nr,
                                               int bl) {
  const size_t blp = pad_tiles(bl);
  return (size_t)stages * stage_b(kind, hd) + (size_t)rp * gq_row_b(kind, hd) +
         nr * (blp + 4) * 4 + (kind == KV_F32 ? 0 : nr * (blp + 8) * 2) + 2 * blp * 4 +
         6 * (size_t)rp * 4 + 2 * WARPS * (size_t)rp * 4;
}

template <int KIND, int NT, bool READ_ALL, int HD>
__global__ void __launch_bounds__(THREADS, (GRingHd<KIND, NT, HD>::BLOCKS))
    attn_grouped_kernel(GArgs a) {
  constexpr int STAGES = GRingHd<KIND, NT, HD>::STAGES;
  constexpr int RP = NT * 8;                 // query rows of a group, padded to the mma's N
  constexpr int QR = RP / WARPS;             // q rows a warp quantizes
  constexpr bool INT4 = (KIND == KV_INT4);
  constexpr bool FLOAT = KIND == KV_BF16 || KIND == KV_F32;
  constexpr int SB = stage_b(KIND, HD), RB = tile_row_b(KIND, HD);
  constexpr int QS_B = row_b(HD), ROW_BF16 = row_bf16(HD), ROW_F32 = row_f32(HD);
  constexpr int VPL = HD / 32;               // values of a query row a lane loads
  constexpr int MC = HD / 64;                // m16 chunks of a warp's HD / 4 output columns
  constexpr int PIECES = RB / 16 - 1;        // 16-byte pieces of a kv unit's row: 8 .. 64
  constexpr int PSH = PIECES == 64 ? 6 : PIECES == 32 ? 5 : PIECES == 16 ? 4 : 3;
  // Row groups: only the 32-row instances take them (more than 16 rows a
  // unit); the others serve all nq rows of a unit in one block, and their
  // work-item arithmetic folds to that of one group
  constexpr bool RGS = NT == 4;
  extern __shared__ __align__(128) unsigned char sm[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  // hd of accumulator element e within an m16 chunk
  auto dcol = [&](int e) { return FLOAT ? g + 8 * (e >> 1) : 2 * g + (e >> 1); };
  const int units = INT4 ? a.Hkv / 2 : a.Hkv;
  const int nq = a.nq, half = nq / 2;
  const int nrs = RGS ? min(nq, G_RG) : nq;   // rows of a full group: the layout of the score and P rows
  const int bl = a.bl, blp = pad_tiles(bl), ntl = blp / TR;
  const bool scaled = !FLOAT || a.ks != nullptr;

  unsigned char* ring = sm;
  int8_t* qc = reinterpret_cast<int8_t*>(ring + STAGES * SB);   // q codes, or values (float)
  float* sc = reinterpret_cast<float*>(qc + RP * gq_row_b(KIND, HD));
  const int scs = blp + 4;
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(sc + (size_t)nrs * scs);
  const int pbs = blp + 8;
  float* vsb = reinterpret_cast<float*>(pb + (KIND == KV_F32 ? 0 : (size_t)nrs * pbs));
  float* st_qs = vsb + 2 * blp;
  int* st_qsum = reinterpret_cast<int*>(st_qs + RP);
  float* st_m = reinterpret_cast<float*>(st_qsum + RP);
  float* st_l = st_m + RP;
  float* st_corr = st_l + RP;
  int* st_hi = reinterpret_cast<int*>(st_corr + RP);   // int4: row rr reads high nibbles
  float* pmx = reinterpret_cast<float*>(st_hi + RP);   // [WARPS][RP] row maxima of a warp's rows
  float* part_sum = pmx + WARPS * RP;                  // [WARPS][RP] sums of a quarter row
  __shared__ int s_last;

  // the work item: unit u, slot, split z (blocks jb0 .. jb0 + n_run - 1),
  // row group rg (the unit's query rows rg0 .. rg0 + nr - 1)
  const int u = blockIdx.x % units;
  const int slot = (blockIdx.x / units) % a.S;
  const int z = RGS ? (blockIdx.x / units / a.S) % a.splits : blockIdx.x / units / a.S;
  const int rg = RGS ? blockIdx.x / units / a.S / a.splits : 0;
  const int rg0 = rg * G_RG, nr = RGS ? min(G_RG, nq - rg0) : nq;
  const int hu = INT4 ? u + a.Hkv / 2 : u;
  const int pos = a.pos[slot];
  const int jb0 = z * a.bps;
  int jb1 = min(a.win / bl, jb0 + a.bps);
  if (!READ_ALL) jb1 = min(jb1, pos < 0 ? jb0 : pos / bl + 1);
  const int n_run = max(0, jb1 - jb0);
  auto nread_of = [&](int jb) { return READ_ALL ? bl : min(bl, pos - jb * bl + 1); };
  // K (and V) tiles of block jb: all of them, or without READ_ALL those
  // holding a row up to pos (a tile past it is read by neither)
  auto ntl_of = [&](int jb) { return READ_ALL ? ntl : (nread_of(jb) + TR - 1) / TR; };
  // the item's tiles: only the run's last block can be cut short
  const int n_tiles = n_run > 0 ? 2 * (ntl * (n_run - 1) + ntl_of(jb0 + n_run - 1)) : 0;

  // bf16 scales are staged in 4-byte words: the word-aligned base of array
  // arr's tensor and the elements it lies before that tensor's start
  auto bf16_base = [&](int arr, int& sh) -> const unsigned char* {
    const unsigned char* p = static_cast<const unsigned char*>(arr >= 2 ? a.vs : a.ks);
    sh = (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 1);
    return p - 2 * sh;
  };
  // scale element of (kv head h, row jb * bl + sub * TR)
  auto scale_elem0 = [&](int jb, int h, int sub) -> size_t {
    return (size_t)slot * a.ss_slot + (size_t)h * a.ss_head + (size_t)jb * bl + sub * TR;
  };

  // ---- the next tile of the item into stage p_tt % STAGES: block p_b of
  // the run, its K tiles (p_rem < ntl_of), then its V tiles. Tiles are
  // issued in order, so the position advances by counters (no division in
  // the loop).
  int p_tt = 0, p_b = 0, p_rem = 0;
  auto issue = [&]() {
    if (p_tt < n_tiles) {
      const int jb = jb0 + p_b, nt = ntl_of(jb);
      const bool is_v = p_rem >= nt;
      const int sub = is_v ? p_rem - nt : p_rem;
      const int live = nread_of(jb) - sub * TR;   // rows of the tile to read
      unsigned char* st = ring + (p_tt % STAGES) * SB;
      const unsigned char* src = is_v ? a.v : a.k;
      const size_t base = (size_t)slot * a.slot_stride +
                          ((size_t)jb * bl + sub * TR) * (size_t)a.row_stride +
                          (size_t)u * (RB - 16);
#pragma unroll
      for (int e = 0; e < TR * PIECES / THREADS; ++e) {
        const int c = tid + e * THREADS, row = c >> PSH, piece = c & (PIECES - 1);
        const bool ok = row < live;
        cp_async16(st + row * RB + piece * 16,
                   ok ? src + base + (size_t)row * a.row_stride + piece * 16 : src, ok ? 16 : 0);
      }
      if (!is_v && scaled) {  // the tile's K and V scales of the lo and hi kv heads
        const int n = max(0, min(live, TR));
        uint32_t* dst = reinterpret_cast<uint32_t*>(st + TR * RB);
        const int arrays = INT4 ? 4 : 2;  // ks lo, (ks hi,) vs lo, (vs hi)
        if (a.sc_bf16) {
          for (int w = tid; w < arrays * 33; w += THREADS) {
            const int arr = INT4 ? w / 33 : 2 * (w / 33), wi = w % 33;
            int sh;
            const unsigned char* sp = bf16_base(arr, sh);
            const size_t e0 = scale_elem0(jb, (arr & 1) ? hu : u, sub) + sh;
            const size_t gw = (e0 >> 1) + wi, end = e0 + n;
            const int bytes = 2 * gw + 1 < end ? 4 : (2 * gw < end ? 2 : 0);
            cp_async4(dst + arr * SC_W + wi, bytes ? sp + gw * 4 : sp, bytes);
          }
        } else {
          for (int w = tid; w < arrays * TR; w += THREADS) {
            const int arr = INT4 ? w / TR : 2 * (w / TR), i = w % TR;
            const float* sp = static_cast<const float*>(arr >= 2 ? a.vs : a.ks);
            const bool ok = i < n;
            cp_async4(dst + arr * SC_W + i,
                      ok ? sp + scale_elem0(jb, (arr & 1) ? hu : u, sub) + i : sp, ok ? 4 : 0);
          }
        }
      }
      if (++p_rem == 2 * nt) {
        p_rem = 0;
        ++p_b;
      }
    }
    ++p_tt;
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) issue();
  // P past a block's rows stays zero: it is never written (f32: P is kept in
  // the score rows, whose columns past block_l are never written)
  if constexpr (KIND == KV_F32) {
    for (int i = tid; i < nr * scs; i += THREADS) sc[i] = 0.f;
  } else {
    for (int i = tid; i < nr * pbs / 2; i += THREADS) reinterpret_cast<uint32_t*>(pb)[i] = 0u;
  }

  // row rr of the group is the unit's query row j = rg0 + rr
  auto io_index = [&](int rr) -> size_t {
    const int j = rg0 + rr;
    const int qh = INT4 ? (j < half ? u * half + j : hu * half + (j - half)) : u * nq + j;
    return ((size_t)slot * a.H + qh) * HD;
  };

  // ---- q codes (float caches: q's values; a bf16 cache's as bf16 pieces)
  // and statistics of the unit's rows, a warp's rows warp, warp + WARPS,
  // ... (the unit's first tiles are in flight meanwhile); padding rows 0
#pragma unroll
  for (int x = 0; x < QR; ++x) {
    const int rr = warp + x * WARPS;
    float scale = 0.f;
    int csum = 0;
    if constexpr (KIND == KV_F32) {
      float qv[VPL] = {};
      if (rr < nr) load_qv<VPL>(a.q, io_index(rr) + lane * VPL, a.q_bf16, qv);
#pragma unroll
      for (int c = 0; c < VPL / 4; ++c)
        reinterpret_cast<float4*>(qc + rr * ROW_F32)[lane * (VPL / 4) + c] =
            make_float4(qv[4 * c], qv[4 * c + 1], qv[4 * c + 2], qv[4 * c + 3]);
    } else if constexpr (KIND == KV_BF16) {
      float qv[VPL] = {};
      if (rr < nr) load_qv<VPL>(a.q, io_index(rr) + lane * VPL, a.q_bf16, qv);
      // q = hi + mid + lo, each a bf16 and each residual exact in f32, so
      // the three pieces' products with the bf16 cache sum to the f32 dot
      // (a bf16 q is its hi piece alone)
      float pc[3][VPL];
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        pc[0][c] = round_bf16(qv[c]);
        pc[1][c] = round_bf16(qv[c] - pc[0][c]);
        pc[2][c] = round_bf16((qv[c] - pc[0][c]) - pc[1][c]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < VPL / 4; ++c)
          reinterpret_cast<uint2*>(qc + (k * RP + rr) * ROW_BF16)[lane * (VPL / 4) + c] =
              make_uint2(pack_bf16(pc[k][4 * c], pc[k][4 * c + 1]),
                         pack_bf16(pc[k][4 * c + 2], pc[k][4 * c + 3]));
    } else {
      uint32_t word[VPL / 4] = {};
      if (rr < nr) {
        float qv[VPL];
        load_qv<VPL>(a.q, io_index(rr) + lane * VPL, a.q_bf16, qv);
        int8_t code[VPL];
        scale = quantize_qv<VPL>(qv, code);
#pragma unroll
        for (int c = 0; c < VPL; ++c) {
          word[c / 4] |= (uint32_t)(uint8_t)code[c] << (8 * (c % 4));
          csum += code[c];
        }
        csum = warp_sum(csum);
      }
#pragma unroll
      for (int c = 0; c < VPL / 4; ++c)
        reinterpret_cast<uint32_t*>(qc + rr * QS_B)[lane * (VPL / 4) + c] = word[c];
    }
    if (lane == 0) {
      st_qs[rr] = scale;
      st_qsum[rr] = csum;
      st_m[rr] = NEG_INF;
      st_l[rr] = 0.f;
      st_hi[rr] = INT4 && rg0 + rr >= half;
    }
  }
  __syncthreads();

  uint32_t qb[NT][HD / 32][2];  // the scores' B fragments: q codes of n-tile n, k-step kk
  if constexpr (!FLOAT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        const int8_t* p = qc + (n * 8 + g) * QS_B + 32 * kk + 4 * t;
        qb[n][kk][0] = *reinterpret_cast<const uint32_t*>(p);
        qb[n][kk][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
  }
  // f32 output [chunk m][n tile][c frag]: hd HD/4*warp + 16*m + 2*g (+1
  // for c2, c3; float caches: g, +8), query rows n*8 + 2*t (+1 for c1, c3)
  float facc[MC][NT][4];
  float pacc[MC][NT][4];    // a block's P @ V (int4: the lo members)
  float pacc_hi[MC][NT][4]; // int4: the hi members
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[m][n][e] = 0.f;

  int b = 0, rem = 0;   // this tile: block b of the run, tile rem of the block
  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue();

    unsigned char* st = ring + (tt % STAGES) * SB;
    const int jb = jb0 + b, nt = ntl_of(jb);
    const int sub = rem < nt ? rem : rem - nt;
    const int nread = nread_of(jb);
    if (rem < nt) {
      // ---- scores of the tile's rows 16*warp .. +15 against the unit's query rows
      int sacc[NT][4] = {}, sacc_hi[NT][4] = {};
      float fsc[NT][4] = {};   // float caches
      if constexpr (KIND == KV_BF16) {
        scores_bf16<NT, HD>(fsc, st, warp * 16, reinterpret_cast<const unsigned char*>(qc),
                            a.q_bf16 ? 1 : 3, RP * ROW_BF16, lane);
      } else if constexpr (KIND == KV_F32) {
        scores_f32<NT, HD>(fsc, st, warp * 16, reinterpret_cast<const float*>(qc), lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, st + (warp * 16 + (lane & 7) + (mat & 1) * 8) * RB + 32 * kk +
                          (mat >> 1) * 16);
          if (INT4) {
            uint32_t lo[4], hi[4];
            nibbles<false>(af, lo, hi);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              mma_s8(sacc[n], lo, qb[n][kk][0], qb[n][kk][1]);
              mma_s8(sacc_hi[n], hi, qb[n][kk][0], qb[n][kk][1]);
            }
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(sacc[n], af, qb[n][kk][0], qb[n][kk][1]);
          }
        }
      }
      // the tile's staged scales (bf16: the halfword offset of each array)
      const uint32_t* scw = reinterpret_cast<const uint32_t*>(st + TR * RB);
      int off[4] = {0, 0, 0, 0};
      if (scaled && a.sc_bf16) {
#pragma unroll
        for (int arr = 0; arr < 4; ++arr) {
          if (!INT4 && (arr & 1)) continue;
          int sh;
          bf16_base(arr, sh);
          off[arr] = (int)((scale_elem0(jb, (arr & 1) ? hu : u, sub) + sh) & 1);
        }
      }
      auto scale_at = [&](int arr, int i) -> float {
        if (!a.sc_bf16) return __uint_as_float(scw[arr * SC_W + i]);
        return __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(scw + arr * SC_W)[off[arr] + i]);
      };
      float cmax[NT][2];  // the largest score of a query row in this thread's rows
#pragma unroll
      for (int n = 0; n < NT; ++n) cmax[n][0] = cmax[n][1] = NEG_INF;
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int il = warp * 16 + g + 8 * hrow;   // row of the tile
        const int ib = sub * TR + il;              // row of the block
        if (ib >= bl) continue;
        float ks_lo = 1.f, ks_hi = 1.f;
        if (scaled) {
          ks_lo = scale_at(0, il);
          ks_hi = INT4 ? scale_at(1, il) : ks_lo;
          if (t == 0) {
            vsb[ib] = scale_at(2, il);
            if (INT4) vsb[blp + ib] = scale_at(3, il);
          }
        }
        const bool ok = ib < nread && jb * bl + ib <= pos;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rr = n * 8 + 2 * t + e;
            if (rr >= nr) continue;
            float v;
            if constexpr (FLOAT) {   // the f32 dot, times k_scale if given
              v = ok ? (scaled ? fsc[n][2 * hrow + e] * ks_lo : fsc[n][2 * hrow + e]) : NEG_INF;
            } else {
              const bool hi = INT4 && st_hi[rr];
              int d = hi ? sacc_hi[n][2 * hrow + e] : sacc[n][2 * hrow + e];
              if (INT4) d -= 8 * st_qsum[rr];
              // the TPU kernel's order: (dot * k_scale) * q_scale
              v = ok ? ((float)d * (hi ? ks_hi : ks_lo)) * st_qs[rr] : NEG_INF;
            }
            sc[rr * scs + ib] = v;
            cmax[n][e] = fmaxf(cmax[n][e], v);
          }
      }
      // the warp's 16 rows: a partial max a query row, kept over the block's K tiles
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cmax[n][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
          const int rr = n * 8 + 2 * t + e;
          if (g == 0 && rr < nr)
            pmx[warp * RP + rr] = sub == 0 ? v : fmaxf(pmx[warp * RP + rr], v);
        }
      if (sub == nt - 1) {
        // ---- the block's softmax statistics and P = bf16(p * v_scale).
        // Fewer rows than warps: warp w takes quarter w of every row, the
        // quarters' sums combined through shared memory; else a warp a row.
        __syncthreads();
        auto row_max = [&](int rr) {
          return fmaxf(fmaxf(pmx[rr], pmx[RP + rr]), fmaxf(pmx[2 * RP + rr], pmx[3 * RP + rr]));
        };
        const bool by_row = nr >= WARPS;
        const int ql = (bl + WARPS - 1) / WARPS;
        const int i0 = by_row ? 0 : warp * ql, i1 = by_row ? bl : min(bl, i0 + ql);
        for (int rr = by_row ? warp : 0; rr < nr; rr += by_row ? WARPS : 1) {
          float* row = sc + rr * scs;
          const float* vrow = vsb + (st_hi[rr] ? blp : 0);
          __nv_bfloat16* prow = pb + rr * pbs;
          const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
          float psum = 0.f;
          for (int i = i0 + lane; i < i1; i += 32) {
            // 0 for the masked rows; the rows past nread have no score
            const float p = i < nread ? expf(row[i] - ss.m_safe) : 0.f;
            psum += p;
            const float pv = i < nread ? (scaled ? p * vrow[i] : p) : 0.f;
            if constexpr (KIND == KV_F32) row[i] = pv;   // f32: P in the score row, unrounded
            else prow[i] = __float2bfloat16_rn(pv);
          }
          psum = warp_sum(psum);
          if (lane == 0) {
            if (by_row) {
              st_l[rr] = st_l[rr] * ss.corr + psum;
              st_m[rr] = ss.m_new;
              st_corr[rr] = ss.corr;
            } else {
              part_sum[warp * RP + rr] = psum;
            }
          }
        }
        if (!by_row) {
          __syncthreads();
          if (tid < nr) {
            const int rr = tid;
            const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
            const float psum = ((part_sum[rr] + part_sum[RP + rr]) + part_sum[2 * RP + rr]) +
                               part_sum[3 * RP + rr];
            st_l[rr] = st_l[rr] * ss.corr + psum;
            st_m[rr] = ss.m_new;
            st_corr[rr] = ss.corr;
          }
        }
      }
    } else {
      // ---- V tile: P @ V on bf16 tensor cores, hd on M, query rows on
      // N, the tile's rows on K. ldmatrix.trans of the int8 tile as b16
      // hands a thread bytes (2t, 2g), (2t, 2g+1), (2t+1, 2g), (2t+1,
      // 2g+1) of an 8-row, 16-byte block: its even columns fill rows g,
      // its odd ones rows g + 8 of an m16 fragment (hd 16c + 2g + {0, 1}
      // of the warp's 32), converted to bf16 exactly; the stage is read
      // in place.
      if (sub == 0) {
#pragma unroll
        for (int c = 0; c < MC; ++c)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pacc[c][n][e] = pacc_hi[c][n][e] = 0.f;
      }
      // float caches: V read in place, bf16 by ldmatrix.trans into the same
      // mma (hd 16c + g, + 8 of the warp's HD / 4), f32 by FMA
      if constexpr (KIND == KV_BF16)
        pv_bf16<NT, HD>(pacc, st, pb, pbs, sub * TR, nr - 1, warp, lane);
      if constexpr (KIND == KV_F32)
        pv_f32<NT, HD>(pacc, st, sc, scs, sub * TR, nr - 1, warp, lane);
      if constexpr (!FLOAT) {
#pragma unroll
        for (int ks = 0; ks < TR / 16; ++ks) {
          uint32_t pl[NT], ph[NT];  // P of query row n*8 + g, cache rows 2t, 2t+1 and 8 + ..
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const __nv_bfloat16* pr = pb + min(n * 8 + g, nr - 1) * pbs + sub * TR + 16 * ks + 2 * t;
            pl[n] = *reinterpret_cast<const uint32_t*>(pr);
            ph[n] = *reinterpret_cast<const uint32_t*>(pr + 8);
          }
          // rows 16ks + 0..7 and 8..15 of chunk 0, then of chunk 1, of each
          // 32 columns j of the warp's HD / 4
          uint32_t vr[2 * MC];
#pragma unroll
          for (int j = 0; j < MC / 2; ++j)
            ldsm_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(vr + 4 * j),
                          st + (16 * ks + (lane & 7) + (mat & 1) * 8) * RB +
                              (HD / 4) * warp + 32 * j + (mat >> 1) * 16);
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            const uint32_t r0 = vr[2 * c], r1 = vr[2 * c + 1];
            if (INT4) {
              const uint32_t l0 = r0 & 0x0F0F0F0Fu, l1 = r1 & 0x0F0F0F0Fu;
              const uint32_t h0 = (r0 >> 4) & 0x0F0F0F0Fu, h1 = (r1 >> 4) & 0x0F0F0F0Fu;
              const uint32_t la0 = u4_to_bf16x2<0, 2>(l0), la1 = u4_to_bf16x2<1, 3>(l0);
              const uint32_t la2 = u4_to_bf16x2<0, 2>(l1), la3 = u4_to_bf16x2<1, 3>(l1);
              const uint32_t ha0 = u4_to_bf16x2<0, 2>(h0), ha1 = u4_to_bf16x2<1, 3>(h0);
              const uint32_t ha2 = u4_to_bf16x2<0, 2>(h1), ha3 = u4_to_bf16x2<1, 3>(h1);
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                mma_bf16(pacc[c][n], la0, la1, la2, la3, pl[n], ph[n]);
                mma_bf16(pacc_hi[c][n], ha0, ha1, ha2, ha3, pl[n], ph[n]);
              }
            } else {
              const uint32_t a0 = s8_to_bf16x2<0, 2>(r0), a1 = s8_to_bf16x2<1, 3>(r0);
              const uint32_t a2 = s8_to_bf16x2<0, 2>(r1), a3 = s8_to_bf16x2<1, 3>(r1);
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_bf16(pacc[c][n], a0, a1, a2, a3, pl[n], ph[n]);
            }
          }
        }
      }
      if (sub == nt - 1) {  // the block's P @ V into the f32 accumulators
#pragma unroll
        for (int m = 0; m < MC; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = n * 8 + 2 * t + (e & 1);
              if (rr >= nr) continue;
              const float part = (INT4 && st_hi[rr]) ? pacc_hi[m][n][e] : pacc[m][n][e];
              facc[m][n][e] = facc[m][n][e] * st_corr[rr] + part;
            }
      }
    }
    if (++rem == 2 * nt) {
      rem = 0;
      ++b;
    }
  }

  // ---- the item's output, or this split's partial and the merge by the last split
  if (a.splits == 1) {
#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = n * 8 + 2 * t + (e & 1);
          if (rr >= nr) continue;
          const int d = warp * (HD / 4) + m * 16 + dcol(e);
          const float l = st_l[rr];
          a.out[io_index(rr) + d] = (l > 0.f) ? facc[m][n][e] / fmaxf(l, 1e-20f) : 0.f;
        }
    return;
  }
  const size_t part = (size_t)RP * (HD + 2);
  const size_t cidx = RGS ? ((size_t)slot * units + u) * a.rgroups + rg : (size_t)slot * units + u;
  float* ws0 = a.ws + cidx * a.splits * part;
  float* wp = ws0 + (size_t)z * part;
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = n * 8 + 2 * t + (e & 1);
        if (rr < nr) wp[rr * HD + warp * (HD / 4) + m * 16 + dcol(e)] = facc[m][n][e];
      }
  if (tid < nr) {
    wp[RP * HD + tid] = st_m[tid];
    wp[RP * HD + RP + tid] = st_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + cidx, 1) == a.splits - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int x = tid; x < nr * HD; x += THREADS) {
      const int rr = x / HD, d = x % HD;
      float mrun = NEG_INF, lrun = 0.f, arun = 0.f;
      for (int zz = 0; zz < a.splits; ++zz) {
        const float* sp = ws0 + (size_t)zz * part;
        const float ms = __ldcg(sp + RP * HD + rr);
        const SoftmaxStep ss = softmax_step(mrun, ms);
        const float cs = expf(ms - ss.m_safe);
        lrun = lrun * ss.corr + __ldcg(sp + RP * HD + RP + rr) * cs;
        arun = arun * ss.corr + __ldcg(sp + rr * HD + d) * cs;
        mrun = ss.m_new;
      }
      a.out[io_index(rr) + d] = (lrun > 0.f) ? arun / fmaxf(lrun, 1e-20f) : 0.f;
    }
    if (tid == 0) a.counters[cidx] = 0;
  }
}

template <int KIND, int NT, bool READ_ALL, int HD>
int launch(const GArgs& a, cudaStream_t st) {
  static size_t opted_in = 0;
  auto kern = attn_grouped_kernel<KIND, NT, READ_ALL, HD>;
  const size_t smem = grouped_smem(KIND, HD, GRingHd<KIND, NT, HD>::STAGES, NT * 8,
                                   a.nq < G_RG ? a.nq : G_RG, a.bl);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int units = (KIND == KV_INT4) ? a.Hkv / 2 : a.Hkv;
  const long long items = (long long)units * a.S * a.splits * a.rgroups;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)items, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool READ_ALL, int HD>
int launch_nt(const GArgs& a, cudaStream_t st) {
  return a.nq <= 8    ? launch<KIND, 1, READ_ALL, HD>(a, st)
         : a.nq <= 16 ? launch<KIND, 2, READ_ALL, HD>(a, st)
                      : launch<KIND, 4, READ_ALL, HD>(a, st);
}

template <int KIND, int HD>
int launch_ra(const GArgs& a, bool read_all, cudaStream_t st) {
  return read_all ? launch_nt<KIND, true, HD>(a, st) : launch_nt<KIND, false, HD>(a, st);
}

template <int HD>
int launch_kind(const GArgs& a, int kind, bool read_all, cudaStream_t st) {
  switch (kind) {
    case KV_INT4: return launch_ra<KV_INT4, HD>(a, read_all, st);
    case KV_BF16: return launch_ra<KV_BF16, HD>(a, read_all, st);
    case KV_F32: return launch_ra<KV_F32, HD>(a, read_all, st);
    default: return launch_ra<KV_INT8, HD>(a, read_all, st);
  }
}

}  // namespace grouped
}  // namespace tpuserve
