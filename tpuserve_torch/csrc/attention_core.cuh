// The Hopper decode-attention core's kernel template and its launches, a
// template over the head_dim HD (128 or 256). decode_attention_hopper.cu
// holds the C entry and the design notes; the instances are built across
// it and four more translation units (_paged, _paged_hd256, _hd256,
// _hd256_all), so that nvcc builds them at once.
#pragma once

#include "attention_common.cuh"
#include "attention_hopper.cuh"

namespace tpuserve {
namespace core {

using namespace tpuserve::attn;
using namespace tpuserve::hopper;
using tpuserve::warp_max;
using tpuserve::warp_sum;

// Ring depth and blocks an SM: 3 stages and 5 blocks for the int8 cache
// with up to 8 query rows (the flat and paged decode step: one kv head a
// block, one row), 4 and 4 for the other int8 and int4 cases. On the card
// (scripts/ab_attention.py against a copy with the other depth) the shallow
// ring was faster for those and slower for packed int4 at the decode step's
// positions and for the multi-candidate rows. The float caches' stages
// are 1.8x (bf16) and 3.4x (f32) the int8 one: 4 and 3 stages, 2 blocks an
// SM (the verify's 256 blocks all resident on 132 SMs), but 2 stages and
// 4 blocks for bf16 with up to 8 rows (the flat and paged decode step's
// short one-row blocks: more of them resident hide each one's first tile;
// 1.31x faster than 4 and 2 at the 7B step, 1.24x than 3 and 3).
// At head_dim 256 (WIDE) a row is twice as long: an f32 ring takes 2
// stages (3 of 67.6 KB leave no room for 32 query rows), and a block may
// hold twice the accumulators (hd 64 * warp .. + 63 a warp), so the register
// cap is that of 2 blocks an SM (1 for a float cache, whose ring fills an SM).
template <int KIND, int NT, int HD> struct Ring {
  static constexpr bool FLOAT = KIND == KV_BF16 || KIND == KV_F32;
  static constexpr bool WIDE = HD > 128;
  static constexpr bool SHALLOW = (KIND == KV_INT8 && NT == 1) || KIND == KV_F32;
  static constexpr bool BF16_ROW = KIND == KV_BF16 && NT == 1;
  static constexpr int STAGES = (WIDE && KIND == KV_F32) || BF16_ROW ? 2 : SHALLOW ? 3 : 4;
  static constexpr int BLOCKS = WIDE ? (FLOAT ? 1 : 2) : BF16_ROW ? 4 : FLOAT ? 2 : SHALLOW ? 5 : 4;
};
constexpr int VT_B = 80;          // transposed V row stride: TR bytes + 16
constexpr int MAX_RG = 32;        // query rows of one block (a row group)

// A ring stage of the core: an int8 or int4 V tile is transposed within its
// stage to HD rows of VT_B bytes, which at head_dim 256 (20,480 bytes) is
// more than the tile and its scales (18,496): the stage is padded to it
__host__ __device__ constexpr int core_stage_b(int kind, int hd) {
  return (kind == KV_BF16 || kind == KV_F32 || stage_b(kind, hd) >= hd * VT_B) ? stage_b(kind, hd)
                                                                              : hd * VT_B;
}
static_assert(core_stage_b(KV_INT8, 128) == stage_b(KV_INT8, 128), "head_dim 128 is unpadded");

struct Args {
  const void* q;
  const unsigned char* k;   // cache or pool base (all layers)
  const unsigned char* v;
  const void* ks;           // scales: this layer's [S, Hkv, L], or pools
  const void* vs;
  const int* pos;           // [S], candidate 0's position, -1 = inactive
  const int* table;         // PAGED: [S, *] page ids, row stride tstride
  float* out;
  float* ws;                // splits > 1: partials
  int* counters;            // splits > 1: one zeroed int per (slot, unit, row group)
  int q_bf16, sc_bf16;
  int S, C, H, Hkv, L, layer, win, bl, row_stride, n_pages, hp, tstride;
  int nq, splits, bps, rgroups;
};

__host__ __device__ inline int pad_tiles(int bl) { return (bl + TR - 1) / TR * TR; }

// Bytes of a staged q row: int8 codes, or the q values rounded to a float
// cache's type (the cache's row stride)
__host__ __device__ constexpr int q_row_b(int kind, int hd) { return tile_row_b(kind, hd); }
// Bytes of a P row: int8 codes, bf16 values, or none (f32 P stays in the
// score rows)
__host__ __device__ inline int p_row_b(int kind, int blp) {
  return kind == KV_F32 ? 0 : kind == KV_BF16 ? 2 * (blp + 8) : blp + 16;
}

// Dynamic shared memory (ops/decode_attention.py::core_smem_bytes mirrors
// it): the ring, q rows [RP][q_row_b], scores and then
// P [RP][blp + 4] f32, P rows [RP][p_row_b], the block's V scales [2][blp]
// f32, eight per-row statistics and flags [RP], four [WARPS][RP] partials,
// the page ids of a split (paged: bps).
__host__ __device__ inline size_t smem_bytes(int kind, int hd, int stages, int rp, int bl,
                                             int pages) {
  const size_t blp = pad_tiles(bl);
  return (size_t)stages * core_stage_b(kind, hd) + (size_t)rp * q_row_b(kind, hd) +
         rp * (blp + 4) * 4 +
         (size_t)rp * p_row_b(kind, (int)blp) + 2 * blp * 4 + 24 * (size_t)rp * 4 +
         (size_t)pages * 4;
}

// One work item of the grid: kv unit u of slot `slot`, row group rg (query
// rows r0 .. r0 + nr - 1), split z (blocks jb0 .. jb0 + n_run - 1 of the
// window, those a row of the group can see unless READ_ALL).
struct Seg {
  int u, slot, rg, z, r0, nr, pos, last, jb0, n_run;
};

template <bool READ_ALL>
__device__ __forceinline__ Seg seg_of(const Args& a, int seg, int units) {
  Seg s;
  s.u = seg % units;
  int rest = seg / units;
  s.slot = rest % a.S;
  rest /= a.S;
  s.rg = rest % a.rgroups;
  s.z = rest / a.rgroups;
  s.r0 = s.rg * MAX_RG;
  s.nr = min(MAX_RG, a.C * a.nq - s.r0);
  s.pos = a.pos[s.slot];
  s.last = s.pos + (s.r0 + s.nr - 1) / a.nq;  // the last cache row any row of the group sees
  s.jb0 = s.z * a.bps;
  int jb1 = min(a.win / a.bl, s.jb0 + a.bps);
  if (!READ_ALL) jb1 = min(jb1, s.last < 0 ? s.jb0 : s.last / a.bl + 1);
  s.n_run = max(0, jb1 - s.jb0);
  return s;
}

// One block per work item (blockIdx.x, unit fastest).
template <int KIND, int NT, bool PAGED, bool NOOP, bool READ_ALL, int HD>
__global__ void __launch_bounds__(THREADS, (Ring<KIND, NT, HD>::BLOCKS))
    attn_core_kernel(Args a) {
  constexpr int STAGES = Ring<KIND, NT, HD>::STAGES;
  constexpr int RP = NT * 8;                 // query rows of an item, padded to the mma's N
  constexpr int QR = RP / WARPS;             // q rows a warp quantizes
  constexpr bool INT4 = (KIND == KV_INT4);
  constexpr bool FLOAT = Ring<KIND, NT, HD>::FLOAT;
  constexpr int SB = core_stage_b(KIND, HD), RB = tile_row_b(KIND, HD);
  constexpr int TILE_B = TR * RB;            // a stage's rows; its staged scales follow
  constexpr int VPL = HD / 32;               // values of a query row a lane loads
  constexpr int MC = HD / 64;                // m16 chunks of a warp's HD / 4 output columns
  constexpr int PIECES = RB / 16 - 1;        // 16-byte pieces of a kv unit's row: 8 .. 64
  constexpr int PSH = PIECES == 64 ? 6 : PIECES == 32 ? 5 : PIECES == 16 ? 4 : 3;
  extern __shared__ __align__(128) unsigned char sm[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // mma groupID, thread in group
  const int units = INT4 ? a.Hkv / 2 : a.Hkv;
  const int nq = a.nq, half = nq / 2;
  const int bl = a.bl, blp = pad_tiles(bl), ntl = blp / TR, tpb = 2 * ntl;

  unsigned char* ring = sm;
  int8_t* qc = reinterpret_cast<int8_t*>(ring + STAGES * SB);   // q codes, or values (float)
  float* sc = reinterpret_cast<float*>(qc + RP * q_row_b(KIND, HD));
  const int scs = blp + 4;
  int8_t* pq = reinterpret_cast<int8_t*>(sc + (size_t)RP * scs);   // P codes, or bf16 P
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(pq);
  const int pqs = blp + 16, pbs = blp + 8;
  float* vsb = reinterpret_cast<float*>(pq + (size_t)RP * p_row_b(KIND, blp));
  float* st_qs = vsb + 2 * blp;
  int* st_qsum = reinterpret_cast<int*>(st_qs + RP);
  float* st_m = reinterpret_cast<float*>(st_qsum + RP);
  float* st_l = st_m + RP;
  float* st_corr = st_l + RP;
  float* st_ps = st_corr + RP;
  int* st_c = reinterpret_cast<int*>(st_ps + RP);   // candidate of row rr
  int* st_hi = st_c + RP;                    // int4: row rr reads high nibbles
  // a block's partials [WARPS][RP]: row maxima (one warp's rows), and the
  // sums, |P| maxima and P-code sums (int4) of a quarter of a row
  float* pmx = reinterpret_cast<float*>(st_hi + RP);
  float* part_sum = pmx + WARPS * RP;
  float* part_max = part_sum + WARPS * RP;
  int* part_cs = reinterpret_cast<int*>(part_max + WARPS * RP);
  int* s_page = part_cs + WARPS * RP;        // PAGED: the run's page ids [bps]
  __shared__ int s_last;

  const Seg s = seg_of<READ_ALL>(a, blockIdx.x, units);
  const int kv_hi = INT4 ? s.u + a.Hkv / 2 : s.u;
  auto io_index = [&](int r) -> size_t {
    const int j = r % nq;
    const int qh = INT4 ? (j < half ? s.u * half + j : (s.u + a.Hkv / 2) * half + (j - half))
                        : s.u * nq + j;
    return (((size_t)s.slot * a.C + r / nq) * a.H + qh) * HD;
  };
  auto nread_of = [&](int jb) { return READ_ALL ? bl : min(bl, s.last - jb * bl + 1); };
  // scale element of (kv head h, row sub * TR) of block jb (page `page`)
  auto scale_elem0 = [&](int jb, int page, int h, int sub) -> size_t {
    if (PAGED) return (((size_t)a.layer * a.n_pages + page) * a.hp + h) * bl + sub * TR;
    return ((size_t)s.slot * a.Hkv + h) * a.L + (size_t)jb * bl + sub * TR;
  };
  // bf16 scales are staged in 4-byte words: the word-aligned base of array
  // arr's tensor and the elements it lies before that tensor's start
  auto bf16_base = [&](int arr, int& sh) -> const unsigned char* {
    const unsigned char* p = static_cast<const unsigned char*>(arr >= 2 ? a.vs : a.ks);
    sh = (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 1);
    return p - 2 * sh;
  };

  const int n_tiles = s.n_run * tpb;

  // ---- tile tt of the item: block tt / tpb of the run, its K tiles, then
  // its V tiles; into stage tt % STAGES
  auto issue = [&](int tt) {
    if (tt < n_tiles) {
      const int b = tt / tpb, rem = tt % tpb;
      const bool is_v = rem >= ntl;
      const int sub = rem % ntl, jb = s.jb0 + b;
      // the prologue's tiles read their page id; later ones find it staged
      const int page = !PAGED ? 0
                       : tt < STAGES - 1 ? a.table[(size_t)s.slot * a.tstride + jb] : s_page[b];
      const int live = nread_of(jb) - sub * TR;   // rows of the tile to read
      unsigned char* st = ring + (tt % STAGES) * SB;
      const unsigned char* src = is_v ? a.v : a.k;
      const size_t row0 = PAGED ? ((size_t)a.layer * a.n_pages + page) * bl
                                : ((size_t)a.layer * a.S + s.slot) * a.L + (size_t)jb * bl;
      const size_t base = (row0 + sub * TR) * (size_t)a.row_stride + (size_t)s.u * (RB - 16);
#pragma unroll
      for (int e = 0; e < TR * PIECES / THREADS; ++e) {
        const int c = tid + e * THREADS, row = c >> PSH, piece = c & (PIECES - 1);
        const bool ok = row < live;
        cp_async16(st + row * RB + piece * 16,
                   ok ? src + base + (size_t)row * a.row_stride + piece * 16 : src, ok ? 16 : 0);
      }
      if (!FLOAT && !is_v) {  // the tile's K and V scales of the lo and hi kv heads
        const int n = max(0, min(live, TR));
        uint32_t* dst = reinterpret_cast<uint32_t*>(st + TILE_B);
        const int arrays = INT4 ? 4 : 2;  // ks lo, (ks hi,) vs lo, (vs hi)
        if (a.sc_bf16) {
          for (int w = tid; w < arrays * 33; w += THREADS) {
            const int arr = INT4 ? w / 33 : 2 * (w / 33), wi = w % 33;
            int sh;
            const unsigned char* sp = bf16_base(arr, sh);
            const size_t e0 = scale_elem0(jb, page, (arr & 1) ? kv_hi : s.u, sub) + sh;
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
                      ok ? sp + scale_elem0(jb, page, (arr & 1) ? kv_hi : s.u, sub) + i : sp,
                      ok ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) issue(p);
  if (PAGED)  // the run's page ids, for the tiles issued from the loop (after a barrier)
    for (int b = tid; b < s.n_run; b += THREADS)
      s_page[b] = a.table[(size_t)s.slot * a.tstride + s.jb0 + b];

  // ---- q codes (float caches: q rounded to the cache's type) and
  // statistics of the item's rows, a warp's rows warp, warp + WARPS, ...
  // (the first tiles are in flight meanwhile); padding rows are zero
#pragma unroll
  for (int x = 0; x < QR; ++x) {
    const int rr = warp + x * WARPS;
    float scale = 0.f;
    int csum = 0;
    if constexpr (FLOAT) {
      float qv[VPL] = {};
      if (rr < s.nr) load_qv<VPL>(a.q, io_index(s.r0 + rr) + lane * VPL, a.q_bf16, qv);
#pragma unroll
      for (int c = 0; c < VPL / 4; ++c) {
        if constexpr (KIND == KV_F32)
          reinterpret_cast<float4*>(qc + rr * RB)[lane * (VPL / 4) + c] =
              make_float4(qv[4 * c], qv[4 * c + 1], qv[4 * c + 2], qv[4 * c + 3]);
        else
          reinterpret_cast<uint2*>(qc + rr * RB)[lane * (VPL / 4) + c] = make_uint2(
              pack_bf16(qv[4 * c], qv[4 * c + 1]), pack_bf16(qv[4 * c + 2], qv[4 * c + 3]));
      }
    } else {
      uint32_t word[VPL / 4] = {};
      if (rr < s.nr) {
        float qv[VPL];
        load_qv<VPL>(a.q, io_index(s.r0 + rr) + lane * VPL, a.q_bf16, qv);
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
        reinterpret_cast<uint32_t*>(qc + rr * RB)[lane * (VPL / 4) + c] = word[c];
    }
    if (lane == 0) {
      const int r = s.r0 + rr;
      st_qs[rr] = scale;
      st_qsum[rr] = csum;
      st_m[rr] = NEG_INF;
      st_l[rr] = 0.f;
      st_c[rr] = r / nq;
      st_hi[rr] = INT4 && (r % nq) >= half;
    }
  }
  // P codes, bf16 P or (f32) the scores and P start at zero: the entries
  // past a block's rows are never written
  if constexpr (KIND == KV_F32) {
    for (int i = tid; i < RP * scs; i += THREADS) sc[i] = 0.f;
  } else {
    for (int i = tid; i < RP * p_row_b(KIND, blp) / 4; i += THREADS)
      reinterpret_cast<int*>(pq)[i] = 0;
  }
  __syncthreads();

  uint32_t qb[NT][HD / 32][2];  // the scores' B fragments: q codes of n-tile n, k-step kk
  if constexpr (!FLOAT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        const int8_t* p = qc + (n * 8 + g) * RB + 32 * kk + 4 * t;
        qb[n][kk][0] = *reinterpret_cast<const uint32_t*>(p);
        qb[n][kk][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
  }
  float facc[MC][NT][4];   // f32 output accumulators: hd rows HD/4*warp + 16*m + .., query rows
  int iacc[MC][NT][4];     // a block's int32 P@V (int4: the lo members)
  int iacc_hi[MC][NT][4];  // int4: the hi members
  float pacc[MC][NT][4];   // float caches: a block's P@V
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[m][n][e] = 0.f;

  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(tt + STAGES - 1);

    const unsigned char* st = ring + (tt % STAGES) * SB;
    const int b = tt / tpb, rem = tt % tpb;
    const int sub = rem % ntl, jb = s.jb0 + b;
    const int nread = nread_of(jb);
    if (rem < ntl) {
      // ---- scores of the tile's rows 16*warp .. +15 against every query row
      int sacc[NT][4] = {}, sacc_hi[NT][4] = {};
      float fsc[NT][4] = {};   // float caches
      if constexpr (KIND == KV_BF16) {
        scores_bf16<NT, HD>(fsc, st, warp * 16, reinterpret_cast<const unsigned char*>(qc), 1,
                            0, lane);
      } else if constexpr (KIND == KV_F32) {
        scores_f32<NT, HD>(fsc, st, warp * 16, reinterpret_cast<const float*>(qc), lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          uint32_t af[4];
          const int mat = lane >> 3;
          ldsm_x4(af, st + (warp * 16 + (lane & 7) + (mat & 1) * 8) * RB + 32 * kk +
                          (mat >> 1) * 16);
          if (INT4) {
            uint32_t lo[4], hi[4];
            nibbles<NOOP>(af, lo, hi);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              mma_s8(sacc[n], lo, qb[n][kk][0], qb[n][kk][1]);
              if (!NOOP) mma_s8(sacc_hi[n], hi, qb[n][kk][0], qb[n][kk][1]);
            }
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(sacc[n], af, qb[n][kk][0], qb[n][kk][1]);
          }
        }
      }
      // the tile's staged scales (bf16: the halfword offset of each array)
      const uint32_t* scw = reinterpret_cast<const uint32_t*>(st + TILE_B);
      int off[4] = {0, 0, 0, 0};
      if (!FLOAT && a.sc_bf16) {
#pragma unroll
        for (int arr = 0; arr < 4; ++arr) {
          if (!INT4 && (arr & 1)) continue;
          int sh;
          bf16_base(arr, sh);
          off[arr] = (int)((scale_elem0(jb, 0, (arr & 1) ? kv_hi : s.u, sub) + sh) & 1);
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
        if constexpr (!FLOAT) {
          ks_lo = scale_at(0, il);
          ks_hi = INT4 ? scale_at(1, il) : ks_lo;
          if (t == 0) {
            vsb[ib] = scale_at(2, il);
            if (INT4) vsb[blp + ib] = scale_at(3, il);
          }
        }
        const bool row_ok = ib < nread;
        const int row_pos = jb * bl + ib;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rr = n * 8 + 2 * t + e;
            if (rr >= s.nr) continue;
            float v;
            if constexpr (FLOAT) {
              const bool ok = row_ok && row_pos <= s.pos + st_c[rr];
              v = ok ? fsc[n][2 * hrow + e] : NEG_INF;
            } else {
              const bool hi = INT4 && st_hi[rr];
              int d = (hi && !NOOP) ? sacc_hi[n][2 * hrow + e] : sacc[n][2 * hrow + e];
              if (INT4) d -= 8 * st_qsum[rr];
              const bool ok = row_ok && row_pos <= s.pos + st_c[rr];
              v = ok ? ((float)d * st_qs[rr]) * (hi ? ks_hi : ks_lo) : NEG_INF;
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
          if (g == 0 && rr < s.nr)
            pmx[warp * RP + rr] = sub == 0 ? v : fmaxf(pmx[warp * RP + rr], v);
        }
      if (sub == ntl - 1) {
        // ---- the block's softmax statistics, v_scale fold and P requant.
        // Fewer rows than warps: warp w takes quarter w of every row, the
        // quarters' sums and maxima combined through shared memory; else a
        // warp a row.
        __syncthreads();
        auto row_max = [&](int rr) {
          return fmaxf(fmaxf(pmx[rr], pmx[RP + rr]), fmaxf(pmx[2 * RP + rr], pmx[3 * RP + rr]));
        };
        if constexpr (FLOAT) {
          // P = exp(s - m_safe), rounded to bf16 for a bf16 cache (f32: kept
          // in the score row); l sums the unrounded p, as the TPU kernel
          const bool by_row = s.nr >= WARPS;
          const int ql = (bl + WARPS - 1) / WARPS;
          const int i0 = by_row ? 0 : warp * ql, i1 = by_row ? bl : min(bl, i0 + ql);
          for (int rr = by_row ? warp : 0; rr < s.nr; rr += by_row ? WARPS : 1) {
            float* row = sc + rr * scs;
            const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
            float psum = 0.f;
            for (int i = i0 + lane; i < i1; i += 32) {
              const float p = expf(row[i] - ss.m_safe);
              psum += p;
              if (KIND == KV_BF16) pb[rr * pbs + i] = __float2bfloat16_rn(p);
              else row[i] = p;
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
            if (tid < s.nr) {
              const int rr = tid;
              const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
              const float psum = ((part_sum[rr] + part_sum[RP + rr]) + part_sum[2 * RP + rr]) +
                                 part_sum[3 * RP + rr];
              st_l[rr] = st_l[rr] * ss.corr + psum;
              st_m[rr] = ss.m_new;
              st_corr[rr] = ss.corr;
            }
          }
        } else if (s.nr >= WARPS) {
          for (int rr = warp; rr < s.nr; rr += WARPS) {
            float* row = sc + rr * scs;
            const float* vrow = vsb + (st_hi[rr] ? blp : 0);
            const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
            float psum = 0.f, pmax = 0.f;
            for (int i = lane; i < bl; i += 32) {
              float p = expf(row[i] - ss.m_safe);
              psum += p;
              if (i < nread) p = p * vrow[i];
              pmax = fmaxf(pmax, fabsf(p));
              row[i] = p;
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              psum += __shfl_xor_sync(0xffffffffu, psum, o);
              pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
            }
            const float pscale = fmaxf(pmax / 127.0f, 1e-20f);
            int csum = 0;
            for (int i = lane; i < bl; i += 32) {
              float c = rintf(row[i] / pscale);
              c = fminf(fmaxf(c, -127.0f), 127.0f);
              pq[rr * pqs + i] = (int8_t)c;
              csum += (int)c;
            }
            if (INT4) csum = warp_sum(csum);
            if (lane == 0) {
              st_l[rr] = st_l[rr] * ss.corr + psum;
              st_m[rr] = ss.m_new;
              st_corr[rr] = ss.corr;
              st_ps[rr] = pscale;
              part_cs[rr] = csum;
              part_cs[RP + rr] = part_cs[2 * RP + rr] = part_cs[3 * RP + rr] = 0;
            }
          }
        } else {
          const int ql = (bl + WARPS - 1) / WARPS;
          const int i0 = warp * ql, i1 = min(bl, i0 + ql);
#pragma unroll 2
          for (int rr = 0; rr < s.nr; ++rr) {
            float* row = sc + rr * scs;
            const float* vrow = vsb + (st_hi[rr] ? blp : 0);
            const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
            float psum = 0.f, pmax = 0.f;
            for (int i = i0 + lane; i < i1; i += 32) {
              float p = expf(row[i] - ss.m_safe);
              psum += p;
              if (i < nread) p = p * vrow[i];
              pmax = fmaxf(pmax, fabsf(p));
              row[i] = p;
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              psum += __shfl_xor_sync(0xffffffffu, psum, o);
              pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
            }
            if (lane == 0) {
              part_sum[warp * RP + rr] = psum;
              part_max[warp * RP + rr] = pmax;
            }
          }
          __syncthreads();
#pragma unroll 2
          for (int rr = 0; rr < s.nr; ++rr) {
            const float pmax = fmaxf(fmaxf(part_max[rr], part_max[RP + rr]),
                                     fmaxf(part_max[2 * RP + rr], part_max[3 * RP + rr]));
            const float pscale = fmaxf(pmax / 127.0f, 1e-20f);
            const float* row = sc + rr * scs;
            int csum = 0;
            for (int i = i0 + lane; i < i1; i += 32) {
              float c = rintf(row[i] / pscale);
              c = fminf(fmaxf(c, -127.0f), 127.0f);
              pq[rr * pqs + i] = (int8_t)c;
              csum += (int)c;
            }
            if (INT4) {
              csum = warp_sum(csum);
              if (lane == 0) part_cs[warp * RP + rr] = csum;
            }
            if (warp == 0 && lane == 0) {
              const SoftmaxStep ss = softmax_step(st_m[rr], row_max(rr));
              const float psum = ((part_sum[rr] + part_sum[RP + rr]) + part_sum[2 * RP + rr]) +
                                 part_sum[3 * RP + rr];
              st_l[rr] = st_l[rr] * ss.corr + psum;
              st_m[rr] = ss.m_new;
              st_corr[rr] = ss.corr;
              st_ps[rr] = pscale;
            }
          }
        }
      }
    } else if constexpr (FLOAT) {
      // ---- V tile of a float cache: P@V on hd rows HD/4*warp .. + HD/4 - 1,
      // V read in place (bf16: ldmatrix.trans into bf16 mma.sync; f32: FMA)
      if (sub == 0) {
#pragma unroll
        for (int m = 0; m < MC; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pacc[m][n][e] = 0.f;
      }
      if constexpr (KIND == KV_BF16)
        pv_bf16<NT, HD>(pacc, st, pb, pbs, sub * TR, RP - 1, warp, lane);
      else
        pv_f32<NT, HD>(pacc, st, sc, scs, sub * TR, RP - 1, warp, lane);
      if (sub == ntl - 1) {  // the block's P@V into the f32 accumulators
#pragma unroll
        for (int m = 0; m < MC; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = n * 8 + 2 * t + (e & 1);
              if (rr < s.nr) facc[m][n][e] = facc[m][n][e] * st_corr[rr] + pacc[m][n][e];
            }
      }
    } else {
      // ---- V tile: transposed in place to [hd][TR] rows of VT_B bytes (rows
      // 16*warp .. +15, columns 4*lane .. +3 of each 128-byte half hh a
      // thread), then P@V on hd rows HD/4*warp .. + HD/4 - 1. The stage is
      // not refilled before the next iteration.
      constexpr int HH = HD / 128;
      unsigned char* vt = ring + (tt % STAGES) * SB;
      uint32_t w[HH][16];
#pragma unroll
      for (int hh = 0; hh < HH; ++hh)
#pragma unroll
        for (int k = 0; k < 16; ++k)
          w[hh][k] = reinterpret_cast<const uint32_t*>(st + (warp * 16 + k) * RB)[lane + 32 * hh];
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < HH; ++hh)
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          uint32_t* x = w[hh] + 4 * k4;
          const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
          const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
          const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
          const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
          x[0] = __byte_perm(t0, t2, 0x5410);
          x[1] = __byte_perm(t0, t2, 0x7632);
          x[2] = __byte_perm(t1, t3, 0x5410);
          x[3] = __byte_perm(t1, t3, 0x7632);
        }
#pragma unroll
      for (int hh = 0; hh < HH; ++hh)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint4*>(vt + (128 * hh + 4 * lane + c) * VT_B + 16 * warp) =
              make_uint4(w[hh][c], w[hh][4 + c], w[hh][8 + c], w[hh][12 + c]);
      __syncthreads();
      if (sub == 0) {
#pragma unroll
        for (int m = 0; m < MC; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) iacc[m][n][e] = iacc_hi[m][n][e] = 0;
      }
#pragma unroll
      for (int kk = 0; kk < TR / 32; ++kk) {
        uint32_t pb[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int8_t* p = pq + (n * 8 + g) * pqs + sub * TR + 32 * kk + 4 * t;
          pb[n][0] = *reinterpret_cast<const uint32_t*>(p);
          pb[n][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          uint32_t af[4];
          const int mat = lane >> 3;
          ldsm_x4(af, vt + (warp * (HD / 4) + m * 16 + (lane & 7) + (mat & 1) * 8) * VT_B +
                          32 * kk + (mat >> 1) * 16);
          if (INT4) {
            uint32_t lo[4], hi[4];
            nibbles<NOOP>(af, lo, hi);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              mma_s8(iacc[m][n], lo, pb[n][0], pb[n][1]);
              if (!NOOP) mma_s8(iacc_hi[m][n], hi, pb[n][0], pb[n][1]);
            }
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(iacc[m][n], af, pb[n][0], pb[n][1]);
          }
        }
      }
      if (sub == ntl - 1) {  // the block's P@V into the f32 accumulators
#pragma unroll
        for (int m = 0; m < MC; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = n * 8 + 2 * t + (e & 1);
              if (rr >= s.nr) continue;
              int v = (INT4 && st_hi[rr] && !NOOP) ? iacc_hi[m][n][e] : iacc[m][n][e];
              if (INT4)
                v -= 8 * (((part_cs[rr] + part_cs[RP + rr]) + part_cs[2 * RP + rr]) +
                          part_cs[3 * RP + rr]);
              facc[m][n][e] = facc[m][n][e] * st_corr[rr] + (float)v * st_ps[rr];
            }
      }
    }
  }

  // ---- output, or this split's partial and the merge by the last split
  if (a.splits == 1) {
#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = n * 8 + 2 * t + (e & 1);
          if (rr >= s.nr) continue;
          const int d = warp * (HD / 4) + m * 16 + g + 8 * (e >> 1);
          const float l = st_l[rr];
          a.out[io_index(s.r0 + rr) + d] = (l > 0.f) ? facc[m][n][e] / fmaxf(l, 1e-20f) : 0.f;
        }
    return;
  }
  const size_t part = (size_t)RP * (HD + 2);
  const size_t cidx = ((size_t)s.slot * units + s.u) * a.rgroups + s.rg;
  float* ws0 = a.ws + cidx * a.splits * part;
  float* wp = ws0 + (size_t)s.z * part;
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = n * 8 + 2 * t + (e & 1);
        if (rr < s.nr) wp[rr * HD + warp * (HD / 4) + m * 16 + g + 8 * (e >> 1)] = facc[m][n][e];
      }
  if (tid < s.nr) {
    wp[RP * HD + tid] = st_m[tid];
    wp[RP * HD + RP + tid] = st_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + cidx, 1) == a.splits - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int x = tid; x < s.nr * HD; x += THREADS) {
      const int rr = x / HD, d = x % HD;
      float mrun = NEG_INF, lrun = 0.f, arun = 0.f;
      for (int z = 0; z < a.splits; ++z) {
        const float* sp = ws0 + (size_t)z * part;
        const float ms = __ldcg(sp + RP * HD + rr);
        const SoftmaxStep ss = softmax_step(mrun, ms);
        const float cs = expf(ms - ss.m_safe);
        lrun = lrun * ss.corr + __ldcg(sp + RP * HD + RP + rr) * cs;
        arun = arun * ss.corr + __ldcg(sp + rr * HD + d) * cs;
        mrun = ss.m_new;
      }
      a.out[io_index(s.r0 + rr) + d] = (lrun > 0.f) ? arun / fmaxf(lrun, 1e-20f) : 0.f;
    }
    if (tid == 0) a.counters[cidx] = 0;
  }
}

template <int KIND, int NT, bool PAGED, bool NOOP, bool READ_ALL, int HD>
int launch(const Args& a, cudaStream_t st) {
  static size_t opted_in = 0;
  auto kern = attn_core_kernel<KIND, NT, PAGED, NOOP, READ_ALL, HD>;
  const size_t smem =
      smem_bytes(KIND, HD, Ring<KIND, NT, HD>::STAGES, NT * 8, a.bl, PAGED ? a.bps : 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int units = (KIND == KV_INT4) ? a.Hkv / 2 : a.Hkv;
  const long long items = (long long)units * a.S * a.rgroups * a.splits;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)items, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// the paged form at every row padding too: a packed int4 pool at GQA rep 8
// has 16 query rows a unit
template <int KIND, bool PAGED, bool NOOP, bool READ_ALL, int HD>
int launch_nt(const Args& a, int nt, cudaStream_t st) {
  switch (nt) {
    case 1: return launch<KIND, 1, PAGED, NOOP, READ_ALL, HD>(a, st);
    case 2: return launch<KIND, 2, PAGED, NOOP, READ_ALL, HD>(a, st);
    case 4: return launch<KIND, 4, PAGED, NOOP, READ_ALL, HD>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED, bool READ_ALL, int HD>
int launch_kind(const Args& a, int kind, int nt, cudaStream_t st) {
  switch (kind) {
    case KV_INT8: return launch_nt<KV_INT8, PAGED, false, READ_ALL, HD>(a, nt, st);
    case KV_INT4: return launch_nt<KV_INT4, PAGED, false, READ_ALL, HD>(a, nt, st);
    case KV_INT4_NOOP: return launch_nt<KV_INT4, PAGED, true, READ_ALL, HD>(a, nt, st);
    case KV_BF16: return launch_nt<KV_BF16, PAGED, false, READ_ALL, HD>(a, nt, st);
    case KV_F32: return launch_nt<KV_F32, PAGED, false, READ_ALL, HD>(a, nt, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Every instance of the core at one head_dim: the flat and multi forms
// (the blocks past a slot's last row skipped or, READ_ALL, read and
// masked) and the paged form, each cache kind and row padding
template <int HD>
int launch_hd(const Args& a, int kind, int nt, bool paged, bool read_all, cudaStream_t st) {
  if (paged) return launch_kind<true, false, HD>(a, kind, nt, st);
  if (read_all) return launch_kind<false, true, HD>(a, kind, nt, st);
  return launch_kind<false, false, HD>(a, kind, nt, st);
}

}  // namespace core
}  // namespace tpuserve

