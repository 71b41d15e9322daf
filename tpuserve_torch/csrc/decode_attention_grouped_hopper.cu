// The grouped decode attention on Hopper (the TPUSERVE_DECODE_ATTN=grouped
// path of the decode step), for int8, packed int4, bf16 and f32 windows.
//
// Replaces tpuserve/ops/decode_attention.py::_kernel (:1237; call :1423,
// entry decode_attention :1309), with its arithmetic, not the flat core's:
//   - q int8 per (slot, head) (clip +-127, round half to even, scale
//     max(absmax/127, 1e-10)); int32 score dots (packed int4: biased
//     nibbles and the exact -8*sum(q) fold, as the codes nibble - 8 that
//     the JAX package's unpack_kv_codes gives); s = (dot * k_scale) *
//     q_scale; rows past positions[slot] at -1e30;
//   - online softmax over block_l blocks, m_safe = max(m, -5e29), p =
//     exp(s - m_safe), l = l * corr + sum(p);
//   - P = bf16(p * v_scale), times V's codes (exact in bf16), f32 sums:
//     acc = acc * corr + P @ V; no P requant;
//   - out = acc / max(l, 1e-20) where l > 0, else 0 (inactive slots: 0).
// A float window (bf16 or f32, scales optional): f32 dots of q's own
// values (an f32 q stays f32, a bf16 one bf16), times k_scale if given; P =
// p * v_scale (if given), rounded to bf16 unless the window is f32; P @ V
// with f32 sums.
//
// Cache: a window view k/v [S, win, W] (int8, W = Hkv*HD; bf16; f32) or [S, win, W/2]
// (packed int4: byte d holds W-position d in its low nibble and W/2 + d in
// its high one, biased by 8), rows row_stride bytes apart, slots
// slot_stride bytes apart: the layer's rows of the flat cache, read in
// place. Scales: element (slot, kv head, row) at slot * ss_slot + head *
// ss_head + row, f32 or bf16 (the head-major scale cache, or a transposed
// view of it). q [S, H, HD] f32 or bf16, scaled by 1/sqrt(HD); out [S, H,
// HD] f32.
//
// Bound on the H100: bytes (each live K/V byte is used for 2 * rep
// operations). Here, as in decode_attention_hopper.cu (the flat core):
//
// - K and V stream through a ring of STAGES tiles of TR rows (cp.async, 16
//   bytes a thread, zero-filled past the rows read, scales with the K
//   tiles). A block_l block's tile sequence is its K tiles, then its V
//   tiles: the V tiles are in flight while the scores and the softmax run,
//   the next block's K tiles while P @ V runs. (A stage holding both K and
//   V of a tile would keep a block's V in the ring through its softmax: a
//   ring of a whole block, 8 tiles at block_l 256.)
// - Work item (kv unit, slot, split): a unit is a kv head (int8, float) or
//   the pair of heads u, u + Hkv/2 whose nibbles share a byte (int4), so a
//   packed tile is read once for both. g_kv (the TPU kernel's kv heads a
//   grid step) changes no value and shapes no block here, so g_kv = Hkv
//   does not shrink the grid. The window split (ops/decode_attention.py::split_plan over Hkv units,
//   whatever the route and g_kv) and the deterministic in-launch merge by
//   per-(slot, unit) counters are the core's; the plain version takes the
//   same plan. A split starts its own online softmax, so P is rounded to
//   bf16 at that run's max: a split moves values by bf16 roundings.
// - Scores on the tensor cores as the core's: int8 mma.sync m16n8k32, cache
//   rows on M (A by ldmatrix), the unit's query rows on N (rep, or 2 * rep
//   for a pair; padded to 8 or 16). P @ V on bf16 mma.sync m16n8k16 with
//   f32 sums: hd on M, read from the V tile in its stage by ldmatrix.trans
//   as b16 (there is no 8-bit form; a thread gets two adjacent columns of
//   two adjacent rows, and the even and odd columns become the two halves
//   of an m16 fragment), so the tile needs no transpose pass (the core's
//   costs two block barriers a V tile); converted to bf16 exactly in
//   registers (int8: PRMT and a float subtraction; int4 nibbles: 0x43 over
//   the code is bf16 128 + code, minus 136); P bf16 from shared memory.
// - A bf16 window: scores on bf16 mma.sync m16n8k16 (cache rows on M by
//   ldmatrix); an f32 q is staged as three bf16 pieces hi + mid + lo, whose
//   products with the bf16 values are exact in f32, three mmas summed in
//   f32 (a bf16 q takes one). P @ V on the same mma with V read in place by
//   ldmatrix.trans (a true b16 transpose here: hd rows g and g + 8 of an m16
//   chunk). An f32 window: the same fragments by FMA on the CUDA cores (TF32
//   would change the values). The float windows take the same ring, work
//   items, window split and merge.
// - The softmax statistics: with fewer query rows than warps each warp
//   takes a quarter of every row, else a warp a row.
//
// READ_ALL (TPUSERVE_ATTN_DYNSKIP=0, the JAX package's default for this
// kernel): every block of a split is read and its rows past pos masked;
// without it only the rows up to pos are read, and the tiles past them are
// neither read nor computed. The output is the same.
//
// Tile positions advance by counters in the producer and the consumer: a
// runtime integer division is tens of instructions, and a tile's own work
// is a few hundred a thread.
#include "attention_common.cuh"
#include "attention_hopper.cuh"

namespace {

using namespace tpuserve::attn;
using namespace tpuserve::hopper;
using tpuserve::warp_sum;

// Ring depth and blocks an SM (the register cap with them)
template <int NT> struct GRing {
  static constexpr int STAGES = 3;
  static constexpr int BLOCKS = NT == 1 ? 4 : 3;
};

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
  int S, H, Hkv, win, bl, row_stride, nq, splits, bps;
};

__host__ __device__ inline int pad_tiles(int bl) { return (bl + TR - 1) / TR * TR; }

// Bytes of the staged q of a padded row: int8 codes; a bf16 cache's q in
// three bf16 pieces (hi, mid, lo; one for a bf16 q), [3][RP] rows; f32 q
__host__ __device__ constexpr int gq_row_b(int kind) {
  return kind == KV_F32 ? ROW_F32 : kind == KV_BF16 ? 3 * ROW_BF16 : QS_B;
}

// Dynamic shared memory (ops/decode_attention.py::grouped_smem_bytes
// mirrors it): the ring, q [RP][gq_row_b], scores f32 [nq][blp + 4] and P
// bf16 [nq][blp + 8] of the unit's nq query rows only (the mma's padding
// rows of P are read from row nq - 1: they only fill output columns that
// are dropped; an f32 cache keeps P in the score rows), the block's V
// scales [2][blp] f32, six per-row statistics [RP], two [WARPS][RP] partials.
__host__ __device__ inline size_t grouped_smem(int kind, int stages, int rp, int nq, int bl) {
  const size_t blp = pad_tiles(bl);
  return (size_t)stages * stage_b(kind) + (size_t)rp * gq_row_b(kind) + nq * (blp + 4) * 4 +
         (kind == KV_F32 ? 0 : nq * (blp + 8) * 2) + 2 * blp * 4 + 6 * (size_t)rp * 4 +
         2 * WARPS * (size_t)rp * 4;
}

template <int KIND, int NT, bool READ_ALL>
__global__ void __launch_bounds__(THREADS, (GRing<NT>::BLOCKS)) attn_grouped_kernel(GArgs a) {
  constexpr int STAGES = GRing<NT>::STAGES;
  constexpr int RP = NT * 8;                 // query rows of a unit, padded to the mma's N
  constexpr int QR = RP / WARPS;             // q rows a warp quantizes
  constexpr bool INT4 = (KIND == KV_INT4);
  constexpr bool FLOAT = KIND == KV_BF16 || KIND == KV_F32;
  constexpr int SB = stage_b(KIND), RB = tile_row_b(KIND);
  constexpr int PIECES = RB / 16 - 1;        // 16-byte pieces of a kv unit's row: 8, 16, 32
  constexpr int PSH = PIECES == 32 ? 5 : PIECES == 16 ? 4 : 3;
  extern __shared__ __align__(128) unsigned char sm[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  // hd of accumulator element e within an m16 chunk
  auto dcol = [&](int e) { return FLOAT ? g + 8 * (e >> 1) : 2 * g + (e >> 1); };
  const int units = INT4 ? a.Hkv / 2 : a.Hkv;
  const int nq = a.nq, half = nq / 2, nr = nq;
  const int bl = a.bl, blp = pad_tiles(bl), ntl = blp / TR;
  const bool scaled = !FLOAT || a.ks != nullptr;

  unsigned char* ring = sm;
  int8_t* qc = reinterpret_cast<int8_t*>(ring + STAGES * SB);   // q codes, or values (float)
  float* sc = reinterpret_cast<float*>(qc + RP * gq_row_b(KIND));
  const int scs = blp + 4;
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(sc + (size_t)nr * scs);
  const int pbs = blp + 8;
  float* vsb = reinterpret_cast<float*>(pb + (KIND == KV_F32 ? 0 : (size_t)nr * pbs));
  float* st_qs = vsb + 2 * blp;
  int* st_qsum = reinterpret_cast<int*>(st_qs + RP);
  float* st_m = reinterpret_cast<float*>(st_qsum + RP);
  float* st_l = st_m + RP;
  float* st_corr = st_l + RP;
  int* st_hi = reinterpret_cast<int*>(st_corr + RP);   // int4: row rr reads high nibbles
  float* pmx = reinterpret_cast<float*>(st_hi + RP);   // [WARPS][RP] row maxima of a warp's rows
  float* part_sum = pmx + WARPS * RP;                  // [WARPS][RP] sums of a quarter row
  __shared__ int s_last;

  // the work item: unit u, slot, split z (blocks jb0 .. jb0 + n_run - 1)
  const int u = blockIdx.x % units;
  const int slot = (blockIdx.x / units) % a.S;
  const int z = blockIdx.x / units / a.S;
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

  auto io_index = [&](int j) -> size_t {
    const int qh = INT4 ? (j < half ? u * half + j : hu * half + (j - half)) : u * nq + j;
    return ((size_t)slot * a.H + qh) * HD;
  };

  // ---- q codes (float caches: q's values; a bf16 cache's as bf16 pieces)
  // and statistics of the unit's rows, a warp's rows warp, warp + WARPS,
  // ... (the unit's first tiles are in flight meanwhile); padding rows 0
#pragma unroll
  for (int x = 0; x < QR; ++x) {
    const int rr = warp + x * WARPS;
    uint32_t word = 0;
    float scale = 0.f;
    int csum = 0;
    if constexpr (KIND == KV_F32) {
      float qv[4] = {0.f, 0.f, 0.f, 0.f};
      if (rr < nr) load_q4(a.q, io_index(rr) + lane * 4, a.q_bf16, qv);
      reinterpret_cast<float4*>(qc + rr * ROW_F32)[lane] =
          make_float4(qv[0], qv[1], qv[2], qv[3]);
    } else if constexpr (KIND == KV_BF16) {
      float qv[4] = {0.f, 0.f, 0.f, 0.f};
      if (rr < nr) load_q4(a.q, io_index(rr) + lane * 4, a.q_bf16, qv);
      // q = hi + mid + lo, each a bf16 and each residual exact in f32, so
      // the three pieces' products with the bf16 cache sum to the f32 dot
      // (a bf16 q is its hi piece alone)
      float pc[3][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pc[0][c] = round_bf16(qv[c]);
        pc[1][c] = round_bf16(qv[c] - pc[0][c]);
        pc[2][c] = round_bf16((qv[c] - pc[0][c]) - pc[1][c]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        reinterpret_cast<uint2*>(qc + (k * RP + rr) * ROW_BF16)[lane] =
            make_uint2(pack_bf16(pc[k][0], pc[k][1]), pack_bf16(pc[k][2], pc[k][3]));
    } else {
      if (rr < nr) {
        float qv[4];
        load_q4(a.q, io_index(rr) + lane * 4, a.q_bf16, qv);
        int8_t code[4];
        scale = quantize_q4(qv, code);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          word |= (uint32_t)(uint8_t)code[c] << (8 * c);
          csum += code[c];
        }
        csum = warp_sum(csum);
      }
      reinterpret_cast<uint32_t*>(qc + rr * QS_B)[lane] = word;
    }
    if (lane == 0) {
      st_qs[rr] = scale;
      st_qsum[rr] = csum;
      st_m[rr] = NEG_INF;
      st_l[rr] = 0.f;
      st_hi[rr] = INT4 && rr >= half;
    }
  }
  __syncthreads();

  uint32_t qb[NT][4][2];  // the scores' B fragments: q codes of n-tile n, k-step kk
  if constexpr (!FLOAT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int8_t* p = qc + (n * 8 + g) * QS_B + 32 * kk + 4 * t;
        qb[n][kk][0] = *reinterpret_cast<const uint32_t*>(p);
        qb[n][kk][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
  }
  // f32 output [chunk m][n tile][c frag]: hd 32*warp + 16*m + 2*g (+1 for
  // c2, c3; float caches: g, +8), query rows n*8 + 2*t (+1 for c1, c3)
  float facc[2][NT][4];
  float pacc[2][NT][4];    // a block's P @ V (int4: the lo members)
  float pacc_hi[2][NT][4]; // int4: the hi members
#pragma unroll
  for (int m = 0; m < 2; ++m)
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
        scores_bf16<NT>(fsc, st, warp * 16, reinterpret_cast<const unsigned char*>(qc),
                        a.q_bf16 ? 1 : 3, RP * ROW_BF16, lane);
      } else if constexpr (KIND == KV_F32) {
        scores_f32<NT>(fsc, st, warp * 16, reinterpret_cast<const float*>(qc), lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, st + (warp * 16 + (lane & 7) + (mat & 1) * 8) * ROW_B + 32 * kk +
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
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pacc[c][n][e] = pacc_hi[c][n][e] = 0.f;
      }
      // float caches: V read in place, bf16 by ldmatrix.trans into the same
      // mma (hd 16c + g, + 8 of the warp's 32), f32 by FMA
      if constexpr (KIND == KV_BF16) pv_bf16<NT>(pacc, st, pb, pbs, sub * TR, nr - 1, warp, lane);
      if constexpr (KIND == KV_F32) pv_f32<NT>(pacc, st, sc, scs, sub * TR, nr - 1, warp, lane);
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
          uint32_t vr[4];  // rows 16ks + 0..7 and 8..15 of chunk 0, then of chunk 1
          ldsm_x4_trans(vr, st + (16 * ks + (lane & 7) + (mat & 1) * 8) * ROW_B + 32 * warp +
                                (mat >> 1) * 16);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
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
        for (int m = 0; m < 2; ++m)
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
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = n * 8 + 2 * t + (e & 1);
          if (rr >= nr) continue;
          const int d = warp * 32 + m * 16 + dcol(e);
          const float l = st_l[rr];
          a.out[io_index(rr) + d] = (l > 0.f) ? facc[m][n][e] / fmaxf(l, 1e-20f) : 0.f;
        }
    return;
  }
  const size_t part = (size_t)RP * (HD + 2);
  const size_t cidx = (size_t)slot * units + u;
  float* ws0 = a.ws + cidx * a.splits * part;
  float* wp = ws0 + (size_t)z * part;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = n * 8 + 2 * t + (e & 1);
        if (rr < nr) wp[rr * HD + warp * 32 + m * 16 + dcol(e)] = facc[m][n][e];
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

template <int KIND, int NT, bool READ_ALL>
int launch(const GArgs& a, cudaStream_t st) {
  static size_t opted_in = 0;
  auto kern = attn_grouped_kernel<KIND, NT, READ_ALL>;
  const size_t smem = grouped_smem(KIND, GRing<NT>::STAGES, NT * 8, a.nq, a.bl);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int units = (KIND == KV_INT4) ? a.Hkv / 2 : a.Hkv;
  const long long items = (long long)units * a.S * a.splits;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)items, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool READ_ALL>
int launch_nt(const GArgs& a, cudaStream_t st) {
  return a.nq <= 8 ? launch<KIND, 1, READ_ALL>(a, st) : launch<KIND, 2, READ_ALL>(a, st);
}

}  // namespace

// The grouped decode attention over an int8 (kind 0), packed int4 (kind 1),
// bf16 (2) or f32 (3) window; the float windows take ks = vs = null when
// unscaled. kind + KV_READ_ALL reads and masks the blocks past a slot's
// position (TPUSERVE_ATTN_DYNSKIP=0). row_stride and slot_stride are in
// bytes. nq query heads a unit (int8, float: rep;
// int4: 2 * rep, the pair's), one unit a block, the window in `splits`
// runs of `bps` blocks; with splits > 1, ws holds S * units * splits *
// pad8(nq) * (HD + 2) floats and counters one zeroed int per (slot, unit).
// Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention_grouped_hopper(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, const int* pos,
    void* out, void* ws, void* counters, long long slot_stride, long long ss_slot,
    long long ss_head, int q_bf16, int sc_bf16, int S, int H, int Hkv, int win, int bl,
    int row_stride, int kind, int nq, int splits, int bps, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  const bool read_all = kind & KV_READ_ALL;
  kind &= ~KV_READ_ALL;
  const bool int4 = kind == KV_INT4, flt = kind == KV_BF16 || kind == KV_F32;
  if ((kind != KV_INT8 && !int4 && !flt) || (ks == nullptr) != (vs == nullptr) ||
      (!flt && ks == nullptr))
    return bad;
  if (bl <= 0 || win <= 0 || win % bl || nq < 1 || nq > 16 || Hkv < 1 ||
      (int4 && (nq % 2 || Hkv % 2)) || H != Hkv * (int4 ? nq / 2 : nq))
    return bad;
  const int units = int4 ? Hkv / 2 : Hkv;
  if (row_stride % 16 || slot_stride % 16 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return bad;
  const int n_blocks = win / bl;
  if (splits < 1 || bps < 1 || splits != (n_blocks + bps - 1) / bps) return bad;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return bad;
  GArgs a;
  a.q = q; a.k = (const unsigned char*)k; a.v = (const unsigned char*)v; a.ks = ks; a.vs = vs;
  a.pos = pos; a.out = (float*)out; a.ws = (float*)ws; a.counters = (int*)counters;
  a.slot_stride = slot_stride; a.ss_slot = ss_slot; a.ss_head = ss_head;
  a.q_bf16 = q_bf16; a.sc_bf16 = sc_bf16;
  a.S = S; a.H = H; a.Hkv = Hkv; a.win = win; a.bl = bl; a.row_stride = row_stride;
  a.nq = nq; a.splits = splits; a.bps = bps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case KV_INT4:
      return read_all ? launch_nt<KV_INT4, true>(a, st) : launch_nt<KV_INT4, false>(a, st);
    case KV_BF16:
      return read_all ? launch_nt<KV_BF16, true>(a, st) : launch_nt<KV_BF16, false>(a, st);
    case KV_F32:
      return read_all ? launch_nt<KV_F32, true>(a, st) : launch_nt<KV_F32, false>(a, st);
    default:
      return read_all ? launch_nt<KV_INT8, true>(a, st) : launch_nt<KV_INT8, false>(a, st);
  }
}
