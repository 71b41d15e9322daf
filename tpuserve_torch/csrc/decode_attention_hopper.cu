// The Hopper decode-attention core: one template for every cache (int8,
// packed int4, bf16, f32) of the flat kernel (C = 1:
// decode_attention_wide_cache, decode_attention_wide), the paged kernel
// (C = 1 over a page table: decode_attention_wide_paged) and the
// multi-candidate kernel (C = 1..16: decode_attention_wide_cache_multi).
//
// Replaces tpuserve/ops/decode_attention.py::_wide_kernel (:160; with
// paged_sc and with a prebuilt Q_wide), ::_packed_kernel (:495, the whole
// window as one L block) and ::_wide_multi_kernel (:804).
//
// Cache, scales and numerics: k/v [n_layers, S, L, W] int8, bf16 or f32,
// or packed int4 [.., W/2] (global split-half, biased by 8), or
// pools [n_layers, n_pages, ps, W(/2)] read through a page table; scales
// this layer's [S, Hkv, L] bf16 or f32, or f32 pools [n_layers, n_pages,
// hp, ps]. q [S, C, H, HD] (C = 1: [S, H, HD]) f32 or bf16, scaled by
// 1/sqrt(HD); out the same shape, f32. HD, the head_dim, is a template
// parameter (attention_core.cuh), built at 128 and 256 for every cache,
// form and row padding. Row r of a unit is candidate r / NQ,
// member r % NQ (NQ query heads of a kv unit: rep, or 2*rep for the int4
// head pair whose nibbles share a byte). The TPU kernel's requant points
// are kept: q int8 per (slot, candidate, head); int32 score dots (int4:
// biased nibbles, -8*sum(q) fold); s * q_scale * k_scale, rows past pos + c
// at -1e30; online softmax over block_l blocks with m_safe = max(m, -5e29);
// v_scale folded into P, P requantized per row and block with pscale =
// max(pmax/127, 1e-20); int32 P@V (int4: the -8 fold as -8*sum(P codes));
// out = acc / max(l, 1e-20) where l > 0, else 0. A float cache (the TPU
// kernel's float branch): f32 dots of q rounded to the cache's type, the
// rows past pos + c at -1e30, the same online softmax, P = exp(s - m_safe)
// rounded to bf16 for a bf16 cache, P@V with f32 sums; no split (below).
//
// Bound on the H100: bytes (every live K/V byte is used for 2 * rows
// operations, a few per byte against the int8 tensor cores' ~590). The
// old kernels ran one block of 4 warps per (kv unit, slot) over its whole
// window with a few rows in flight per warp, K and V loaded in separate
// phases, dots on CUDA cores with a warp reduction per row. Here:
//
// - The window is split over blocks (flash-decoding). Block (u, slot, z)
//   takes a run of `bps` whole block_l blocks; the wrapper picks the split
//   count so that the grid fills the card (ops/decode_attention.py,
//   split_plan: splits = clamp(4 * SMs / (units * S), 1, n_blocks), whole
//   blocks a split; the slice's 1024 blocks take none, the spec cell's 256
//   take two, a window that is one block takes none; the flat and multi
//   entries at the same positions split alike). A split's (m, l, acc)
//   go to an f32 workspace; the last block of (u, slot, row group) to
//   bump its counter merges the partials in split order and resets the
//   counter: deterministic, one launch. The int8 P codes do not depend on
//   the max they are taken against (one factor per row), so a split
//   changes only the order of f32 sums (and a code where that order moves
//   a value across a rounding tie).
// - K and V stream through a ring of STAGES tiles of TR rows in shared
//   memory with cp.async (16 bytes a thread, zero-filled past the live
//   rows, which are never read), the scales with the K tiles; the tile
//   sequence of a block_l block is its K tiles, then its V tiles, so the
//   next block's K is in flight while this block's P@V runs.
// - One block per work item (kv unit, slot, row group, split), 4 or 5
//   blocks an SM (Ring in attention_core.cuh; at most 128 or 102 registers a thread; a V
//   tile is transposed within its own stage, so it needs no buffer of its
//   own); an item's first tiles are in flight while its q is loaded and
//   quantized. A persistent grid, each block streaming several items
//   through one ring, measured no faster and lost the hardware's balancing
//   of unequal items.
// - Scores and P@V on the tensor cores, mma.sync m16n8k32 s8 x s8 -> s32.
//   Scores: cache rows on M (a warp's 16 rows of a tile, A by ldmatrix),
//   the block's query rows on N (padded to 8; B, the q codes, in
//   registers): no warp reduction per row. P@V: hd on M (a warp's 32
//   columns), query rows on N, cache rows on K; int8 V has no 8-bit
//   ldmatrix.trans, so each V tile is transposed once in shared memory
//   (four PRMT-transposed 4x4 byte blocks a thread, 16-byte stores) and
//   read by ldmatrix. Int4: the nibbles become int8 in registers (one
//   LOP3, and a shift for the high ones) and the two member halves take
//   one mma each.
// - The softmax statistics: the score epilogue keeps each warp's row
//   maxima (three shuffles over its 16 rows); with fewer query rows than
//   warps each warp then takes a quarter of every row, the quarters' sums
//   and maxima combined through shared memory, else a warp takes a row.
//   (A warp a row left three warps idle for the decode step's one or two
//   rows, on the critical path of every block.)
// - Query rows beyond 32 (C * NQ > 32) take more blocks (row groups), each
//   reading the window for its own rows. NQ is any GQA ratio (3, 5, 6, 7
//   too): a row's candidate and member are r / NQ and r % NQ, and the rows
//   past a group's nr (padding to the mma's 8, 16 or 32) are never scored,
//   stored or read back.
// - head_dim 256: the same blocks of 4 warps. The q.k dot runs over both
//   128-wide halves (8 k32 steps) before the softmax, q quantized once per
//   head over its 256 values with one scale; P@V gives a warp hd 64 * warp
//   .. + 63 (four m16 chunks, twice the accumulators: the register cap of 2
//   blocks an SM). Rows are twice as long (int8/int4 272 bytes, bf16 528,
//   f32 1040); the f32 ring has 2 stages; an int8 V tile transposed in its
//   stage takes 256 rows of 80 bytes, so an int8 stage is padded to 20,480.
//   Packed int4: a unit's 256-byte row holds head u in the low nibbles and
//   head u + Hkv/2 in the high ones (the global split-half), so NQ = 2*rep.
// - The float caches (KV_BF16, KV_F32) take the same ring, work items,
//   statistics and output, with rows of 2 * HD (bf16) or 4 * HD (f32)
//   bytes a kv head. bf16: scores on mma.sync m16n8k16 bf16 -> f32 (cache rows on
//   M by ldmatrix, the query rows, q rounded to bf16, on N), P@V on the same
//   mma with hd on M read from the V tile in its stage by ldmatrix.trans
//   and P bf16 on N: no transpose pass, no conversion. f32: the same
//   fragments by FMA on the CUDA cores (TF32 would change the values).
//   The wrapper never splits their window: a run would round P to bf16 at
//   its own max, where the TPU kernel rounds it at the window's running
//   max.
//
// NOOP (packed int4, TPUSERVE_INT4_UNPACK=noop): the raw bytes as signed
// int8 for both halves of K and V, the folds kept (a timing diagnostic,
// wrong on purpose). READ_ALL (TPUSERVE_ATTN_DYNSKIP=0): every block of a
// split is read and its rows past pos + c masked (exact zeros). PAGED: a
// block_l block is a page; the first tiles read their page id, the block
// stages the ids of its run for the rest, and it never touches a page past
// the live one.
#include "attention_core.cuh"

using namespace tpuserve::attn;
using namespace tpuserve::core;

// Built in their own translation units, so that nvcc builds them at once:
// the paged form (decode_attention_hopper_paged.cu at head_dim 128,
// _paged_hd256.cu at 256) and head_dim 256's flat and multi forms
// (decode_attention_hopper_hd256.cu, skipping the blocks past a slot, and
// decode_attention_hopper_hd256_all.cu, reading them)
extern template int tpuserve::core::launch_kind<true, false, 128>(const Args&, int, int,
                                                                  cudaStream_t);
extern template int tpuserve::core::launch_kind<true, false, 256>(const Args&, int, int,
                                                                  cudaStream_t);
extern template int tpuserve::core::launch_kind<false, false, 256>(const Args&, int, int,
                                                                   cudaStream_t);
extern template int tpuserve::core::launch_kind<false, true, 256>(const Args&, int, int,
                                                                  cudaStream_t);

// The core for int8 (kind 0), packed int4 (1), packed int4 with the noop
// unpack (4) and, unscaled, bf16 (2) and f32 (3) caches and pools (ks,
// vs and sc_bf16 are not read); kind + KV_READ_ALL reads and masks the
// blocks past the last row (flat and multi only). row_stride is in bytes.
// table != null: the paged form (k/v and
// the f32 scales are pools, block_l = ps, L = ps, C = 1). C candidates of nq
// query heads a unit (C * nq rows, in groups of 32 along grid.z); the
// window in `splits` runs of `bps` blocks; with splits > 1, ws holds S *
// units * groups * splits * pad8(rows of a group) * (HD + 2) floats and
// counters one zeroed int per (slot, unit, group). hd is 128 or 256.
// Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention_core(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, const int* pos,
    const int* table, void* out, void* ws, void* counters, int q_bf16, int sc_bf16, int S, int C,
    int H, int Hkv, int L, int layer, int win, int bl, int row_stride, int n_pages, int hp,
    int tstride, int kind, int nq, int splits, int bps, int hd, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  if (hd != 128 && hd != 256) return bad;
  const bool read_all = kind & KV_READ_ALL;
  kind &= ~KV_READ_ALL;
  const bool paged = table != nullptr;
  if (bl <= 0 || win % bl || C < 1 || nq < 1 || (paged && (read_all || C != 1)) ||
      ((kind == KV_INT4 || kind == KV_INT4_NOOP) && nq % 2) || row_stride % 16 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return bad;
  const int n_blocks = win / bl;
  if (splits < 1 || bps < 1 || splits != (n_blocks + bps - 1) / bps) return bad;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return bad;
  const int rows = C * nq;
  const int rgroups = (rows + MAX_RG - 1) / MAX_RG;
  const int rmax = rows < MAX_RG ? rows : MAX_RG;
  const int nt = rmax <= 8 ? 1 : (rmax <= 16 ? 2 : 4);
  Args a;
  a.q = q; a.k = (const unsigned char*)k; a.v = (const unsigned char*)v; a.ks = ks; a.vs = vs;
  a.pos = pos; a.table = table; a.out = (float*)out; a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.q_bf16 = q_bf16; a.sc_bf16 = paged ? 0 : sc_bf16;
  a.S = S; a.C = C; a.H = H; a.Hkv = Hkv; a.L = L; a.layer = layer; a.win = win; a.bl = bl;
  a.row_stride = row_stride; a.n_pages = n_pages; a.hp = hp; a.tstride = tstride;
  a.nq = nq; a.splits = splits; a.bps = bps; a.rgroups = rgroups;
  cudaStream_t st = (cudaStream_t)stream;
  return hd == 128 ? launch_hd<128>(a, kind, nt, paged, read_all, st)
                   : launch_hd<256>(a, kind, nt, paged, read_all, st);
}
