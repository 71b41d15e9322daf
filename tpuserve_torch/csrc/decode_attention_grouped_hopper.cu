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
// HD] f32. HD, the head_dim, is 128 or 256 (a template parameter: at 256
// the q.k dot covers both 128-wide halves, q is quantized once over its
// 256 values, a warp's P @ V covers hd 64 * warp .. + 63, and an f32 ring
// has 2 stages).
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
// - Work item (kv unit, slot, split, row group): a unit is a kv head (int8, float) or
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
//   for a pair, any ratio; padded to 8, 16 or 32; a unit's rows past 32 go
//   to more blocks, row groups of 32, each reading the window for its own). P @ V on bf16 mma.sync m16n8k16 with
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
#include "attention_grouped.cuh"

using namespace tpuserve::attn;
using namespace tpuserve::grouped;

// built in decode_attention_grouped_hopper_hd256.cu
extern template int tpuserve::grouped::launch_kind<256>(const GArgs&, int, bool, cudaStream_t);

// The grouped decode attention over an int8 (kind 0), packed int4 (kind 1),
// bf16 (2) or f32 (3) window; the float windows take ks = vs = null when
// unscaled. kind + KV_READ_ALL reads and masks the blocks past a slot's
// position (TPUSERVE_ATTN_DYNSKIP=0). row_stride and slot_stride are in
// bytes. nq query heads a unit (int8, float: rep;
// int4: 2 * rep, the pair's; any ratio), one unit and one row group of up
// to 32 of its rows a block, the window in `splits` runs of `bps` blocks;
// with splits > 1, ws holds S * units * groups * splits * pad8(rows of a
// group) * (hd + 2) floats and counters one zeroed int per (slot, unit,
// group). hd is 128 or 256. Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention_grouped_hopper(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, const int* pos,
    void* out, void* ws, void* counters, long long slot_stride, long long ss_slot,
    long long ss_head, int q_bf16, int sc_bf16, int S, int H, int Hkv, int win, int bl,
    int row_stride, int kind, int nq, int splits, int bps, int hd, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  const bool read_all = kind & KV_READ_ALL;
  kind &= ~KV_READ_ALL;
  const bool int4 = kind == KV_INT4, flt = kind == KV_BF16 || kind == KV_F32;
  if ((kind != KV_INT8 && !int4 && !flt) || (ks == nullptr) != (vs == nullptr) ||
      (!flt && ks == nullptr))
    return bad;
  if (bl <= 0 || win <= 0 || win % bl || nq < 1 || Hkv < 1 || (hd != 128 && hd != 256) ||
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
  a.nq = nq; a.splits = splits; a.bps = bps; a.rgroups = (nq + G_RG - 1) / G_RG;
  cudaStream_t st = (cudaStream_t)stream;
  return hd == 128 ? launch_kind<128>(a, kind, read_all, st)
                   : launch_kind<256>(a, kind, read_all, st);
}
