// Single-token GQA decode attention over the flat multi-layer KV cache,
// read in place at a layer offset.
//
// Replaces tpuserve/ops/decode_attention.py::_wide_kernel (the
// decode_attention_wide_cache path, inline Q_wide), ::_packed_kernel
// (several slots per block when the window is small; here that is the same
// kernel run with one L block covering the whole window, which is what a
// plain softmax over the row with one P requant amounts to), and
// ::_wide_kernel with paged_sc=True (decode_attention_wide_paged: the same
// body over a paged pool, see PAGED below).
//
// Cache: k/v [n_layers, S, L, W] (W = Hkv*hd values; int8, bf16 or f32) or
// packed int4 uint8 [n_layers, S, L, W/2] where byte d holds W-position d in
// its low nibble and W/2 + d in its high nibble (global split-half, biased
// by 8). Scales: this layer's [S, Hkv, L], bf16 or f32, head-major.
//
// PAGED: k/v are pools [n_layers, n_pages, ps, W] (W/2 for int4) and the
// scales are f32 pools [n_layers, n_pages, hp, ps] (hp = pad8(Hkv)), all
// read in place. Block jb of a slot is page table[slot, jb], so block_l ==
// ps: the TPU kernel's one-page block, with one P requant per page. Only
// addressing differs from the flat form: one lane per warp loads the
// block's page id and shuffles it to the others. The table is read only for
// blocks at or before the slot's position (jb <= pos/ps), so the kernel
// never touches a page past the live one.
//
// Numerics kept from the TPU kernel, so that the two differ only in the
// order of float sums:
//   - q quantized to int8 per (slot, head): clip +-127, round half to even;
//   - int32 score dots (int4: biased nibbles with the -8*sum(q) fold);
//   - s * q_scale * k_scale, masked positions at s + (-1e30);
//   - online softmax over block_l blocks with m_safe = max(m, -5e29);
//   - v_scale folded into P, then P requantized to int8 per row and block
//     with pscale = max(pmax/127, 1e-20), int32 P@V (int4: nibbles - 8);
//   - out = acc / max(l, 1e-20) where l > 0, else 0 (inactive slots).
// bf16/f32 caches use plain f32 dots, P rounded to bf16 for a bf16 cache.
//
// NOOP (packed int4 only; TPUSERVE_INT4_UNPACK=noop, ops/decode_attention.py):
// the raw packed bytes, as signed int8, stand for both nibble halves of K
// and of V, with the -8*sum(q) and -8 folds kept, as the JAX package's
// _unpack_nibbles does in that mode. Numerically wrong on purpose: an A/B
// against the default instances times the nibble unpack in place. The
// default instances (NOOP = false) compile as before.
//
// Bound on the H100: bytes. Each cached K/V byte of a live position is
// used for 2*rep operations. Design: one block of 4 warps per (kv unit,
// slot). A kv unit is one kv head, or for packed int4 the head pair
// (h, h + Hkv/2) whose nibbles share bytes [h*hd, (h+1)*hd) of each row,
// so every byte is read once. A warp reads a row's segment of the unit in
// one coalesced load and starts the loads of ROWS rows before it uses them,
// the rep query heads of the unit share each row read, and rows past
// positions[slot] are never read.
#include "attention_common.cuh"

namespace {

using namespace tpuserve::attn;
using tpuserve::to_f32;
using tpuserve::warp_max;
using tpuserve::warp_sum;

struct AttnArgs {
  const void* q;       // [S, H, HD] f32 or bf16, already scaled by 1/sqrt(HD)
  const void* k;       // flat cache base (all layers)
  const void* v;
  const void* ks;      // this layer's scales [S, Hkv, L] (int kinds only)
  const void* vs;
  const int* pos;      // [S], -1 = inactive
  float* out;          // [S, H, HD]
  int q_bf16;
  int sc_bf16;
  int S, H, Hkv, L, layer, win, bl;
  int row_stride;      // elements (bytes for int4) per cache row
  // paged pools only
  const int* table;    // [S, P] page ids, row stride tstride
  int tstride, n_pages, hp;
};

template <int KIND, int NQ, bool PAGED, bool NOOP = false>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(AttnArgs a) {
  constexpr bool INTK = (KIND == KV_INT8 || KIND == KV_INT4);
  extern __shared__ __align__(16) unsigned char dsm[];
  float* sc = reinterpret_cast<float*>(dsm);                 // [NQ][bl] scores, then P
  int8_t* pq = reinterpret_cast<int8_t*>(dsm + (size_t)NQ * a.bl * sizeof(float));  // [NQ][bl]
  __shared__ __align__(16) float qf[NQ][HD];
  __shared__ __align__(16) int8_t q8[NQ][HD];
  __shared__ __align__(16) float red[WARPS][NQ][HD];
  __shared__ float s_qscale[NQ], s_m[NQ], s_l[NQ], s_corr[NQ], s_pscale[NQ];

  const int u = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = a.H / a.Hkv;
  const int pos = a.pos[slot];
  const int bl = a.bl;

  // query head / kv head of unit member j
  auto kv_of = [&](int j) -> int {
    if (KIND == KV_INT4) return j < rep ? u : u + a.Hkv / 2;
    return u;
  };
  auto qh_of = [&](int j) -> int {
    if (KIND == KV_INT4) return j < rep ? u * rep + j : (u + a.Hkv / 2) * rep + (j - rep);
    return u * rep + j;
  };

  // ---- q: per-head int8 quantization (int kinds) or dtype rounding
  for (int j = warp; j < NQ; j += WARPS) {
    const size_t base = ((size_t)slot * a.H + qh_of(j)) * HD + lane * 4;
    float qv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qv[c] = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[base + c])
                       : reinterpret_cast<const float*>(a.q)[base + c];
    if (INTK) {
      float am = fmaxf(fmaxf(fabsf(qv[0]), fabsf(qv[1])), fmaxf(fabsf(qv[2]), fabsf(qv[3])));
      am = warp_max(am);
      const float scale = fmaxf(am / 127.0f, 1e-10f);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float r = rintf(qv[c] / scale);
        r = fminf(fmaxf(r, -127.0f), 127.0f);
        q8[j][lane * 4 + c] = (int8_t)r;
      }
      if (lane == 0) s_qscale[j] = scale;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) qf[j][lane * 4 + c] = (KIND == KV_BF16) ? round_bf16(qv[c]) : qv[c];
    }
  }
  if (tid < NQ) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  int qw[NQ];
  int qsum[NQ];
  float qv4[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (INTK) {
      qw[j] = *reinterpret_cast<const int*>(&q8[j][lane * 4]);
      qsum[j] = __dp4a(qw[j], 0x01010101, 0);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) qv4[j][c] = qf[j][lane * 4 + c];
    }
  }

  float acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.f;

  const size_t unit_off = (size_t)u * HD;  // elements (bytes for int4)

  const int n_blocks = a.win / bl;
  for (int jb = 0; jb < n_blocks && jb * bl <= pos; ++jb) {
    const int l0 = jb * bl;
    const int live = min(bl, pos - l0 + 1);
    // this block's first cache row, and its scales: scale of (kv head h,
    // row i) at sc0 + h * sc_h + i
    size_t blk_row, sc0, sc_h;
    if (PAGED) {
      int page = 0;
      if (lane == 0) page = a.table[(size_t)slot * a.tstride + jb];
      page = __shfl_sync(0xffffffffu, page, 0);
      const size_t pg = (size_t)a.layer * a.n_pages + (size_t)page;
      blk_row = pg * bl;
      sc0 = pg * a.hp * bl;
      sc_h = bl;
    } else {
      blk_row = ((size_t)a.layer * a.S + slot) * a.L + l0;
      sc0 = (size_t)slot * a.Hkv * a.L + l0;
      sc_h = a.L;
    }

    // one lane's word of block row i of the K or V cache
    auto word = [&](const void* base, int i) {
      return load_word<KIND>(base, (blk_row + i) * (size_t)a.row_stride + unit_off, lane);
    };

    // ---- phase 1: scores for every row of the block (dead rows masked).
    // A warp takes rows warp, warp + WARPS, ... in groups of ROWS: it loads
    // the group's K words and scales first, so that ROWS loads are in
    // flight, then does their dots.
    for (int i0 = warp; i0 < bl; i0 += WARPS * ROWS) {
      typename RowWord<KIND>::T kw[ROWS] = {};
      float ks_lo[ROWS] = {}, ks_hi[ROWS] = {};  // scales of kv_of(0) and kv_of(NQ-1)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r * WARPS;
        if (i < live) {
          kw[r] = word(a.k, i);
          if constexpr (INTK) {
            ks_lo[r] = load_scale(a.ks, sc0 + kv_of(0) * sc_h + i, a.sc_bf16);
            if (KIND == KV_INT4) ks_hi[r] = load_scale(a.ks, sc0 + kv_of(NQ - 1) * sc_h + i, a.sc_bf16);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r * WARPS;
        if (i >= bl) break;
        if (i >= live) {
          if (lane < NQ) sc[lane * bl + i] = NEG_INF;
          continue;
        }
        float s[NQ];
        if constexpr (INTK) {
          int d[NQ];
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            if (KIND == KV_INT4) {
              const int nib = NOOP ? (int)kw[r]
                                   : (int)((j < rep) ? (kw[r] & 0x0F0F0F0Fu)
                                                     : ((kw[r] >> 4) & 0x0F0F0F0Fu));
              d[j] = __dp4a(qw[j], nib, 0) - 8 * qsum[j];
            } else {
              d[j] = __dp4a(qw[j], (int)kw[r], 0);
            }
            d[j] = warp_sum(d[j]);
          }
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float ksc = (KIND == KV_INT4 && j >= rep) ? ks_hi[r] : ks_lo[r];
            s[j] = ((float)d[j] * s_qscale[j]) * ksc;
          }
        } else {
          float kv[4];
          word_floats<KIND>(kw[r], kv);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            float t = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) t += qv4[j][c] * kv[c];
            s[j] = warp_sum(t);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < NQ; ++j) sc[j * bl + i] = s[j];
        }
      }
    }
    __syncthreads();

    // ---- phase 2: online-softmax statistics, v_scale fold, P requant
    for (int j = warp; j < NQ; j += WARPS) {
      float* row = sc + (size_t)j * bl;
      float mx = NEG_INF;
      for (int i = lane; i < bl; i += 32) mx = fmaxf(mx, row[i]);
      mx = warp_max(mx);
      const float m_prev = s_m[j];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, NEG_INF / 2);
      const float corr = expf(m_prev - m_safe);
      float psum = 0.f, pmax = 0.f;
      for (int i = lane; i < bl; i += 32) {
        float p = expf(row[i] - m_safe);
        psum += p;
        if (INTK) {
          if (i < live) p = p * load_scale(a.vs, sc0 + kv_of(j) * sc_h + i, a.sc_bf16);
          pmax = fmaxf(pmax, fabsf(p));
        } else if (KIND == KV_BF16) {
          p = round_bf16(p);
        }
        row[i] = p;
      }
      psum = warp_sum(psum);
      float pscale = 1.f;
      if (INTK) {
        pmax = warp_max(pmax);
        pscale = fmaxf(pmax / 127.0f, 1e-20f);
        for (int i = lane; i < bl; i += 32) {
          float r = rintf(row[i] / pscale);
          r = fminf(fmaxf(r, -127.0f), 127.0f);
          pq[(size_t)j * bl + i] = (int8_t)r;
        }
      }
      if (lane == 0) {
        s_l[j] = s_l[j] * corr + psum;
        s_m[j] = m_new;
        s_corr[j] = corr;
        s_pscale[j] = pscale;
      }
    }
    __syncthreads();

    // ---- phase 3: P @ V over the live rows; one warp per row, the V words
    // of ROWS rows loaded first as in phase 1
    if constexpr (INTK) {
      int pa[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) pa[j][c] = 0;
      for (int i0 = warp; i0 < live; i0 += WARPS * ROWS) {
        uint32_t vws[ROWS] = {};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (i0 + r * WARPS < live) vws[r] = word(a.v, i0 + r * WARPS);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r * WARPS;
          if (i >= live) break;
          const uint32_t vw = vws[r];
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int p = (int)pq[(size_t)j * bl + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const uint32_t byte = (vw >> (8 * c)) & 0xFFu;
              int val;
              if (KIND == KV_INT4)
                val = (NOOP ? (int)(int8_t)byte
                            : (int)((j < rep) ? (byte & 0xFu) : (byte >> 4))) - 8;
              else
                val = (int)(int8_t)byte;
              pa[j][c] += p * val;
            }
          }
        }
      }
      int* redi = reinterpret_cast<int*>(&red[0][0][0]);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) redi[(warp * NQ + j) * HD + lane * 4 + c] = pa[j][c];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        int tot = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) tot += redi[(w * NQ + j) * HD + tid];
        const float part = (float)tot * s_pscale[j];
        acc[j] = acc[j] * s_corr[j] + part;
      }
    } else {
      float pa[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) pa[j][c] = 0.f;
      for (int i0 = warp; i0 < live; i0 += WARPS * ROWS) {
        typename RowWord<KIND>::T vws[ROWS] = {};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (i0 + r * WARPS < live) vws[r] = word(a.v, i0 + r * WARPS);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r * WARPS;
          if (i >= live) break;
          float vv[4];
          word_floats<KIND>(vws[r], vv);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float p = sc[(size_t)j * bl + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) pa[j][c] += p * vv[c];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[warp][j][lane * 4 + c] = pa[j][c];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float part = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) part += red[w][j][tid];
        acc[j] = acc[j] * s_corr[j] + part;
      }
    }
    __syncthreads();  // sc / pq / red are rewritten by the next block
  }

#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float l = s_l[j];
    const float o = (l > 0.f) ? acc[j] / fmaxf(l, 1e-20f) : 0.f;
    a.out[((size_t)slot * a.H + qh_of(j)) * HD + tid] = o;
  }
}

template <int KIND, int NQ, bool PAGED, bool NOOP>
int launch(const AttnArgs& a, size_t smem, cudaStream_t st) {
  // static + dynamic shared memory above 48 KB needs an opt-in per kernel;
  // raise the opt-in whenever a larger window asks for more
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<KIND, NQ, PAGED, NOOP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int units = (KIND == KV_INT4) ? a.Hkv / 2 : a.Hkv;
  dim3 grid(units, a.S);
  decode_attn_kernel<KIND, NQ, PAGED, NOOP><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool PAGED, bool NOOP = false>
int launch_nq(const AttnArgs& a, int nq, size_t smem, cudaStream_t st) {
  switch (nq) {
    case 1: return launch<KIND, 1, PAGED, NOOP>(a, smem, st);
    case 2: return launch<KIND, 2, PAGED, NOOP>(a, smem, st);
    case 4: return launch<KIND, 4, PAGED, NOOP>(a, smem, st);
    case 8: return launch<KIND, 8, PAGED, NOOP>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int launch_kind(const AttnArgs& a, int kind, int nq, cudaStream_t st) {
  if (a.S <= 0) return 0;
  const size_t smem = (size_t)nq * a.bl * (sizeof(float) + 1);
  switch (kind) {
    case KV_INT8: return launch_nq<KV_INT8, PAGED>(a, nq, smem, st);
    case KV_INT4: return launch_nq<KV_INT4, PAGED>(a, nq, smem, st);
    case KV_BF16: return launch_nq<KV_BF16, PAGED>(a, nq, smem, st);
    case KV_F32: return launch_nq<KV_F32, PAGED>(a, nq, smem, st);
    case KV_INT4_NOOP: return launch_nq<KV_INT4, PAGED, true>(a, nq, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 int8, 1 packed int4, 2 bf16, 3 f32 cache, 4 packed int4 with
// the noop unpack (see NOOP). nq: query heads per block (rep, or 2*rep for
// int4). Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const int* pos,
                                         void* out, int q_bf16, int sc_bf16, int S, int H,
                                         int Hkv, int L, int layer, int win, int bl,
                                         int row_stride, int kind, int nq, void* stream) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.ks = ks; a.vs = vs; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16; a.sc_bf16 = sc_bf16;
  a.S = S; a.H = H; a.Hkv = Hkv; a.L = L; a.layer = layer; a.win = win; a.bl = bl;
  a.row_stride = row_stride;
  a.table = nullptr; a.tstride = 0; a.n_pages = 0; a.hp = 0;
  return launch_kind<false>(a, kind, nq, (cudaStream_t)stream);
}

// The paged form: pools [n_layers, n_pages, ps, row_stride] and f32 scale
// pools [n_layers, n_pages, hp, ps] (int kinds only), page table [S, *]
// with row stride table_stride; win is a multiple of ps. Returns a
// cudaError_t code.
extern "C" int tpuserve_decode_attention_paged(const void* q, const void* k, const void* v,
                                               const void* ks, const void* vs, const int* pos,
                                               const int* table, void* out, int q_bf16, int S,
                                               int H, int Hkv, int n_pages, int ps, int hp,
                                               int layer, int win, int table_stride,
                                               int row_stride, int kind, int nq, void* stream) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.ks = ks; a.vs = vs; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16; a.sc_bf16 = 0;
  a.S = S; a.H = H; a.Hkv = Hkv; a.L = ps; a.layer = layer; a.win = win; a.bl = ps;
  a.row_stride = row_stride;
  a.table = table; a.tstride = table_stride; a.n_pages = n_pages; a.hp = hp;
  if (ps <= 0 || win % ps != 0) return (int)cudaErrorInvalidValue;
  return launch_kind<true>(a, kind, nq, (cudaStream_t)stream);
}
