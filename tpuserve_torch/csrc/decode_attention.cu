// Single-token GQA decode attention over a bf16 or f32 KV cache: the flat
// multi-layer cache read in place at a layer offset, or a paged pool.
//
// Replaces tpuserve/ops/decode_attention.py::_wide_kernel (the
// decode_attention_wide_cache path), ::_packed_kernel (the whole window as
// one L block) and ::_wide_kernel with paged_sc=True (decode_attention_wide
// _paged; see PAGED below) for float caches. The int8 and packed int4
// caches take the Hopper core, decode_attention_hopper.cu.
//
// Cache: k/v [n_layers, S, L, W] (W = Hkv*hd; bf16 or f32). PAGED: k/v are
// pools [n_layers, n_pages, ps, W] read in place; block jb of a slot is page
// table[slot, jb], so block_l == ps. One lane per warp loads the block's
// page id and shuffles it to the others. The table is read only for blocks
// at or before the slot's position (jb <= pos/ps).
//
// Numerics kept from the TPU kernel, so that the two differ only in the
// order of float sums: q rounded to the cache's type, f32 dots, positions
// past positions[slot] at s + (-1e30), online softmax over block_l blocks
// with m_safe = max(m, -5e29), P rounded to bf16 for a bf16 cache, out =
// acc / max(l, 1e-20) where l > 0, else 0 (inactive slots).
//
// READ_ALL (flat form; TPUSERVE_ATTN_DYNSKIP=0, launch code + KV_READ_ALL):
// the blocks past positions[slot] are read and their rows masked, as the
// TPU kernel reads them under TPUSERVE_ATTN_DYNSKIP=0; masked rows add
// exact zeros, so the output is the same. The paged form always skips.
//
// Bound on the H100: bytes. Each cached K/V value of a live position is
// used for 2*rep operations. Design: one block of 4 warps per (kv head,
// slot). A warp reads a row's segment of the head in one coalesced load and
// starts the loads of ROWS rows before it uses them, the rep query heads
// share each row read, and rows past positions[slot] are never read
// (unless READ_ALL).
#include "attention_common.cuh"

namespace {

using namespace tpuserve::attn;
using tpuserve::warp_max;
using tpuserve::warp_sum;

struct AttnArgs {
  const void* q;       // [S, H, HD] f32 or bf16, already scaled by 1/sqrt(HD)
  const void* k;       // flat cache base (all layers)
  const void* v;
  const int* pos;      // [S], -1 = inactive
  float* out;          // [S, H, HD]
  int q_bf16;
  int S, H, Hkv, L, layer, win, bl;
  int row_stride;      // elements per cache row
  // paged pools only
  const int* table;    // [S, P] page ids, row stride tstride
  int tstride, n_pages;
};

template <int KIND, int NQ, bool PAGED, bool READ_ALL = false>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(AttnArgs a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float* sc = reinterpret_cast<float*>(dsm);                 // [NQ][bl] scores, then P
  __shared__ __align__(16) float qf[NQ][HD];
  __shared__ __align__(16) float red[WARPS][NQ][HD];
  __shared__ float s_m[NQ], s_l[NQ], s_corr[NQ];

  const int u = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos[slot];
  const int bl = a.bl;

  // ---- q rounded to the cache's type
  for (int j = warp; j < NQ; j += WARPS) {
    float qv[4];
    load_q4(a.q, ((size_t)slot * a.H + u * NQ + j) * HD + lane * 4, a.q_bf16, qv);
#pragma unroll
    for (int c = 0; c < 4; ++c) qf[j][lane * 4 + c] = (KIND == KV_BF16) ? round_bf16(qv[c]) : qv[c];
  }
  if (tid < NQ) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  float qv4[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) qv4[j][c] = qf[j][lane * 4 + c];

  float acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.f;

  const size_t unit_off = (size_t)u * HD;

  const int n_blocks = a.win / bl;
  for (int jb = 0; jb < n_blocks && (READ_ALL || jb * bl <= pos); ++jb) {
    const int l0 = jb * bl;
    const int live = min(bl, pos - l0 + 1);     // rows <= pos (may be <= 0 without the skip)
    const int nread = READ_ALL ? bl : live;     // rows read
    size_t blk_row;                             // this block's first cache row
    if (PAGED) {
      int page = 0;
      if (lane == 0) page = a.table[(size_t)slot * a.tstride + jb];
      page = __shfl_sync(0xffffffffu, page, 0);
      blk_row = ((size_t)a.layer * a.n_pages + (size_t)page) * bl;
    } else {
      blk_row = ((size_t)a.layer * a.S + slot) * a.L + l0;
    }

    // one lane's word of block row i of the K or V cache
    auto word = [&](const void* base, int i) {
      return load_word<KIND>(base, (blk_row + i) * (size_t)a.row_stride + unit_off, lane);
    };

    // ---- phase 1: scores for every row of the block (dead rows masked).
    // A warp takes rows warp, warp + WARPS, ... in groups of ROWS: it loads
    // the group's K words first, so that ROWS loads are in flight, then does
    // their dots.
    for (int i0 = warp; i0 < bl; i0 += WARPS * ROWS) {
      typename RowWord<KIND>::T kw[ROWS] = {};
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r * WARPS;
        if (i < nread) kw[r] = word(a.k, i);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r * WARPS;
        if (i >= bl) break;
        if (i >= nread) {
          if (lane < NQ) sc[lane * bl + i] = NEG_INF;
          continue;
        }
        float kv[4];
        word_floats<KIND>(kw[r], kv);
        float s[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          float t = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) t += qv4[j][c] * kv[c];
          s[j] = warp_sum(t);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < NQ; ++j) sc[j * bl + i] = i < live ? s[j] : NEG_INF;
        }
      }
    }
    __syncthreads();

    // ---- phase 2: online-softmax statistics, P rounded to the cache's type
    for (int j = warp; j < NQ; j += WARPS) {
      float* row = sc + (size_t)j * bl;
      float mx = NEG_INF;
      for (int i = lane; i < bl; i += 32) mx = fmaxf(mx, row[i]);
      mx = warp_max(mx);
      const SoftmaxStep st = softmax_step(s_m[j], mx);
      float psum = 0.f;
      for (int i = lane; i < bl; i += 32) {
        float p = expf(row[i] - st.m_safe);
        psum += p;
        row[i] = (KIND == KV_BF16) ? round_bf16(p) : p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        s_l[j] = s_l[j] * st.corr + psum;
        s_m[j] = st.m_new;
        s_corr[j] = st.corr;
      }
    }
    __syncthreads();

    // ---- phase 3: P @ V over the live rows; one warp per row, the V words
    // of ROWS rows loaded first as in phase 1
    float pa[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) pa[j][c] = 0.f;
    for (int i0 = warp; i0 < nread; i0 += WARPS * ROWS) {
      typename RowWord<KIND>::T vws[ROWS] = {};
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (i0 + r * WARPS < nread) vws[r] = word(a.v, i0 + r * WARPS);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r * WARPS;
        if (i >= nread) break;
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
    __syncthreads();  // sc / red are rewritten by the next block
  }

#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float l = s_l[j];
    const float o = (l > 0.f) ? acc[j] / fmaxf(l, 1e-20f) : 0.f;
    a.out[((size_t)slot * a.H + u * NQ + j) * HD + tid] = o;
  }
}

template <int KIND, int NQ, bool PAGED, bool READ_ALL>
int launch(const AttnArgs& a, size_t smem, cudaStream_t st) {
  // static + dynamic shared memory above 48 KB needs an opt-in per kernel;
  // raise the opt-in whenever a larger window asks for more
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<KIND, NQ, PAGED, READ_ALL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 grid(a.Hkv, a.S);
  decode_attn_kernel<KIND, NQ, PAGED, READ_ALL><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool PAGED, bool READ_ALL = false>
int launch_nq(const AttnArgs& a, int nq, size_t smem, cudaStream_t st) {
  switch (nq) {
    case 1: return launch<KIND, 1, PAGED, READ_ALL>(a, smem, st);
    case 2: return launch<KIND, 2, PAGED, READ_ALL>(a, smem, st);
    case 4: return launch<KIND, 4, PAGED, READ_ALL>(a, smem, st);
    case 8: return launch<KIND, 8, PAGED, READ_ALL>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED, bool READ_ALL = false>
int launch_kind(const AttnArgs& a, int kind, int nq, cudaStream_t st) {
  if (a.S <= 0) return 0;
  const size_t smem = (size_t)nq * a.bl * sizeof(float);
  switch (kind) {  // int8 and packed int4: decode_attention_hopper.cu
    case KV_BF16: return launch_nq<KV_BF16, PAGED, READ_ALL>(a, nq, smem, st);
    case KV_F32: return launch_nq<KV_F32, PAGED, READ_ALL>(a, nq, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 2 bf16, 3 f32 cache (int8 and packed int4 take the Hopper core);
// ks, vs and sc_bf16 are not read. nq: query heads per block (rep). kind +
// KV_READ_ALL: the READ_ALL instances. Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const int* pos,
                                         void* out, int q_bf16, int sc_bf16, int S, int H,
                                         int Hkv, int L, int layer, int win, int bl,
                                         int row_stride, int kind, int nq, void* stream) {
  (void)ks; (void)vs; (void)sc_bf16;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16;
  a.S = S; a.H = H; a.Hkv = Hkv; a.L = L; a.layer = layer; a.win = win; a.bl = bl;
  a.row_stride = row_stride;
  a.table = nullptr; a.tstride = 0; a.n_pages = 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind & KV_READ_ALL) return launch_kind<false, true>(a, kind & ~KV_READ_ALL, nq, st);
  return launch_kind<false>(a, kind, nq, st);
}

// The paged form over a bf16 or f32 pool [n_layers, n_pages, ps,
// row_stride], page table [S, *] with row stride table_stride; win is a
// multiple of ps; ks, vs and hp are not read. Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention_paged(const void* q, const void* k, const void* v,
                                               const void* ks, const void* vs, const int* pos,
                                               const int* table, void* out, int q_bf16, int S,
                                               int H, int Hkv, int n_pages, int ps, int hp,
                                               int layer, int win, int table_stride,
                                               int row_stride, int kind, int nq, void* stream) {
  (void)ks; (void)vs; (void)hp;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16;
  a.S = S; a.H = H; a.Hkv = Hkv; a.L = ps; a.layer = layer; a.win = win; a.bl = ps;
  a.row_stride = row_stride;
  a.table = table; a.tstride = table_stride; a.n_pages = n_pages;
  if (ps <= 0 || win % ps != 0) return (int)cudaErrorInvalidValue;
  return launch_kind<true>(a, kind, nq, (cudaStream_t)stream);
}
