// Speculative-verification decode attention: C candidate queries per slot
// over ONE read of the flat multi-layer KV cache, in place at a layer
// offset.
//
// Replaces tpuserve/ops/decode_attention.py::_wide_multi_kernel (entry
// decode_attention_wide_cache_multi). Candidate c of slot s is the token at
// position positions[s] + c; its K/V is already in the cache, and it attends
// to every row <= positions[s] + c. Inactive slots (positions = -1) give 0
// for candidate 0 and garbage for the rest, which the caller masks.
//
// Cache and scales as decode_attention.cu (flat form): k/v [n_layers, S, L,
// W] int8/bf16/f32 or packed int4 [.., W/2] (global split-half, biased by
// 8), scales this layer's [S, Hkv, L] bf16 or f32. q [S, C, H, HD] f32 or
// bf16, scaled by 1/sqrt(HD); out [S, C, H, HD] f32.
//
// Numerics are decode_attention.cu's, row by row, so that row (s, c) equals
// the flat kernel at positions[s] + c up to the order of float sums (in
// practice bitwise): int8 q per (slot, candidate, head), int32 score dots
// (int4: -8*sum(q) fold), s * q_scale * k_scale, online softmax with
// m_safe = max(m, -5e29), v_scale folded into P, P requantized per row and
// block with pscale = max(pmax/127, 1e-20), out = acc / max(l, 1e-20) where
// l > 0. A block runs while it holds a row <= positions[s] + C - 1; row c
// masks the rows past positions[s] + c.
//
// NOOP (packed int4 only; kind 4): TPUSERVE_INT4_UNPACK=noop as in
// decode_attention.cu, the raw packed bytes as signed int8 for both nibble
// halves of K and V, the folds kept; a timing diagnostic, wrong on purpose.
//
// Bound on the H100: bytes, as the flat kernel; the point of this kernel is
// that each live K/V byte is read from device memory once for all C
// candidates, where C flat calls would read it C times. Design: the flat
// kernel's block per (kv unit, slot), widened from NQ query rows to R =
// C*NQ. C is a run-time bound, so per-row state lives in shared memory (q,
// scores and P, the accumulators). Scores of the int kinds: a thread owns
// one cache row of the block, holds its 128-byte K segment in registers
// and runs the whole dot of every candidate that sees the row against q
// codes broadcast from shared memory, so no warp reduction is needed; it
// also stages the row's V scales for the softmax phase. Scores of the
// float kinds: a warp owns a row and its lanes 4 values each, as in the
// flat kernel. P@V runs over groups of GROUP query rows, the register
// accumulators of one group at a time, warps loading ROWS V rows ahead;
// each group reads the block's V rows again, from L1 or L2, not from device
// memory.
#include "attention_common.cuh"

namespace {

using namespace tpuserve::attn;
using tpuserve::warp_max;
using tpuserve::warp_sum;

constexpr int GROUP = 16;     // query rows accumulated in registers per P@V pass
constexpr int MAX_ROWS = 128; // C * NQ
constexpr size_t SMEM_LIMIT = 227 * 1024;

struct MultiArgs {
  const void* q;       // [S, C, H, HD] f32 or bf16
  const void* k;       // flat cache base (all layers)
  const void* v;
  const void* ks;      // this layer's scales [S, Hkv, L] (int kinds only)
  const void* vs;
  const int* pos;      // [S], candidate 0's position, -1 = inactive
  float* out;          // [S, C, H, HD]
  int q_bf16, sc_bf16;
  int S, C, H, Hkv, L, layer, win, bl;
  int row_stride;      // elements (bytes for int4) per cache row
};

// Dynamic shared memory, in this order (ops/decode_attention.py's
// multi_smem_bytes computes the same size): q [R][HD] f32 (int8 codes in
// its first bytes for the int kinds), the P@V reduction [WARPS][GROUP][HD]
// 32-bit, accumulators [R][HD] f32 (the three read in 16-byte vectors, so
// they come first), scores then P [R][bl] f32, the block's V scales [2][bl]
// f32 (kv heads of members 0 and NQ-1), P codes [R][bl] int8.
__host__ __device__ inline size_t smem_bytes(int rows, int bl) {
  return (size_t)rows * HD * 4 + (size_t)WARPS * GROUP * HD * 4 + (size_t)rows * HD * 4 +
         (size_t)rows * bl * 4 + (size_t)2 * bl * 4 + (size_t)rows * bl;
}

template <int KIND, int NQ, bool NOOP = false>
__global__ void __launch_bounds__(THREADS) decode_attn_multi_kernel(MultiArgs a) {
  constexpr bool INTK = (KIND == KV_INT8 || KIND == KV_INT4);
  constexpr int HALF = NQ / 2;  // int4: members < HALF read low nibbles
  const int R = a.C * NQ;       // query rows of the block: row r = c * NQ + j
  const int bl = a.bl;
  extern __shared__ __align__(16) unsigned char dsm[];
  float* qf = reinterpret_cast<float*>(dsm);
  int8_t* q8 = reinterpret_cast<int8_t*>(dsm);
  unsigned char* red = dsm + (size_t)R * HD * 4;
  float* acc = reinterpret_cast<float*>(red + (size_t)WARPS * GROUP * HD * 4);
  float* sc = acc + (size_t)R * HD;
  float* vsc = sc + (size_t)R * bl;
  int8_t* pq = reinterpret_cast<int8_t*>(vsc + (size_t)2 * bl);
  __shared__ float s_qscale[MAX_ROWS], s_m[MAX_ROWS], s_l[MAX_ROWS], s_corr[MAX_ROWS],
      s_pscale[MAX_ROWS];
  __shared__ int s_qsum[MAX_ROWS];  // int4: sum of the row's q codes, for the -8 fold

  const int u = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos[slot];
  const int last = pos + a.C - 1;  // the last row any candidate sees

  // kv head / query head of unit member j (as decode_attention.cu)
  auto kv_of = [&](int j) -> int {
    if (KIND == KV_INT4) return j < HALF ? u : u + a.Hkv / 2;
    return u;
  };
  auto qh_of = [&](int j) -> int {
    if (KIND == KV_INT4) return j < HALF ? u * HALF + j : (u + a.Hkv / 2) * HALF + (j - HALF);
    return u * NQ + j;
  };
  auto io_index = [&](int r) -> size_t {  // element of row r's first value in q and out
    return (((size_t)slot * a.C + r / NQ) * a.H + qh_of(r % NQ)) * HD;
  };

  // ---- q: per-row int8 quantization (int kinds) or dtype rounding
  for (int r = warp; r < R; r += WARPS) {
    float qv[4];
    load_q4(a.q, io_index(r) + lane * 4, a.q_bf16, qv);
    if (INTK) {
      int8_t code[4];
      const float scale = quantize_q4(qv, code);
      int csum = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        q8[r * HD + lane * 4 + c] = code[c];
        csum += code[c];
      }
      csum = warp_sum(csum);
      if (lane == 0) {
        s_qscale[r] = scale;
        s_qsum[r] = csum;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        qf[r * HD + lane * 4 + c] = (KIND == KV_BF16) ? round_bf16(qv[c]) : qv[c];
    }
  }
  for (int r = tid; r < R; r += THREADS) {
    s_m[r] = NEG_INF;
    s_l[r] = 0.f;
  }
  for (int i = tid; i < R * HD; i += THREADS) acc[i] = 0.f;  // column i % HD == tid
  __syncthreads();

  const size_t unit_off = (size_t)u * HD;  // elements (bytes for int4)
  const int n_blocks = a.win / bl;
  for (int jb = 0; jb < n_blocks && jb * bl <= last; ++jb) {
    const int l0 = jb * bl;
    const int live = min(bl, last - l0 + 1);
    const size_t blk_row = ((size_t)a.layer * a.S + slot) * a.L + l0;
    const size_t sc0 = (size_t)slot * a.Hkv * a.L + l0;  // scale of (kv head h, row i):
    const size_t sc_h = a.L;                              // sc0 + h * sc_h + i

    auto word = [&](const void* base, int i) {
      return load_word<KIND>(base, (blk_row + i) * (size_t)a.row_stride + unit_off, lane);
    };

    // ---- phase 1: scores of every (row, candidate). Candidate c sees block
    // row i iff l0 + i <= pos + c; the rows of candidates before c_min are
    // masked.
    if constexpr (INTK) {
      // a thread owns row i: its K segment (HD codes, or HD packed bytes of
      // a head pair) in registers, one whole dot per (candidate, member)
      for (int i = tid; i < bl; i += THREADS) {
        const int c_min = (i < live) ? max(0, l0 + i - pos) : a.C;
        for (int rr = 0; rr < c_min * NQ; ++rr) sc[rr * bl + i] = NEG_INF;
        if (c_min >= a.C) continue;
        const uint4* kp = reinterpret_cast<const uint4*>(
            static_cast<const unsigned char*>(a.k) + (blk_row + i) * (size_t)a.row_stride +
            unit_off);
        uint32_t kw[HD / 4];
#pragma unroll
        for (int t = 0; t < HD / 16; ++t) {
          const uint4 w = kp[t];
          kw[4 * t] = w.x; kw[4 * t + 1] = w.y; kw[4 * t + 2] = w.z; kw[4 * t + 3] = w.w;
        }
        // scales of kv_of(0) and, for int4's hi-nibble members, kv_of(NQ-1)
        const float ks_lo = load_scale(a.ks, sc0 + kv_of(0) * sc_h + i, a.sc_bf16);
        const float ks_hi = (KIND == KV_INT4)
                                ? load_scale(a.ks, sc0 + kv_of(NQ - 1) * sc_h + i, a.sc_bf16)
                                : ks_lo;
        vsc[i] = load_scale(a.vs, sc0 + kv_of(0) * sc_h + i, a.sc_bf16);
        if (KIND == KV_INT4) vsc[bl + i] = load_scale(a.vs, sc0 + kv_of(NQ - 1) * sc_h + i, a.sc_bf16);
        for (int c = c_min; c < a.C; ++c) {
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int rq = c * NQ + j;
            const int4* qp = reinterpret_cast<const int4*>(&q8[rq * HD]);  // broadcast reads
            int d = 0;
#pragma unroll
            for (int t = 0; t < HD / 16; ++t) {
              const int4 q4 = qp[t];
              const int qs[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const uint32_t w = kw[4 * t + e];
                if (KIND == KV_INT4)
                  d = __dp4a(qs[e],
                             NOOP ? (int)w
                                  : (int)((j < HALF) ? (w & 0x0F0F0F0Fu) : ((w >> 4) & 0x0F0F0F0Fu)),
                             d);
                else
                  d = __dp4a(qs[e], (int)w, d);
              }
            }
            if (KIND == KV_INT4) d -= 8 * s_qsum[rq];
            const float ksc = (KIND == KV_INT4 && j >= HALF) ? ks_hi : ks_lo;
            sc[rq * bl + i] = ((float)d * s_qscale[rq]) * ksc;
          }
        }
      }
    } else {
      // a warp owns row i and its lanes 4 values each, loading ROWS rows ahead
      for (int i0 = warp; i0 < bl; i0 += WARPS * ROWS) {
        typename RowWord<KIND>::T kw[ROWS] = {};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r * WARPS;
          if (i < live) kw[r] = word(a.k, i);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r * WARPS;
          if (i >= bl) break;
          const int c_min = (i < live) ? max(0, l0 + i - pos) : a.C;
          for (int rr = lane; rr < c_min * NQ; rr += 32) sc[rr * bl + i] = NEG_INF;
          float kv[4];
          word_floats<KIND>(kw[r], kv);
          for (int c = c_min; c < a.C; ++c) {
#pragma unroll
            for (int j = 0; j < NQ; ++j) {
              const float4 q4 = *reinterpret_cast<const float4*>(&qf[(c * NQ + j) * HD + lane * 4]);
              const float qv4[4] = {q4.x, q4.y, q4.z, q4.w};
              float t = 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e) t += qv4[e] * kv[e];
              t = warp_sum(t);
              if (lane == 0) sc[(c * NQ + j) * bl + i] = t;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- phase 2: online-softmax statistics, v_scale fold, P requant
    for (int r = warp; r < R; r += WARPS) {
      float* row = sc + (size_t)r * bl;
      const float* vrow = vsc + ((KIND == KV_INT4 && r % NQ >= HALF) ? bl : 0);
      float mx = NEG_INF;
      for (int i = lane; i < bl; i += 32) mx = fmaxf(mx, row[i]);
      mx = warp_max(mx);
      const SoftmaxStep st = softmax_step(s_m[r], mx);
      float psum = 0.f, pmax = 0.f;
      for (int i = lane; i < bl; i += 32) {
        float p = expf(row[i] - st.m_safe);
        psum += p;
        if (INTK) {
          if (i < live) p = p * vrow[i];
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
          float q = rintf(row[i] / pscale);
          q = fminf(fmaxf(q, -127.0f), 127.0f);
          pq[(size_t)r * bl + i] = (int8_t)q;
        }
      }
      if (lane == 0) {
        s_l[r] = s_l[r] * st.corr + psum;
        s_m[r] = st.m_new;
        s_corr[r] = st.corr;
        s_pscale[r] = pscale;
      }
    }
    __syncthreads();

    // ---- phase 3: P @ V over the live rows, GROUP query rows per pass; a
    // warp takes rows warp, warp + WARPS, ... and loads ROWS V words ahead.
    // GROUP is a multiple of NQ, so row g0 + jj is unit member jj % NQ.
    for (int g0 = 0; g0 < R; g0 += GROUP) {
      const int gn = min(GROUP, R - g0);
      if constexpr (INTK) {
        int pa[GROUP][4];
#pragma unroll
        for (int jj = 0; jj < GROUP; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[jj][e] = 0;
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
            for (int jj = 0; jj < GROUP; ++jj) {
              if (jj < gn) {
                const int p = (int)pq[(size_t)(g0 + jj) * bl + i];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const uint32_t byte = (vw >> (8 * e)) & 0xFFu;
                  int val;
                  if (KIND == KV_INT4)
                    val = (NOOP ? (int)(int8_t)byte
                                : (int)(((jj % NQ) < HALF) ? (byte & 0xFu) : (byte >> 4))) - 8;
                  else
                    val = (int)(int8_t)byte;
                  pa[jj][e] += p * val;
                }
              }
            }
          }
        }
        int* redi = reinterpret_cast<int*>(red);
#pragma unroll
        for (int jj = 0; jj < GROUP; ++jj)
          if (jj < gn)
            reinterpret_cast<int4*>(redi + (warp * GROUP + jj) * HD)[lane] =
                make_int4(pa[jj][0], pa[jj][1], pa[jj][2], pa[jj][3]);
        __syncthreads();
        for (int jj = 0; jj < gn; ++jj) {
          int tot = 0;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) tot += redi[(w * GROUP + jj) * HD + tid];
          const int r = g0 + jj;
          const float part = (float)tot * s_pscale[r];
          acc[r * HD + tid] = acc[r * HD + tid] * s_corr[r] + part;
        }
      } else {
        float pa[GROUP][4];
#pragma unroll
        for (int jj = 0; jj < GROUP; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[jj][e] = 0.f;
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
            for (int jj = 0; jj < GROUP; ++jj) {
              if (jj < gn) {
                const float p = sc[(size_t)(g0 + jj) * bl + i];
#pragma unroll
                for (int e = 0; e < 4; ++e) pa[jj][e] += p * vv[e];
              }
            }
          }
        }
        float* redf = reinterpret_cast<float*>(red);
#pragma unroll
        for (int jj = 0; jj < GROUP; ++jj)
          if (jj < gn)
            reinterpret_cast<float4*>(redf + (warp * GROUP + jj) * HD)[lane] =
                make_float4(pa[jj][0], pa[jj][1], pa[jj][2], pa[jj][3]);
        __syncthreads();
        for (int jj = 0; jj < gn; ++jj) {
          float part = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) part += redf[(w * GROUP + jj) * HD + tid];
          const int r = g0 + jj;
          acc[r * HD + tid] = acc[r * HD + tid] * s_corr[r] + part;
        }
      }
      __syncthreads();  // red is rewritten by the next group, sc / pq by the next block
    }
  }

  for (int r = 0; r < R; ++r) {
    const float l = s_l[r];
    a.out[io_index(r) + tid] = (l > 0.f) ? acc[r * HD + tid] / fmaxf(l, 1e-20f) : 0.f;
  }
}

template <int KIND, int NQ, bool NOOP>
int launch(const MultiArgs& a, size_t smem, cudaStream_t st) {
  // dynamic shared memory above 48 KB needs an opt-in per kernel; raise it
  // whenever a call asks for more
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_multi_kernel<KIND, NQ, NOOP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int units = (KIND == KV_INT4) ? a.Hkv / 2 : a.Hkv;
  dim3 grid(units, a.S);
  decode_attn_multi_kernel<KIND, NQ, NOOP><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, bool NOOP = false>
int launch_nq(const MultiArgs& a, int nq, size_t smem, cudaStream_t st) {
  switch (nq) {
    case 1: return launch<KIND, 1, NOOP>(a, smem, st);
    case 2: return launch<KIND, 2, NOOP>(a, smem, st);
    case 4: return launch<KIND, 4, NOOP>(a, smem, st);
    case 8: return launch<KIND, 8, NOOP>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 int8, 1 packed int4, 2 bf16, 3 f32 cache, 4 packed int4 with the
// noop unpack. nq: query heads per block (rep, or 2*rep for int4); C
// candidates, C * nq <= 128. Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention_multi(const void* q, const void* k, const void* v,
                                               const void* ks, const void* vs, const int* pos,
                                               void* out, int q_bf16, int sc_bf16, int S, int C,
                                               int H, int Hkv, int L, int layer, int win, int bl,
                                               int row_stride, int kind, int nq, void* stream) {
  MultiArgs a;
  a.q = q; a.k = k; a.v = v; a.ks = ks; a.vs = vs; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16; a.sc_bf16 = sc_bf16;
  a.S = S; a.C = C; a.H = H; a.Hkv = Hkv; a.L = L; a.layer = layer; a.win = win; a.bl = bl;
  a.row_stride = row_stride;
  if (S <= 0) return 0;
  if (C < 1 || C * nq > MAX_ROWS || bl <= 0 || win % bl != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C * nq, bl);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case KV_INT8: return launch_nq<KV_INT8>(a, nq, smem, st);
    case KV_INT4: return launch_nq<KV_INT4>(a, nq, smem, st);
    case KV_BF16: return launch_nq<KV_BF16>(a, nq, smem, st);
    case KV_F32: return launch_nq<KV_F32>(a, nq, smem, st);
    case KV_INT4_NOOP: return launch_nq<KV_INT4, true>(a, nq, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
