// Speculative-verification decode attention over a bf16 or f32 cache: C
// candidate queries per slot over ONE read of the flat multi-layer KV
// cache, in place at a layer offset.
//
// Replaces tpuserve/ops/decode_attention.py::_wide_multi_kernel (entry
// decode_attention_wide_cache_multi) for float caches; the int8 and packed
// int4 caches take the Hopper core, decode_attention_hopper.cu. Candidate c
// of slot s is the token at position positions[s] + c; its K/V is already
// in the cache, and it attends to every row <= positions[s] + c. Inactive
// slots (positions = -1) give 0 for candidate 0 and garbage for the rest,
// which the caller masks.
//
// Cache as decode_attention.cu (flat form): k/v [n_layers, S, L, W] bf16 or
// f32. q [S, C, H, HD] f32 or bf16, scaled by 1/sqrt(HD); out [S, C, H, HD]
// f32. Numerics are decode_attention.cu's, row by row, so that row (s, c)
// equals the flat kernel at positions[s] + c up to the order of float sums
// (in practice bitwise). A block runs while it holds a row <= positions[s]
// + C - 1; row c masks the rows past positions[s] + c. With dynskip off
// (TPUSERVE_ATTN_DYNSKIP=0) every block is read and every row scored, and
// the rows past them masked: exact zeros, the same output.
//
// Bound on the H100: bytes, as the flat kernel; each live K/V value is read
// from device memory once for all C candidates. Design: the flat kernel's
// block per (kv head, slot), widened from NQ query rows to R = C*NQ. C is
// a run-time bound, so per-row state lives in shared memory (q, scores and
// P, the accumulators). Scores: a warp owns a row and its lanes 4 values
// each. P@V runs over groups of GROUP query rows, the register
// accumulators of one group at a time, warps loading ROWS V rows ahead;
// each group reads the block's V rows again, from L1 or L2.
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
  const int* pos;      // [S], candidate 0's position, -1 = inactive
  float* out;          // [S, C, H, HD]
  int q_bf16;
  int S, C, H, Hkv, L, layer, win, bl;
  int row_stride;      // elements per cache row
  int dynskip;         // 1: skip the blocks past the last row; 0: read and mask them
};

// Dynamic shared memory, in this order (ops/decode_attention.py's
// multi_smem_bytes computes the same size): q [R][HD] f32, the P@V
// reduction [WARPS][GROUP][HD] f32, accumulators [R][HD] f32 (the three
// read in 16-byte vectors, so they come first), scores then P [R][bl] f32.
__host__ __device__ inline size_t smem_bytes(int rows, int bl) {
  return (size_t)rows * HD * 4 + (size_t)WARPS * GROUP * HD * 4 + (size_t)rows * HD * 4 +
         (size_t)rows * bl * 4;
}

template <int KIND, int NQ>
__global__ void __launch_bounds__(THREADS) decode_attn_multi_kernel(MultiArgs a) {
  const int R = a.C * NQ;       // query rows of the block: row r = c * NQ + j
  const int bl = a.bl;
  extern __shared__ __align__(16) unsigned char dsm[];
  float* qf = reinterpret_cast<float*>(dsm);
  float* red = qf + (size_t)R * HD;
  float* acc = red + (size_t)WARPS * GROUP * HD;
  float* sc = acc + (size_t)R * HD;
  __shared__ float s_m[MAX_ROWS], s_l[MAX_ROWS], s_corr[MAX_ROWS];

  const int u = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos[slot];
  const int last = pos + a.C - 1;  // the last row any candidate sees

  auto io_index = [&](int r) -> size_t {  // element of row r's first value in q and out
    return (((size_t)slot * a.C + r / NQ) * a.H + u * NQ + r % NQ) * HD;
  };

  // ---- q rounded to the cache's type
  for (int r = warp; r < R; r += WARPS) {
    float qv[4];
    load_q4(a.q, io_index(r) + lane * 4, a.q_bf16, qv);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qf[r * HD + lane * 4 + c] = (KIND == KV_BF16) ? round_bf16(qv[c]) : qv[c];
  }
  for (int r = tid; r < R; r += THREADS) {
    s_m[r] = NEG_INF;
    s_l[r] = 0.f;
  }
  for (int i = tid; i < R * HD; i += THREADS) acc[i] = 0.f;  // column i % HD == tid
  __syncthreads();

  const size_t unit_off = (size_t)u * HD;
  const int n_blocks = a.win / bl;
  for (int jb = 0; jb < n_blocks && (!a.dynskip || jb * bl <= last); ++jb) {
    const int l0 = jb * bl;
    const int live = min(bl, last - l0 + 1);   // rows any candidate sees (may be <= 0)
    const int nread = a.dynskip ? live : bl;   // rows read
    const size_t blk_row = ((size_t)a.layer * a.S + slot) * a.L + l0;

    auto word = [&](const void* base, int i) {
      return load_word<KIND>(base, (blk_row + i) * (size_t)a.row_stride + unit_off, lane);
    };

    // ---- phase 1: scores of every (row, candidate). Candidate c sees block
    // row i iff l0 + i <= pos + c; the rows of candidates before c_min are
    // masked. A warp owns row i and its lanes 4 values each, loading ROWS
    // rows ahead.
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
        const int c_min = (i < live) ? max(0, l0 + i - pos) : a.C;
        const int c_from = a.dynskip ? c_min : 0;
        for (int rr = lane; rr < c_from * NQ; rr += 32) sc[rr * bl + i] = NEG_INF;
        float kv[4];
        word_floats<KIND>(kw[r], kv);
        for (int c = c_from; c < a.C; ++c) {
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float4 q4 = *reinterpret_cast<const float4*>(&qf[(c * NQ + j) * HD + lane * 4]);
            const float qv4[4] = {q4.x, q4.y, q4.z, q4.w};
            float t = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) t += qv4[e] * kv[e];
            t = warp_sum(t);
            if (lane == 0) sc[(c * NQ + j) * bl + i] = c >= c_min ? t : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // ---- phase 2: online-softmax statistics, P rounded to the cache's type
    for (int r = warp; r < R; r += WARPS) {
      float* row = sc + (size_t)r * bl;
      float mx = NEG_INF;
      for (int i = lane; i < bl; i += 32) mx = fmaxf(mx, row[i]);
      mx = warp_max(mx);
      const SoftmaxStep st = softmax_step(s_m[r], mx);
      float psum = 0.f;
      for (int i = lane; i < bl; i += 32) {
        float p = expf(row[i] - st.m_safe);
        psum += p;
        row[i] = (KIND == KV_BF16) ? round_bf16(p) : p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        s_l[r] = s_l[r] * st.corr + psum;
        s_m[r] = st.m_new;
        s_corr[r] = st.corr;
      }
    }
    __syncthreads();

    // ---- phase 3: P @ V over the live rows, GROUP query rows per pass; a
    // warp takes rows warp, warp + WARPS, ... and loads ROWS V words ahead.
    for (int g0 = 0; g0 < R; g0 += GROUP) {
      const int gn = min(GROUP, R - g0);
      float pa[GROUP][4];
#pragma unroll
      for (int jj = 0; jj < GROUP; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[jj][e] = 0.f;
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
          for (int jj = 0; jj < GROUP; ++jj) {
            if (jj < gn) {
              const float p = sc[(size_t)(g0 + jj) * bl + i];
#pragma unroll
              for (int e = 0; e < 4; ++e) pa[jj][e] += p * vv[e];
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < GROUP; ++jj)
        if (jj < gn)
          reinterpret_cast<float4*>(red + (warp * GROUP + jj) * HD)[lane] =
              make_float4(pa[jj][0], pa[jj][1], pa[jj][2], pa[jj][3]);
      __syncthreads();
      for (int jj = 0; jj < gn; ++jj) {
        float part = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) part += red[(w * GROUP + jj) * HD + tid];
        const int r = g0 + jj;
        acc[r * HD + tid] = acc[r * HD + tid] * s_corr[r] + part;
      }
      __syncthreads();  // red is rewritten by the next group, sc by the next block
    }
  }

  for (int r = 0; r < R; ++r) {
    const float l = s_l[r];
    a.out[io_index(r) + tid] = (l > 0.f) ? acc[r * HD + tid] / fmaxf(l, 1e-20f) : 0.f;
  }
}

template <int KIND, int NQ>
int launch(const MultiArgs& a, size_t smem, cudaStream_t st) {
  // dynamic shared memory above 48 KB needs an opt-in per kernel; raise it
  // whenever a call asks for more
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_multi_kernel<KIND, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 grid(a.Hkv, a.S);
  decode_attn_multi_kernel<KIND, NQ><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_nq(const MultiArgs& a, int nq, size_t smem, cudaStream_t st) {
  switch (nq) {
    case 1: return launch<KIND, 1>(a, smem, st);
    case 2: return launch<KIND, 2>(a, smem, st);
    case 4: return launch<KIND, 4>(a, smem, st);
    case 8: return launch<KIND, 8>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 2 bf16, 3 f32 cache (int8 and packed int4 take the Hopper core);
// ks, vs and sc_bf16 are not read. nq: query heads per block (rep); C
// candidates, C * nq <= 128. kind + KV_READ_ALL reads and masks the blocks
// past the last row any candidate sees (TPUSERVE_ATTN_DYNSKIP=0); the output
// is the same. Returns a cudaError_t code.
extern "C" int tpuserve_decode_attention_multi(const void* q, const void* k, const void* v,
                                               const void* ks, const void* vs, const int* pos,
                                               void* out, int q_bf16, int sc_bf16, int S, int C,
                                               int H, int Hkv, int L, int layer, int win, int bl,
                                               int row_stride, int kind, int nq, void* stream) {
  (void)ks; (void)vs; (void)sc_bf16;
  MultiArgs a;
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16;
  a.S = S; a.C = C; a.H = H; a.Hkv = Hkv; a.L = L; a.layer = layer; a.win = win; a.bl = bl;
  a.row_stride = row_stride;
  a.dynskip = !(kind & KV_READ_ALL);
  kind &= ~KV_READ_ALL;
  if (S <= 0) return 0;
  if (C < 1 || C * nq > MAX_ROWS || bl <= 0 || win % bl != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C * nq, bl);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {  // int8 and packed int4: decode_attention_hopper.cu
    case KV_BF16: return launch_nq<KV_BF16>(a, nq, smem, st);
    case KV_F32: return launch_nq<KV_F32>(a, nq, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
