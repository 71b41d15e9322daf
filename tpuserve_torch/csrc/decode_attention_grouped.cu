// Grouped decode attention over a bf16 or f32 [S, L, Hkv, HD] cache view
// (the TPUSERVE_DECODE_ATTN=grouped path of the decode step; int8 and
// packed int4 windows take decode_attention_grouped_hopper.cu).
//
// Replaces tpuserve/ops/decode_attention.py::_kernel (entry
// decode_attention) for float caches. It computes what that kernel
// computes, in order:
//   - an f32 dot of q's own values (f32 or bf16) with the cache's, times
//     k_scale if given;
//   - positions past positions[slot] masked to -1e30;
//   - online softmax over blocks of bl rows: m_safe = max(m, -5e29),
//     p = exp(s - m_safe), l = l * corr + sum(p); blocks wholly past
//     positions[slot] are read and masked, or skipped with dynskip on
//     (TPUSERVE_ATTN_DYNSKIP=1); either way an inactive slot (-1) gives 0;
//   - p * v_scale (if given) rounded to bf16 (f32 cache: not rounded), times
//     V's values, accumulated in f32: acc = acc * corr + P @ V. No P
//     requant: this is not decode_attention.cu's arithmetic;
//   - out = acc / max(l, 1e-20) where l > 0, else 0.
// The TPU kernel serves g_kv kv heads per grid step with one dense dot and
// masks the mismatched head pairs to -1e30; those add exact zeros, so here a
// block serves g_kv kv heads one after another, each with its rep query
// heads, and g_kv only splits the work.
//
// Cache: k/v [S, L, Hkv, HD] bf16 or f32 with contiguous rows and a slot
// stride of its own (a window view of a longer cache is read in place).
// Scales, if any, [S, L, Hkv] f32 or bf16 with any strides. q [S, H, HD]
// f32 or bf16, scaled by 1/sqrt(HD); out [S, H, HD] f32.
//
// Bound on the H100: bytes. Each live K/V byte is used for 2 * rep
// operations. Design: one block of 4 warps per (slot, group of g_kv kv
// heads); the default g_kv = 1 gives S * Hkv blocks (2048 at Llama-2-7B
// widths and 64 slots). Scores (256 or 512 bytes a row, too many for one
// thread's registers): a warp owns a row and its lanes 4 values each,
// loading ROWS rows ahead, as the flat kernel does. P @ V: a warp takes
// rows warp, warp + 4, ..., loads ROWS of them ahead, a lane owns 4
// columns, and the 4 warps' partial sums meet in shared memory. With
// dynskip on, rows past positions[slot] are never read.
#include "attention_common.cuh"

namespace {

using namespace tpuserve::attn;
using tpuserve::warp_max;
using tpuserve::warp_sum;

constexpr int MAX_BL = 2048;  // ops/decode_attention.py's _GROUPED_MAX_BL

struct GroupedArgs {
  const void* q;       // [S, H, HD]
  const void* k;       // [S, L, Hkv, HD] view, slot stride slot_stride elements
  const void* v;
  const void* ks;      // [S, L, Hkv] view, or null
  const void* vs;
  const int* pos;      // [S], -1 = inactive
  float* out;          // [S, H, HD]
  int q_bf16, sc_bf16;
  int S, H, Hkv, L, bl, g_kv;
  int dynskip;         // 1: skip the blocks past pos; 0: read and mask them
  long long slot_stride;             // elements between slots of k and v
  long long ss_slot, ss_row, ss_head; // scale strides, elements
};

template <int KIND, int NQ>
__global__ void __launch_bounds__(THREADS) decode_attn_grouped_kernel(GroupedArgs a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float* sc = reinterpret_cast<float*>(dsm);  // [NQ][bl] scores, then P
  __shared__ __align__(16) float qf[NQ][HD];
  __shared__ __align__(16) float red[WARPS][NQ][HD];
  __shared__ float s_m[NQ], s_l[NQ], s_corr[NQ];

  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos[slot];
  const int bl = a.bl;
  const int n_blocks = a.L / bl;
  const size_t rstride = (size_t)a.Hkv * HD;  // elements between cache rows
  const bool scaled = a.ks != nullptr;

  for (int hh = 0; hh < a.g_kv; ++hh) {
    const int h = blockIdx.x * a.g_kv + hh;  // kv head; its query heads are h*NQ ..
    __syncthreads();                         // the previous head's readers are done

    // ---- q: its own values
    for (int j = warp; j < NQ; j += WARPS) {
      float qv[4];
      load_q4(a.q, ((size_t)slot * a.H + h * NQ + j) * HD + lane * 4, a.q_bf16, qv);
#pragma unroll
      for (int c = 0; c < 4; ++c) qf[j][lane * 4 + c] = qv[c];
    }
    if (tid < NQ) {
      s_m[tid] = NEG_INF;
      s_l[tid] = 0.f;
    }
    float acc[NQ];  // column tid of each query head
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
    __syncthreads();
    float qr[NQ][4];  // this lane's 4 values of each query head
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[j][c] = qf[j][lane * 4 + c];

    for (int jb = 0; jb < n_blocks && (!a.dynskip || jb * bl <= pos); ++jb) {
      const int l0 = jb * bl;
      const int live = min(bl, pos - l0 + 1);    // rows <= pos (may be <= 0 without the skip)
      const int nread = a.dynskip ? live : bl;   // rows read
      // element of (slot, l0, h, 0), and the scale of (slot, l0 + i, h) at
      // sc0 + i * ss_row
      const size_t row0 = (size_t)slot * a.slot_stride + (size_t)l0 * rstride + (size_t)h * HD;
      const size_t sc0 = (size_t)slot * a.ss_slot + (size_t)l0 * a.ss_row + (size_t)h * a.ss_head;

      // ---- phase 1: scores of every row of the block (dead rows masked);
      // a warp owns row i and its lanes 4 values each, ROWS rows loaded ahead
      for (int i0 = warp; i0 < bl; i0 += WARPS * ROWS) {
        typename RowWord<KIND>::T kw[ROWS] = {};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r * WARPS;
          if (i < nread) kw[r] = load_word<KIND>(a.k, row0 + (size_t)i * rstride, lane);
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
            for (int c = 0; c < 4; ++c) t += qr[j][c] * kv[c];
            s[j] = warp_sum(t);
          }
          if (lane == 0) {
            const float ksc = scaled ? load_scale(a.ks, sc0 + (size_t)i * a.ss_row, a.sc_bf16)
                                     : 1.f;
#pragma unroll
            for (int j = 0; j < NQ; ++j)
              sc[j * bl + i] = i >= live ? NEG_INF : (scaled ? s[j] * ksc : s[j]);
          }
        }
      }
      __syncthreads();

      // ---- phase 2: online-softmax statistics, v_scale fold, P rounding
      for (int j = warp; j < NQ; j += WARPS) {
        float* row = sc + (size_t)j * bl;
        float mx = NEG_INF;
        for (int i = lane; i < bl; i += 32) mx = fmaxf(mx, row[i]);
        mx = warp_max(mx);
        const SoftmaxStep st = softmax_step(s_m[j], mx);
        float psum = 0.f;
        for (int i = lane; i < bl; i += 32) {
          float p = expf(row[i] - st.m_safe);  // 0 for the masked rows
          psum += p;
          if (scaled && i < nread) p *= load_scale(a.vs, sc0 + (size_t)i * a.ss_row, a.sc_bf16);
          if (KIND != KV_F32) p = round_bf16(p);
          row[i] = p;
        }
        psum = warp_sum(psum);
        if (lane == 0) {
          s_l[j] = s_l[j] * st.corr + psum;
          s_m[j] = st.m_new;
          s_corr[j] = st.corr;
        }
      }
      __syncthreads();

      // ---- phase 3: P @ V over the live rows
      float pa[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) pa[j][c] = 0.f;
      for (int i0 = warp; i0 < nread; i0 += WARPS * ROWS) {
        typename RowWord<KIND>::T vws[ROWS] = {};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r * WARPS;
          if (i < nread) vws[r] = load_word<KIND>(a.v, row0 + (size_t)i * rstride, lane);
        }
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
        *reinterpret_cast<float4*>(&red[warp][j][lane * 4]) =
            make_float4(pa[j][0], pa[j][1], pa[j][2], pa[j][3]);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float part = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) part += red[w][j][tid];
        acc[j] = acc[j] * s_corr[j] + part;
      }
      __syncthreads();  // sc and red are rewritten by the next block
    }

#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float l = s_l[j];
      a.out[((size_t)slot * a.H + h * NQ + j) * HD + tid] =
          (l > 0.f) ? acc[j] / fmaxf(l, 1e-20f) : 0.f;
    }
  }
}

template <int KIND, int NQ>
int launch(const GroupedArgs& a, cudaStream_t st) {
  const size_t smem = (size_t)NQ * a.bl * sizeof(float);
  // dynamic shared memory above 48 KB needs an opt-in per kernel; raise it
  // whenever a call asks for more
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_grouped_kernel<KIND, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 grid(a.Hkv / a.g_kv, a.S);
  decode_attn_grouped_kernel<KIND, NQ><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_nq(const GroupedArgs& a, int nq, cudaStream_t st) {
  switch (nq) {
    case 1: return launch<KIND, 1>(a, st);
    case 2: return launch<KIND, 2>(a, st);
    case 4: return launch<KIND, 4>(a, st);
    case 8: return launch<KIND, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 2 bf16, 3 f32 cache. nq: query heads per kv head (rep). kind +
// KV_READ_ALL (the JAX package's default for this kernel,
// TPUSERVE_ATTN_DYNSKIP=0) reads and masks the blocks past a slot's
// position; without it they are skipped; the output is the same. Returns a
// cudaError_t code.
extern "C" int tpuserve_decode_attention_grouped(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, const int* pos,
    void* out, int q_bf16, int sc_bf16, int S, int H, int Hkv, int L, int bl, int g_kv,
    long long slot_stride, long long ss_slot, long long ss_row, long long ss_head, int kind,
    int nq, void* stream) {
  GroupedArgs a;
  a.q = q; a.k = k; a.v = v; a.ks = ks; a.vs = vs; a.pos = pos; a.out = (float*)out;
  a.q_bf16 = q_bf16; a.sc_bf16 = sc_bf16;
  a.S = S; a.H = H; a.Hkv = Hkv; a.L = L; a.bl = bl; a.g_kv = g_kv;
  a.dynskip = !(kind & KV_READ_ALL);
  kind &= ~KV_READ_ALL;
  a.slot_stride = slot_stride; a.ss_slot = ss_slot; a.ss_row = ss_row; a.ss_head = ss_head;
  if (S <= 0) return 0;
  if (bl <= 0 || bl > MAX_BL || L % bl != 0 || g_kv <= 0 || Hkv % g_kv != 0 || H != Hkv * nq)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case KV_BF16: return launch_nq<KV_BF16>(a, nq, st);
    case KV_F32: return launch_nq<KV_F32>(a, nq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
