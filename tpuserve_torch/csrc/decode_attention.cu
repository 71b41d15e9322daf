// Single-token GQA decode attention over the flat multi-layer KV cache,
// read in place at a layer offset.
//
// Replaces tpuserve/ops/decode_attention.py::_wide_kernel (the
// decode_attention_wide_cache path, inline Q_wide) and ::_packed_kernel
// (several slots per block when the window is small; here that is the same
// kernel run with one L block covering the whole window, which is what a
// plain softmax over the row with one P requant amounts to).
//
// Cache: k/v [n_layers, S, L, W] (W = Hkv*hd values; int8, bf16 or f32) or
// packed int4 uint8 [n_layers, S, L, W/2] where byte d holds W-position d in
// its low nibble and W/2 + d in its high nibble (global split-half, biased
// by 8). Scales: this layer's [S, Hkv, L], bf16 or f32, head-major.
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
// Bound on the H100: bytes. Each cached K/V byte of a live position is
// used for 2*rep operations. Design: one block of 4 warps per (kv unit,
// slot). A kv unit is one kv head, or for packed int4 the head pair
// (h, h + Hkv/2) whose nibbles share bytes [h*hd, (h+1)*hd) of each row,
// so every byte is read once. One warp reads one 128-byte row segment at a
// time (coalesced), the rep query heads of the unit share each row read,
// and rows past positions[slot] are never read.
#include "common.cuh"

namespace {

using tpuserve::to_f32;
using tpuserve::warp_max;
using tpuserve::warp_sum;

constexpr int HD = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

enum Kind { KV_INT8 = 0, KV_INT4 = 1, KV_BF16 = 2, KV_F32 = 3 };

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
};

__device__ __forceinline__ float load_scale(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int KIND, int NQ>
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

  const size_t row0 = ((size_t)a.layer * a.S + slot) * a.L;  // first cache row of this slot
  const size_t unit_off = (size_t)u * HD;                    // elements (bytes for int4)
  const size_t sc_row = (size_t)slot * a.Hkv;                // scale rows of this slot

  const int n_blocks = a.win / bl;
  for (int jb = 0; jb < n_blocks && jb * bl <= pos; ++jb) {
    const int l0 = jb * bl;
    const int live = min(bl, pos - l0 + 1);

    // ---- phase 1: scores for every row of the block (dead rows masked)
    for (int i = warp; i < bl; i += WARPS) {
      if (i >= live) {
        if (lane < NQ) sc[lane * bl + i] = NEG_INF;
        continue;
      }
      const size_t off = (row0 + l0 + i) * (size_t)a.row_stride + unit_off;
      float s[NQ];
      if (INTK) {
        const uint32_t kw = *reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(a.k) + off + lane * 4);
        int d[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          if (KIND == KV_INT4) {
            const int nib = (int)((j < rep) ? (kw & 0x0F0F0F0Fu) : ((kw >> 4) & 0x0F0F0F0Fu));
            d[j] = __dp4a(qw[j], nib, 0) - 8 * qsum[j];
          } else {
            d[j] = __dp4a(qw[j], (int)kw, 0);
          }
          d[j] = warp_sum(d[j]);
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float ksc = load_scale(a.ks, (sc_row + kv_of(j)) * a.L + l0 + i, a.sc_bf16);
          s[j] = ((float)d[j] * s_qscale[j]) * ksc;
        }
      } else {
        float kv[4];
        if (KIND == KV_BF16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              reinterpret_cast<const __nv_bfloat16*>(a.k) + off + lane * 4);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int c = 0; c < 4; ++c) kv[c] = __bfloat162float(h[c]);
        } else {
          const float4 raw = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(a.k) + off + lane * 4);
          kv[0] = raw.x; kv[1] = raw.y; kv[2] = raw.z; kv[3] = raw.w;
        }
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
          if (i < live) p = p * load_scale(a.vs, (sc_row + kv_of(j)) * a.L + l0 + i, a.sc_bf16);
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

    // ---- phase 3: P @ V over the live rows; one warp per row
    if (INTK) {
      int pa[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) pa[j][c] = 0;
      for (int i = warp; i < live; i += WARPS) {
        const size_t off = (row0 + l0 + i) * (size_t)a.row_stride + unit_off;
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(a.v) + off + lane * 4);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int p = (int)pq[(size_t)j * bl + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t byte = (vw >> (8 * c)) & 0xFFu;
            int val;
            if (KIND == KV_INT4)
              val = (int)((j < rep) ? (byte & 0xFu) : (byte >> 4)) - 8;
            else
              val = (int)(int8_t)byte;
            pa[j][c] += p * val;
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
      for (int i = warp; i < live; i += WARPS) {
        const size_t off = (row0 + l0 + i) * (size_t)a.row_stride + unit_off;
        float vv[4];
        if (KIND == KV_BF16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              reinterpret_cast<const __nv_bfloat16*>(a.v) + off + lane * 4);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int c = 0; c < 4; ++c) vv[c] = __bfloat162float(h[c]);
        } else {
          const float4 raw = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(a.v) + off + lane * 4);
          vv[0] = raw.x; vv[1] = raw.y; vv[2] = raw.z; vv[3] = raw.w;
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float p = sc[(size_t)j * bl + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) pa[j][c] += p * vv[c];
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

template <int KIND, int NQ>
int launch(const AttnArgs& a, size_t smem, cudaStream_t st) {
  // static + dynamic shared memory above 48 KB needs an opt-in per kernel;
  // raise the opt-in whenever a larger window asks for more
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<KIND, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int units = (KIND == KV_INT4) ? a.Hkv / 2 : a.Hkv;
  dim3 grid(units, a.S);
  decode_attn_kernel<KIND, NQ><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_nq(const AttnArgs& a, int nq, size_t smem, cudaStream_t st) {
  switch (nq) {
    case 1: return launch<KIND, 1>(a, smem, st);
    case 2: return launch<KIND, 2>(a, smem, st);
    case 4: return launch<KIND, 4>(a, smem, st);
    case 8: return launch<KIND, 8>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 int8, 1 packed int4, 2 bf16, 3 f32 cache. nq: query heads per
// block (rep, or 2*rep for int4). Returns a cudaError_t code.
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
  if (S <= 0) return 0;
  const size_t smem = (size_t)nq * bl * (sizeof(float) + 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case KV_INT8: return launch_nq<KV_INT8>(a, nq, smem, st);
    case KV_INT4: return launch_nq<KV_INT4>(a, nq, smem, st);
    case KV_BF16: return launch_nq<KV_BF16>(a, nq, smem, st);
    case KV_F32: return launch_nq<KV_F32>(a, nq, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
