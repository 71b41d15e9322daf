// Pieces shared by the decode-attention kernels (attention_core.cuh,
// decode_attention_grouped_hopper.cu): the block shape, the cache kinds,
// how one lane reads its V values of a query row (head_dim / 32: 4 at
// head_dim 128, 8 at 256), the per-row int8 quantizer of q and the
// online-softmax step.
#pragma once

#include "common.cuh"

namespace tpuserve {
namespace attn {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

enum Kind { KV_INT8 = 0, KV_INT4 = 1, KV_BF16 = 2, KV_F32 = 3 };
// packed int4 under TPUSERVE_INT4_UNPACK=noop: a launch code, run by the
// KV_INT4 instances with their NOOP flag set
constexpr int KV_INT4_NOOP = 4;
// a flag added to the launch code under TPUSERVE_ATTN_DYNSKIP=0: read and
// mask the blocks past a slot's position instead of skipping them
constexpr int KV_READ_ALL = 16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A lane's V consecutive values of a query row, f32 or bf16, from element i.
template <int V>
__device__ __forceinline__ void load_qv(const void* q, size_t i, int q_bf16, float (&qv)[V]) {
#pragma unroll
  for (int c = 0; c < V; ++c)
    qv[c] = q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[i + c])
                   : reinterpret_cast<const float*>(q)[i + c];
}

// Symmetric int8 quantization of one query row of 32 * V values held by
// one warp, V a lane (the TPU kernels' _quantize_q: one scale over the whole
// head): scale = max(absmax / 127, 1e-10), code = clip(round half to
// even(x / scale), +-127). Writes the lane's V codes and returns the row's
// scale.
template <int V>
__device__ __forceinline__ float quantize_qv(const float (&qv)[V], int8_t (&code)[V]) {
  float am = fmaxf(fmaxf(fabsf(qv[0]), fabsf(qv[1])), fmaxf(fabsf(qv[2]), fabsf(qv[3])));
#pragma unroll
  for (int c = 4; c < V; c += 4)
    am = fmaxf(am, fmaxf(fmaxf(fabsf(qv[c]), fabsf(qv[c + 1])),
                         fmaxf(fabsf(qv[c + 2]), fabsf(qv[c + 3]))));
  am = warp_max(am);
  const float scale = fmaxf(am / 127.0f, 1e-10f);
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float r = rintf(qv[c] / scale);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    code[c] = (int8_t)r;
  }
  return scale;
}

// One online-softmax step of a query row over a block whose largest score
// is block_max: the new running max, the max that p = exp(s - m_safe) is
// taken against (finite for a fully masked row) and the factor that
// rescales the running sum and accumulators.
struct SoftmaxStep {
  float m_new, m_safe, corr;
};

__device__ __forceinline__ SoftmaxStep softmax_step(float m_prev, float block_max) {
  SoftmaxStep st;
  st.m_new = fmaxf(m_prev, block_max);
  st.m_safe = fmaxf(st.m_new, NEG_INF / 2);
  st.corr = expf(m_prev - st.m_safe);
  return st;
}

}  // namespace attn
}  // namespace tpuserve
