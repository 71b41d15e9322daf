// Pieces shared by the decode-attention kernels (decode_attention_hopper.cu,
// decode_attention_grouped_hopper.cu): the block shape, the cache kinds,
// how one lane reads its four values of a query row, the per-row int8
// quantizer of q and the online-softmax step.
#pragma once

#include "common.cuh"

namespace tpuserve {
namespace attn {

constexpr int HD = 128;
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

// A lane's 4 consecutive values of a query row, f32 or bf16, from element i.
__device__ __forceinline__ void load_q4(const void* q, size_t i, int q_bf16, float (&qv)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    qv[c] = q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[i + c])
                   : reinterpret_cast<const float*>(q)[i + c];
}

// Symmetric int8 quantization of one query row of HD values held by one
// warp, 4 a lane (the TPU kernels' _quantize_q): scale = max(absmax / 127,
// 1e-10), code = clip(round half to even(x / scale), +-127). Writes the
// lane's 4 codes and returns the row's scale.
__device__ __forceinline__ float quantize_q4(const float (&qv)[4], int8_t (&code)[4]) {
  float am = fmaxf(fmaxf(fabsf(qv[0]), fabsf(qv[1])), fmaxf(fabsf(qv[2]), fabsf(qv[3])));
  am = warp_max(am);
  const float scale = fmaxf(am / 127.0f, 1e-10f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
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
