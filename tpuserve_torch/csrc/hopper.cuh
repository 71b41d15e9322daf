// Hopper building blocks shared by the kernels that stream tiles by TMA
// into an mbarrier ring and multiply them with wgmma (quant_matmul.cu,
// unpack_probes.cu): the barriers, the 2-D tensor copy, the wgmma fences,
// the shared-memory matrix descriptor and, on the host, the tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace tpuserve {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// The wgmma fences order registers, not memory: no memory clobber, so that
// the compiler may move shared-memory loads across them (the mbarrier waits
// and arrivals carry the clobbers that order the ring).
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N));
}
__device__ __forceinline__ void wg_wait0() { wg_wait<0>(); }
// keep the compiler from moving accumulator reads or writes across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]));
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]));
}

// K-major operand with 128-byte swizzle (the layout a TMA box of 128-byte
// rows lands in): rows of 128 bytes, 8-row atoms 1024 bytes apart (stride
// byte offset), start address in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// The same with 64-byte rows and the 64-byte swizzle: 8-row atoms 512 bytes
// apart (an 8-bit K-major operand of 64 values of K a row)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// ---- host: tensor maps (cuTensorMapEncodeTiled from libcuda, found with
// dlopen so that the library links against nothing but the runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// 2-D map over a row-major [outer, inner] array; false if the encoder
// refuses. Elements of a box past the array's edge arrive as zeros.
inline bool encode(CUtensorMap* m, CUtensorMapDataType dt, const void* ptr, uint64_t inner,
                   uint64_t outer, uint64_t row_bytes, uint32_t box_in, uint32_t box_out,
                   CUtensorMapSwizzle sw) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_in, box_out};
  const cuuint32_t es[2] = {1, 1};
  return fn(m, dt, 2, const_cast<void*>(ptr), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace tpuserve
