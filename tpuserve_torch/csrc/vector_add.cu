// Device smoke kernel: out = a + b over float32 vectors of any length.
//
// Replaces tpuserve/device/smoke.py::_add_kernel (the Pallas form of the
// reference server's only CUDA kernel, addVectors). It is the first kernel
// chip_smoke.py builds and checks.
//
// Bound on the H100: bytes. Each element reads 8 bytes and writes 4, with
// one add, so the card's memory rate is the limit. Design: a grid-stride
// loop in which neighbouring threads touch neighbouring elements, so every
// warp load and store is one coalesced 128-byte transaction.
#include "common.cuh"

namespace {

__global__ void vector_add_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n; i += stride) out[i] = a[i] + b[i];
}

}  // namespace

extern "C" const char* tpuserve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int tpuserve_vector_add(const void* a, const void* b, void* out,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  vector_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, n);
  return (int)cudaGetLastError();
}
