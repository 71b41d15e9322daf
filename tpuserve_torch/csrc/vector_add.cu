// Device smoke kernel: out = a + b over two 1-D tensors of any length and
// one of the seven dtypes the JAX function adds with x64 off: float32,
// bfloat16, float16, int32, int16, int8, uint8. Integers wrap in two's
// complement, as XLA's add does; each float result is the correctly
// rounded sum (bf16 and f16 add in f32 and round once to nearest even,
// which is exact rounding for these formats, and is what torch.add does).
//
// Replaces tpuserve/device/smoke.py::_add_kernel (the Pallas form of the
// reference server's only CUDA kernel, addVectors). It is the first kernel
// chip_smoke.py builds and checks.
//
// Bound on the H100: bytes. Each element reads two inputs and writes one
// output (12 bytes an f32 element, 6 bf16) with one add, so the card's
// memory rate is the limit: 0.0036 ms for 1M f32 at 3.35 TB/s. Design (the
// vector route, taken when a, b and out share one alignment modulo 16):
//   - 16-byte loads (ld.global.nc with L1::no_allocate) and 16-byte
//     streaming stores (st.global.cs): every byte is used once;
//   - a grid of whole waves: SM count x waves blocks of 256 threads, about
//     one vector a thread up to the card's 8 resident blocks an SM, each
//     block walking its own contiguous share of the vectors (32-bit
//     offsets from 64-bit bases: a few instructions less before the first
//     load, which shows in a 5-microsecond call), so every SM gets the same
//     bytes; a longer array loops with UNROLL vectors of each input in
//     flight a thread, all loads issued before the first add;
//   - a scalar head of at most 15 bytes brings the pointers to a 16-byte
//     boundary, and a scalar tail finishes the last partial vector (block
//     0's first threads take both).
// Pointers of different alignments (a[1:] + b[3:]) take the scalar route:
// one element a thread, grid-stride. The wrapper
// (tpuserve_torch/device/smoke.py) picks the route and allocates out with
// a's alignment.
#include "common.cuh"

#include <cuda_fp16.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;           // 16-byte vectors of each input in flight a thread
constexpr int MAX_WAVES = 8;        // resident 256-thread blocks an SM

enum Dtype { F32 = 0, BF16 = 1, F16 = 2, I32 = 3, I16 = 4, I8 = 5, U8 = 6 };

// one element, and one 32-bit word of packed elements, of each dtype
template <int D> struct Add;
template <> struct Add<F32> {
  using T = float;
  __device__ static T elem(T a, T b) { return a + b; }
  __device__ static uint32_t word(uint32_t a, uint32_t b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};
template <> struct Add<BF16> {
  using T = __nv_bfloat16;
  __device__ static T elem(T a, T b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static uint32_t word(uint32_t a, uint32_t b) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
    __nv_bfloat162 r = __float22bfloat162_rn(make_float2(fa.x + fb.x, fa.y + fb.y));
    return *reinterpret_cast<uint32_t*>(&r);
  }
};
template <> struct Add<F16> {
  using T = __half;
  __device__ static T elem(T a, T b) { return __float2half_rn(__half2float(a) + __half2float(b)); }
  __device__ static uint32_t word(uint32_t a, uint32_t b) {
    const float2 fa = __half22float2(*reinterpret_cast<const __half2*>(&a));
    const float2 fb = __half22float2(*reinterpret_cast<const __half2*>(&b));
    __half2 r = __float22half2_rn(make_float2(fa.x + fb.x, fa.y + fb.y));
    return *reinterpret_cast<uint32_t*>(&r);
  }
};
template <> struct Add<I32> {
  using T = uint32_t;  // two's complement: the unsigned sum wraps alike
  __device__ static T elem(T a, T b) { return a + b; }
  __device__ static uint32_t word(uint32_t a, uint32_t b) { return a + b; }
};
template <> struct Add<I16> {
  using T = uint16_t;
  __device__ static T elem(T a, T b) { return (T)(a + b); }
  __device__ static uint32_t word(uint32_t a, uint32_t b) { return __vadd2(a, b); }
};
template <> struct Add<I8> {  // int8 and uint8: the same bits
  using T = uint8_t;
  __device__ static T elem(T a, T b) { return (T)(a + b); }
  __device__ static uint32_t word(uint32_t a, uint32_t b) { return __vadd4(a, b); }
};

__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void store_once(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// a, b and out share one alignment: `head` scalar elements bring them to
// 16 bytes, then nvec whole vectors, `per` a block (a multiple of 8, so
// that a block's share is whole 128-byte lines; computed on the host, which
// keeps a 64-bit division out of the kernel's start), then a scalar tail
template <int D>
__global__ void __launch_bounds__(THREADS)
vector_add_vec_kernel(const void* __restrict__ a_, const void* __restrict__ b_,
                      void* __restrict__ out_, long long n, int head, long long nvec,
                      long long per) {
  using A = Add<D>;
  using T = typename A::T;
  constexpr int V = 16 / sizeof(T);  // elements a vector
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* out = static_cast<T*>(out_);
  const long long tail0 = head + nvec * V;
  const int edge = head + (int)(n - tail0);  // head and tail elements, fewer than 2 V
  if (blockIdx.x == 0 && threadIdx.x < edge) {
    const long long i = threadIdx.x < head ? threadIdx.x : tail0 + (threadIdx.x - head);
    out[i] = A::elem(a[i], b[i]);
  }
  // the block's share from 64-bit bases, walked with 32-bit offsets
  const long long v0 = blockIdx.x * per;
  if (v0 >= nvec) return;
  const unsigned cnt = (unsigned)(per < nvec - v0 ? per : nvec - v0);
  const uint4* va = reinterpret_cast<const uint4*>(a + head) + v0;
  const uint4* vb = reinterpret_cast<const uint4*>(b + head) + v0;
  uint4* vo = reinterpret_cast<uint4*>(out + head) + v0;
  for (unsigned v = threadIdx.x; v < cnt; v += THREADS * UNROLL) {
    uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (v + j * THREADS < cnt) {
        ra[j] = load_once(va + v + j * THREADS);
        rb[j] = load_once(vb + v + j * THREADS);
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (v + j * THREADS < cnt) {
        const uint4 r = make_uint4(A::word(ra[j].x, rb[j].x), A::word(ra[j].y, rb[j].y),
                                   A::word(ra[j].z, rb[j].z), A::word(ra[j].w, rb[j].w));
        store_once(vo + v + j * THREADS, r);
      }
    }
  }
}

// pointers of different alignments: one element a thread, grid-stride
template <int D>
__global__ void __launch_bounds__(THREADS)
vector_add_scalar_kernel(const void* __restrict__ a_, const void* __restrict__ b_,
                         void* __restrict__ out_, long long n) {
  using A = Add<D>;
  using T = typename A::T;
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* out = static_cast<T*>(out_);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    out[i] = A::elem(a[i], b[i]);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int D>
int launch(const void* a, const void* b, void* out, long long n, int route, cudaStream_t st) {
  using T = typename Add<D>::T;
  constexpr long long V = 16 / sizeof(T);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (route == 1) {
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > (long long)sms * MAX_WAVES) blocks = (long long)sms * MAX_WAVES;
    vector_add_scalar_kernel<D><<<(unsigned)blocks, THREADS, 0, st>>>(a, b, out, n);
    return (int)cudaGetLastError();
  }
  const uintptr_t mis = reinterpret_cast<uintptr_t>(out) & 15;
  if ((reinterpret_cast<uintptr_t>(a) & 15) != mis || (reinterpret_cast<uintptr_t>(b) & 15) != mis ||
      mis % sizeof(T))
    return (int)cudaErrorInvalidValue;
  long long head = (long long)((16 - mis) & 15) / (long long)sizeof(T);
  if (head > n) head = n;
  const long long nvec = (n - head) / V;
  // about one vector a thread while the card's resident threads suffice, in
  // whole waves once every SM has a block; past MAX_WAVES a thread loops
  const long long wave = (long long)sms * THREADS;
  long long blocks;
  if (nvec < wave) {
    blocks = (nvec + THREADS - 1) / THREADS;
    if (blocks < 1) blocks = 1;
  } else {
    const long long waves = (nvec + wave - 1) / wave;
    blocks = sms * (waves < MAX_WAVES ? waves : MAX_WAVES);
  }
  const long long per = ((nvec + blocks - 1) / blocks + 7) / 8 * 8;
  vector_add_vec_kernel<D><<<(unsigned)blocks, THREADS, 0, st>>>(a, b, out, n, (int)head, nvec,
                                                                 per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* tpuserve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[i] = a[i] + b[i] for n elements of `dtype` (0 float32, 1 bfloat16,
// 2 float16, 3 int32, 4 int16, 5 int8, 6 uint8). route 0: 16-byte vectors
// after a scalar head, a, b and out sharing one alignment modulo 16
// (refused otherwise); route 1: one element a thread. Returns a
// cudaError_t code.
extern "C" int tpuserve_vector_add(const void* a, const void* b, void* out, long long n,
                                   int dtype, int route, void* stream) {
  if (n <= 0) return 0;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch<F32>(a, b, out, n, route, st);
    case BF16: return launch<BF16>(a, b, out, n, route, st);
    case F16: return launch<F16>(a, b, out, n, route, st);
    case I32: return launch<I32>(a, b, out, n, route, st);
    case I16: return launch<I16>(a, b, out, n, route, st);
    case I8:
    case U8: return launch<I8>(a, b, out, n, route, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
