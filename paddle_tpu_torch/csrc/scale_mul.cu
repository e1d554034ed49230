// K4: the custom-op door's user kernel, out = (x * y) * 2, elementwise.
//
// Replaces the Pallas kernel `_pallas_scale_mul` (tests/test_incubate.py:77,
// `pl.pallas_call` at :84), which enters the reference framework through
// `paddle_tpu/incubate/custom_op.py:34` `register_custom_op`.  Its backward
// is plain tensor code in both packages, not a kernel.
//
// Arithmetic: each element is widened to fp32, multiplied, doubled and
// rounded once to the input type.  A bf16 or f16 product is exact in fp32
// and doubling is exact, so the result equals the reference's (a product
// rounded to the input type, then doubled) wherever it is normal.  Built
// without --use_fast_math: subnormals are kept, not flushed.
//
// Bound on the H100: bytes.  The pass reads x and y and writes out once,
// 3 * n * itemsize bytes over 3.35 TB/s, and does 2 fp32 operations per
// element, far below the compute rate.  The design's answer is coalesced
// 16-byte accesses: when x, y and out are all 16-byte aligned every thread
// moves whole 16-byte vectors (neighbouring threads on neighbouring
// vectors) and the last n % (16 / itemsize) elements take a scalar tail;
// a misaligned operand (a view such as x[1:]) sends the whole pass down the
// scalar path.  A grid-stride loop with 64-bit indices keeps one block per
// resident slot (8 x 256 threads on each SM) and covers any n.
//
// C interface (bound with ctypes by ops/_build.py):
//   int ptt_scale_mul(int dtype, const void* x, const void* y, void* out,
//                     long long n, void* stream)
//   dtype: 0 float32, 1 bfloat16, 2 float16.  Launches nothing for n <= 0.
//   Returns cudaGetLastError() after the launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 = the SM's 2048 resident threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ T scale_mul_one(T a, T b) {
  return from_f32<T>((to_f32(a) * to_f32(b)) * 2.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scale_mul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     T* __restrict__ out, long long n, long long n_vec) {
  constexpr int kPer = 16 / sizeof(T);  // elements in one 16-byte vector
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  const int4* xv = reinterpret_cast<const int4*>(x);
  const int4* yv = reinterpret_cast<const int4*>(y);
  int4* ov = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    int4 a = xv[i];
    int4 b = yv[i];
    int4 o;
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int k = 0; k < kPer; ++k) oe[k] = scale_mul_one(ae[k], be[k]);
    ov[i] = o;
  }
  // the scalar tail (or, misaligned, every element)
  for (long long i = n_vec * kPer + tid; i < n; i += stride)
    out[i] = scale_mul_one(x[i], y[i]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n,
           cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  const long long n_vec =
      (aligned16(x) && aligned16(y) && aligned16(out)) ? n / kPer : 0;
  const long long work = n_vec > 0 ? n_vec : n;  // items of the longer loop
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  scale_mul_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_scale_mul(int dtype, const void* x, const void* y,
                             void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, out, n, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, out, n, s);
    case 2:
      return launch<__half>(x, y, out, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
