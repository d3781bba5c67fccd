// B5: fused image normalize, NHWC, in front of the vision tower.
//
// Replaces the Pallas kernel `_normalize_kernel` of
// intelligent_video_analysis_retrieval_system_tpu/ops/preprocess.py.
//
//   out[..., c] = (float(in[..., c]) * (1/255) - mean[c]) * (1/std[c])
//
// with the TPU kernel's arithmetic and order of operations: the pixel is
// multiplied by the f32 constant 1/255, the f32 mean is subtracted, the
// difference is multiplied by the f32 reciprocal of std (taken in double
// and rounded once by the wrapper), and the result is rounded once to the
// output type.  No sum is taken, so nothing can reorder: the kernel and its
// plain PyTorch version agree bit for bit.  The three steps use
// __fmul_rn / __fsub_rn so that the compiler cannot contract
// `x * (1/255) - mean` into one fused multiply-add, which rounds once where
// the plain version rounds twice.
//
// What bounds it on an H100: bytes.  One pass, each input element read once
// and each output element written once (a batch of 256 images of 224 x 224
// x 3 is 38.5 MB of uint8 in and 77.1 MB of bf16 out); eager PyTorch runs
// the same chain as five launches with four round trips through device
// memory.  The design: one thread per 8 consecutive elements, 8 or 32 bytes
// loaded and 16 or 32 bytes stored per thread with neighbouring threads on
// neighbouring addresses, in a grid-stride loop.  The channel of an element
// is its flat index modulo 3 (NHWC), so the constants are chosen per
// element, never per vector: a vector of 8 spans channels.
//
// Inputs uint8 or f32, outputs bf16 or f32.  Where a pointer is not 16-byte
// aligned the whole tensor takes the scalar loop that otherwise handles the
// last n % 8 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per thread and step
constexpr float kInv255 = (float)(1.0 / 255.0);

struct Consts {
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float pick(const float (&v)[3], int ch) {
  return ch == 0 ? v[0] : (ch == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float normalize_one(float x, float mean, float inv_std) {
  return __fmul_rn(__fsub_rn(__fmul_rn(x, kInv255), mean), inv_std);
}

__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

__device__ __forceinline__ void load8(const uint8_t* p, float (&x)[kVec]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = (float)((r.x >> (8 * j)) & 0xffu);
    x[4 + j] = (float)((r.y >> (8 * j)) & 0xffu);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store8(bf16* p, const float (&y)[kVec]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                                            pack2(y[4], y[5]), pack2(y[6], y[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&y)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
}

// n_vec: number of 8-element groups taken by the vector loop (0 when a
// pointer is misaligned); elements from 8 * n_vec on take the scalar loop.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const TIn* __restrict__ in, TOut* __restrict__ out, long long n,
                 long long n_vec, Consts c) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long v = first; v < n_vec; v += stride) {
    float x[kVec];
    load8(in + v * kVec, x);
    int ch = (int)((v * kVec) % 3);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      x[j] = normalize_one(x[j], pick(c.mean, ch), pick(c.inv_std, ch));
      ch = ch == 2 ? 0 : ch + 1;
    }
    store8(out + v * kVec, x);
  }
  for (long long e = n_vec * kVec + first; e < n; e += stride) {
    const int ch = (int)(e % 3);
    store_one(out + e, normalize_one(to_float(in[e]), pick(c.mean, ch), pick(c.inv_std, ch)));
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* in, void* out, long long n, const Consts& c,
                   cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n_vec = aligned ? n / kVec : 0;
  const long long work = n_vec + (n - n_vec * kVec);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  normalize_kernel<TIn, TOut><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), n, n_vec, c);
  return cudaGetLastError();
}

}  // namespace

// in: n contiguous elements whose innermost dimension is the 3 channels
// (n % 3 == 0); in_dtype: 0 = uint8, 1 = float32; out_dtype: 0 = bfloat16,
// 1 = float32.  mean and inv_std are the f32 constants of the three
// channels.  Returns the cudaError_t of the launch.
extern "C" int ivars_normalize(const void* in, void* out, long long n, int in_dtype,
                               int out_dtype, float mean0, float mean1, float mean2,
                               float inv_std0, float inv_std1, float inv_std2,
                               void* stream) {
  if (n <= 0 || n % 3 != 0) return (int)cudaErrorInvalidValue;
  const Consts c = {{mean0, mean1, mean2}, {inv_std0, inv_std1, inv_std2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return (int)launch<uint8_t, bf16>(in, out, n, c, s);
  if (in_dtype == 0 && out_dtype == 1) return (int)launch<uint8_t, float>(in, out, n, c, s);
  if (in_dtype == 1 && out_dtype == 0) return (int)launch<float, bf16>(in, out, n, c, s);
  if (in_dtype == 1 && out_dtype == 1) return (int)launch<float, float>(in, out, n, c, s);
  return (int)cudaErrorInvalidValue;
}
