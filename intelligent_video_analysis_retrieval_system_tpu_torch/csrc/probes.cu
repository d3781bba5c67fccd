// P1-P3: the bench probes (bench/probes.py), three measurements of how the
// card streams int8 rows.
//
// They replace the Pallas kernels of the JAX package's bench experiments:
// `_mxu_kernel` / `mxu_kernel` (P1) and `conv_kernel` (P2) of
// benchmarks/exp_int8.py, and `kernel` of benchmarks/exp_stream_bw.py (P3).
//
// P1  out[c, j] = max over rows r of chunk c (128 rows) of
//         (float)(X[r] . Q[j]) * xs[r]      X, Q int8, the dot in int32,
//     rows r >= n_valid at -inf.  No tombstones, and the query's own scale
//     is not applied (it commutes with the max and is applied outside).  It
//     computes B2's function (int8_sweep.cu) without the tombstone load, for
//     8 queries, in B2's first design (below); `rows_per_block` (128, 256,
//     512) is what the TPU kernel's tile was.
// P2  the same with the rows widened to bf16 in registers and a bf16 query:
//     bf16 products accumulated in f32 by `mma.sync.m16n8k16`.
// P3  reads every byte of x once and writes the first 8 x 128 elements of
//     the last tile as f32: the memory stream alone.
//
// What bounds them on an H100: the read of X (1.61 GB: 0.48 ms at 3.35
// TB/s).  P1 and P2 do 8 queries' products per row, far below the tensor
// cores' rate; P2 adds 16 int8 -> bf16 conversions per thread per 16 bytes
// on the CUDA cores, which is what it measures.
//
// Design of P1 and P2: the first designs of B1 and B2, before both moved to
// a TMA ring and `wgmma`.  One block of 8 warps walks `rows_per_block / 128`
// chunks; each warp owns 16 rows of the chunk; a thread reads 16 contiguous
// bytes of each of its two rows per 64 columns straight into registers (four
// steps in flight, evict-first: X is read once), and the dot product's k
// order is permuted so that those bytes are the thread's own A-fragment
// elements.  P2 widens the 16 bytes to eight bf16 pairs in registers: word w
// of the 16 bytes (columns 16t + 4w ..+3) feeds product w, its first two
// columns at k slots {2t, 2t+1} and its last two at {2t+8, 2t+9}, and the
// query's columns take the same slots (two 16-byte loads of the query row).
//
// Design of P3: a grid-stride loop of 16-byte evict-first loads, four in
// flight per thread, folded into a per-thread XOR that is stored only if it
// equals a value given at launch (so the loads cannot be dropped).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 128;    // rows per chunk max (ops/topk.py CHUNK)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // 64-column steps whose loads are in flight together
constexpr int kQueries = 8;    // the probes' query batch

// bytes `lo`, `lo + 1` of w (int8) -> packed bf16 pair, the lower byte in
// the lower half; |v| <= 128 is exact in bf16
__device__ __forceinline__ uint32_t widen2(uint32_t w, int lo) {
  const float f0 = (float)(int)(int8_t)(w >> (8 * lo));
  const float f1 = (float)(int)(int8_t)(w >> (8 * lo + 8));
  const __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// one 4-column word of both rows against the same columns of the query
__device__ __forceinline__ void mma_widened(float* c, uint32_t wa, uint32_t wb,
                                            uint32_t q0, uint32_t q1) {
  mma_bf16(c, widen2(wa, 0), widen2(wb, 0), widen2(wa, 2), widen2(wb, 2), q0, q1);
}

// scale and mask the thread's four scores, max over the chunk's 128 rows,
// write the chunk's 8 maxima (all threads of the block call this)
__device__ __forceinline__ void chunk_max_store(float s0, float s1, float s2, float s3,
                                                bool alive_a, bool alive_b,
                                                float (*red)[kQueries], float* out_row) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  float v0 = fmaxf(alive_a ? s0 : neg_inf(), alive_b ? s2 : neg_inf());
  float v1 = fmaxf(alive_a ? s1 : neg_inf(), alive_b ? s3 : neg_inf());
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) {  // over g: the warp's 16 rows
    v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, s));
    v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, s));
  }
  if (g == 0) {
    red[warp][2 * t4] = v0;
    red[warp][2 * t4 + 1] = v1;
  }
  __syncthreads();
  if (threadIdx.x < kQueries) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    out_row[threadIdx.x] = m;
  }
  __syncthreads();  // red is reused by the block's next chunk
}

// P1: int8 x int8 -> int32 on the tensor cores
__global__ void __launch_bounds__(kThreads)
probe_int8_mma_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                      const int8_t* __restrict__ q, float* __restrict__ out, int d,
                      long long n_valid, int chunks_per_block) {
  __shared__ float red[kWarps][kQueries];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int8_t* qg = q + (long long)g * d;
  const int steps = (d + 63) / 64;

  for (int c = 0; c < chunks_per_block; ++c) {
    const long long chunk = (long long)blockIdx.x * chunks_per_block + c;
    const long long row_a = chunk * kChunk + warp * 16 + g;
    const long long row_b = row_a + 8;
    const int8_t* xa = x + row_a * d;
    const int8_t* xb = x + row_b * d;
    int acc[4] = {0, 0, 0, 0};
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int col = (s0 + u) * 64 + 16 * t4;
        if (col < d) {  // d % 16 == 0: a 16-byte segment is all in or all out
          ra[u] = __ldcs(reinterpret_cast<const uint4*>(xa + col));
          rb[u] = __ldcs(reinterpret_cast<const uint4*>(xb + col));
        } else {
          ra[u] = rb[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int col = (s0 + u) * 64 + 16 * t4;
        const uint4 rq = col < d ? __ldg(reinterpret_cast<const uint4*>(qg + col))
                                 : make_uint4(0u, 0u, 0u, 0u);
        mma_s8(acc, ra[u].x, rb[u].x, ra[u].y, rb[u].y, rq.x, rq.y);
        mma_s8(acc, ra[u].z, rb[u].z, ra[u].w, rb[u].w, rq.z, rq.w);
      }
    }
    const float sa = xs[row_a], sb = xs[row_b];
    chunk_max_store(__fmul_rn((float)acc[0], sa), __fmul_rn((float)acc[1], sa),
                    __fmul_rn((float)acc[2], sb), __fmul_rn((float)acc[3], sb),
                    row_a < n_valid, row_b < n_valid, red, out + chunk * kQueries);
  }
}

// P2: int8 rows widened to bf16 in registers, bf16 x bf16 -> f32
__global__ void __launch_bounds__(kThreads)
probe_int8_convert_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                          const bf16* __restrict__ q, float* __restrict__ out, int d,
                          long long n_valid, int chunks_per_block) {
  __shared__ float red[kWarps][kQueries];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const bf16* qg = q + (long long)g * d;
  const int steps = (d + 63) / 64;

  for (int c = 0; c < chunks_per_block; ++c) {
    const long long chunk = (long long)blockIdx.x * chunks_per_block + c;
    const long long row_a = chunk * kChunk + warp * 16 + g;
    const long long row_b = row_a + 8;
    const int8_t* xa = x + row_a * d;
    const int8_t* xb = x + row_b * d;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int col = (s0 + u) * 64 + 16 * t4;
        if (col < d) {
          ra[u] = __ldcs(reinterpret_cast<const uint4*>(xa + col));
          rb[u] = __ldcs(reinterpret_cast<const uint4*>(xb + col));
        } else {
          ra[u] = rb[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int col = (s0 + u) * 64 + 16 * t4;
        uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
        if (col < d) {  // the query's 16 columns: 32 bytes
          q0 = __ldg(reinterpret_cast<const uint4*>(qg + col));
          q1 = __ldg(reinterpret_cast<const uint4*>(qg + col + 8));
        }
        mma_widened(acc, ra[u].x, rb[u].x, q0.x, q0.y);
        mma_widened(acc, ra[u].y, rb[u].y, q0.z, q0.w);
        mma_widened(acc, ra[u].z, rb[u].z, q1.x, q1.y);
        mma_widened(acc, ra[u].w, rb[u].w, q1.z, q1.w);
      }
    }
    const float sa = xs[row_a], sb = xs[row_b];
    chunk_max_store(__fmul_rn(acc[0], sa), __fmul_rn(acc[1], sa), __fmul_rn(acc[2], sb),
                    __fmul_rn(acc[3], sb), row_a < n_valid, row_b < n_valid, red,
                    out + chunk * kQueries);
  }
}

constexpr int kStreamThreads = 512;

__device__ __forceinline__ void fold(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// P3: the memory stream.  dtype: 0 = bf16, 1 = int8, 2 = int32 (only the
// 8 x 128 slice of the last tile is ever interpreted).
__global__ void __launch_bounds__(kStreamThreads)
probe_stream_kernel(const uint4* __restrict__ x, long long n_vec, const void* __restrict__ tile,
                    int d, int dtype, float* __restrict__ out, unsigned sentinel,
                    unsigned* __restrict__ scratch) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (; i + 3 * stride < n_vec; i += 4 * stride) {
    const uint4 a = __ldcs(x + i), b = __ldcs(x + i + stride);
    const uint4 c = __ldcs(x + i + 2 * stride), e = __ldcs(x + i + 3 * stride);
    fold(acc, a);
    fold(acc, b);
    fold(acc, c);
    fold(acc, e);
  }
  for (; i < n_vec; i += stride) fold(acc, __ldcs(x + i));
  const unsigned folded = acc.x ^ acc.y ^ acc.z ^ acc.w;
  if (folded == sentinel) scratch[0] = folded;  // keeps every load alive
  if (blockIdx.x == gridDim.x - 1) {  // the last block writes the probe slice
    for (int e = threadIdx.x; e < 8 * 128; e += blockDim.x) {
      const long long at = (long long)(e / 128) * d + e % 128;
      float v;
      if (dtype == 0) v = __bfloat162float(static_cast<const bf16*>(tile)[at]);
      else if (dtype == 1) v = (float)static_cast<const int8_t*>(tile)[at];
      else v = (float)static_cast<const int*>(tile)[at];
      out[e] = v;
    }
  }
}

bool bad_sweep_args(long long n_pad, int d, int rows_per_block) {
  return n_pad <= 0 || d <= 0 || d % 16 != 0 || rows_per_block <= 0 ||
         rows_per_block % kChunk != 0 || n_pad % rows_per_block != 0;
}

}  // namespace

// x (n_pad, d) int8, xs (n_pad,) f32, q (8, d) int8, out (n_pad / 128, 8)
// f32.  n_pad % rows_per_block == 0, rows_per_block % 128 == 0, d % 16 == 0,
// x and q 16-byte aligned (checked by the Python wrapper).  Returns the
// cudaError_t of the launch.
extern "C" int ivars_probe_int8_mma(const void* x, const void* xs, const void* q, void* out,
                                    long long n_pad, int d, int rows_per_block,
                                    long long n_valid, void* stream) {
  if (bad_sweep_args(n_pad, d, rows_per_block)) return (int)cudaErrorInvalidValue;
  probe_int8_mma_kernel<<<(unsigned)(n_pad / rows_per_block), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(q), static_cast<float*>(out), d, n_valid,
      rows_per_block / kChunk);
  return (int)cudaGetLastError();
}

// As above with q (8, d) bf16.
extern "C" int ivars_probe_int8_convert(const void* x, const void* xs, const void* q,
                                        void* out, long long n_pad, int d,
                                        int rows_per_block, long long n_valid,
                                        void* stream) {
  if (bad_sweep_args(n_pad, d, rows_per_block)) return (int)cudaErrorInvalidValue;
  probe_int8_convert_kernel<<<(unsigned)(n_pad / rows_per_block), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const bf16*>(q), static_cast<float*>(out), d, n_valid,
      rows_per_block / kChunk);
  return (int)cudaGetLastError();
}

// x: n_bytes (a multiple of 16, 16-byte aligned) read once by `blocks`
// blocks; tile: the first element of the last tile, rows of d elements of
// dtype (0 bf16, 1 int8, 2 int32), d >= 128; out (8, 128) f32; scratch one
// word.  Returns the cudaError_t of the launch.
extern "C" int ivars_probe_stream(const void* x, long long n_bytes, const void* tile, int d,
                                  int dtype, void* out, unsigned sentinel, void* scratch,
                                  int blocks, void* stream) {
  if (n_bytes <= 0 || n_bytes % 16 != 0 || d < 128 || dtype < 0 || dtype > 2 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  probe_stream_kernel<<<(unsigned)blocks, kStreamThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), n_bytes / 16, tile, d, dtype, static_cast<float*>(out),
      sentinel, static_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}
