// B2: int8 chunk-max sweep, phase 1 of the int8 capacity mode's search.
//
// Replaces the Pallas kernel `_int8_sweep_kernel` of
// intelligent_video_analysis_retrieval_system_tpu/ops/quant.py.
//
// out[c, j] = max over rows r of chunk c (128 rows) of  (float)(X[r] . Q[j]) * xs[r]
// with X and Q int8, the dot product accumulated in int32, and rows
// r >= n_valid, and rows whose tombstone byte is nonzero, at -inf.  Every
// product is at most 127^2, so the int32 sum is exact, and so is its
// float image while d < 1040 (768 in the index): the result equals the
// plain version (an f32 matmul of the same integers) bit for bit.  The one
// rounding is the f32 multiply by the row scale, as in the TPU kernel.
//
// What bounds it on an H100: the read of X.  10M x 768 int8 rows are
// 7.68 GB, which the card streams in about 2.3 ms at 3.35 TB/s; the output
// is (N/128) x B floats.  The tensor cores do 2x the bf16 rate on int8, so
// the products stay far below the read for every batch up to 64 queries.
//
// Design, B1's (chunk_max.cu) with the int8 tensor-core product: one block
// of 8 warps per 128-row chunk (no state carries between blocks, so
// 78,128 blocks at 10M rows keep all 132 SMs streaming); each warp owns 16
// rows and all the launch's queries (up to 64).  A thread reads 16
// contiguous bytes of each of its two rows per 64 columns, straight from
// device memory into registers (four 64-column steps in flight, with the
// evict-first hint: X is read once).  The dot product's k order is permuted
// so that those 16 bytes are exactly the thread's A-fragment elements of two
// `mma.sync.m16n8k32` s8 products; the query fragments use the same
// permutation, are read with 16-byte loads and stay in L1.  The chunk max is
// a warp-shuffle max over the fragment's rows, then an 8-warp meet in shared
// memory.  The wrapper launches once per 64 queries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;    // rows per chunk max (ops/topk.py CHUNK)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // 64-column steps whose loads are in flight together

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// c[0..3] += A (16x32 s8, row) . B (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragment map of m16n8k32 s8 (g = lane / 4, t = lane % 4; four int8 per
// register, the lowest k in the lowest byte): A holds row g at k = 4t..4t+3
// (a0) and 16+4t..16+4t+3 (a2), row g + 8 at the same k (a1, a3); B holds
// query g at k = 4t.. (b0) and 16+4t.. (b1); C holds rows g (c0, c1) and
// g + 8 (c2, c3) at queries 2t, 2t+1.  With 16 bytes = columns [16t, 16t+16)
// of a 64-column step loaded per row, product 0 takes columns 16t+{0..7}
// (.x as k 4t.., .y as k 16+4t..) and product 1 columns 16t+{8..15}
// (.z, .w): every column of the 64 is used once, by A and B alike.
template <int QG>
__global__ void __launch_bounds__(kThreads)
int8_chunk_max_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                      const int8_t* __restrict__ q, const int8_t* __restrict__ dead,
                      float* __restrict__ out, int d, int out_stride, long long n_valid) {
  constexpr int kGroups = QG / 8;
  __shared__ float red[kWarps][QG];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long chunk = blockIdx.x;
  const int q0 = blockIdx.y * QG;
  const long long row_a = chunk * kChunk + warp * 16 + g;
  const long long row_b = row_a + 8;
  const int8_t* xa = x + row_a * d;
  const int8_t* xb = x + row_b * d;
  const int8_t* qg = q + (long long)(q0 + g) * d;

  int acc[kGroups][4];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const int steps = (d + 63) / 64;
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
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const uint4 rq = col < d
            ? __ldg(reinterpret_cast<const uint4*>(qg + (long long)j * 8 * d + col))
            : make_uint4(0u, 0u, 0u, 0u);
        mma_s8(acc[j], ra[u].x, rb[u].x, ra[u].y, rb[u].y, rq.x, rq.y);
        mma_s8(acc[j], ra[u].z, rb[u].z, ra[u].w, rb[u].w, rq.z, rq.w);
      }
    }
  }

  // scale, then mask dead rows (past n_valid, or tombstoned) BEFORE the max:
  // a dead row must never lift its chunk above a live one
  const bool alive_a = row_a < n_valid && (dead == nullptr || dead[row_a] == 0);
  const bool alive_b = row_b < n_valid && (dead == nullptr || dead[row_b] == 0);
  const float sa = xs[row_a], sb = xs[row_b];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    float v0 = fmaxf(alive_a ? __fmul_rn((float)acc[j][0], sa) : neg_inf(),
                     alive_b ? __fmul_rn((float)acc[j][2], sb) : neg_inf());
    float v1 = fmaxf(alive_a ? __fmul_rn((float)acc[j][1], sa) : neg_inf(),
                     alive_b ? __fmul_rn((float)acc[j][3], sb) : neg_inf());
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {  // over g: the warp's 16 rows
      v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, s));
      v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, s));
    }
    if (g == 0) {
      red[warp][j * 8 + 2 * t4] = v0;
      red[warp][j * 8 + 2 * t4 + 1] = v1;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < QG; j += kThreads) {
    float m = red[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w][j]);
    out[chunk * out_stride + q0 + j] = m;
  }
}

template <int QG>
cudaError_t launch(const int8_t* x, const float* xs, const int8_t* q, const int8_t* dead,
                   float* out, long long n_pad, int d, int nq, int out_stride,
                   long long n_valid, cudaStream_t stream) {
  const dim3 grid((unsigned)(n_pad / kChunk), (unsigned)(nq / QG));
  int8_chunk_max_kernel<QG><<<grid, kThreads, 0, stream>>>(x, xs, q, dead, out, d,
                                                           out_stride, n_valid);
  return cudaGetLastError();
}

}  // namespace

// One sweep over the rows for nq queries (nq % 8 == 0, nq <= 64).  q points
// at the sweep's first query row, out at its first column of a row-major
// (n_pad / 128, out_stride) f32 matrix.  n_pad % 128 == 0, d % 16 == 0, x
// and q 16-byte aligned (checked by the Python wrapper).  dead may be null.
// Returns the cudaError_t of the launch.
extern "C" int ivars_int8_chunk_max(const void* x, const void* xs, const void* q,
                                    const void* dead, void* out, long long n_pad, int d,
                                    int nq, int out_stride, long long n_valid,
                                    void* stream) {
  if (n_pad % kChunk != 0 || n_pad <= 0 || d <= 0 || d % 16 != 0 || nq <= 0 ||
      nq % 8 != 0 || nq > 64 || out_stride < nq)
    return (int)cudaErrorInvalidValue;
  const int8_t* xx = static_cast<const int8_t*>(x);
  const float* ss = static_cast<const float*>(xs);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int8_t* dd = static_cast<const int8_t*>(dead);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest query group that divides nq: one pass over X when nq is a
  // power of two (the wrapper's buckets), a few otherwise
  if (nq % 64 == 0) return (int)launch<64>(xx, ss, qq, dd, o, n_pad, d, nq, out_stride, n_valid, s);
  if (nq % 32 == 0) return (int)launch<32>(xx, ss, qq, dd, o, n_pad, d, nq, out_stride, n_valid, s);
  if (nq % 16 == 0) return (int)launch<16>(xx, ss, qq, dd, o, n_pad, d, nq, out_stride, n_valid, s);
  return (int)launch<8>(xx, ss, qq, dd, o, n_pad, d, nq, out_stride, n_valid, s);
}
