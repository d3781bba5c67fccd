// B1: chunk-max sweep, phase 1 of the exact top-k search.
//
// Replaces the Pallas kernels `_chunk_max_kernel` and
// `_chunk_max_masked_kernel` of
// intelligent_video_analysis_retrieval_system_tpu/ops/topk.py.
//
// out[c, b] = max over rows r of chunk c (128 rows) of  X[r] . Q[b]
// with rows r >= n_valid, and rows whose tombstone byte is nonzero, at -inf.
// Products of bf16 (or f32) values accumulate in f32.
//
// What bounds it on an H100: the read of X.  1M x 768 bf16 rows are 1.5 GB,
// which the card streams in about 0.46 ms at 3.35 TB/s; the output is only
// (N/128) x B floats.  The TPU kernel kept one grid step per 2048-row tile
// and walked them in order; here every 128-row chunk is an independent
// block (no state carries between blocks), so 7,824 blocks cover 1M rows
// and keep all 132 SMs streaming.
//
// bf16 (the index's dtype): tensor cores through `mma.sync.m16n8k16`, so
// the sweep stays bound by the read of X for every query batch up to 64.
// One block of 8 warps per 128-row chunk; each warp owns 16 rows and all
// the block's queries.  A thread reads 16 contiguous bytes of each of its
// two rows per 32 columns, straight from device memory into registers
// (four 32-column steps in flight, with the evict-first hint: X is read
// once).  The dot product's k order is permuted so that those 16 bytes are
// exactly the thread's A-fragment elements of two k16 steps; the query
// fragments use the same permutation (a sum does not depend on the order
// of its terms), are read with 16-byte loads and stay in L1.  The chunk max
// is a warp-shuffle max over the fragment's rows, then an 8-warp meet in
// shared memory.  Batches above 64 queries sweep X once per 64 (a group
// of 128 needs 130 registers a thread, one block per SM, and ran 2x slower
// than two sweeps of 64 on an H100).
//
// f32 (the index in parity mode): CUDA cores.  One block of 256 threads per
// (chunk, group of 8 or 16 queries): the chunk's 128 x 64 slab of X and the
// group's queries are staged in shared memory, every thread accumulates one
// row against half the group, then the same shuffle max and meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 128;    // rows per chunk max (ops/topk.py CHUNK)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kUnroll = 4;  // 32-column steps whose loads are in flight together

// c[0..3] += A (16x16 bf16, row) . B (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragment map of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8 at k = {2t, 2t+1} (a0, a1) and {2t+8, 2t+9} (a2, a3); B holds query
// g at the same k; C holds rows g (c0, c1) and g + 8 (c2, c3) at queries
// 2t, 2t+1.  With 16 bytes = columns [8t, 8t+8) of a 32-column step loaded
// per row, step 0 takes columns 8t+{0..3} and step 1 columns 8t+{4..7}:
// every column of the 32 is used once, by A and B alike.
template <int QG>
__global__ void __launch_bounds__(kThreads)
chunk_max_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ q,
                      const int8_t* __restrict__ dead, float* __restrict__ out,
                      int d, int b_pad, long long n_valid) {
  constexpr int kGroups = QG / 8;
  __shared__ float red[kWarps][QG];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long chunk = blockIdx.x;
  const int q0 = blockIdx.y * QG;
  const long long row_a = chunk * kChunk + warp * 16 + g;
  const long long row_b = row_a + 8;
  const bf16* xa = x + row_a * d;
  const bf16* xb = x + row_b * d;
  const bf16* qg = q + (long long)(q0 + g) * d;

  float acc[kGroups][4];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int steps = (d + 31) / 32;
  for (int s0 = 0; s0 < steps; s0 += kUnroll) {
    uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = (s0 + u) * 32 + 8 * t4;
      if (col < d) {  // d % 8 == 0: a 16-byte segment is all in or all out
        ra[u] = __ldcs(reinterpret_cast<const uint4*>(xa + col));
        rb[u] = __ldcs(reinterpret_cast<const uint4*>(xb + col));
      } else {
        ra[u] = rb[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = (s0 + u) * 32 + 8 * t4;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const uint4 rq = col < d
            ? __ldg(reinterpret_cast<const uint4*>(qg + (long long)j * 8 * d + col))
            : make_uint4(0u, 0u, 0u, 0u);
        mma_bf16(acc[j], ra[u].x, rb[u].x, ra[u].y, rb[u].y, rq.x, rq.y);
        mma_bf16(acc[j], ra[u].z, rb[u].z, ra[u].w, rb[u].w, rq.z, rq.w);
      }
    }
  }

  // mask dead rows (past n_valid, or tombstoned) BEFORE the max: a dead row
  // must never lift its chunk above a live one
  const bool alive_a = row_a < n_valid && (dead == nullptr || dead[row_a] == 0);
  const bool alive_b = row_b < n_valid && (dead == nullptr || dead[row_b] == 0);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    float v0 = fmaxf(alive_a ? acc[j][0] : neg_inf(), alive_b ? acc[j][2] : neg_inf());
    float v1 = fmaxf(alive_a ? acc[j][1] : neg_inf(), alive_b ? acc[j][3] : neg_inf());
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
    out[chunk * b_pad + q0 + j] = m;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSlab = 64;  // columns of X staged per step

template <int QG>
__global__ void __launch_bounds__(kThreads)
chunk_max_f32_kernel(const float* __restrict__ x, const float* __restrict__ q,
                     const int8_t* __restrict__ dead, float* __restrict__ out,
                     int d, int b_pad, long long n_valid) {
  constexpr int kQPT = QG / 2;                  // queries per thread
  __shared__ float xs[kChunk][kSlab + 1];       // +1: no bank conflicts on rows
  __shared__ __align__(16) float qs[kSlab][QG];
  __shared__ float red[kWarps][QG];

  const int tid = threadIdx.x;
  const long long chunk = blockIdx.x;
  const int q0 = blockIdx.y * QG;
  const int row = tid % kChunk;                 // row of the chunk this thread scores
  const int qoff = (tid / kChunk) * kQPT;       // first query of its half of the group
  const float* xchunk = x + chunk * kChunk * (long long)d;

  float acc[kQPT];
#pragma unroll
  for (int j = 0; j < kQPT; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kSlab) {
    // stage X[chunk rows, k0:k0+64], 16 bytes per load (d % 4 == 0)
    constexpr int kVecPerRow = kSlab / 4;
    for (int v = tid; v < kChunk * kVecPerRow; v += kThreads) {
      const int r = v / kVecPerRow;
      const int c = (v % kVecPerRow) * 4;
      const float4 e = k0 + c < d
          ? *reinterpret_cast<const float4*>(xchunk + (long long)r * d + k0 + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[r][c] = e.x;
      xs[r][c + 1] = e.y;
      xs[r][c + 2] = e.z;
      xs[r][c + 3] = e.w;
    }
    // stage Q[q0:q0+QG, k0:k0+64] transposed
    for (int v = tid; v < kSlab * QG; v += kThreads) {
      const int c = v / QG;
      const int j = v % QG;
      qs[c][j] = k0 + c < d ? q[(long long)(q0 + j) * d + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kSlab; ++c) {
      const float xv = xs[row][c];
      const float4* qv = reinterpret_cast<const float4*>(&qs[c][qoff]);
#pragma unroll
      for (int j = 0; j < kQPT / 4; ++j) {
        const float4 w = qv[j];
        acc[4 * j + 0] = fmaf(xv, w.x, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(xv, w.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(xv, w.z, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(xv, w.w, acc[4 * j + 3]);
      }
    }
    __syncthreads();
  }

  const long long grow = chunk * kChunk + row;
  const bool alive = grow < n_valid && (dead == nullptr || dead[grow] == 0);
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    float v = alive ? acc[j] : neg_inf();
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    acc[j] = v;
  }
  const int warp = tid / 32;
  if (tid % 32 == 0) {
#pragma unroll
    for (int j = 0; j < kQPT; ++j) red[warp][qoff + j] = acc[j];
  }
  __syncthreads();
  if (tid < QG) {
    // warps 0-3 hold queries [0, QG/2), warps 4-7 queries [QG/2, QG)
    const int w0 = (tid / kQPT) * (kChunk / 32);
    float m = red[w0][tid];
#pragma unroll
    for (int w = 1; w < kChunk / 32; ++w) m = fmaxf(m, red[w0 + w][tid]);
    out[chunk * b_pad + q0 + tid] = m;
  }
}

template <int QG>
cudaError_t launch_bf16(const void* x, const void* q, const int8_t* dead, float* out,
                        long long n_pad, int d, int b_pad, long long n_valid,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)(n_pad / kChunk), (unsigned)(b_pad / QG));
  chunk_max_bf16_kernel<QG><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(q), dead, out, d,
      b_pad, n_valid);
  return cudaGetLastError();
}

template <int QG>
cudaError_t launch_f32(const void* x, const void* q, const int8_t* dead, float* out,
                       long long n_pad, int d, int b_pad, long long n_valid,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)(n_pad / kChunk), (unsigned)(b_pad / QG));
  chunk_max_f32_kernel<QG><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(q), dead, out, d,
      b_pad, n_valid);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  n_pad % 128 == 0, b_pad % 8 == 0,
// d * sizeof(T) % 16 == 0, x and q 16-byte aligned (checked by the Python
// wrapper).  dead may be null.  Returns the cudaError_t of the launch.
extern "C" int ivars_chunk_max(const void* x, const void* q, const void* dead,
                               void* out, long long n_pad, int d, int b_pad,
                               long long n_valid, int dtype, void* stream) {
  if (n_pad % kChunk != 0 || b_pad % 8 != 0 || n_pad <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* dd = static_cast<const int8_t*>(dead);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {  // the largest query group (up to 64) that divides b_pad
    if (b_pad % 64 == 0) return (int)launch_bf16<64>(x, q, dd, o, n_pad, d, b_pad, n_valid, s);
    if (b_pad % 32 == 0) return (int)launch_bf16<32>(x, q, dd, o, n_pad, d, b_pad, n_valid, s);
    if (b_pad % 16 == 0) return (int)launch_bf16<16>(x, q, dd, o, n_pad, d, b_pad, n_valid, s);
    return (int)launch_bf16<8>(x, q, dd, o, n_pad, d, b_pad, n_valid, s);
  }
  if (dtype == 1) {
    return b_pad % 16 == 0
        ? (int)launch_f32<16>(x, q, dd, o, n_pad, d, b_pad, n_valid, s)
        : (int)launch_f32<8>(x, q, dd, o, n_pad, d, b_pad, n_valid, s);
  }
  return (int)cudaErrorInvalidValue;
}
