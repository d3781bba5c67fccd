// B1: chunk-max sweep, phase 1 of the exact top-k search.
//
// Replaces the Pallas kernels `_chunk_max_kernel` and
// `_chunk_max_masked_kernel` of
// intelligent_video_analysis_retrieval_system_tpu/ops/topk.py.
//
// out[c, b] = max over rows r of chunk c (128 rows) of  X[r] . Q[b]
// with rows r >= n_valid, and rows whose tombstone byte is nonzero, at -inf
// before the max.  Products of bf16 (or f32) values accumulate in f32.
//
// What bounds it on an H100: bytes, the one read of X.  1M x 768 bf16 rows
// are 1.54 GB, 0.46 ms at the published 3.35 TB/s; the products are 12 GFLOP
// at B = 8 (0.012 ms of tensor-core time), the output (N/128) x B floats.
// The TPU kernel walked 2048-row tiles in grid order with the queries
// resident in its fast memory.
//
// bf16 (the index's dtype).  A first version ran one block per 128-row chunk
// with row loads straight into `mma.sync` fragments and reached 62% of the
// bound: each block paid its reduction and store with no loads in flight, a
// warp's loads were 16 bytes from each of 8 rows 1,536 bytes apart, and the
// query fragments were loaded again for every 32 columns.  This design:
//   - Persistent blocks, one or two per multiprocessor (`plan_bf16`, from the
//     device's multiprocessor count), each walking chunks blockIdx.x,
//     += gridDim.x, so one chunk's reduction and store run while the next
//     chunk's rows are already arriving.
//   - Rows through a TMA ring: one producer thread keeps up to 8 stages of
//     16 KB (the chunk's 128 rows x 64 columns, one `cp.async.bulk.tensor`
//     each, 128-byte swizzle) in flight, 96-192 KB per multiprocessor, on
//     `mbarrier`s with byte counts; the copy engine forms the addresses, and
//     columns past d arrive as zeros (d = 40 needs no path of its own).
//   - The block's query group (up to 64; larger batches sweep once per 64,
//     the group is blockIdx.y) is copied into shared memory once, by the same
//     TMA map layout, and stays there for the block's life: no query is
//     loaded in the loop.
//   - Products by `wgmma` (m64nQGk16): each of two consumer warpgroups takes
//     64 rows of the stage as the A operand and the queries as B, both read
//     by the tensor cores from shared memory through descriptors.  Chosen
//     over `ldmatrix` + `mma.sync` because it needs no fragment registers and
//     one instruction per 64 x QG x 16 product, so the consumers issue almost
//     nothing while the copy engine streams; the swizzle of TMA's box and of
//     the descriptors is the same map (hopper.cuh), for X and for Q alike.
//   - Masks: the tombstone bytes of a thread's two rows are read once per
//     chunk, at its start; dead rows are -inf before a shuffle max over the
//     warp's 16 rows and a meet of the 8 warps in shared memory (two buffers,
//     one named barrier of the consumers per chunk; the producer never waits
//     on it).
// Where its time goes: ops/kernel_lab.py `b1-probes`.  On an H100 80GB HBM3
// at 700 W, 1,001,472 x 768 rows: 0.495 ms at B = 8 and 0.501 at B = 64, as
// long as the same build without products (0.494, the ring's own ceiling)
// and as P3's plain stream over the same bytes (0.497): the sweep reads the
// rows at the card's stream rate, 3.1 TB/s; without the rows' loads it takes
// 0.13-0.22 ms, all of it hidden under them.
//
// f32 (the index in parity mode): CUDA cores.  One block of 256 threads per
// (chunk, group of 8 or 16 queries): the chunk's 128 x 64 slab of X and the
// group's queries are staged in shared memory, every thread accumulates one
// row against half the group, then the same shuffle max and meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "lab.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 128;    // rows per chunk max (ops/topk.py CHUNK)
constexpr int kThreads = 256;  // f32 kernel: 8 warps
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// bf16: persistent blocks, a TMA ring of rows, queries staged once, wgmma
// ---------------------------------------------------------------------------

constexpr int kBoxCols = 64;                        // columns of a stage: one 128-byte swizzle row
constexpr int kStageBytes = kChunk * kBoxCols * 2;  // a chunk's 128 rows x 64 columns: 16 KB
constexpr int kConsumers = 256;                     // two warpgroups, 64 rows of the chunk each
constexpr int kThreadsB = kConsumers + 32;          // and the producer's warp
constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;
constexpr int kBarBytes = 256;                      // the ring's full and empty barriers, the queries'
constexpr int kSmemBlock = 232448;                  // shared memory a block can have on this card
constexpr int kSmemSM = 233472;                     // a multiprocessor's; the runtime keeps 1 KB a block

struct PlanBf16 {
  int group, stages, blocks_per_sm;
  size_t smem;
};

// shared memory besides the ring: 1,024 bytes of slack (the carve-up starts on
// a 1,024-byte boundary), the query tiles, two buffers of the warps' maxima
inline size_t fixed_bytes(int group, int d) {
  const int nkb = (d + kBoxCols - 1) / kBoxCols;
  return 1024 + (size_t)nkb * group * 128 + 2 * (kConsumers / 32) * group * 4 + kBarBytes;
}

// The launch plan (ops/topk.py `chunk_max_plan` computes the same): the
// largest query group of 64, 32, 16 or 8 that divides b_pad and leaves room
// for kMinStages stages; then two blocks a multiprocessor if each still gets
// 4 stages or more, else one with as many stages as fit (at most 8).
// group == 0: d is too wide for any group.
inline PlanBf16 plan_bf16(int b_pad, int d) {
  PlanBf16 p = {0, 0, 0, 0};
  for (int g = 64; g >= 8; g >>= 1)
    if (b_pad % g == 0 && fixed_bytes(g, d) + (size_t)kMinStages * kStageBytes <= kSmemBlock) {
      p.group = g;
      break;
    }
  if (p.group == 0) return p;
  const size_t fixed = fixed_bytes(p.group, d);
  const size_t half = kSmemSM / 2 - 1024;
  const int fit2 = half > fixed ? (int)((half - fixed) / kStageBytes) : 0;
  const int fit1 = (int)((kSmemBlock - fixed) / kStageBytes);
  p.blocks_per_sm = fit2 >= 4 ? 2 : 1;
  p.stages = p.blocks_per_sm == 2 ? fit2 : fit1;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = fixed + (size_t)p.stages * kStageBytes;
  return p;
}

// blocks along the chunks: the card's worth of blocks shared by the groups
inline long long blocks_x(const PlanBf16& p, long long n_chunks, int groups, int sms) {
  long long bx = ((long long)sms * p.blocks_per_sm + groups - 1) / groups;
  if (bx < 1) bx = 1;
  return bx < n_chunks ? bx : n_chunks;
}

// grid = (blocks along the chunks, b_pad / QG); shared memory as plan_bf16.
template <int QG>
__global__ void __launch_bounds__(kThreadsB, 2)
chunk_max_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_q,
                      const int8_t* __restrict__ dead, float* __restrict__ out, int d,
                      int b_pad, long long n_valid, int n_chunks, int n_stages) {
  constexpr int kQTile = QG * 128;   // one 64-column block of the queries
  const int nkb = (d + kBoxCols - 1) / kBoxCols;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  const uint32_t ring = (raw_a + 1023u) & ~1023u;
  const uint32_t q_a = ring + (uint32_t)n_stages * kStageBytes;
  const uint32_t red_a = q_a + (uint32_t)nkb * kQTile;
  float* red = reinterpret_cast<float*>(smem_raw + (red_a - raw_a));   // [2][8 warps][QG]
  const uint32_t bars = red_a + 2 * (kConsumers / 32) * QG * 4;
  const uint32_t full = bars, empty = bars + 8 * kMaxStages, q_full = bars + 16 * kMaxStages;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.y * QG;
  if (tid == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(full + 8 * i, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * i, kConsumers / 32);   // every consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: the queries once, then the ring, in the order the
    // consumers drain it
    if (lane == 0) {
      mbar_expect_tx(q_full, (uint32_t)nkb * kQTile);
      for (int kb = 0; kb < nkb; ++kb)
        tma_load_2d(q_a + kb * kQTile, &map_q, q_full, kb * kBoxCols, q0);
      int stage = 0;
      uint32_t round = 0;   // times the ring has wrapped
      for (int c = blockIdx.x; c < n_chunks; c += gridDim.x)
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(empty + 8 * stage, (round & 1) ^ 1);
          if constexpr (kLabSkipLoads) {
            mbar_arrive(full + 8 * stage);
          } else {
            mbar_expect_tx(full + 8 * stage, kStageBytes);
            tma_load_2d(ring + stage * kStageBytes, &map_x, full + 8 * stage, kb * kBoxCols,
                        c * kChunk);
          }
          if (++stage == n_stages) { stage = 0; ++round; }
        }
    }
    return;
  }

  // ---- consumers: warpgroup wg scores rows [64 wg, 64 wg + 64) of each chunk
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // this thread's rows: r0 and r0 + 8
  float acc[QG / 2];
#pragma unroll
  for (int i = 0; i < QG / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  int stage = 0, buf = 0;
  uint32_t round = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the masks of the thread's two rows, read once, ahead of the products
    const long long row_a = (long long)c * kChunk + r0, row_b = row_a + 8;
    const bool live_a = row_a < n_valid && (dead == nullptr || dead[row_a] == 0);
    const bool live_b = row_b < n_valid && (dead == nullptr || dead[row_b] == 0);

    int pending = -1;   // the stage whose products may still be reading it
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = stage;
      mbar_wait(full + 8 * s, round & 1);
      if (++stage == n_stages) { stage = 0; ++round; }
      const uint32_t a_tile = ring + s * kStageBytes + wg * (64 * 128);
      const uint32_t b_tile = q_a + kb * kQTile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (!kLabSkipProducts || n_valid < 0)
          Wgmma<QG>::run(acc, smem_desc(a_tile + ks * 32), smem_desc(b_tile + ks * 32),
                         (kb | ks) != 0);
      // the group just committed may run on; the one before has completed,
      // so the stage it read goes back to the producer
      wgmma_commit();
      wgmma_wait<1>();
      if (pending >= 0 && lane == 0) mbar_arrive(empty + 8 * pending);
      pending = s;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * pending);
#pragma unroll
    for (int i = 0; i < QG / 2; ++i) acc_fence(acc[i]);

    // dead rows at -inf BEFORE the max: a dead row never lifts its chunk.
    // acc[4j + 0, 1] are row r0 at queries 8j + 2 t4 + {0, 1}; acc[4j + 2, 3]
    // row r0 + 8 (hopper.cuh)
    float* red_buf = red + buf * (kConsumers / 32) * QG;
#pragma unroll
    for (int j = 0; j < QG / 8; ++j) {
      float v0 = fmaxf(live_a ? acc[4 * j] : neg_inf(), live_b ? acc[4 * j + 2] : neg_inf());
      float v1 = fmaxf(live_a ? acc[4 * j + 1] : neg_inf(), live_b ? acc[4 * j + 3] : neg_inf());
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) {   // over g: the warp's 16 rows
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, sh));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, sh));
      }
      if (g == 0) {
        red_buf[warp * QG + 8 * j + 2 * t4] = v0;
        red_buf[warp * QG + 8 * j + 2 * t4 + 1] = v1;
      }
    }
    // the consumers only; a buffer is written again two chunks later, after
    // every consumer has passed the next chunk's barrier
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    for (int j = tid; j < QG; j += kConsumers) {
      float m = red_buf[j];
#pragma unroll
      for (int w = 1; w < kConsumers / 32; ++w) m = fmaxf(m, red_buf[w * QG + j]);
      out[(long long)c * b_pad + q0 + j] = m;
    }
    buf ^= 1;
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
                        const PlanBf16& plan, cudaStream_t stream) {
  // a map holds its tensor's address and shape: encoded for this launch only
  CUtensorMap map_x, map_q;
  if (!tma_map_bf16(&map_x, x, (unsigned long long)n_pad, d, kChunk) ||
      !tma_map_bf16(&map_q, q, (unsigned long long)b_pad, d, QG))
    return cudaErrorInvalidValue;
  auto kernel = chunk_max_bf16_kernel<QG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.smem);
  if (err == cudaSuccess)   // room for two blocks a multiprocessor where the plan has two
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long n_chunks = n_pad / kChunk;
  const int groups = b_pad / QG;
  const dim3 grid((unsigned)blocks_x(plan, n_chunks, groups, device_sm_count()),
                  (unsigned)groups);
  kernel<<<grid, kThreadsB, plan.smem, stream>>>(map_x, map_q, dead, out, d, b_pad, n_valid,
                                                 (int)n_chunks, plan.stages);
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

// The bf16 launch plan (`plan_bf16`) for n_pad rows of width d and b_pad
// queries on a card of `sms` multiprocessors (sms <= 0: the current
// device's): query group, ring stages, blocks a multiprocessor, blocks
// along the chunks, bytes of dynamic shared memory per block.  group 0: d is
// too wide for the bf16 kernel.
extern "C" void ivars_chunk_max_plan(long long n_pad, int d, int b_pad, int sms, int* group,
                                     int* stages, int* blocks_per_sm, long long* blocks,
                                     long long* smem_bytes) {
  const PlanBf16 p = plan_bf16(b_pad, d);
  *group = p.group;
  *stages = p.stages;
  *blocks_per_sm = p.blocks_per_sm;
  if (sms <= 0) sms = device_sm_count();
  *blocks = p.group ? blocks_x(p, n_pad / kChunk, b_pad / p.group, sms) : 0;
  *smem_bytes = (long long)p.smem;
}

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
  if (dtype == 0) {
    const PlanBf16 plan = plan_bf16(b_pad, d);
    switch (plan.group) {
      case 64: return (int)launch_bf16<64>(x, q, dd, o, n_pad, d, b_pad, n_valid, plan, s);
      case 32: return (int)launch_bf16<32>(x, q, dd, o, n_pad, d, b_pad, n_valid, plan, s);
      case 16: return (int)launch_bf16<16>(x, q, dd, o, n_pad, d, b_pad, n_valid, plan, s);
      case 8: return (int)launch_bf16<8>(x, q, dd, o, n_pad, d, b_pad, n_valid, plan, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    return b_pad % 16 == 0
        ? (int)launch_f32<16>(x, q, dd, o, n_pad, d, b_pad, n_valid, s)
        : (int)launch_f32<8>(x, q, dd, o, n_pad, d, b_pad, n_valid, s);
  }
  return (int)cudaErrorInvalidValue;
}
