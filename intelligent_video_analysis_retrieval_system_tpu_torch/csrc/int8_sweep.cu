// B2: int8 chunk-max sweep, phase 1 of the int8 capacity mode's search.
//
// Replaces the Pallas kernel `_int8_sweep_kernel` of
// intelligent_video_analysis_retrieval_system_tpu/ops/quant.py (line 167,
// called at 211).  The TPU kernel walked 2048-row tiles in grid order with
// the whole query batch resident in its fast memory.
//
// out[c, j] = max over rows r of chunk c (128 rows) of  (float)(X[r] . Q[j]) * xs[r]
// with X and Q int8, the dot product accumulated in int32, and rows
// r >= n_valid, and rows whose tombstone byte is nonzero, at -inf.  Every
// product is at most 127^2, so the int32 sum is exact, and so is its
// float image while d < 1040 (512 and 768 in the index): the result equals
// the plain version (an f32 matmul of the same integers) bit for bit.  The
// one rounding is the f32 multiply by the row scale, as in the TPU kernel.
//
// What bounds it on an H100 (1,979 TOP/s int8, 3.35 TB/s):
//   - 8 queries (a served batch) over 10M x 768 rows: the read of X, 7.68
//     GB in 2.29 ms; the products take 0.06 ms.
//   - 512 queries (the batched k-NN call) over 96M x 512 rows (51.5 GB and
//     0.4 GB of scales): the products, 52.8 TOP in 26.7 ms, against 15.5 ms
//     for one read of the rows.  A sweep that holds 64 queries reads the rows
//     8 times a call (124 ms of bytes); one that holds 256 reads them twice
//     (31.0 ms, which then bounds the call).
//
// A first version (one block of 8 warps per 128-row chunk, rows loaded
// straight into `mma.sync` fragments, the query fragments re-read for every
// 64 columns, at most 64 queries a launch) ran B=8 at 68% of its bytes bound
// and 512 queries at ~13% of the call's bound: eight sweeps, each at ~62% of
// its bytes.  This design is B1's (chunk_max.cu) in int8:
//   - One launch is one sweep over every row for one query group.  The group
//     is chosen from the shapes (ops/quant.py `int8_sweep_plan`, the same
//     rule as `max_group` and `plan_for` below): the widest of 256, 128, ...,
//     8 queries whose tiles and a ring of 4 stages fit in a block's shared
//     memory (256 at d = 512, 128 at d = 768), and at most what is left of
//     the batch.  512 queries at d = 512 are two sweeps.
//   - Persistent blocks (one a multiprocessor; two where the group is at most
//     64 and each block still gets 4 stages) walk chunks blockIdx.x,
//     += gridDim.x, so one chunk's maxima and store run while the next
//     chunk's rows are arriving.
//   - Rows through a TMA ring: one producer thread keeps up to 8 stages of 16
//     KB (the chunk's 128 rows x 128 int8 columns, one `cp.async.bulk.tensor`
//     each, 128-byte swizzle) in flight on `mbarrier`s with byte counts;
//     columns past d arrive as zeros.
//   - The query group is copied into shared memory once per block, in the
//     same layout, and stays there: no query is loaded in the loop.  Its
//     tiles are `W` rows, the power of two at or above the group (`plan_for`);
//     rows past the group are the wrapper's zeros and their columns are not
//     stored.
//   - Products by `wgmma.m64nWk32.s32.s8.s8`: each of two consumer warpgroups
//     takes 64 rows of the stage as A and the queries as B, both read by the
//     tensor cores from shared memory through descriptors.  At W = 256 and
//     d = 512 a chunk is 32 such products, about as long as its 64 KB take
//     to arrive.
//   - The epilogue: the int32 sums to f32, times the row scale (NaN for a
//     dead row, which every `fmaxf` then passes over: the same maxima as -inf
//     before the max, with no select per value); the max of the thread's two
//     rows; a max over the warp's 16 rows that halves the values a lane holds
//     at each of three shuffle steps, so each lane ends with W/32 maxima in
//     an order that stores to shared memory without bank conflicts; a meet of
//     the 8 warps (two buffers, one named barrier of the consumers per chunk;
//     the producer never waits on it); a chunk whose 128 rows are all dead is
//     NaN there and is stored as -inf.
// Where its time goes, on an H100 80GB HBM3 at 700 W, 10M rows: B=8 reads the
// rows at 3.0-3.1 TB/s (1.64-1.69 ms at d = 512, 2.50 at 768: 92-94% of the
// bound, from 2.12 and 3.42 in the first design).  B=512 at d = 512 takes
// 4.75-5.08 ms for its two sweeps (61-65% of the bound, from 20.0): the same
// build without products takes 3.48 (the ring's own ceiling), without the
// epilogue 3.92-4.04, so the products cost about 0.25 ms a sweep over the
// stream and the epilogue, which the tensor cores wait out, about 0.45.  The
// int32 to f32 conversions compile to I2FP (the ALU pipe): without them the
// time does not move.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kChunk = 128;                      // rows per chunk max (ops/topk.py CHUNK)
constexpr int kBoxCols = 128;                    // int8 columns of a stage: a swizzle row
constexpr int kStageBytes = kChunk * kBoxCols;   // a chunk's 128 rows x 128 columns: 16 KB
constexpr int kConsumers = 256;                  // two warpgroups, 64 rows of the chunk each
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;        // and the producer's warp
constexpr int kMaxStages = 8;
constexpr int kMinStages = 4;                    // a ring that keeps the rows streaming
constexpr int kMaxWidth = 256;                   // wgmma's widest N
constexpr int kBarBytes = 256;                   // the ring's full and empty barriers, the queries'
constexpr int kSmemBlock = 232448;               // shared memory a block can have on this card
constexpr int kSmemSM = 233472;                  // a multiprocessor's (1 KB a block is reserved)

struct Plan {
  int width, stages, blocks_per_sm;
  size_t smem;
};

// shared memory besides the ring: 1,024 bytes of slack (the carve-up starts on
// a 1,024-byte boundary), the query tiles, two buffers of the warps' maxima
inline size_t fixed_bytes(int width, int d) {
  const int nkb = (d + kBoxCols - 1) / kBoxCols;
  return 1024 + (size_t)nkb * width * kBoxCols + 2 * kWarps * width * 4 + kBarBytes;
}

// The largest query group of one launch for rows of width d: the widest of
// 256, 128, ..., 8 whose tiles and kMinStages stages fit; 0 if none does.
inline int max_group(int d) {
  for (int w = kMaxWidth; w >= 8; w >>= 1)
    if (fixed_bytes(w, d) + (size_t)kMinStages * kStageBytes <= kSmemBlock) return w;
  return 0;
}

// The launch of one group of nq queries (ops/quant.py `int8_sweep_plan`
// computes the same): tiles of the power of two at or above nq; two blocks a
// multiprocessor where W <= 64 and each still gets kMinStages stages, else
// one with as many stages as fit (at most 8).
inline Plan plan_for(int nq, int d) {
  Plan p = {8, 0, 1, 0};
  while (p.width < nq) p.width <<= 1;
  const size_t fixed = fixed_bytes(p.width, d);
  const size_t half = kSmemSM / 2 - 1024;
  const int fit2 = half > fixed ? (int)((half - fixed) / kStageBytes) : 0;
  p.blocks_per_sm = p.width <= 64 && fit2 >= kMinStages ? 2 : 1;
  p.stages = p.blocks_per_sm == 2 ? fit2 : (int)((kSmemBlock - fixed) / kStageBytes);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = fixed + (size_t)p.stages * kStageBytes;
  return p;
}

inline long long blocks_x(const Plan& p, long long n_chunks, int sms) {
  const long long bx = (long long)sms * p.blocks_per_sm;
  return bx < n_chunks ? bx : n_chunks;
}

// One step of the max over the warp's rows, on f32 maxima kept as their bits
// in int registers: lanes that differ in lane bit S hold maxima of other rows
// for the same L values.  With L >= 2 each keeps every second value (the odd
// ones where its bit is set), sends the others to its partner and takes the
// max with what the partner sent: L/2 values remain, value i standing for the
// old 2i + bit.  With L = 1 both keep the max of the two.
template <int L, int S>
__device__ __forceinline__ void fold_rows(int* v, int lane) {
  if constexpr (L >= 2) {
    const bool hi = (lane & S) != 0;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      const int keep = hi ? v[2 * i + 1] : v[2 * i];
      const int send = hi ? v[2 * i] : v[2 * i + 1];
      v[i] = __float_as_int(fmaxf(__int_as_float(keep),
                                  __int_as_float(__shfl_xor_sync(0xffffffffu, send, S))));
    }
  } else {
    v[0] = __float_as_int(fmaxf(__int_as_float(v[0]),
                                __int_as_float(__shfl_xor_sync(0xffffffffu, v[0], S))));
  }
}

// grid = (blocks along the chunks); shared memory as plan_for.  q holds W
// rows (zeros past nq); out points at the group's first column.
template <int W>
__global__ void __launch_bounds__(kThreads, W <= 64 ? 2 : 1)
int8_chunk_max_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_q, const float* __restrict__ xs,
                      const int8_t* __restrict__ dead, float* __restrict__ out, int d, int nq,
                      int out_stride, long long n_valid, int n_chunks, int n_stages) {
  constexpr int kQTile = W * kBoxCols;   // one 128-column block of the queries
  constexpr int kV = W / 4;              // maxima a lane holds after the max of its two rows
  // fold steps that halve the values (3, or fewer when kV < 8) and what is left
  constexpr int kHalve = kV >= 8 ? 3 : kV >= 4 ? 2 : 1;
  constexpr int kLeft = kV >> kHalve;
  const int nkb = (d + kBoxCols - 1) / kBoxCols;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  const uint32_t ring = (raw_a + 1023u) & ~1023u;
  const uint32_t q_a = ring + (uint32_t)n_stages * kStageBytes;
  const uint32_t red_a = q_a + (uint32_t)nkb * kQTile;
  float* red = reinterpret_cast<float*>(smem_raw + (red_a - raw_a));   // [2][8 warps][W]
  const uint32_t bars = red_a + 2 * kWarps * W * 4;
  const uint32_t full = bars, empty = bars + 8 * kMaxStages, q_full = bars + 16 * kMaxStages;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(full + 8 * i, 1);          // the producer's expect_tx
      mbar_init(empty + 8 * i, kWarps);    // every consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: the queries once, then the ring, in the order the
    // consumers drain it
    if (lane == 0) {
      mbar_expect_tx(q_full, (uint32_t)nkb * kQTile);
      for (int kb = 0; kb < nkb; ++kb)
        tma_load_2d(q_a + kb * kQTile, &map_q, q_full, kb * kBoxCols, 0);
      int stage = 0;
      uint32_t round = 0;   // times the ring has wrapped
      for (int c = blockIdx.x; c < n_chunks; c += gridDim.x)
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(empty + 8 * stage, (round & 1) ^ 1);
          mbar_expect_tx(full + 8 * stage, kStageBytes);
          tma_load_2d(ring + stage * kStageBytes, &map_x, full + 8 * stage, kb * kBoxCols,
                      c * kChunk);
          if (++stage == n_stages) { stage = 0; ++round; }
        }
    }
    return;
  }

  // ---- consumers: warpgroup wg scores rows [64 wg, 64 wg + 64) of each chunk
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // this thread's rows: r0 and r0 + 8
  const float nan = __int_as_float(0x7fc00000);
  int acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0;
  mbar_wait(q_full, 0);

  int stage = 0, buf = 0;
  uint32_t round = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the scales and masks of the thread's two rows, read ahead of the
    // products; a dead row's scale is NaN
    const long long row_a = (long long)c * kChunk + r0, row_b = row_a + 8;
    const float xa = xs[row_a], xb = xs[row_b];
    const bool live_a = row_a < n_valid && (dead == nullptr || dead[row_a] == 0);
    const bool live_b = row_b < n_valid && (dead == nullptr || dead[row_b] == 0);

    int pending = -1;   // the stage whose products may still be reading it
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = stage;
      mbar_wait(full + 8 * s, round & 1);
      if (++stage == n_stages) { stage = 0; ++round; }
      const uint32_t a_tile = ring + s * kStageBytes + wg * (64 * kBoxCols);
      const uint32_t b_tile = q_a + kb * kQTile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        WgmmaS8<W>::run(acc, smem_desc(a_tile + ks * 32), smem_desc(b_tile + ks * 32),
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
    for (int i = 0; i < W / 2; ++i) acc_fence(acc[i]);

    // acc[4j + 0, 1] are row r0 at queries 8j + 2 t4 + {0, 1}; acc[4j + 2, 3]
    // row r0 + 8 (hopper.cuh).  The max of the two rows at query 8j + 2 t4 + e
    // goes, as f32 bits, to acc[2j + e]: in place, since the next chunk's
    // first product overwrites the accumulators
    const float sa = live_a ? xa : nan, sb = live_b ? xb : nan;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float m0 =
          fmaxf(__fmul_rn((float)acc[4 * j], sa), __fmul_rn((float)acc[4 * j + 2], sb));
      const float m1 =
          fmaxf(__fmul_rn((float)acc[4 * j + 1], sa), __fmul_rn((float)acc[4 * j + 3], sb));
      acc[2 * j] = __float_as_int(m0);
      acc[2 * j + 1] = __float_as_int(m1);
    }
    // over g, the warp's 16 rows: afterwards acc[i] stands for the old index
    // k = i * 2^kHalve + (g mod 2^kHalve), the same in every lane whose g
    // agrees in its low kHalve bits
    fold_rows<kV, 4>(acc, lane);
    fold_rows<(kV >= 2 ? kV / 2 : 1), 8>(acc, lane);
    fold_rows<(kV >= 4 ? kV / 4 : 1), 16>(acc, lane);
    float* red_buf = red + buf * kWarps * W;
    if ((g >> kHalve) == 0) {
#pragma unroll
      for (int i = 0; i < kLeft; ++i) {
        const int k = (i << kHalve) + g;
        red_buf[warp * W + 8 * (k >> 1) + 2 * t4 + (k & 1)] = __int_as_float(acc[i]);
      }
    }
    // the consumers only; a buffer is written again two chunks later, after
    // every consumer has passed the next chunk's barrier
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    for (int j = tid; j < nq; j += kConsumers) {
      float m = red_buf[j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_buf[w * W + j]);
      out[(long long)c * out_stride + j] = m == m ? m : neg_inf();   // NaN: every row dead
    }
    buf ^= 1;
  }
}

template <int W>
cudaError_t launch(const void* x, const float* xs, const void* q, const int8_t* dead, float* out,
                   long long n_pad, int d, int nq, int out_stride, long long n_valid,
                   const Plan& plan, cudaStream_t stream) {
  // a map holds its tensor's address and shape: encoded for this launch only
  CUtensorMap map_x, map_q;
  if (!tma_map_s8(&map_x, x, (unsigned long long)n_pad, d, kChunk) ||
      !tma_map_s8(&map_q, q, (unsigned long long)W, d, W))
    return cudaErrorInvalidValue;
  auto kernel = int8_chunk_max_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.smem);
  if (err == cudaSuccess)   // room for two blocks a multiprocessor where the plan has two
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long n_chunks = n_pad / kChunk;
  const dim3 grid((unsigned)blocks_x(plan, n_chunks, device_sm_count()));
  kernel<<<grid, kThreads, plan.smem, stream>>>(map_x, map_q, xs, dead, out, d, nq, out_stride,
                                                n_valid, (int)n_chunks, plan.stages);
  return cudaGetLastError();
}

}  // namespace

// The launch plan for a group of nq queries over n_pad rows of width d on a
// card of `sms` multiprocessors (sms <= 0: the current device's): the largest
// group any launch at this d takes, the tiles' width W, ring stages, blocks a
// multiprocessor, blocks along the chunks, bytes of dynamic shared memory per
// block.  max_group 0: d is too wide for the kernel.
extern "C" void ivars_int8_chunk_max_plan(long long n_pad, int d, int nq, int sms,
                                          int* max_group_out, int* width, int* stages,
                                          int* blocks_per_sm, long long* blocks,
                                          long long* smem_bytes) {
  const Plan p = plan_for(nq, d);
  *max_group_out = max_group(d);
  *width = p.width;
  *stages = p.stages;
  *blocks_per_sm = p.blocks_per_sm;
  *blocks = blocks_x(p, n_pad / kChunk, sms > 0 ? sms : device_sm_count());
  *smem_bytes = (long long)p.smem;
}

// One sweep over the rows for one group of nq queries (nq % 8 == 0, nq at
// most max_group(d)).  q points at the group's first query row and holds W
// rows of d int8 (plan_for; zeros past nq); out at its first column of a
// row-major (n_pad / 128, out_stride) f32 matrix.  n_pad % 128 == 0, d % 16
// == 0, x and q 16-byte aligned (checked by the Python wrapper).  dead may be
// null.  Returns the cudaError_t of the launch.
extern "C" int ivars_int8_chunk_max(const void* x, const void* xs, const void* q,
                                    const void* dead, void* out, long long n_pad, int d,
                                    int nq, int out_stride, long long n_valid,
                                    void* stream) {
  if (n_pad % kChunk != 0 || n_pad <= 0 || n_pad / kChunk > 0x7fffffffLL || d <= 0 ||
      d % 16 != 0 || nq <= 0 || nq % 8 != 0 || nq > max_group(d) || out_stride < nq)
    return (int)cudaErrorInvalidValue;
  const float* ss = static_cast<const float*>(xs);
  const int8_t* dd = static_cast<const int8_t*>(dead);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan = plan_for(nq, d);
  switch (plan.width) {
    case 256: return (int)launch<256>(x, ss, q, dd, o, n_pad, d, nq, out_stride, n_valid, plan, s);
    case 128: return (int)launch<128>(x, ss, q, dd, o, n_pad, d, nq, out_stride, n_valid, plan, s);
    case 64: return (int)launch<64>(x, ss, q, dd, o, n_pad, d, nq, out_stride, n_valid, plan, s);
    case 32: return (int)launch<32>(x, ss, q, dd, o, n_pad, d, nq, out_stride, n_valid, plan, s);
    case 16: return (int)launch<16>(x, ss, q, dd, o, n_pad, d, nq, out_stride, n_valid, plan, s);
    case 8: return (int)launch<8>(x, ss, q, dd, o, n_pad, d, nq, out_stride, n_valid, plan, s);
  }
  return (int)cudaErrorInvalidValue;
}
