// B4: fused LayerNorm + MLP residual half-block of a pre-LN transformer,
// forward only.
//
// Replaces the Pallas kernel `_ln_mlp_kernel` of
// intelligent_video_analysis_retrieval_system_tpu/ops/block.py.
//
//   out = x + fc2(act(fc1(LN(x))))        x: (tokens, D), hidden width H
//
// Rounding points (the TPU kernel's): LN statistics in f32 (two passes,
// biased variance), rsqrt(var + eps), affine in f32, LN output rounded to
// the input dtype; fc1 accumulated in f32, + b1 in f32, rounded to the input
// dtype; the activation evaluated in the input dtype (quick_gelu in bf16 is
// x / (1 + exp(-1.702 x)) with every step rounded to bf16; gelu and
// gelu_tanh are evaluated in f32 on the rounded argument and rounded once,
// as PyTorch evaluates them on a bf16 tensor); fc2 accumulated in f32 onto
// x_f32 + b2; one rounding at the store.  The hidden activation (tokens x H)
// never reaches device memory.
//
// Weights are read as nn.Linear holds them: w1 = fc1.weight (H, D),
// w2 = fc2.weight (D, H), both row-major.  For `ln . w1^T` and `a . w2^T`
// those are exactly K-major B operands, so nothing is transposed per call.
//
// What bounds it on an H100: operations (4 D H per token: 34.5 GFLOP at
// 2,056 tokens of ViT-L/14, 1.10 PFLOP at 65,792, against 25 MB and 286 MB),
// provided the weights are reused across enough tokens: every token tile
// streams all of w1 and w2 (16.8 MB at ViT-L/14) from L2, so the tile's
// height sets the L2 traffic, and only `wgmma` reaches the tensor cores'
// full rate.  LN and the MLP are per token, so the grid runs over tiles of
// the flattened tokens and not over images (the TPU kernel held one whole
// image in its fast memory and walked the hidden chunks in grid order; a
// block here has 227 KB and blocks run in no order, so a loop over hidden
// chunks inside the block takes the place of the grid's second axis).
//
// bf16: a tile is 64 tokens, the height of one `wgmma`.  Its f32
// accumulator (64 x D) is 256 KB at D = 1024, a whole multiprocessor's
// register file, so it is split along D over a thread-block CLUSTER of 4
// blocks (also for few tokens: 8 images of ViT-L/14 are 33 tiles, 132
// blocks).  Block c owns output columns [c D/4, (c+1) D/4).  Its three
// warpgroups each do one thing and meet only at barriers in shared memory:
//   - The fc2 warpgroup holds the block's accumulator, 64 x D/4 in two parts
//     of 64 x D/8 (128 registers a thread at D = 1024; `setmaxnreg` gives it
//     232, taken from the producers).  The parts start at x_f32 + b2, written
//     straight into the `wgmma` accumulator registers (layout in hopper.cuh).
//     Per hidden chunk of 128 it waits for the chunk's activation tile and
//     runs acc += a (64 x 128) . w2[cols, chunk]^T, one w2 stage (D/8 rows x
//     64 of K) after the other.  With the accumulator and both products in
//     one warpgroup, as a first version had it, the compiler ran out of the
//     168 registers it plans with and serialised the asynchronous products.
//   - The fc1 warpgroup computes the block's 32 columns of each chunk's fc1
//     (K = D) from LN(x) and w1 stages (32 rows x 128 of K), adds b1 and
//     rounds.  The values then go through the activation and, as bf16, into
//     the activation tile of EVERY block of the cluster, in the swizzled
//     K-major layout of fc2's A operand: the threads of a quad exchange words
//     so that each holds a whole 16-byte group, and one asynchronous store
//     per block (`st.async` on a `mapa`-mapped address) carries it over and
//     counts its bytes on that block's `mbarrier` for the tile.  A block's fc2
//     starts when the tile's 16 KB have landed; no fence and no arrival is
//     needed on the way.  The activation's arithmetic is the longest part of
//     the chunk for one warpgroup, so the fc1 warpgroup does it for half of
//     its rows and leaves the other half as rounded pre-activations in its own
//     block's tile, where the fc2 warpgroup, which would otherwise wait,
//     picks them up, finishes them and sends them out the same way.
//     Two tiles alternate; a tile is written again only after the fc2 warps
//     of the whole cluster have arrived on its `empty` barrier, which they
//     do once the products that read it have completed.  So fc1 of chunk
//     i + 1 runs while fc2 of chunk i does.
//   - LN(x) of the 64 tokens (64 x D bf16, 128 KB at D = 1024) is computed by
//     every block of the cluster (cheap), by the fc1 and fc2 warpgroups
//     together, into shared memory in the K-major 128-byte-swizzled layout
//     `wgmma`'s A operand wants.  Rows past the last token are zero there
//     and never stored: the ragged last tile is masked.
//   - Two threads of the third warpgroup are the producers, one per weight:
//     each keeps a ring of stages full by TMA (`cp.async.bulk.tensor`,
//     128-byte swizzle, completing on an `mbarrier`), up to the ring's depth
//     ahead of the products; a stage is released by each consumer warp once
//     the `wgmma` group that read it has completed.  What LN(x) and the two
//     activation tiles leave of the 227 KB is halved between the rings (at
//     D = 1024: 4 stages of 8 KB for w1, 2 of 16 KB for w2; up to 8 each at
//     smaller D).  The tensor maps are encoded on the host in the C entry
//     point (`cuTensorMapEncodeTiled`, fetched through
//     `cudaGetDriverEntryPoint`, so nothing links against libcuda) and
//     passed as `__grid_constant__` parameters.
//   - `wgmma` widths are built from four instructions (n16, n32, n64, n128):
//     an accumulator part's D/8 = 16 ND columns are the sum of the widths of
//     ND's binary digits, so every admitted D (multiples of 128 up to 1024)
//     runs the same code, one template instance each.
// What holds it back (ops/kernel_lab.py: timestamps of one block and
// timing-only builds, D = 1024, 65,792 tokens): a chunk takes about 6,300
// cycles in both warpgroups where the products alone need 2,048.  Dropping
// one part after the other: 4.48 ms as it is, 4.05 without any product, 3.16
// with the activation replaced by the identity as well, 2.57 without the
// weights' loads, 2.36 without the exchange of tiles, 0.52 with no hidden
// chunk at all.  So the products cost a tenth and the activation (8 values a
// thread in each warpgroup: an `expf`, a division and five roundings each, on
// one warp per scheduler) a fifth.  The products' phases are waits for
// weights: with the products off they last as long.  A block pulls its 128 KB
// of weights per chunk in the time the chunk takes, about 22 bytes a cycle,
// whatever the stage size and ring depth and whether one cluster runs or a
// card full of them; times 132 multiprocessors that is 5.1 TB/s, the card's
// L2 rate.  So the kernel is bound by what one multiprocessor pulls from L2:
// at 64 tokens a block does 64 operations per byte pulled, a third of what
// the tensor cores want.
// Tried and dropped, each measured slower or no faster: two fc1 warpgroups
// (512 threads leave the compiler 128 registers, and it serialises the fc2
// products), running the epilogue between the two halves of a chunk's
// products in either warpgroup, all stores after all arithmetic, a reciprocal
// in place of the division, handing a stage back before a wait, busy-polling
// barrier waits.  A cluster of 2 token tiles x 4 parts of D sharing each
// weight tile by one TMA multicast would halve the L2 reads but not a block's
// intake; 128 tokens per block would, and LN(x) of 128 tokens fits only if
// fc1 is split along K over the cluster (LN(x) a quarter the width, f32
// partial sums exchanged like the tiles).  Neither is done here.
// D stays limited to 1024: beyond it LN(x) of 64 tokens no longer fits one
// block's shared memory beside the rings.  The card runs fewer than 32
// clusters of 4 at a time (16 take what one takes, 32 twice that), so the 33
// tiles of 8 images of ViT-L/14 take two rounds.
//
// f32: CUDA cores (tensor cores would round to TF32), 8 tokens per block of
// 256 threads, one hidden column of the chunk per thread for fc1 and D/256
// output columns per thread for fc2.  It is off the served path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "lab.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // f32 kernel: threads per block
constexpr int kChunk = 256;    // f32 kernel: hidden columns per step; the gate is H % 256 == 0
constexpr int kMaxD = 1024;

enum Act { kQuickGelu = 0, kGelu = 1, kGeluTanh = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.79788456080286535588f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// activation of a bf16 value (given and returned as the f32 that holds it)
template <int ACT>
__device__ __forceinline__ float act_bf16(float x) {
  if constexpr (kLabSkipActivation) return x;
  if constexpr (ACT == kQuickGelu) {
    const float c = 1.703125f;  // bf16(1.702)
    const float t = round_bf16(-c * x);
    const float e = round_bf16(expf(t));
    const float den = round_bf16(1.0f + e);
    return round_bf16(x / den);
  }
  return round_bf16(ACT == kGelu ? gelu_erf(x) : gelu_tanh(x));
}

__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == kQuickGelu) return x / (1.0f + expf(-1.702f * x));
  return act == kGelu ? gelu_erf(x) : gelu_tanh(x);
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA rings, D split over a cluster, one warpgroup per product
// ---------------------------------------------------------------------------

constexpr int kTokB = 64;             // tokens per tile: one wgmma's rows
constexpr int kChunkB = 128;          // hidden columns per step
constexpr int kCluster = 4;           // blocks per tile: D split four ways
constexpr int kF1N = kChunkB / kCluster;   // fc1 columns of a chunk per block
constexpr int kThreadsB = 384;        // warpgroups: fc2, fc1, producers
constexpr int kW1StageBytes = kF1N * 128 * 2;   // kF1N rows of w1 x 128 of K
constexpr int kW2StageBytes = 16384;  // up to 128 rows of w2 x 64 of K
constexpr int kMaxStages = 8;         // per ring
constexpr int kActBytes = kTokB * kChunkB * 2;   // one activation tile
constexpr int kBarBytes = 512;        // 4 x 8 ring barriers, 3 x 2 for the tiles
constexpr int kSmemLimit = 232448;    // per block on this card

// Scope of the operations that hand an activation tile from block to block:
// false = as described under "hand-over" in hopper.cuh, true = acquire and
// release at cluster scope throughout (-DIVARS_LAB_STRICT_HANDOVER, to price
// the difference: ops/kernel_lab.py, `b4-handover`).
#ifdef IVARS_LAB_STRICT_HANDOVER
constexpr bool kHandoverClusterScope = true;
#else
constexpr bool kHandoverClusterScope = false;
#endif

struct PlanBf16 {
  int w1_stages, w2_stages;
  size_t smem;
};

// The launch plan from D alone: what LN(x) and the activation tiles leave of
// the block's shared memory is halved between the rings of w1 and of w2.
__host__ __device__ inline PlanBf16 plan_bf16(int d) {
  PlanBf16 p;
  // 1,024 bytes of slack: the carve-up starts on a 1,024-byte boundary
  const size_t fixed = 1024 + (size_t)kTokB * d * 2 + 2 * kActBytes + kBarBytes;
  const size_t half = (kSmemLimit - fixed) / 2;
  const int fit1 = (int)(half / kW1StageBytes), fit2 = (int)(half / kW2StageBytes);
  p.w1_stages = fit1 < kMaxStages ? fit1 : kMaxStages;
  p.w2_stages = fit2 < kMaxStages ? fit2 : kMaxStages;
  p.smem = fixed + (size_t)p.w1_stages * kW1StageBytes + (size_t)p.w2_stages * kW2StageBytes;
  return p;
}

// acc (64 x 16 ND, one accumulator part) += A (64 x 16) . B^T (16 ND x 16): the
// width is the sum of its binary digits' instructions
template <int ND>
__device__ __forceinline__ void fc2_step(float* acc, uint64_t da, uint64_t db) {
  // rows of the B tile are 128 bytes: 8 descriptor units each
  constexpr int r8 = (ND & 8) ? 128 : 0;
  constexpr int r4 = r8 + ((ND & 4) ? 64 : 0);
  constexpr int r2 = r4 + ((ND & 2) ? 32 : 0);
  if constexpr ((ND & 8) != 0) Wgmma<128>::run(acc, da, db, 1);
  if constexpr ((ND & 4) != 0) Wgmma<64>::run(acc + r8 / 2, da, db + r8 * 8, 1);
  if constexpr ((ND & 2) != 0) Wgmma<32>::run(acc + r4 / 2, da, db + r4 * 8, 1);
  if constexpr ((ND & 1) != 0) Wgmma<16>::run(acc + r2 / 2, da, db + r2 * 8, 1);
}

// word `idx` (0..3) of v, for an index only known at run time
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int idx) {
  const uint32_t lo = (idx & 1) ? v[1] : v[0], hi = (idx & 1) ? v[3] : v[2];
  return (idx & 2) ? hi : lo;
}

// Eight bf16 values of one 16-byte group to the same place in the activation
// tile of every block of the cluster: one asynchronous store per block, which
// completes on that block's barrier for the tile.
__device__ __forceinline__ void store_group(const uint32_t* cta_base, uint32_t off,
                                            uint32_t bar_off, uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3) {
#pragma unroll
  for (int cta = 0; cta < kCluster; ++cta)
    if (!kLabSkipExchange || off == 1)
      st_async_v4(cta_base[cta] + off, cta_base[cta] + bar_off, w0, w1, w2, w3);
}

template <int ACT>
__device__ __forceinline__ uint32_t act_pair(uint32_t pre) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&pre);
  const __nv_bfloat162 p = __floats2bfloat162_rn(act_bf16<ACT>(__bfloat162float(x.x)),
                                                 act_bf16<ACT>(__bfloat162float(x.y)));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The fc1 warpgroup's share of a chunk's epilogue.  `c1` is the block's fc1
// piece (64 x kF1N f32) + b1 still to add; a thread holds two columns of each
// of the piece's four 8-column groups, for rows r0 and r0 + 8.  Row r0: the
// values go through the activation, the four threads of a quad exchange words
// so that each holds one whole group (thread tq group tq), and `store_group`
// sends it to every block.  Row r0 + 8: the rounded pre-activations go as they
// are into this block's own tile (`pre_addr`, the thread's word of group 0;
// group j is `^ (j << 4)` on in the swizzled row), for the fc2 warpgroup to
// finish (`finish_act`): the activation's arithmetic is most of the
// epilogue, and the fc2 warpgroup would otherwise wait for it.
template <int ACT>
__device__ __forceinline__ void write_act(const float* c1, const float2* bias,
                                          const uint32_t* cta_base, uint32_t bar_off,
                                          uint32_t grp_off, uint32_t pre_addr, int tq) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(c1[4 * j + 2] + bias[j].x,
                                                   c1[4 * j + 3] + bias[j].y);
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(pre_addr ^ (uint32_t)(j << 4)),
                    "r"(*reinterpret_cast<const uint32_t*>(&p)) : "memory");
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(c1[4 * j] + bias[j].x, c1[4 * j + 1] + bias[j].y);
    v[j] = act_pair<ACT>(*reinterpret_cast<const uint32_t*>(&p));
  }
  // in round s a thread hands the word of group tq ^ s to the thread that
  // owns that group and gets word tq ^ s of its own
  uint32_t got[4];
  got[0] = pick(v, tq);
#pragma unroll
  for (int s = 1; s < 4; ++s) got[s] = __shfl_xor_sync(0xffffffffu, pick(v, tq ^ s), s);
  // got[s] is word tq ^ s of the group: word i is got[i ^ tq]
  store_group(cta_base, grp_off, bar_off, pick(got, tq), pick(got, 1 ^ tq), pick(got, 2 ^ tq),
              pick(got, 3 ^ tq));
}

// The fc2 warpgroup's share: the thread's group of row r0 + 8, left in this
// block's tile as rounded pre-activations, through the activation and to
// every block (this one's own copy is overwritten in place).
template <int ACT>
__device__ __forceinline__ void finish_act(const uint32_t* cta_base, uint32_t bar_off,
                                           uint32_t grp_off, uint32_t own_addr) {
  uint32_t w0, w1, w2, w3;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w0), "=r"(w1), "=r"(w2), "=r"(w3) : "r"(own_addr) : "memory");
  store_group(cta_base, grp_off, bar_off, act_pair<ACT>(w0), act_pair<ACT>(w1), act_pair<ACT>(w2),
              act_pair<ACT>(w3));
}

// LN(x) of the tile's 64 tokens into shared memory at `ln_p` (K-major,
// swizzled), by eight warps: `warp` in [0, 8).
template <int ND>
__device__ __forceinline__ void layer_norm_tile(unsigned char* ln_p, const bf16* __restrict__ x,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, long long tok0,
                                                long long n_tok, float eps, int warp, int lane) {
  constexpr int D = 128 * ND;
  // 8 rows per warp, ROWS at a time (fewer where a row is many registers).  A
  // lane owns granules of 4 columns (8 bytes), ND of them a row; the loads of
  // a pass's rows are issued before the first is used.
  constexpr int ROWS = ND > 4 ? 2 : 4;
  for (int pass = 0; pass < 8 / ROWS; ++pass) {
    const int row_base = warp + 8 * ROWS * pass;
    uint2 xin[ROWS][ND];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long tok = tok0 + row_base + 8 * i;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        xin[i][j] = tok < n_tok
            ? *reinterpret_cast<const uint2*>(x + tok * D + 4 * (lane + 32 * j))
            : make_uint2(0u, 0u);
    }
    auto widen = [](const uint2& g, float (&v)[4]) {
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&g.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&g.y);
      v[0] = __bfloat162float(lo.x);
      v[1] = __bfloat162float(lo.y);
      v[2] = __bfloat162float(hi.x);
      v[3] = __bfloat162float(hi.y);
    };
    float mu[ROWS], rstd[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        float v[4];
        widen(xin[i][j], v);
        sum += (v[0] + v[1]) + (v[2] + v[3]);
      }
      mu[i] = warp_sum(sum) / (float)D;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        float v[4];
        widen(xin[i][j], v);
#pragma unroll
        for (int e = 0; e < 4; ++e) q += (v[e] - mu[i]) * (v[e] - mu[i]);
      }
      rstd[i] = rsqrtf(warp_sum(q) / (float)D + eps);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = 4 * (lane + 32 * j);
      float gm[4], bt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gm[e] = gamma[c + e];
        bt[e] = beta[c + e];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = row_base + 8 * i;
        float v[4], y[4];
        widen(xin[i][j], v);
        const bool live = tok0 + r < n_tok;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = live ? (v[e] - mu[i]) * rstd[i] * gm[e] + bt[e] : 0.f;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
        *reinterpret_cast<uint2*>(ln_p + (c / 64) * (kTokB * 128) + swizzled_offset(r, c % 64)) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

// D = 128 ND; h % 128 == 0; x 8-byte and out 4-byte aligned; grid = tiles x
// kCluster blocks in clusters of kCluster.
template <int ND>
__global__ void __launch_bounds__(kThreadsB, 1)
ln_mlp_bf16_kernel(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ b1, const float* __restrict__ b2,
                   bf16* __restrict__ out, long long n_tok, int h, float eps, int act,
                   int n1, int n2) {
  constexpr int D = 128 * ND;
  constexpr int F2N = 16 * ND;   // rows of w2 in an fc2 stage: one accumulator part's columns
  constexpr int NQ = 2;          // parts: the block's D / 4 columns = NQ x F2N

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  const uint32_t ring1 = (raw_a + 1023u) & ~1023u;
  const uint32_t ring2 = ring1 + (uint32_t)n1 * kW1StageBytes;
  const uint32_t ln_a = ring2 + (uint32_t)n2 * kW2StageBytes;
  unsigned char* ln_p = smem_raw + (ln_a - raw_a);
  const uint32_t act_a = ln_a + kTokB * D * 2;
  const uint32_t bars = act_a + 2 * kActBytes;
  const uint32_t full1 = bars, empty1 = bars + 64, full2 = bars + 128, empty2 = bars + 192;
  const uint32_t act_full = bars + 256, act_empty = bars + 272, pre_full = bars + 288;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, role = warp / 4;
  const uint32_t rank = cluster_rank();
  const long long tok0 = (long long)(blockIdx.x / kCluster) * kTokB;
  const int n_chunks = kLabHeadOnly ? 0 : h / kChunkB;

  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(full1 + 8 * i, 1);    // the producer's expect_tx
      mbar_init(empty1 + 8 * i, 4);   // the warps of the fc1 warpgroup
      mbar_init(full2 + 8 * i, 1);
      mbar_init(empty2 + 8 * i, 4);   // the warps of the fc2 warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(act_full + 8 * i, 1);               // the fc2 thread that tells it the tile's bytes
      mbar_init(act_empty + 8 * i, 4 * kCluster);   // the fc2 warps of the cluster that read it
      mbar_init(pre_full + 8 * i, 4);               // the fc1 warps that left their half in it
    }
    mbar_init_fence();
  }
  cluster_sync();  // the peers' barriers exist before anything arrives on them

  // One branch per role and no code after it: only then does the compiler
  // honour `setmaxnreg`.  384 threads start with 168 registers each; the
  // producers hand theirs to the fc2 warpgroup, which holds the accumulator.
  if (role == 2) {
    // ---- producers: one thread per ring keeps it full, in the order its
    // consumers drain it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      // w1: this block's kF1N rows of the chunk, 128 of K a stage
      int stage = 0;
      uint32_t round = 0;   // times the ring has wrapped
      for (int c = 0; c < n_chunks; ++c) {
        const int row = c * kChunkB + (int)rank * kF1N;
        for (int kb = 0; kb < ND; ++kb) {
          mbar_wait(empty1 + 8 * stage, (round & 1) ^ 1);
          if constexpr (kLabSkipLoads) {
            mbar_arrive(full1 + 8 * stage);
          } else {
            mbar_expect_tx(full1 + 8 * stage, kW1StageBytes);
            const uint32_t dst = ring1 + stage * kW1StageBytes;
            tma_load_2d(dst, &map_w1, full1 + 8 * stage, kb * 128, row);
            tma_load_2d(dst + kF1N * 128, &map_w1, full1 + 8 * stage, kb * 128 + 64, row);
          }
          if (++stage == n1) { stage = 0; ++round; }
        }
      }
    } else if (warp == 9 && lane == 0) {
      // w2: F2N of this block's rows, 64 of K a stage
      int stage = 0;
      uint32_t round = 0;
      for (int c = 0; c < n_chunks; ++c)
        for (int kb = 0; kb < 2; ++kb)
          for (int q = 0; q < NQ; ++q) {
            mbar_wait(empty2 + 8 * stage, (round & 1) ^ 1);
            if constexpr (kLabSkipLoads) {
              mbar_arrive(full2 + 8 * stage);
            } else {
              mbar_expect_tx(full2 + 8 * stage, F2N * 128);
              tma_load_2d(ring2 + stage * kW2StageBytes, &map_w2, full2 + 8 * stage,
                          c * kChunkB + kb * 64, (int)rank * (D / kCluster) + q * F2N);
            }
            if (++stage == n2) { stage = 0; ++round; }
          }
    }
    __syncwarp();
    cluster_sync();  // as below
  } else if (role == 1) {
    // ---- fc1 warpgroup: the block's kF1N hidden columns of every chunk,
    // through the activation, into every block's activation tile
    const int g = lane / 4, tq = lane % 4;
    const int r0 = (warp % 4) * 16 + g;  // this thread's accumulator rows: r0, r0 + 8

    layer_norm_tile<ND>(ln_p, x, gamma, beta, tok0, n_tok, eps, warp, lane);
    fence_proxy_async();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // LN(x) is complete (both warpgroups' rows)

    // where this thread's 16-byte group of row r0 goes in an activation tile
    // (the block's group tq of the chunk's hidden columns), the address of this
    // block's shared memory in every block's window,
    // and where its own words of row r0 + 8 go in this block's tile
    uint32_t cta_base[kCluster];
#pragma unroll
    for (uint32_t cta = 0; cta < kCluster; ++cta) cta_base[cta] = map_cluster(raw_a, cta);
    const int hc = (int)rank * kF1N;
    const uint32_t grp_off = (act_a - raw_a) + (hc / 64) * (kTokB * 128) +
                             swizzled_offset(r0, hc % 64 + 8 * tq);
    const uint32_t pre_addr0 = act_a + (hc / 64) * (kTokB * 128) +
                               swizzled_offset(r0 + 8, hc % 64 + 2 * tq);

    int stage = 0;      // ring position, in step with the producer
    uint32_t round = 0;
    LAB_TRACE_BEGIN(blockIdx.x == 8 && warp == 4);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      LAB_STAMP(0);
      // this thread's b1 values, fetched under the products
      float2 bias[kF1N / 8];
#pragma unroll
      for (int j = 0; j < kF1N / 8; ++j) {
        const int hc = c * kChunkB + (int)rank * kF1N + 8 * j + 2 * tq;
        bias[j] = make_float2(b1[hc], b1[hc + 1]);
      }

      // ---- fc1: the block's kF1N hidden columns of chunk c, K = D
      float c1[kF1N / 2];
      int pending = -1;   // the stage whose products are still in flight
      for (int kb = 0; kb < ND; ++kb) {
        const int s = stage;
        mbar_wait(full1 + 8 * s, round & 1);
        if (++stage == n1) { stage = 0; ++round; }
        const uint32_t w_tile = ring1 + s * kW1StageBytes;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint64_t da = smem_desc(ln_a + (2 * kb + ks / 4) * (kTokB * 128) + (ks % 4) * 32);
          const uint64_t db = smem_desc(w_tile + (ks / 4) * (kF1N * 128) + (ks % 4) * 32);
          if (!kLabSkipProducts || n_tok < 0) Wgmma<kF1N>::run(c1, da, db, (kb | ks) != 0);
        }
        // the group just committed may run on; the one before it has
        // completed, so the stage it read goes back to the producer
        wgmma_commit();
        wgmma_wait<1>();
        if (pending >= 0 && lane == 0) mbar_arrive(empty1 + 8 * pending);
        pending = s;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty1 + 8 * pending);
      LAB_STAMP(0);
#pragma unroll
      for (int i = 0; i < kF1N / 2; ++i) acc_fence(c1[i]);

      // the tile is free once every fc2 warp of the cluster has read chunk c - 2
      if (c >= 2 && !kLabSkipExchange)
        mbar_wait<kHandoverClusterScope>(act_empty + 8 * buf, (uint32_t)((c >> 1) - 1) & 1);
      LAB_STAMP(0);

      // ---- + b1 in f32, round, activation in bf16, into every block's tile
      const uint32_t bar_off = (act_full - raw_a) + 8 * buf;
      const uint32_t off = grp_off + buf * kActBytes, pre_addr = pre_addr0 + buf * kActBytes;
      if (act == kQuickGelu) write_act<kQuickGelu>(c1, bias, cta_base, bar_off, off, pre_addr, tq);
      else if (act == kGelu) write_act<kGelu>(c1, bias, cta_base, bar_off, off, pre_addr, tq);
      else write_act<kGeluTanh>(c1, bias, cta_base, bar_off, off, pre_addr, tq);
      __syncwarp();
      if (lane == 0) mbar_arrive(pre_full + 8 * buf);   // the warp's rows r0 + 8 are in the tile
      LAB_STAMP(0);
    }
    // no block leaves while a peer may still write into its shared memory
    cluster_sync();
  } else {
    // ---- fc2 warpgroup: the block's D / 4 output columns of the 64 tokens
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = lane / 4, tq = lane % 4;
    const int r0 = warp * 16 + g;  // this thread's accumulator rows: r0, r0 + 8

    layer_norm_tile<ND>(ln_p, x, gamma, beta, tok0, n_tok, eps, warp, lane);
    fence_proxy_async();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // with the fc1 warpgroup

    // accumulators start at x_f32 + b2 (residual and fc2 bias); part q holds
    // columns q F2N .. (q + 1) F2N of the block's
    float acc[NQ][8 * ND];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col0 = (int)rank * (D / kCluster) + q * F2N + 2 * tq;
#pragma unroll
      for (int j = 0; j < 2 * ND; ++j) {
        const int col = col0 + 8 * j;
        const float2 bias = make_float2(b2[col], b2[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long tok = tok0 + r0 + 8 * half;
          float lo = 0.f, hi = 0.f;
          if (tok < n_tok) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + tok * D + col);
            lo = __bfloat162float(xv.x) + bias.x;
            hi = __bfloat162float(xv.y) + bias.y;
          }
          acc[q][4 * j + 2 * half] = lo;
          acc[q][4 * j + 2 * half + 1] = hi;
        }
      }
    }

    // this thread's 16-byte group of row r0 + 8 in an activation tile
    uint32_t cta_base[kCluster];
#pragma unroll
    for (uint32_t cta = 0; cta < kCluster; ++cta) cta_base[cta] = map_cluster(raw_a, cta);
    const int hc = (int)rank * kF1N;
    const uint32_t grp_off = (act_a - raw_a) + (hc / 64) * (kTokB * 128) +
                             swizzled_offset(r0 + 8, hc % 64 + 8 * tq);

    int stage = 0;         // ring position, in step with the producer
    uint32_t round = 0;
    int pending = -1;      // the stage whose products are still in flight
    int tile_pending = -1; // the activation tile whose last products are

    LAB_TRACE_BEGIN(blockIdx.x == 8 && warp == 0);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      const uint32_t act_tile = act_a + buf * kActBytes;
      LAB_STAMP(1);
      // this warpgroup's half of the epilogue, under the products of the chunk
      // before
      mbar_wait(pre_full + 8 * buf, (uint32_t)(c >> 1) & 1);
      LAB_STAMP(1);
      {
        const uint32_t bar_off = (act_full - raw_a) + 8 * buf, off = grp_off + buf * kActBytes;
        if (act == kQuickGelu) finish_act<kQuickGelu>(cta_base, bar_off, off, raw_a + off);
        else if (act == kGelu) finish_act<kGelu>(cta_base, bar_off, off, raw_a + off);
        else finish_act<kGeluTanh>(cta_base, bar_off, off, raw_a + off);
      }
      LAB_STAMP(1);
      // the chunk's tile is complete when the 16 KB the cluster's warpgroups
      // store into it have landed
      if (tid == 0) {
        if constexpr (kLabSkipExchange) mbar_arrive(act_full + 8 * buf);
        else mbar_expect_tx(act_full + 8 * buf, kActBytes);
      }
      mbar_wait<kHandoverClusterScope>(act_full + 8 * buf, (uint32_t)(c >> 1) & 1);
      fence_proxy_async();  // the peers' writes, seen through the barrier, before the products
      LAB_STAMP(1);

      // ---- fc2: acc += a (64 x 128) . w2[cols, chunk c]^T
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int s = stage;
          mbar_wait(full2 + 8 * s, round & 1);
          if (++stage == n2) { stage = 0; ++round; }
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (!kLabSkipProducts || n_tok < 0) fc2_step<ND>(acc[q], smem_desc(act_tile + kb * (kTokB * 128) + ks * 32),
                         smem_desc(ring2 + s * kW2StageBytes + ks * 32));
          // the group just committed may run on; those before it have
          // completed: their stage goes back to the producer and, at a chunk's
          // first stage, the tile of the chunk before to the fc1 warpgroups
          wgmma_commit();
          wgmma_wait<1>();
          if (lane == 0) {
            if (pending >= 0) mbar_arrive(empty2 + 8 * pending);
            if (tile_pending >= 0) {
#pragma unroll
              for (uint32_t cta = 0; cta < kCluster; ++cta)
                mbar_arrive_cluster<kHandoverClusterScope>(act_empty + 8 * tile_pending, cta);
            }
          }
          pending = s;
          tile_pending = -1;
        }
      }
      tile_pending = buf;
      LAB_STAMP(1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int i = 0; i < 8 * ND; ++i) acc_fence(acc[q][i]);

    // ---- store: one rounding
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col0 = (int)rank * (D / kCluster) + q * F2N + 2 * tq;
#pragma unroll
      for (int j = 0; j < 2 * ND; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long tok = tok0 + r0 + 8 * half;
          if (tok < n_tok)
            *reinterpret_cast<__nv_bfloat162*>(out + tok * D + col0 + 8 * j) =
                __floats2bfloat162_rn(acc[q][4 * j + 2 * half], acc[q][4 * j + 2 * half + 1]);
        }
      }
    }
    cluster_sync();  // as above
  }
}

template <int ND>
cudaError_t launch_bf16(const bf16* x, const float* gamma, const float* beta, const bf16* w1,
                        const float* b1, const bf16* w2, const float* b2, bf16* out,
                        long long n_tok, int h, float eps, int act, cudaStream_t s) {
  constexpr int D = 128 * ND;
  const PlanBf16 plan = plan_bf16(D);
  CUtensorMap map_w1, map_w2;
  if (!tma_map_bf16(&map_w1, w1, h, D, kF1N) || !tma_map_bf16(&map_w2, w2, D, h, 16 * ND))
    return cudaErrorInvalidValue;
  auto kernel = ln_mlp_bf16_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_tok + kTokB - 1) / kTokB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * kCluster));
  cfg.blockDim = dim3(kThreadsB);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, map_w1, map_w2, x, gamma, beta, b1, b2, out, n_tok, h,
                            eps, act, plan.w1_stages, plan.w2_stages);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTokF = 8;                   // tokens per block, one per warp in LN
constexpr int kMaxCF = kMaxD / kThreads;   // output columns per thread

__host__ __device__ inline size_t smem_bytes_f32(int d) {
  return ((size_t)kTokF * d + (size_t)kTokF * kChunk) * sizeof(float);
}

// d % 4 == 0, h % 256 == 0, w1 and w2 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  long long n_tok, int d, int h, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ln_s = reinterpret_cast<float*>(smem_raw);   // [kTokF][d]
  float* a_s = ln_s + (size_t)kTokF * d;              // [kTokF][kChunk]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long tok0 = (long long)blockIdx.x * kTokF;

  {  // LN: warp w normalizes token w of the tile
    const long long tok = tok0 + warp;
    float* lrow = ln_s + warp * d;
    if (tok < n_tok) {
      const float* xrow = x + tok * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += xrow[c];
      const float mu = warp_sum(s) / (float)d;
      float q = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float dv = xrow[c] - mu;
        q += dv * dv;
      }
      const float rstd = rsqrtf(warp_sum(q) / (float)d + eps);
      for (int c = lane; c < d; c += 32)
        lrow[c] = (xrow[c] - mu) * rstd * gamma[c] + beta[c];
    } else {
      for (int c = lane; c < d; c += 32) lrow[c] = 0.f;
    }
  }

  float acc[kMaxCF][kTokF];
#pragma unroll
  for (int i = 0; i < kMaxCF; ++i) {
    const int c = tid + kThreads * i;
#pragma unroll
    for (int m = 0; m < kTokF; ++m)
      acc[i][m] = (c < d && tok0 + m < n_tok) ? x[(tok0 + m) * d + c] + b2[c] : 0.f;
  }
  __syncthreads();

  for (int h0 = 0; h0 < h; h0 += kChunk) {
    {  // fc1: hidden column h0 + tid for the tile's tokens
      float p[kTokF];
#pragma unroll
      for (int m = 0; m < kTokF; ++m) p[m] = 0.f;
      const float* wr = w1 + (long long)(h0 + tid) * d;
      for (int k = 0; k < d; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
        for (int m = 0; m < kTokF; ++m) {
          const float* l = ln_s + m * d + k;
          p[m] = fmaf(l[0], w.x, p[m]);
          p[m] = fmaf(l[1], w.y, p[m]);
          p[m] = fmaf(l[2], w.z, p[m]);
          p[m] = fmaf(l[3], w.w, p[m]);
        }
      }
      const float bias = b1[h0 + tid];
#pragma unroll
      for (int m = 0; m < kTokF; ++m) a_s[m * kChunk + tid] = act_f32(p[m] + bias, act);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxCF; ++i) {
      const int c = tid + kThreads * i;
      if (c < d) {
        const float* wr = w2 + (long long)c * h + h0;
        for (int k = 0; k < kChunk; k += 4) {
          const float4 w = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
          for (int m = 0; m < kTokF; ++m) {
            const float* a = a_s + m * kChunk + k;
            acc[i][m] = fmaf(a[0], w.x, acc[i][m]);
            acc[i][m] = fmaf(a[1], w.y, acc[i][m]);
            acc[i][m] = fmaf(a[2], w.z, acc[i][m]);
            acc[i][m] = fmaf(a[3], w.w, acc[i][m]);
          }
        }
      }
    }
    __syncthreads();  // a_s is rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < kMaxCF; ++i) {
    const int c = tid + kThreads * i;
    if (c < d) {
#pragma unroll
      for (int m = 0; m < kTokF; ++m)
        if (tok0 + m < n_tok) out[(tok0 + m) * d + c] = acc[i][m];
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

LAB_EXPORT_STAMPS(ivars_ln_mlp_set_stamps)

// The bf16 launch plan for `n_tok` tokens of width `d`: blocks per cluster,
// blocks in all, stages of each w1 ring and of the w2 ring, bytes of dynamic
// shared memory per block.
extern "C" void ivars_ln_mlp_plan(long long n_tok, int d, int* cluster, long long* blocks,
                                  int* w1_stages, int* w2_stages, long long* smem_bytes) {
  const PlanBf16 p = plan_bf16(d);
  *cluster = kCluster;
  *blocks = (n_tok + kTokB - 1) / kTokB * kCluster;
  *w1_stages = p.w1_stages;
  *w2_stages = p.w2_stages;
  *smem_bytes = (long long)p.smem;
}

// x, out: contiguous (n_tok, d); gamma, beta, b2: f32 (d); w1: (h, d) and
// w2: (d, h) in x's dtype, row-major (nn.Linear's weights); b1: f32 (h).
// d % 128 == 0, d <= 1024, h % 256 == 0.  dtype: 0 = bfloat16, 1 = float32.
// act: 0 = quick_gelu, 1 = gelu (erf), 2 = gelu_tanh.  Returns the
// cudaError_t.
extern "C" int ivars_ln_mlp(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, long long n_tok, int d, int h,
                            float eps, int act, int dtype, void* stream) {
  if (n_tok <= 0 || d <= 0 || d % 128 != 0 || d > kMaxD || h <= 0 || h % kChunk != 0 ||
      act < 0 || act > 2 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype == 0) {
    // TMA reads the weights from 16-byte-aligned rows; x is read in fours, out
    // is written in pairs
    if (!aligned(w1, 16) || !aligned(w2, 16) || !aligned(x, 8) || !aligned(out, 4))
      return (int)cudaErrorMisalignedAddress;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* w1b = static_cast<const bf16*>(w1);
    const bf16* w2b = static_cast<const bf16*>(w2);
    bf16* ob = static_cast<bf16*>(out);
#define IVARS_LN_MLP_CASE(ND) \
  case ND:                    \
    return (int)launch_bf16<ND>(xb, g, bt, w1b, fb1, w2b, fb2, ob, n_tok, h, eps, act, s);
    switch (d / 128) {
      IVARS_LN_MLP_CASE(1)
      IVARS_LN_MLP_CASE(2)
      IVARS_LN_MLP_CASE(3)
      IVARS_LN_MLP_CASE(4)
      IVARS_LN_MLP_CASE(5)
      IVARS_LN_MLP_CASE(6)
      IVARS_LN_MLP_CASE(7)
      IVARS_LN_MLP_CASE(8)
    }
#undef IVARS_LN_MLP_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (!aligned(w1, 16) || !aligned(w2, 16)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes_f32(d);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_tok + kTokF - 1) / kTokF);
  ln_mlp_f32_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), g, bt, static_cast<const float*>(w1), fb1,
      static_cast<const float*>(w2), fb2, static_cast<float*>(out), n_tok, d, h, eps, act);
  return (int)cudaGetLastError();
}
