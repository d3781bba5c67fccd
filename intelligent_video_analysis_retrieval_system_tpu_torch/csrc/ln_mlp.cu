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
// those are exactly column-major B operands with leading dimensions D and
// H, so nothing is transposed per call.
//
// What bounds it on an H100: operations (16 D H per token: 34.5 GFLOP at
// 2,056 tokens of ViT-L/14, against 25 MB of bytes), provided the weights
// are reused across enough tokens.  LN and the MLP are per token, so the
// grid runs over tiles of the flattened tokens and not over images (the
// TPU kernel held one whole image in its fast memory and walked the hidden
// chunks in grid order; a block here has 227 KB and blocks run in no
// order, so a loop over hidden chunks inside the block takes the place of
// the grid's second axis).
//
// bf16: tensor cores through WMMA (16x16x16 bf16, f32 accumulators).  One
// block of 8 warps per tile of M = 32 tokens.  The tile's LN(x) (M x D
// bf16, 66 KB at D = 1024) lives in shared memory; the f32 accumulator
// (M x D) lives in registers, 128 a thread at D = 1024: each warp owns D/8
// output columns, 2 x D/128 fragments.  M = 64 would fit neither the
// register file (it is the whole of it) nor, with the LN tile, shared
// memory, without splitting D and computing fc1 twice; M = 32 was chosen
// for that reason, and D is limited to 1024.  Per hidden chunk of 256:
// every warp computes a 32 x 32 piece of fc1 (K = D, A fragments from
// shared memory, B fragments straight from w1 in device memory / L2: each
// weight element is loaded once per block, so staging it in shared memory
// would add traffic, not save it), passes it through its own f32 staging
// slab for bias, rounding and activation (the layout of a WMMA fragment is
// opaque), and writes bf16 into the chunk's activation tile (M x 256, 17
// KB of shared memory); after a block barrier every warp accumulates the
// chunk's fc2 contribution into its columns (B fragments straight from
// w2).  Every token tile streams all of w1 and w2 from L2 (16.8 MB at
// ViT-L/14 vision): that traffic, not the tensor cores, bounds this
// simple design; a larger token tile (wgmma with the accumulator split
// over a cluster) is the way on.  The ragged last tile is masked: rows past
// the last token are zero in shared memory and never stored.
//
// f32: CUDA cores (tensor cores would round to TF32), 8 tokens per block of
// 256 threads, one hidden column of the chunk per thread for fc1 and D/256
// output columns per thread for fc2.  It is off the served path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kChunk = 256;    // hidden columns per step (H % 256 == 0)
constexpr int kMaxD = 1024;    // accumulators live in registers

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
__device__ __forceinline__ float act_bf16(float x, int act) {
  if (act == kQuickGelu) {
    const float c = 1.703125f;  // bf16(1.702)
    const float t = round_bf16(-c * x);
    const float e = round_bf16(expf(t));
    const float den = round_bf16(1.0f + e);
    return round_bf16(x / den);
  }
  return round_bf16(act == kGelu ? gelu_erf(x) : gelu_tanh(x));
}

__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == kQuickGelu) return x / (1.0f + expf(-1.702f * x));
  return act == kGelu ? gelu_erf(x) : gelu_tanh(x);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTok = 32;          // tokens per block: two 16-row fragments
constexpr int kMaxNT = kMaxD / (16 * kWarps);  // fc2 column fragments per warp
constexpr int kStageLd = 36;      // per-warp f32 staging slab, 32 x 32 + pad

struct LayoutBf16 {
  int ld_ln, ld_a;
  size_t ln_off, a_off, stage_off, total;
};

__host__ __device__ inline LayoutBf16 layout_bf16(int d) {
  LayoutBf16 L;
  L.ld_ln = d + 8;       // +16 bytes a row: fragment rows fall on different banks
  L.ld_a = kChunk + 8;
  L.ln_off = 0;
  L.a_off = L.ln_off + (size_t)kTok * L.ld_ln * sizeof(bf16);
  L.stage_off = L.a_off + (size_t)kTok * L.ld_a * sizeof(bf16);
  L.total = L.stage_off + (size_t)kWarps * kTok * kStageLd * sizeof(float);
  return L;
}

// d = 128 * ntw (ntw in 1..8); h % 256 == 0; x, w1, w2, out 32-byte aligned.
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, bf16* __restrict__ out,
                   long long n_tok, int d, int h, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const LayoutBf16 L = layout_bf16(d);
  bf16* ln_s = reinterpret_cast<bf16*>(smem_raw + L.ln_off);
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw + L.a_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* stage = reinterpret_cast<float*>(smem_raw + L.stage_off) + warp * kTok * kStageLd;

  const long long tok0 = (long long)blockIdx.x * kTok;
  const int ntw = d / (16 * kWarps);   // fc2 column fragments of this warp
  const int col0 = warp * 16 * ntw;    // its first output column
  const bf16 zero = __float2bfloat16_rn(0.f);

  // ---- LN(x) of the tile's tokens into shared memory, 4 rows per warp
  for (int r = warp; r < kTok; r += kWarps) {
    const long long tok = tok0 + r;
    bf16* lrow = ln_s + r * L.ld_ln;
    if (tok < n_tok) {
      const bf16* xrow = x + tok * d;
      float v[kMaxD / 32];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < d ? __bfloat162float(xrow[c]) : 0.f;
        s += v[i];
      }
      const float mu = warp_sum(s) / (float)d;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int c = lane + 32 * i;
        const float dv = c < d ? v[i] - mu : 0.f;
        q += dv * dv;
      }
      const float rstd = rsqrtf(warp_sum(q) / (float)d + eps);
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < d) lrow[c] = __float2bfloat16_rn((v[i] - mu) * rstd * gamma[c] + beta[c]);
      }
    } else {
      for (int c = lane; c < d; c += 32) lrow[c] = zero;
    }
  }

  // ---- accumulators start at x_f32 + b2 (residual and fc2 bias)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kMaxNT];
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt) {
    if (nt < ntw) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = e % 16;
          const long long tok = tok0 + mt * 16 + r;
          const int col = col0 + nt * 16 + c;
          stage[r * kStageLd + c] =
              tok < n_tok ? __bfloat162float(x[tok * d + col]) + b2[col] : 0.f;
        }
        __syncwarp();
        wmma::load_matrix_sync(acc[mt][nt], stage, kStageLd, wmma::mem_row_major);
        __syncwarp();
      }
    }
  }
  __syncthreads();  // ln_s is complete

  for (int h0 = 0; h0 < h; h0 += kChunk) {
    // ---- fc1: this warp's 32 x 32 piece, hidden columns hc .. hc + 32
    const int hc = h0 + warp * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c1[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) wmma::fill_fragment(c1[mt][nt], 0.f);
    const bf16* w1p = w1 + (long long)hc * d;
#pragma unroll 4
    for (int k = 0; k < d; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> f0, f1;
      wmma::load_matrix_sync(f0, w1p + k, d);
      wmma::load_matrix_sync(f1, w1p + (long long)16 * d + k, d);
      wmma::load_matrix_sync(a0, ln_s + k, L.ld_ln);
      wmma::load_matrix_sync(a1, ln_s + 16 * L.ld_ln + k, L.ld_ln);
      wmma::mma_sync(c1[0][0], a0, f0, c1[0][0]);
      wmma::mma_sync(c1[1][0], a1, f0, c1[1][0]);
      wmma::mma_sync(c1[0][1], a0, f1, c1[0][1]);
      wmma::mma_sync(c1[1][1], a1, f1, c1[1][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        wmma::store_matrix_sync(stage + mt * 16 * kStageLd + nt * 16, c1[mt][nt],
                                kStageLd, wmma::mem_row_major);
    __syncwarp();
    // + b1 in f32, round, activation in bf16: lane = column of the piece
    {
      const float bias = b1[hc + lane];
      for (int r = 0; r < kTok; ++r) {
        const float pre = round_bf16(stage[r * kStageLd + lane] + bias);
        a_s[r * L.ld_a + warp * 32 + lane] = __float2bfloat16_rn(act_bf16(pre, act));
      }
    }
    __syncthreads();  // the chunk's activation tile is complete

    // ---- fc2: acc += a (32 x 256) . w2[cols, h0 : h0 + 256]^T
    const bf16* w2p = w2 + (long long)col0 * h + h0;
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, a_s + kk, L.ld_a);
      wmma::load_matrix_sync(a1, a_s + 16 * L.ld_a + kk, L.ld_a);
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt) {
        if (nt < ntw) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> f;
          wmma::load_matrix_sync(f, w2p + (long long)nt * 16 * h + kk, h);
          wmma::mma_sync(acc[0][nt], a0, f, acc[0][nt]);
          wmma::mma_sync(acc[1][nt], a1, f, acc[1][nt]);
        }
      }
    }
    __syncthreads();  // a_s is rewritten by the next chunk
  }

  // ---- store: one rounding
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt) {
    if (nt < ntw) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        wmma::store_matrix_sync(stage, acc[mt][nt], kStageLd, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = e % 16;
          const long long tok = tok0 + mt * 16 + r;
          if (tok < n_tok)
            out[tok * d + col0 + nt * 16 + c] = __float2bfloat16_rn(stage[r * kStageLd + c]);
        }
        __syncwarp();
      }
    }
  }
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
  cudaError_t err;
  if (dtype == 0) {
    if (!aligned(x, 32) || !aligned(w1, 32) || !aligned(w2, 32) || !aligned(out, 32))
      return (int)cudaErrorMisalignedAddress;  // WMMA loads from device memory
    const size_t smem = layout_bf16(d).total;
    err = cudaFuncSetAttribute(ln_mlp_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((n_tok + kTok - 1) / kTok);
    ln_mlp_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), g, bt, static_cast<const bf16*>(w1), fb1,
        static_cast<const bf16*>(w2), fb2, static_cast<bf16*>(out), n_tok, d, h, eps, act);
  } else {
    if (!aligned(w1, 16) || !aligned(w2, 16)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = smem_bytes_f32(d);
    err = cudaFuncSetAttribute(ln_mlp_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((n_tok + kTokF - 1) / kTokF);
    ln_mlp_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), g, bt, static_cast<const float*>(w1), fb1,
        static_cast<const float*>(w2), fb2, static_cast<float*>(out), n_tok, d, h, eps, act);
  }
  return (int)cudaGetLastError();
}
