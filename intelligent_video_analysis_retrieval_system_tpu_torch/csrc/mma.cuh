// Warp-level tensor-core products of the bench probes (probes.cu), and
// `neg_inf` for every kernel that masks.  Fragment maps (g = lane / 4,
// t = lane % 4):
//
// m16n8k16 bf16: A holds rows g and g + 8 at k = {2t, 2t+1} (a0, a1) and
// {2t+8, 2t+9} (a2, a3); B holds query g at the same k (b0, b1); C holds
// rows g (c0, c1) and g + 8 (c2, c3) at queries 2t, 2t+1.
//
// m16n8k32 s8 (four int8 per register, the lowest k in the lowest byte): A
// holds row g at k = 4t..4t+3 (a0) and 16+4t..16+4t+3 (a2), row g + 8 at the
// same k (a1, a3); B holds query g at k = 4t.. (b0) and 16+4t.. (b1); C as
// above, in int32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// c[0..3] += A (16x16 bf16, row) . B (16x8 bf16, col), f32 accumulate
static __device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c[0..3] += A (16x32 s8, row) . B (32x8 s8, col), s32 accumulate
static __device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
