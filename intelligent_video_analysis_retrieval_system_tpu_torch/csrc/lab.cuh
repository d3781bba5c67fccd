// Hooks for ops/kernel_lab.py, which builds the kernels a second time with
// one of these defined to see where a kernel's time goes.  The library the
// port loads defines none of them: every macro below is then empty and every
// `kLab...` constant false, so the kernels compile as if this file were not
// there.
//
//   -DIVARS_LAB_TRACE    `clock64` stamps: LAB_TRACE_BEGIN(cond) picks the one
//                        warp that writes them (lane 0, into the buffer set
//                        through the entry point LAB_EXPORT_STAMPS defines),
//                        LAB_STAMP(row) writes the next stamp of that row,
//                        LAB_SETTLE makes the stamp wait for two registers
//   -DIVARS_LAB_SKIP=n   timing-only builds of ln_mlp.cu and chunk_max.cu that
//                        leave parts out (bits below); their results are
//                        wrong on purpose

#pragma once

#ifndef IVARS_LAB_SKIP
#define IVARS_LAB_SKIP 0
#endif
constexpr bool kLabSkipProducts = (IVARS_LAB_SKIP & 1) != 0;    // no wgmma
constexpr bool kLabSkipActivation = (IVARS_LAB_SKIP & 2) != 0;  // the identity
constexpr bool kLabSkipLoads = (IVARS_LAB_SKIP & 4) != 0;       // no TMA of weights or rows
constexpr bool kLabSkipExchange = (IVARS_LAB_SKIP & 8) != 0;    // no tiles between blocks
constexpr bool kLabHeadOnly = (IVARS_LAB_SKIP & 16) != 0;       // no hidden chunk at all

#ifdef IVARS_LAB_TRACE
#define LAB_STAMP_ROW 256
namespace { __device__ long long* g_lab_stamps = nullptr; }
#define LAB_TRACE_BEGIN(cond)                                 \
  long long* lab_dbg = (cond) ? g_lab_stamps : nullptr;       \
  int lab_n = 0
#define LAB_STAMP(row)                                                          \
  do {                                                                          \
    if (lab_dbg && lane == 0 && lab_n < LAB_STAMP_ROW - 6)                      \
      lab_dbg[(row) * LAB_STAMP_ROW + lab_n++] = clock64();                     \
  } while (0)
#define LAB_SETTLE(constraint, a, b)                                            \
  do {                                                                          \
    if (lab_dbg) asm volatile("" :: constraint(a), constraint(b));              \
  } while (0)
#define LAB_EXPORT_STAMPS(name) \
  extern "C" void name(void* p) { cudaMemcpyToSymbol(g_lab_stamps, &p, sizeof(p)); }
#else
#define LAB_TRACE_BEGIN(cond)
#define LAB_STAMP(row)
#define LAB_SETTLE(constraint, a, b)
#define LAB_EXPORT_STAMPS(name)
#endif
