// Every kernel instantiation a library launches, with the shared memory
// the compiler gave it (cudaFuncGetAttributes: static bytes, registers)
// and the dynamic bytes its launcher requests (-1 when the request depends
// on the call's arguments, or no launcher of this library launches it).
// chip_smoke.py phase `analysis` holds each row against the static
// estimate of analysis/smem.py, which reads the same sources.
//
// A source lists its rows once, at its end:
//   HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(dyn, kernel<args>), ...)
// and the library exports hpcpat_smem_rows(i, &name, &static, &regs,
// &dyn): the row count, row i filled when 0 <= i < count (a negative
// return is -cudaError_t).

#pragma once

#include <cuda_runtime.h>

struct HpcpatSmemRow {
  const char* name;
  const void* fn;
  int dyn;
};

#define HPCPAT_SMEM_ROW(DYN, ...) \
  HpcpatSmemRow { #__VA_ARGS__, (const void*)(__VA_ARGS__), (int)(DYN) }

#define HPCPAT_SMEM_EXPORT(...)                                                \
  extern "C" int hpcpat_smem_rows(int i, const char** name, int* static_bytes, \
                                  int* regs, int* dyn) {                       \
    static const HpcpatSmemRow rows[] = {__VA_ARGS__};                         \
    const int n = (int)(sizeof(rows) / sizeof(rows[0]));                       \
    if (i < 0 || i >= n) return n;                                             \
    cudaFuncAttributes a;                                                      \
    cudaError_t err = cudaFuncGetAttributes(&a, rows[i].fn);                   \
    if (err != cudaSuccess) return -(int)err;                                  \
    *name = rows[i].name;                                                      \
    *static_bytes = (int)a.sharedSizeBytes;                                    \
    *regs = a.numRegs;                                                         \
    *dyn = rows[i].dyn;                                                        \
    return n;                                                                  \
  }
