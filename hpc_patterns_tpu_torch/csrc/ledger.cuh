// The runtime half of the kernel family's static ledger (analysis/
// cuda_rules.py): a build of a source with -DHPCPAT_LEDGER counts every
// mbarrier event and every flag release and credit of its kernels in a
// __device__ table that an exported host function reads after the launch
// (analysis/runtime.py::strict_barriers holds the balance). Without the
// macro every hook is empty and this header adds nothing to a kernel: the
// timed libraries are built without it (ops/_build.py), the ledger build
// into a directory of its own.
//
// Barrier rows are keyed by the barrier's shared-memory address (8-byte
// words, so every block's barrier at one offset adds to one row): inits,
// the sum of init counts, arrivals (expect_tx included), transaction bytes
// expected and brought by bulk copies, completed waits. Flag counters:
// releases, credits handed back, spins that saw their value.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

enum LedgerField {
  HPCPAT_L_INITS = 0,
  HPCPAT_L_COUNT,
  HPCPAT_L_ARRIVE,
  HPCPAT_L_TX_EXPECT,
  HPCPAT_L_TX_COPY,
  HPCPAT_L_WAIT,
  HPCPAT_L_FIELDS
};
enum LedgerFlag {
  HPCPAT_F_RELEASE = 0,
  HPCPAT_F_CREDIT,
  HPCPAT_F_SPIN_OK,
  HPCPAT_F_FIELDS
};
constexpr int HPCPAT_LEDGER_BARS = 4096;  // rows: shared offset / 8, wrapped

#ifdef HPCPAT_LEDGER

__device__ unsigned long long hpcpat_ledger_bars[HPCPAT_LEDGER_BARS * HPCPAT_L_FIELDS];
__device__ unsigned long long hpcpat_ledger_flags[HPCPAT_F_FIELDS];

__device__ __forceinline__ void ledger_bar(uint32_t bar, int field, unsigned long long v) {
  atomicAdd(&hpcpat_ledger_bars[((bar >> 3) % HPCPAT_LEDGER_BARS) * HPCPAT_L_FIELDS + field], v);
}

__device__ __forceinline__ void ledger_flag(int field) {
  atomicAdd(&hpcpat_ledger_flags[field], 1ull);
}

// The tables, read (rows of HPCPAT_L_FIELDS words, then the flag words)
// and zeroed by the host around one launch. Returns a cudaError_t.
extern "C" int hpcpat_ledger_read(unsigned long long* bars, unsigned long long* flags) {
  cudaError_t e = cudaMemcpyFromSymbol(bars, hpcpat_ledger_bars, sizeof(hpcpat_ledger_bars));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(flags, hpcpat_ledger_flags, sizeof(hpcpat_ledger_flags));
}

extern "C" int hpcpat_ledger_reset() {
  static unsigned long long zeros[HPCPAT_LEDGER_BARS * HPCPAT_L_FIELDS] = {0};
  cudaError_t e = cudaMemcpyToSymbol(hpcpat_ledger_bars, zeros, sizeof(zeros));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(hpcpat_ledger_flags, zeros, sizeof(hpcpat_ledger_flags));
}

extern "C" int hpcpat_ledger_shape(int* out) {
  out[0] = HPCPAT_LEDGER_BARS;
  out[1] = HPCPAT_L_FIELDS;
  out[2] = HPCPAT_F_FIELDS;
  return 0;
}

#define HPCPAT_LEDGER_BAR(bar, field, v) ledger_bar((bar), (field), (v))
#define HPCPAT_LEDGER_FLAG(field) ledger_flag(field)

#else

#define HPCPAT_LEDGER_BAR(bar, field, v) ((void)0)
#define HPCPAT_LEDGER_FLAG(field) ((void)0)

#endif
