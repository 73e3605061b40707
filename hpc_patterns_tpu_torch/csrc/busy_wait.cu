// The concurrency suite's compute command: a dependent FMA chain, for
// Hopper (sm_90a).
//
// Replaces: hpc_patterns_tpu/concurrency/kernels.py::_busy_wait_kernel
// (the Pallas kernel behind busy_wait, the reference's busy_wait of
// sycl_con.cpp:26-33). Same math: every element runs 8 * trips dependent
// steps acc = acc * 0.9999999f + 0.5f, and the result is stored.
//
// Rounding: each step is fmaf, one rounding. The JAX kernel's multiply
// and add are fused the same way when it runs (XLA contracts them), so
// the two agree bit for bit; nvcc's own contraction is not relied on.
//
// Design: one thread per element, trips a kernel argument (retuning never
// rebuilds), 256 threads a block. The chain is a timer by design: its
// result feeds the next step, so each thread waits the FFMA latency
// (4 cycles) per step.
//
// What bounds it on the H100: at the suite's default 1024 elements
// (4 blocks) neither bytes nor the FP32 rate: it is latency-bound, and
// the floor is 8 * trips * 4 cycles at the SM clock. The table's bound
// max(bytes / 3.35 TB/s, 2 * n * 8 * trips / 67 TF/s) is far below that
// floor; the kernel does nothing about it because its duration is the
// quantity the suite tunes (sycl_con.cpp:257-268).

#include <cuda_runtime.h>
#include "smem_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FMA_UNROLL = 8;

__global__ void busy_wait_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int n, int trips) {
  int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int u = 0; u < FMA_UNROLL; ++u) acc = fmaf(acc, 0.9999999f, 0.5f);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int busy_wait(const float* x, float* out, int n, int trips,
                         void* stream) {
  if (n > 0) {
    int blocks = (n + THREADS - 1) / THREADS;
    busy_wait_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, out, n, trips);
  }
  return (int)cudaGetLastError();
}

HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(0, busy_wait_kernel))
