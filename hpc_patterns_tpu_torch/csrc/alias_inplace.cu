// In-place kernel of the interop proof, for Hopper (sm_90a).
//
// Replaces: hpc_patterns_tpu/interop/device.py's inline Pallas kernel (the
// body at device.py:104, called at :112 with input_output_aliases={0: 0}):
// o = x * 2 + 1 written into the input's own buffer. Here the kernel takes
// one pointer and writes where it reads, so the buffer PyTorch allocated
// is the output — the two runtimes (PyTorch's allocator and this
// separately compiled library) sharing one device context, as the
// reference's OpenMP and SYCL kernels do (interop_omp_ze_sycl.cpp:81-101).
//
// x * 2 is exact in float32, so the multiply-add rounds once whether or not
// it is contracted: bitwise x.mul_(2).add_(1).
//
// What bounds it on the H100: bytes (each element read once and written
// once, 8 bytes at 3.35 TB/s); at the proof's 8 x 128 elements it is one
// launch's latency. One thread per element.

#include <cuda_runtime.h>
#include "smem_rows.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void alias_inplace_kernel(float* x, long long n) {
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) x[i] = x[i] * 2.0f + 1.0f;
}

}  // namespace

extern "C" int alias_inplace(float* x, long long n, void* stream) {
  if (n > 0) {
    long long blocks = (n + THREADS - 1) / THREADS;
    alias_inplace_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(x, n);
  }
  return (int)cudaGetLastError();
}

HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(0, alias_inplace_kernel))
