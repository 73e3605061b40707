// Known-bad: a flag released while other threads' writes may still be in
// flight (no block barrier or fence before the release), and a flag
// released that no acquire ever reads.
//
// Lines carrying `EXPECT: <rule>` markers are the golden findings
// tests/test_torch_analysis.py asserts, line-exact.

#include <cuda_runtime.h>

__device__ void st_release(unsigned* p, unsigned v) {}
__device__ unsigned ld_acquire(const unsigned* p) { return *p; }

constexpr int THREADS = 256;

struct Args {
  float* data;
  unsigned* flags;
  unsigned* done;
};

__global__ void __launch_bounds__(THREADS) publish_kernel(Args a) {
  a.data[blockIdx.x * THREADS + threadIdx.x] = 1.f;
  if (threadIdx.x == 0) st_release(a.flags + blockIdx.x, 1u);  // EXPECT: flag-balance
  if (threadIdx.x == 0)
    while (ld_acquire(a.flags + (blockIdx.x ^ 1)) != 1u) {
    }
}

__global__ void __launch_bounds__(THREADS) orphan_kernel(Args a) {
  a.data[threadIdx.x] = 2.f;
  __syncthreads();
  if (threadIdx.x == 0) st_release(a.done, 1u);  // EXPECT: flag-balance
}
