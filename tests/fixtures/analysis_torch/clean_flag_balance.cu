// Known-clean: the block's writes, a block barrier and a fence, then one
// thread's release; the partner spins on the flag with an acquire.

#include <cuda_runtime.h>

__device__ void st_release(unsigned* p, unsigned v) {}
__device__ unsigned ld_acquire(const unsigned* p) { return *p; }

constexpr int THREADS = 256;

struct Args {
  float* data;
  unsigned* flags;
};

__global__ void __launch_bounds__(THREADS) publish_kernel(Args a) {
  a.data[blockIdx.x * THREADS + threadIdx.x] = 1.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(a.flags + blockIdx.x, 1u);
  }
  if (threadIdx.x == 0)
    while (ld_acquire(a.flags + (blockIdx.x ^ 1)) != 1u) {
    }
  __syncthreads();
}
