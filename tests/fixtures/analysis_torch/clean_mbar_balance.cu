// Known-clean: one arrival per warp on a barrier that counts warps,
// expect_tx of exactly the copy's bytes, a block barrier between the
// inits and every use, and every waited barrier fed.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ void mbar_init(uint64_t* bar, uint32_t count) {}
__device__ void mbar_arrive(uint64_t* bar) {}
__device__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {}
__device__ void mbar_wait(uint64_t* bar, uint32_t parity) {}
__device__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {}

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;

__global__ void __launch_bounds__(THREADS) counted_kernel(const float* x, int n) {
  __shared__ __align__(8) uint64_t full, empty;
  __shared__ float slot[TILE];
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init(&empty, WARPS);
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (tid == 0) {
      if (k > 0) mbar_wait(&empty, (k - 1) & 1);
      mbar_expect_tx(&full, TILE * 4);
      bulk_load(slot, x + k * TILE, TILE * 4, &full);
    }
    mbar_wait(&full, k & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty);
  }
}
