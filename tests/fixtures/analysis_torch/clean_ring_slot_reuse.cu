// Known-clean: the ring's producer waits each slot's empty barrier before
// refilling it (its first lap finds the slots free), and the FIFO store
// follows the credit acquired for its slot.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ void mbar_init(uint64_t* bar, uint32_t count) {}
__device__ void mbar_arrive(uint64_t* bar) {}
__device__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {}
__device__ void mbar_wait(uint64_t* bar, uint32_t parity) {}
__device__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {}
__device__ void st_fifo(float* p, float v) {}
__device__ unsigned ld_acquire(const unsigned* p) { return *p; }

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;

__global__ void __launch_bounds__(THREADS) ring_kernel(const float* x, int n) {
  __shared__ __align__(8) uint64_t full[2], empty[2];
  __shared__ float slot[2][TILE];
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (tid == 0) {
      if (k >= 2) mbar_wait(&empty[k & 1], ((k >> 1) - 1) & 1);
      mbar_expect_tx(&full[k & 1], TILE * 4);
      bulk_load(slot[k & 1], x + k * TILE, TILE * 4, &full[k & 1]);
    }
    mbar_wait(&full[k & 1], (k >> 1) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k & 1]);
  }
}

__global__ void __launch_bounds__(THREADS) fifo_kernel(float* fifo, const unsigned* credits, int n) {
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x == 0)
      while (ld_acquire(credits) + 4 <= (unsigned)k) {
      }
    __syncthreads();
    st_fifo(fifo + (k % 4) * THREADS + threadIdx.x, 1.f);
  }
}
