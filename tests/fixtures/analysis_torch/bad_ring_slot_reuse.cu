// Known-bad: a two-slot ring refilled before its readers released the
// slot (no wait on the empty barrier), and a FIFO store with no credit
// acquired for its slot.
//
// Lines carrying `EXPECT: <rule>` markers are the golden findings
// tests/test_torch_analysis.py asserts, line-exact.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ void mbar_init(uint64_t* bar, uint32_t count) {}
__device__ void mbar_arrive(uint64_t* bar) {}
__device__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {}
__device__ void mbar_wait(uint64_t* bar, uint32_t parity) {}
__device__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {}
__device__ void st_fifo(float* p, float v) {}

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
      mbar_expect_tx(&full[k & 1], TILE * 4);
      bulk_load(slot[k & 1], x + k * TILE, TILE * 4, &full[k & 1]);  // EXPECT: ring-slot-reuse
    }
    mbar_wait(&full[k & 1], (k >> 1) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k & 1]);
  }
}

__global__ void __launch_bounds__(THREADS) fifo_kernel(float* fifo, int n) {
  for (int k = 0; k < n; ++k) {
    st_fifo(fifo + (k % 4) * THREADS + threadIdx.x, 1.f);  // EXPECT: ring-slot-reuse
    __syncthreads();
  }
}
