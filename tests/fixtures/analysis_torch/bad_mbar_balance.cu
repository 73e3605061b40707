// Known-bad: mbarrier ledgers that do not balance. Every thread arrives
// on a barrier that waits for one arrival per warp; expect_tx asks for
// more bytes than the copy brings; a barrier used before a block barrier
// follows its init; a barrier waited on that nothing arrives on.
//
// Lines carrying `EXPECT: <rule>` markers are the golden findings
// tests/test_torch_analysis.py asserts, line-exact.

#include <cuda_runtime.h>
#include <stdint.h>

// the protocol vocabulary (csrc/hopper.cuh's names), bodies elided
__device__ void mbar_init(uint64_t* bar, uint32_t count) {}
__device__ void mbar_arrive(uint64_t* bar) {}
__device__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {}
__device__ void mbar_wait(uint64_t* bar, uint32_t parity) {}
__device__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {}

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;

__global__ void __launch_bounds__(THREADS) overcount_kernel(const float* x, int n) {
  __shared__ __align__(8) uint64_t full, empty;
  __shared__ float slot[TILE];
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init(&empty, WARPS);
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (tid == 0) {
      if (k > 0) mbar_wait(&empty, (k - 1) & 1);
      mbar_expect_tx(&full, TILE * 4);  // EXPECT: mbar-balance
      bulk_load(slot, x + k * TILE, TILE * 2, &full);
    }
    mbar_wait(&full, k & 1);
    mbar_arrive(&empty);  // EXPECT: mbar-balance
  }
}

__global__ void __launch_bounds__(THREADS) unfenced_kernel(const float* x) {
  __shared__ __align__(8) uint64_t full;
  __shared__ float slot[TILE];
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    mbar_expect_tx(&full, TILE * 4);  // EXPECT: mbar-balance
    bulk_load(slot, x, TILE * 4, &full);
  }
  mbar_wait(&full, 0);
}

__global__ void __launch_bounds__(THREADS) starved_kernel() {
  __shared__ __align__(8) uint64_t done;
  if (threadIdx.x == 0) mbar_init(&done, 1);
  __syncthreads();
  mbar_wait(&done, 0);  // EXPECT: mbar-balance
}
