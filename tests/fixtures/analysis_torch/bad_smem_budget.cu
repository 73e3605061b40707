// Known-bad: a kernel whose static tile plus the dynamic bytes its
// launcher requests exceed the H100's 232448-byte per-block opt-in limit
// (the launch is refused on the card, and nowhere else).
//
// Lines carrying `EXPECT: <rule>` markers are the golden findings
// tests/test_torch_analysis.py asserts, line-exact.

#include <cuda_runtime.h>

constexpr int ROWS = 128, COLS = 256;

__global__ void big_kernel(float* out) {  // EXPECT: smem-budget
  __shared__ float tile[ROWS][COLS];
  extern __shared__ float staged[];
  tile[threadIdx.x][0] = staged[threadIdx.x];
  out[threadIdx.x] = tile[threadIdx.x][0];
}

int launch(float* out, cudaStream_t stream) {
  big_kernel<<<1, 128, 2 * ROWS * COLS * sizeof(float), stream>>>(out);
  return (int)cudaGetLastError();
}
