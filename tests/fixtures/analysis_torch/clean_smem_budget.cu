// Known-clean: the same kernel with half the rows and one staged tile:
// 32768 static + 65536 dynamic bytes, within the opt-in limit.

#include <cuda_runtime.h>

constexpr int ROWS = 32, COLS = 256;

__global__ void tile_kernel(float* out) {
  __shared__ float tile[ROWS][COLS];
  extern __shared__ float staged[];
  tile[threadIdx.x % ROWS][0] = staged[threadIdx.x];
  out[threadIdx.x] = tile[threadIdx.x % ROWS][0];
}

int launch(float* out, cudaStream_t stream) {
  tile_kernel<<<1, 128, 2 * ROWS * COLS * sizeof(float), stream>>>(out);
  return (int)cudaGetLastError();
}
