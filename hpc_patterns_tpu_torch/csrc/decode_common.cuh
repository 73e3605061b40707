// Shared device code of the single-query decode kernels (sm_90a):
// paged_decode.cu (the paged cache), flash_decode.cu (the linear cache)
// and paged_attention.cu (the exact-softmax paged route), all three
// through decode_split.cuh: the CTA size, the dtype codes, and the
// widening of 16 bytes of cache values to f32.
//
// The thread layout they share (128 threads per CTA): thread (rg, cg)
// owns the 16-byte column slice cg of the head (4 f32, 8 bf16 or 16
// one-byte values) and the rows r = rg (mod RG). The g = H / Hkv query
// rows sharing the kv head sit in shared memory in f32; each thread keeps
// a partial (g, slice) accumulator in registers, summed over the row
// groups in a fixed order at the end (deterministic).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hpc_decode {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 8;  // query rows per kv head these builds take
constexpr float NEG_INF = -1e30f;

// 16 bytes of cache values already in registers, widened to f32 (the
// kernels issue all their loads of a step before they widen any)
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void cvt(uint4 x, float* out) {
    out[0] = __uint_as_float(x.x); out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z); out[3] = __uint_as_float(x.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void cvt(uint4 x, float* out) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void cvt(uint4 x, float* out) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)  // sign-extend byte k
        out[4 * i + k] = (float)((int32_t)(w[i] << (24 - 8 * k)) >> 24);
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void cvt(uint4 x, float* out) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        // e4m3 -> f16 is exact (every e4m3 value is an f16 value)
        __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            (__nv_fp8x2_storage_t)((w[i] >> (16 * k)) & 0xffffu), __NV_E4M3);
        float2 f = __half22float2(__half2(h));
        out[4 * i + 2 * k] = f.x;
        out[4 * i + 2 * k + 1] = f.y;
      }
  }
};

template <typename T>
__device__ inline float to_f32(T x) { return float(x); }
template <>
__device__ inline float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// dtype codes shared with the Python wrappers: q 0 = f32, 1 = bf16;
// cache 0 = f32, 1 = bf16, 2 = int8, 3 = float8_e4m3fn
enum : int { F32 = 0, BF16 = 1, I8 = 2, FP8 = 3 };

}  // namespace hpc_decode
