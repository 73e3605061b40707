// Shared device code of the single-query decode kernels (sm_90a):
// paged_decode.cu (the paged cache), flash_decode.cu (the linear cache),
// both through decode_split.cuh, and paged_attention.cu (the exact-softmax
// paged route).
//
// The counterpart of hpc_patterns_tpu/ops/flash_decode.py::_softmax_block,
// the one online-softmax block update behind both JAX decode kernels:
// scores and values in f32; for one-byte caches the per-row dequant scales
// fold into the score (s_j = (q.k8_j) * scale * kscale_j) and into the
// probability (p_j * vscale_j) instead of rescaling the (rows, D) tile;
// mask -1e30; out = acc / max(l, 1e-30).
//
// Online's thread layout (paged_attention.cu; the split kernels take only
// Vec and the constants; 128 threads per CTA, one CTA per (sequence, kv
// head)):
// thread (rg, cg) owns the 16-byte column slice cg of the head (4 f32,
// 8 bf16 or 16 one-byte values) and the block rows r = rg (mod RG). The
// g = H / Hkv query rows sharing the kv head sit in shared memory in f32;
// each thread keeps a partial (g, slice) accumulator in registers, summed
// over the RG row groups in a fixed order at the end (deterministic).

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
// rows of one streamed block: the score buffer is (g, BLOCK_ROWS) f32
// whatever the cache length
constexpr int BLOCK_ROWS = 256;

// one 16-byte load of cache values, widened to f32 (load); cvt widens 16
// bytes already in registers (decode_split.cuh's pass 1 issues all its
// loads of a step before it widens any)
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  // the same widening of 16 bytes already in registers
  __device__ static void cvt(uint4 x, float* out) {
    out[0] = __uint_as_float(x.x); out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z); out[3] = __uint_as_float(x.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    cvt(*reinterpret_cast<const uint4*>(p), out);
  }
  // the same widening of 16 bytes already in registers
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
  __device__ static void load(const int8_t* p, float* out) {
    cvt(*reinterpret_cast<const uint4*>(p), out);
  }
  // the same widening of 16 bytes already in registers
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
  __device__ static void load(const __nv_fp8_e4m3* p, float* out) {
    cvt(*reinterpret_cast<const uint4*>(p), out);
  }
  // the same widening of 16 bytes already in registers
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

// Shared-memory layout of one CTA of the online-softmax kernels.
template <typename TK, int D>
struct Online {
  static constexpr int N = Vec<TK>::N;  // values per 16-byte load
  static constexpr int CG = D / N;      // threads per row
  static constexpr int RG = THREADS / CG;
  static_assert(D % N == 0 && CG <= 32 && (32 % CG) == 0, "head_dim");

  // bytes of dynamic shared memory for g query rows and blocks of blk rows
  static size_t smem_bytes(int g, int blk) {
    return sizeof(float) * ((size_t)g * D + (size_t)g * blk +
                            (size_t)RG * g * D + 3 * G_MAX);
  }

  float* qs;   // (g, D) f32 queries
  float* ss;   // (g, blk) scores, then probabilities
  float* red;  // (RG, g, D) partial accumulators
  float* ms;   // (g,) running max
  float* ls;   // (g,) running sum
  float* rs;   // (g,) this block's rescale factor
  int g, blk, cg, rg, tid, warp, lane;
  float acc[G_MAX][N];

  template <typename TQ>
  __device__ void init(float* smem, const TQ* qrow, int g_, int blk_) {
    g = g_;
    blk = blk_;
    qs = smem;
    ss = qs + g * D;
    red = ss + g * blk;
    ms = red + RG * g * D;
    ls = ms + G_MAX;
    rs = ls + G_MAX;
    tid = threadIdx.x;
    cg = tid % CG;
    rg = tid / CG;
    warp = tid / 32;
    lane = tid % 32;
    for (int i = tid; i < g * D; i += THREADS) qs[i] = to_f32(qrow[i]);
    if (tid < G_MAX) {
      ms[tid] = NEG_INF;
      ls[tid] = 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[gi][e] = 0.f;
    __syncthreads();
  }

  // One online-softmax update over the n <= blk rows of a block whose row
  // 0 is logical position `base` (base <= pos): k/v point at the block's
  // first row (row stride D), ks/vs at its scale rows or null. Rows past
  // pos are neither read nor given probability.
  __device__ void block(const TK* __restrict__ k, const TK* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, int n, int base,
                        int pos, float scale) {
    // A. scores. Every thread runs the same trip count, ceil(n / RG), so
    // the shuffles see full warps; rows past n or pos load nothing.
    for (int r0 = 0; r0 < n; r0 += RG) {
      const int r = r0 + rg;
      const bool in_block = r < n;
      const bool live = in_block && base + r <= pos;
      float kv[N];
      if (live) {
        Vec<TK>::load(k + (long)r * D + cg * N, kv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kv[e] = 0.f;
      }
      const float kscale = (live && ks) ? ks[r] : 1.f;
      for (int gi = 0; gi < g; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) d = fmaf(qs[gi * D + cg * N + e], kv[e], d);
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (cg == 0 && in_block)
          ss[gi * blk + r] = live ? d * scale * kscale : NEG_INF;
      }
    }
    __syncthreads();

    // B. online softmax, one warp per query row
    for (int gi = warp; gi < g; gi += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ss[gi * blk + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(ss[gi * blk + r] - m_new);
        ss[gi * blk + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float rescale = expf(m_old - m_new);
        rs[gi] = rescale;
        ms[gi] = m_new;
        ls[gi] = ls[gi] * rescale + sum;
      }
    }
    __syncthreads();

    // C. values: p (times vscale) . v over the live rows
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi) {
      if (gi < g) {
        const float f = rs[gi];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[gi][e] *= f;
      }
    }
    for (int r = rg; r < n && base + r <= pos; r += RG) {
      float vv[N];
      Vec<TK>::load(v + (long)r * D + cg * N, vv);
      const float vscale = vs ? vs[r] : 1.f;
#pragma unroll
      for (int gi = 0; gi < G_MAX; ++gi) {
        if (gi < g) {
          const float p = ss[gi * blk + r] * vscale;
#pragma unroll
          for (int e = 0; e < N; ++e) acc[gi][e] = fmaf(p, vv[e], acc[gi][e]);
        }
      }
    }
    __syncthreads();  // ss is rewritten by the next block
  }

  // fixed-order reduction of the RG partial accumulators; out row of the
  // g query rows, normalised by the running sums
  __device__ void finish(float* __restrict__ orow) {
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int e = 0; e < N; ++e)
          red[(rg * g + gi) * D + cg * N + e] = acc[gi][e];
      }
    }
    __syncthreads();
    for (int i = tid; i < g * D; i += THREADS) {
      const int gi = i / D, d = i % D;
      float s = 0.f;
      for (int t = 0; t < RG; ++t) s += red[(t * g + gi) * D + d];
      orow[i] = s / fmaxf(ls[gi], 1e-30f);
    }
  }
};

// dtype codes shared with the Python wrappers: q 0 = f32, 1 = bf16;
// cache 0 = f32, 1 = bf16, 2 = int8, 3 = float8_e4m3fn
enum : int { F32 = 0, BF16 = 1, I8 = 2, FP8 = 3 };

// The (q type, cache type, head_dim) dispatch every decode entry point
// shares: compute-dtype caches match q; one-byte caches take either q.
// LAUNCH(TQ, TK, D) must be a macro that returns.
#define HPC_DECODE_DISPATCH_D(TQ, TK)        \
  do {                                       \
    if (D == 16) LAUNCH(TQ, TK, 16);         \
    if (D == 32) LAUNCH(TQ, TK, 32);         \
    if (D == 64) LAUNCH(TQ, TK, 64);         \
    if (D == 128) LAUNCH(TQ, TK, 128);       \
  } while (0)

#define HPC_DECODE_DISPATCH(qd, kd)                                         \
  do {                                                                      \
    using hpc_decode::F32;                                                  \
    using hpc_decode::BF16;                                                 \
    using hpc_decode::I8;                                                   \
    using hpc_decode::FP8;                                                  \
    if (qd == F32 && kd == F32) HPC_DECODE_DISPATCH_D(float, float);        \
    if (qd == BF16 && kd == BF16)                                           \
      HPC_DECODE_DISPATCH_D(__nv_bfloat16, __nv_bfloat16);                  \
    if (qd == F32 && kd == I8) HPC_DECODE_DISPATCH_D(float, int8_t);        \
    if (qd == BF16 && kd == I8) HPC_DECODE_DISPATCH_D(__nv_bfloat16, int8_t); \
    if (qd == F32 && kd == FP8)                                             \
      HPC_DECODE_DISPATCH_D(float, __nv_fp8_e4m3);                          \
    if (qd == BF16 && kd == FP8)                                            \
      HPC_DECODE_DISPATCH_D(__nv_bfloat16, __nv_fp8_e4m3);                  \
  } while (0)

}  // namespace hpc_decode
