// Single-query attention through a page table, for Hopper (sm_90a).
//
// Replaces: hpc_patterns_tpu/ops/flash_decode.py::_decode_kernel_paged
// (the Pallas kernel behind flash_decode_paged, run once per layer per
// decode step by paged_decode_step). Same math: the g = H / Hkv query rows
// that share a kv head attend the live prefix rows [0, pos[b]] of that
// head, gathered page by page through the sequence's table row; scores
// and values in f32 (flash_decode.py::_softmax_block), mask -1e30, online
// softmax across pages, out = acc / max(l, 1e-30) in f32.
//
// Layout: q (B, H, D); k_pool, v_pool (n_pool, Hkv, P, D) in the compute
// dtype; table (B, pages) int32; pos (B,) int32 or one scalar; out
// (B, H, D) f32.
//
// Design: one CTA (128 threads) per (b, kv head). The block reads its own
// table row and pos[b] and walks pages 0 .. pos[b] / P only: pages past
// the fill are never read (the clamped index map of the Pallas kernel).
// Thread (rg, cg) owns a 16-byte column slice cg of the head (8 bf16 or
// 4 f32 values) and the page rows r = rg (mod RG). Per page:
//   A. scores: each thread dots its K slice with the g query slices, the
//      CG threads of a row reduce with warp shuffles, and one writes
//      s[gi][r] to shared memory (rows past pos: -1e30);
//   B. softmax: one warp per query row updates m and l and turns the
//      page's scores into probabilities;
//   C. values: each thread rescales its partial accumulator and adds
//      p * v over its rows (rows past pos are skipped, not read).
// At the end the RG partial accumulators are summed in a fixed order
// (deterministic) and normalised.
//
// What bounds it on the H100: bytes. A decode step reads each live K/V
// row once, 2 * Hkv * D * 2 bytes per position and layer (bf16): at
// B=8, Hkv=8, D=128 and a fill of 1024 that is 33.5 MB, about 10 us at
// 3.35 TB/s, against ~0.07 GFLOP. With one CTA per (b, kv head) the bench
// shape launches 8 * 8 = 64 CTAs on 132 SMs, and each CTA walks its pages
// with no load/compute overlap, so the kernel cannot reach the memory
// rate at that shape; splitting each sequence's pages over several CTAs
// (flash-decoding, with a merge pass) is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 8;  // query rows per kv head this build takes
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Vec;  // one 16-byte load, widened to f32

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos_vec, int pos_scalar,
                    float* __restrict__ out, int H, int Hkv, int P,
                    int pages, int n_pool, float scale) {
  constexpr int N = Vec<T>::N;   // values per 16-byte load
  constexpr int CG = D / N;      // threads per row (a power of two <= 32)
  constexpr int RG = THREADS / CG;
  static_assert(D % N == 0 && CG <= 32 && (32 % CG) == 0, "head_dim");

  extern __shared__ __align__(16) float smem[];
  const int g = H / Hkv;
  float* qs = smem;               // (g, D) f32 queries
  float* ss = qs + g * D;         // (g, P) scores, then probabilities
  float* red = ss + g * P;        // (RG, g, D) partial accumulators
  float* ms = red + RG * g * D;   // (g,) running max
  float* ls = ms + G_MAX;         // (g,) running sum
  float* rs = ls + G_MAX;         // (g,) this page's rescale factor

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;

  int pos = pos_vec ? pos_vec[b] : pos_scalar;
  pos = min(max(pos, 0), pages * P - 1);  // the table holds `pages` pages
  const int n_live = pos / P + 1;

  const T* qrow = q + ((long)b * H + (long)hk * g) * D;
  for (int i = tid; i < g * D; i += THREADS) qs[i] = float(qrow[i]);
  if (tid < G_MAX) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  float acc[G_MAX][N];
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[gi][e] = 0.f;
  __syncthreads();

  const long head_off = (long)hk * P * D;
  const long page_stride = (long)Hkv * P * D;
  for (int j = 0; j < n_live; ++j) {
    int pid = table[(long)b * pages + j];
    pid = min(max(pid, 0), n_pool - 1);
    const T* kp = k_pool + pid * page_stride + head_off;
    const T* vp = v_pool + pid * page_stride + head_off;
    const int base = j * P;

    // A. scores. Every thread runs the same trip count, ceil(P / RG), so
    // the shuffles below see full warps; rows past the page or past pos
    // load nothing.
    for (int r0 = 0; r0 < P; r0 += RG) {
      const int r = r0 + rg;
      const bool in_page = r < P;
      const bool live = in_page && base + r <= pos;
      float kv[N];
      if (live) {
        Vec<T>::load(kp + (long)r * D + cg * N, kv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kv[e] = 0.f;
      }
      for (int gi = 0; gi < g; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) d = fmaf(qs[gi * D + cg * N + e], kv[e], d);
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (cg == 0 && in_page) ss[gi * P + r] = live ? d * scale : NEG_INF;
      }
    }
    __syncthreads();

    // B. online softmax, one warp per query row
    for (int gi = warp; gi < g; gi += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < P; r += 32) mx = fmaxf(mx, ss[gi * P + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < P; r += 32) {
        const float p = expf(ss[gi * P + r] - m_new);
        ss[gi * P + r] = p;
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

    // C. values
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi) {
      if (gi < g) {
        const float f = rs[gi];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[gi][e] *= f;
      }
    }
    for (int r = rg; r < P && base + r <= pos; r += RG) {
      float vv[N];
      Vec<T>::load(vp + (long)r * D + cg * N, vv);
#pragma unroll
      for (int gi = 0; gi < G_MAX; ++gi) {
        if (gi < g) {
          const float p = ss[gi * P + r];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[gi][e] = fmaf(p, vv[e], acc[gi][e]);
        }
      }
    }
    __syncthreads();  // ss is rewritten by the next page
  }

  // fixed-order reduction of the RG partial accumulators
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi) {
    if (gi < g) {
#pragma unroll
      for (int e = 0; e < N; ++e)
        red[(rg * g + gi) * D + cg * N + e] = acc[gi][e];
    }
  }
  __syncthreads();
  float* orow = out + ((long)b * H + (long)hk * g) * D;
  for (int i = tid; i < g * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    float s = 0.f;
    for (int t = 0; t < RG; ++t) s += red[(t * g + gi) * D + d];
    orow[i] = s / fmaxf(ls[gi], 1e-30f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* pos_vec, int pos_scalar, void* out, int B, int H,
           int Hkv, int P, int pages, int n_pool, float scale,
           cudaStream_t stream) {
  constexpr int RG = THREADS / (D / Vec<T>::N);
  const int g = H / Hkv;
  const size_t bytes =
      sizeof(float) * ((size_t)g * D + (size_t)g * P + (size_t)RG * g * D +
                       3 * G_MAX);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, D><<<B * Hkv, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, pos_vec, pos_scalar,
      static_cast<float*>(out), H, Hkv, P, pages, n_pool, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. pos: a (B,) int32 device array, or
// null with the shared position in pos_scalar. Returns cudaGetLastError()
// after the launch (0 = launched), -1 for an unsupported head_dim, -2 for
// g > G_MAX.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const int* pos, int pos_scalar, void* out,
                 int B, int H, int Hkv, int D, int P, int pages, int n_pool,
                 float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > G_MAX) return -2;
#define HPC_LAUNCH(T, DD)                                                   \
  return launch<T, DD>(q, k_pool, v_pool, table, pos, pos_scalar, out, B, \
                       H, Hkv, P, pages, n_pool, scale, s)
  if (dtype == 1) {
    if (D == 16) HPC_LAUNCH(__nv_bfloat16, 16);
    if (D == 32) HPC_LAUNCH(__nv_bfloat16, 32);
    if (D == 64) HPC_LAUNCH(__nv_bfloat16, 64);
    if (D == 128) HPC_LAUNCH(__nv_bfloat16, 128);
  } else if (dtype == 0) {
    if (D == 16) HPC_LAUNCH(float, 16);
    if (D == 32) HPC_LAUNCH(float, 32);
    if (D == 64) HPC_LAUNCH(float, 64);
    if (D == 128) HPC_LAUNCH(float, 128);
  }
#undef HPC_LAUNCH
  return -1;
}

}  // extern "C"
