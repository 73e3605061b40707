// Single-query attention against the LINEAR KV cache, for Hopper (sm_90a):
// flash-decoding, the live rows split over the sequence and merged by lse.
//
// Replaces: hpc_patterns_tpu/ops/flash_decode.py::_decode_kernel (the
// Pallas kernel behind flash_decode_attention, run once per layer per
// decode step by decode_step on the linear cache). Same math as the paged
// kernel (paged_decode.cu): the g = H / Hkv query rows sharing a kv head
// attend rows [0, pos] of that head's cache; scores and values in f32,
// per-row dequant scales folded into the scores and probabilities for
// one-byte caches, mask -1e30, out = acc / max(l, 1e-30) in f32.
//
// Layout: q (B, H, D) f32 or bf16; k, v (B, Hkv, S_max, D) in the compute
// dtype (as q) or int8 / float8_e4m3fn with f32 scales ks, vs
// (B, Hkv, S_max); pos one host int shared by the batch; out (B, H, D) f32.
//
// What bounds it on the H100: bytes, and at the sizes decode sees, the
// latency of getting them in flight. A step reads each live K/V row once:
// 2 * Hkv * D bytes per position and layer in int8/fp8 (plus 8 bytes of
// scales per kv head), twice that in bf16. At the precision law's shape
// (B 4, Hkv 8, D 128, pos 519) that is 4.2 MB in int8 and 8.5 MB in bf16,
// 1.3 and 2.5 us at 3.35 TB/s: less than a launch. One CTA per (sequence,
// kv head) gives that shape 32 CTAs on 132 SMs (8 with Hkv 2); the design
// puts enough CTAs and enough loads in flight to cover the latency.
//
// Design (the wrapper, ops/flash_decode.py, plans the split from the host
// int pos, B * Hkv and the SM count: decode_chunks()):
// - pass 1 runs one CTA per (b * Hkv + hk, chunk). Thread (rg, cg) owns
//   the 16-byte column slice cg of the head and rows rg + RG j of each step
//   of RB rows: it issues all R of its K loads and then all R V loads (with
//   their scales) before it reads any, so a CTA has its whole step (up to
//   32 KB) in flight; scores reduce over the slice's lanes by shuffles, and
//   each thread keeps its own online softmax state (m, l, acc) over its
//   rows. At the end the states merge by lse, first across the row groups
//   of a warp (shuffles), then across the four warps (shared memory, in
//   warp order). With one chunk (a shape whose kv rows fill the card, or
//   few live rows) the CTA writes acc / max(l, 1e-30) to out and nothing
//   else runs; with more, the chunk's unnormalised (g x D) accumulator and
//   (m, l) of its g query rows go to the f32 workspace the wrapper
//   allocated;
// - pass 2 (decode_merge_kernel, one CTA of D threads per (b, h), n_chunks
//   > 1 only): m* = max m_i, l = sum l_i e^(m_i - m*), out = sum acc_i
//   e^(m_i - m*) / max(l, 1e-30), over the chunks in index order (each
//   weight taken once into shared memory, the sums unrolled so that several
//   chunks' loads are in flight). It is launched as a programmatic
//   dependent of pass 1 (griddepcontrol), so its launch overlaps pass 1's
//   tail.
// No atomics, and every sum runs in a fixed order: two calls give equal
// bits. No tensor cores: g <= 8 query rows is far below wgmma's 64.

#include "decode_common.cuh"

namespace {

using hpc_decode::G_MAX;
using hpc_decode::NEG_INF;
using hpc_decode::THREADS;
using hpc_decode::Vec;
using hpc_decode::WARPS;
using hpc_decode::to_f32;

// The lanes of pass 1 for a cache type, head_dim and query-row bound G:
// N values a 16-byte load, CG threads across a row, RG rows side by side,
// R rows a thread a step (all loads of a step issued before any is read:
// up to 64 rows a step, fewer as G grows, since each row keeps G scores
// in registers beside the (G, N) accumulator), RB rows a step.
template <typename TK, int D, int G>
struct Lanes {
  static constexpr int N = Vec<TK>::N;
  static constexpr int CG = D / N;
  static constexpr int RG = THREADS / CG;
  static constexpr int R_ROWS = RG >= 64 ? 1 : 64 / RG;
  static constexpr int R_REGS = 16 / G;
  static constexpr int R = R_ROWS < R_REGS ? R_ROWS : R_REGS > 0 ? R_REGS : 1;
  static constexpr int RB = RG * R;
  static_assert(D % N == 0 && CG <= 32 && (32 % CG) == 0, "head_dim");
};

// Fold the state (mo, lo, ao) into (m, l, a): both sums rescaled to the
// larger max. A state that saw no row has m = -1e30, l = 0, a = 0.
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&a)[N],
                                            float mo, float lo,
                                            const float (&ao)[N]) {
  const float mn = fmaxf(m, mo);
  const float x = expf(m - mn), y = expf(mo - mn);
  l = l * x + lo * y;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * x + ao[e] * y;
  m = mn;
}

// Pass 1: one CTA per (cache row b * Hkv + hk, chunk); the chunk's rows
// [lo, hi) with hi <= pos + 1. G >= g is the compile-time bound on the
// query rows (the registers of acc); rows gi >= g are never stored. One
// chunk stores the normalised rows to out, more their partials to part_*.
template <typename TK, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_chunk_kernel(const void* __restrict__ q, int q_bf16,
                    const TK* __restrict__ k, const TK* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs, int pos,
                    float* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int n_chunks, int chunk,
                    int H, int Hkv, int S, float scale) {
  using L = Lanes<TK, D, G>;
  constexpr int N = L::N, CG = L::CG, RG = L::RG, R = L::R;
  __shared__ __align__(16) float qs[G * D];
  __shared__ __align__(16) float red[WARPS][G][D];
  __shared__ float red_m[WARPS][G], red_l[WARPS][G];
  // the merge kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int g = H / Hkv;
  const long row = blockIdx.x;  // b * Hkv + hk
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int c = blockIdx.y;
  const int lo = c * chunk, hi = min(lo + chunk, pos + 1);
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  const long q0 = ((long)b * H + (long)hk * g) * D;
  for (int i = tid; i < g * D; i += THREADS)
    qs[i] = q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[q0 + i])
                   : static_cast<const float*>(q)[q0 + i];
  __syncthreads();
  const TK* kr = k + row * S * D + cg * N;
  const TK* vr = v + row * S * D + cg * N;
  const float* ksr = ks ? ks + row * S : nullptr;
  const float* vsr = vs ? vs + row * S : nullptr;

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[gi][e] = 0.f;
  }

  for (int base = lo; base < hi; base += L::RB) {
    // every load of the step in flight before any is read; rows past hi
    // load nothing and stay 0 (so 0 * value is never 0 * garbage)
    uint4 kraw[R], vraw[R];
    float ksc[R], vsc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = base + rg + j * RG;
      kraw[j] = make_uint4(0u, 0u, 0u, 0u);
      ksc[j] = 1.f;
      if (r < hi) {
        kraw[j] = __ldg(reinterpret_cast<const uint4*>(kr + (long)r * D));
        if (ksr) ksc[j] = __ldg(ksr + r);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = base + rg + j * RG;
      vraw[j] = make_uint4(0u, 0u, 0u, 0u);
      vsc[j] = 1.f;
      if (r < hi) {
        vraw[j] = __ldg(reinterpret_cast<const uint4*>(vr + (long)r * D));
        if (vsr) vsc[j] = __ldg(vsr + r);
      }
    }
    // scores of the thread's rows (every lane runs every shuffle: the
    // lanes of a row share its liveness)
    float s[R][G];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = base + rg + j * RG < hi;
      float kv[N];
      Vec<TK>::cvt(kraw[j], kv);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
        if (gi < g) {
          const float4* qv =
              reinterpret_cast<const float4*>(qs + gi * D + cg * N);
#pragma unroll
          for (int e4 = 0; e4 < N / 4; ++e4) {
            const float4 x = qv[e4];
            d = fmaf(x.x, kv[4 * e4], d);
            d = fmaf(x.y, kv[4 * e4 + 1], d);
            d = fmaf(x.z, kv[4 * e4 + 2], d);
            d = fmaf(x.w, kv[4 * e4 + 3], d);
          }
        }
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[j][gi] = live ? d * scale * ksc[j] : NEG_INF;
      }
    }
    // the thread's online softmax over its rows of the step
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int j = 0; j < R; ++j) mx = fmaxf(mx, s[j][gi]);
      const float alpha = expf(m[gi] - mx);
      m[gi] = mx;
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[gi][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = base + rg + j * RG < hi;
      float vv[N];
      Vec<TK>::cvt(vraw[j], vv);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = live ? expf(s[j][gi] - m[gi]) : 0.f;
        l[gi] += p;
        const float pv = p * vsc[j];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[gi][e] = fmaf(pv, vv[e], acc[gi][e]);
      }
    }
  }

  // merge the row groups of each warp (lanes CG apart share a slice)
#pragma unroll
  for (int off = CG; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float ao[N];
#pragma unroll
      for (int e = 0; e < N; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], off);
      merge_state<N>(m[gi], l[gi], acc[gi], mo, lo_, ao);
    }
  }
  // then the warps, in order, through shared memory
  if (lane < CG) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int e = 0; e < N; ++e) red[warp][gi][cg * N + e] = acc[gi][e];
        if (lane == 0) {
          red_m[warp][gi] = m[gi];
          red_l[warp][gi] = l[gi];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w][gi]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = expf(red_m[w][gi] - mx);
      ls += red_l[w][gi] * x;
      a += red[w][gi][d] * x;
    }
    const long bh = (long)b * H + (long)hk * g + gi;
    if (n_chunks == 1) {
      out[bh * D + d] = a / fmaxf(ls, 1e-30f);
      continue;
    }
    part_acc[(bh * n_chunks + c) * D + d] = a;
    if (d == 0) {
      part_ml[(bh * n_chunks + c) * 2] = mx;
      part_ml[(bh * n_chunks + c) * 2 + 1] = ls;
    }
  }
}

// Pass 2: one CTA of D threads per query row b * H + h. Each chunk's
// weight e^(m_i - m*) is taken once into shared memory, then every thread
// sums its column over the chunks in index order (unrolled, so that the
// loads of several chunks are in flight together).
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    int n_chunks, int D,
                                    float* __restrict__ out) {
  extern __shared__ float wts[];  // (n_chunks,)
  // pass 1's writes are complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * n_chunks * 2;
  float mx = NEG_INF;
#pragma unroll 8
  for (int i = 0; i < n_chunks; ++i) mx = fmaxf(mx, ml[2 * i]);
  for (int i = d; i < n_chunks; i += blockDim.x)
    wts[i] = expf(ml[2 * i] - mx);
  __syncthreads();
  const float* acc = part_acc + bh * n_chunks * D + d;
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_chunks; ++i) {
    l += ml[2 * i + 1] * wts[i];
    a += acc[(long)i * D] * wts[i];
  }
  out[bh * D + d] = a / fmaxf(l, 1e-30f);
}

template <typename TK, int D, int G>
int launch_split(const void* q, int q_bf16, const void* k, const void* v,
                 const float* ks, const float* vs, int pos, void* out,
                 float* part, int n_chunks, int chunk, int B, int H, int Hkv,
                 int S, float scale, cudaStream_t stream) {
  float* part_acc = part;
  float* part_ml = n_chunks > 1 ? part + (long)B * H * n_chunks * D : nullptr;
  decode_chunk_kernel<TK, D, G><<<dim3(B * Hkv, n_chunks), THREADS, 0,
                                  stream>>>(
      q, q_bf16, static_cast<const TK*>(k), static_cast<const TK*>(v), ks,
      vs, pos, static_cast<float*>(out), part_acc, part_ml, n_chunks, chunk,
      H, Hkv, S, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = sizeof(float) * n_chunks;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_merge_kernel,
                           static_cast<const float*>(part_acc),
                           static_cast<const float*>(part_ml), n_chunks, D,
                           static_cast<float*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TK, int D>
int launch_split_g(const void* q, int q_bf16, const void* k, const void* v,
                   const float* ks, const float* vs, int pos, void* out,
                   float* part, int n_chunks, int chunk, int B, int H,
                   int Hkv, int S, float scale, cudaStream_t s) {
  const int g = H / Hkv;
#define HPC_SPLIT_G(GG)                                                    \
  return launch_split<TK, D, GG>(q, q_bf16, k, v, ks, vs, pos, out, part, \
                                 n_chunks, chunk, B, H, Hkv, S, scale, s)
  if (g <= 1) HPC_SPLIT_G(1);
  if (g <= 2) HPC_SPLIT_G(2);
  if (g <= 4) HPC_SPLIT_G(4);
  HPC_SPLIT_G(8);
#undef HPC_SPLIT_G
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 =
// bfloat16 (both as q), 2 = int8, 3 = float8_e4m3fn (with ks/vs scales;
// null for compute-dtype caches). It returns cudaGetLastError() after
// its launches (0 = launched), -1 for an unsupported (q, kv, head_dim)
// combination, -2 for g > G_MAX.

// Rows [0, pos] in n_chunks chunks of `chunk` rows (the last ragged, none
// empty: (n_chunks - 1) * chunk <= pos < n_chunks * chunk), then their
// merge. `part` is the f32 workspace of B * H * n_chunks * (D + 2) values:
// the unnormalised accumulators (B*H, n_chunks, D), then (m, l) (B*H,
// n_chunks, 2); one chunk takes none (part may be null) and launches one
// kernel. Also -3 for a chunking that does not cover [0, pos], or more
// than one chunk without a workspace.
int flash_decode_split(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, int pos, void* out,
                       float* part, int n_chunks, int chunk, int B, int H,
                       int Hkv, int D, int S, float scale, int q_dtype,
                       int kv_dtype, void* stream) {
  using hpc_decode::BF16;
  using hpc_decode::F32;
  using hpc_decode::FP8;
  using hpc_decode::I8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > G_MAX) return -2;
  if (pos < 0 || pos >= S || n_chunks < 1 || chunk < 1 ||
      (long)(n_chunks - 1) * chunk > pos || (long)n_chunks * chunk <= pos ||
      (n_chunks > 1 && part == nullptr))
    return -3;
  if (q_dtype != F32 && q_dtype != BF16) return -1;
  const int qb = q_dtype == BF16;
#define HPC_SPLIT(TK, DD)                                                  \
  return launch_split_g<TK, DD>(q, qb, k, v, ks, vs, pos, out, part,      \
                                n_chunks, chunk, B, H, Hkv, S, scale, s)
#define HPC_SPLIT_D(TK)                      \
  do {                                       \
    if (D == 16) HPC_SPLIT(TK, 16);          \
    if (D == 32) HPC_SPLIT(TK, 32);          \
    if (D == 64) HPC_SPLIT(TK, 64);          \
    if (D == 128) HPC_SPLIT(TK, 128);        \
  } while (0)
  // compute-dtype caches match q; one-byte caches take either q
  if (kv_dtype == F32 && q_dtype == F32) HPC_SPLIT_D(float);
  if (kv_dtype == BF16 && q_dtype == BF16) HPC_SPLIT_D(__nv_bfloat16);
  if (kv_dtype == I8) HPC_SPLIT_D(int8_t);
  if (kv_dtype == FP8) HPC_SPLIT_D(__nv_fp8_e4m3);
#undef HPC_SPLIT_D
#undef HPC_SPLIT
  return -1;
}

}  // extern "C"
