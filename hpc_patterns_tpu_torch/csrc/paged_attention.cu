// Exact-softmax single-query attention through a page table, for Hopper
// (sm_90a): the decode_attn="paged_flash" route.
//
// Replaces: hpc_patterns_tpu/ops/paged_attention.py::_paged_attention_kernel
// (the Pallas kernel behind paged_attention_decode). Same math as the
// gather route (models/decode.py::_paged_attend_gather): each live K/V row
// is dequantized first (k.float() * scale for one-byte pools), then
// s = (q . kd) * scale, rows past pos get exactly zero probability, the
// softmax over the whole row is exact (one max, one sum; no online
// rescale), and out = p . vd in f32.
//
// Layout: q (B, H, D) f32 or bf16; k_pool, v_pool (n_pool, Hkv, P, D) in
// the compute dtype (as q) or int8 / float8_e4m3fn with f32 scale pools
// ks_pool, vs_pool (n_pool, Hkv, 1, P); table (B, pages) int32; pos (B,)
// int32 or one scalar; out (B, H, D) f32.
//
// Design: the TPU kernel stages the whole allocated span of K and V in
// VMEM; at the serving shape (4 pages of 256 rows, D 128, bf16) that is
// 512 KB against 227 KB of shared memory per block, so K/V are not staged.
// One CTA (128 threads) per (b, kv head) keeps only the (g, pages * P) f32
// score row in shared memory and makes three passes over the live pages
// 0 .. pos / P (pages past the fill are never read):
//   1. stream K once: scores of the live rows into the score row;
//   2. one warp per query row: the exact row max and sum, then
//      p = exp(s - max) / sum in place (masked slots are never touched
//      and contribute nothing);
//   3. stream V once: each thread accumulates p * vd over its rows and
//      16-byte column slice; the partial sums reduce in a fixed order.
// The wrapper (ops/paged_attention.py, which computes the same smem_bytes)
// refuses a score row past the shared-memory budget with a ValueError;
// long contexts belong on the online-softmax route (paged_decode.cu).
//
// What bounds it on the H100: bytes, as the paged kernel: each live K/V
// row once per step (2 * Hkv * D bytes per position and layer for
// one-byte pools, plus 8 bytes of scales per kv head; twice that in bf16).
// One CTA per (b, kv head) walking its pages with no load/compute overlap
// is latency-bound at the serving shape (64 CTAs on 132 SMs).

#include "decode_common.cuh"

namespace {

using hpc_decode::G_MAX;
using hpc_decode::THREADS;
using hpc_decode::Vec;
using hpc_decode::WARPS;

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q,
                       const TK* __restrict__ k_pool,
                       const TK* __restrict__ v_pool,
                       const float* __restrict__ ks_pool,
                       const float* __restrict__ vs_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ pos_vec, int pos_scalar,
                       float* __restrict__ out, int H, int Hkv, int P,
                       int pages, int n_pool, float scale) {
  constexpr int N = Vec<TK>::N;
  constexpr int CG = D / N;
  constexpr int RG = THREADS / CG;
  static_assert(D % N == 0 && CG <= 32 && (32 % CG) == 0, "head_dim");

  extern __shared__ __align__(16) float smem[];
  const int g = H / Hkv;
  const int S = pages * P;
  float* qs = smem;            // (g, D) f32 queries
  float* ss = qs + g * D;      // (g, S) scores, then probabilities
  float* red = ss + g * S;     // (RG, g, D) partial accumulators

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  int pos = pos_vec ? pos_vec[b] : pos_scalar;
  pos = min(max(pos, 0), S - 1);
  const int n_live = pos / P + 1;

  const TQ* qrow = q + ((long)b * H + (long)hk * g) * D;
  for (int i = tid; i < g * D; i += THREADS)
    qs[i] = hpc_decode::to_f32(qrow[i]);
  __syncthreads();

  const long page_stride = (long)Hkv * P * D;
  const long head_off = (long)hk * P * D;

  // 1. scores of the live rows. Every thread runs the same trip count per
  // page so the shuffles see full warps.
  for (int j = 0; j < n_live; ++j) {
    int pid = table[(long)b * pages + j];
    pid = min(max(pid, 0), n_pool - 1);
    const TK* kp = k_pool + pid * page_stride + head_off;
    const float* ksr = ks_pool ? ks_pool + ((long)pid * Hkv + hk) * P
                               : nullptr;
    for (int r0 = 0; r0 < P; r0 += RG) {
      const int r = r0 + rg;
      const bool live = r < P && j * P + r <= pos;
      float kd[N];
      if (live) {
        Vec<TK>::load(kp + (long)r * D + cg * N, kd);
        if (ksr) {  // dequantize first, as the gather view does
          const float sc = ksr[r];
#pragma unroll
          for (int e = 0; e < N; ++e) kd[e] *= sc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kd[e] = 0.f;
      }
      for (int gi = 0; gi < g; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) d = fmaf(qs[gi * D + cg * N + e], kd[e], d);
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (cg == 0 && live) ss[gi * S + j * P + r] = d * scale;
      }
    }
  }
  __syncthreads();

  // 2. exact softmax over rows [0, pos], one warp per query row
  for (int gi = warp; gi < g; gi += WARPS) {
    float* srow = ss + gi * S;
    float mx = hpc_decode::NEG_INF;
    for (int r = lane; r <= pos; r += 32) mx = fmaxf(mx, srow[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r <= pos; r += 32) {
      const float e = expf(srow[r] - mx);
      srow[r] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    for (int r = lane; r <= pos; r += 32) srow[r] = srow[r] / sum;
  }
  __syncthreads();

  // 3. p . vd over the live rows
  float acc[G_MAX][N];
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[gi][e] = 0.f;
  for (int j = 0; j < n_live; ++j) {
    int pid = table[(long)b * pages + j];
    pid = min(max(pid, 0), n_pool - 1);
    const TK* vp = v_pool + pid * page_stride + head_off;
    const float* vsr = vs_pool ? vs_pool + ((long)pid * Hkv + hk) * P
                               : nullptr;
    for (int r = rg; r < P && j * P + r <= pos; r += RG) {
      float vd[N];
      Vec<TK>::load(vp + (long)r * D + cg * N, vd);
      if (vsr) {
        const float sc = vsr[r];
#pragma unroll
        for (int e = 0; e < N; ++e) vd[e] *= sc;
      }
#pragma unroll
      for (int gi = 0; gi < G_MAX; ++gi) {
        if (gi < g) {
          const float p = ss[gi * S + j * P + r];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[gi][e] = fmaf(p, vd[e], acc[gi][e]);
        }
      }
    }
  }
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
    orow[i] = s;
  }
}

template <typename TK, int D>
size_t smem_bytes(int g, int S) {
  constexpr int RG = THREADS / (D / Vec<TK>::N);
  return sizeof(float) *
         ((size_t)g * D + (size_t)g * S + (size_t)RG * g * D);
}

template <typename TQ, typename TK, int D>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* table, const int* pos_vec,
           int pos_scalar, void* out, int B, int H, int Hkv, int P,
           int pages, int n_pool, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<TK, D>(H / Hkv, pages * P);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<TQ, TK, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<TQ, TK, D><<<B * Hkv, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(kp),
      static_cast<const TK*>(vp), ks, vs, table, pos_vec, pos_scalar,
      static_cast<float*>(out), H, Hkv, P, pages, n_pool, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes, pos and return codes as paged_decode (paged_decode.cu).
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const float* ks_pool, const float* vs_pool,
                    const int* table, const int* pos, int pos_scalar,
                    void* out, int B, int H, int Hkv, int D, int P,
                    int pages, int n_pool, float scale, int q_dtype,
                    int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > G_MAX) return -2;
#define LAUNCH(TQ, TK, DD)                                                 \
  return launch<TQ, TK, DD>(q, k_pool, v_pool, ks_pool, vs_pool, table,   \
                            pos, pos_scalar, out, B, H, Hkv, P, pages,    \
                            n_pool, scale, s)
  HPC_DECODE_DISPATCH(q_dtype, kv_dtype);
#undef LAUNCH
  return -1;
}

}  // extern "C"
