// Exact-softmax single-query attention through a page table, for Hopper
// (sm_90a): the decode_attn="paged_flash" route, split over fixed chunks
// of each sequence's rows and merged by lse.
//
// Replaces: hpc_patterns_tpu/ops/paged_attention.py::_paged_attention_kernel
// (the Pallas kernel behind paged_attention_decode). Same math as the
// gather route (models/decode.py::_paged_attend_gather): each live K/V row
// is dequantized first (k.float() * scale for one-byte pools), then
// s = (q . kd) * scale, rows past pos get exactly zero probability, the
// softmax is exact (one max over the scores, then the exponentials and
// their sum; no running rescale), and out = p . vd in f32.
//
// Layout: q (B, H, D) f32 or bf16; k_pool, v_pool (n_pool, Hkv, P, D) in
// the compute dtype (as q) or int8 / float8_e4m3fn with f32 scale pools
// ks_pool, vs_pool (n_pool, Hkv, 1, P); table (B, pages) int32; pos (B,)
// int32 on the device or one scalar; out (B, H, D) f32.
//
// What bounds it on the H100: bytes, and at decode's sizes the latency of
// getting them in flight. A step reads each live K/V row once (2 * Hkv * D
// bytes per position and layer for one-byte pools plus 8 bytes of scales a
// kv head, twice the values in bf16): at the serving shape (B 8, Hkv 8,
// D 128, page 256, fills up to 1023) at most 16.8 MB in int8, 5 us at
// 3.35 TB/s. One CTA per (sequence, kv head) walking its whole row, as the
// TPU kernel's grid row does, is 64 CTAs on 132 SMs there.
//
// Design: the TPU kernel stages a sequence's whole K/V span in VMEM and
// takes one softmax over it. Here each sequence's rows split into chunks
// of a length the wrapper fixes by the page size alone (ops/flash_decode.py
// ::paged_decode_chunk, 128 rows at P 256), never by the batch, the kv
// heads or the card, so a sequence's bits depend only on its own q, pages
// and pos. pos lives on the device: the host plans n_chunks from the table
// width, and both passes read pos[b] on the card and clamp it alike.
// - Pass 1, one CTA (128 threads) per (b * Hkv + hk, chunk c); a chunk that
//   starts past pos[b] exits. The CTA stages its page bases in shared
//   memory (decode_split.cuh's stage_pages), then keeps the JAX kernel's
//   form inside the chunk:
//   1. scores: thread (rg, cg) owns the 16-byte column slice cg and rows
//      rg + RG j; it issues every K load of a step (and its scale), and
//      with the first step the first V step's loads, before it reads any
//      (for one-byte pools at D 128 a 128-row chunk is one K step, and one
//      V step at g <= 4: the chunk's K and V are in flight at once),
//      dequantizes each row (kd = k * kscale), dots it with the g query
//      rows and reduces over the slice's lanes by shuffles; the (g, chunk)
//      f32 scores go to shared memory (4 KB at g 8);
//   2. the exact softmax, one warp per query row: the max over all the
//      chunk's scores, then e = exp(s - max) and their sum, in place;
//   3. p . vd: every V load of a step in flight before any is read (the
//      first step's issued in step 1), each row dequantized, the (g,
//      slice) accumulators in registers, reduced over the row groups by
//      shuffles and then over the four warps in order through shared
//      memory.
//   A chunk that holds every live row (pos[b] < chunk) normalises its rows
//   in place (out = (e . vd) / sum) and writes out; any other writes its
//   unnormalised accumulator and (max, sum) to the f32 workspace (B*H,
//   n_chunks, D) then (B*H, n_chunks, 2).
// - Pass 2 (decode_split.cuh's paged_merge_kernel, a programmatic
//   dependent launch, only when the table holds more than one chunk): one
//   CTA of D threads per (b, h) merges chunks 0 .. pos[b] / chunk by lse in
//   index order; it does nothing when chunk 0 held every live row.
// No atomics, and every sum runs in a fixed order: two calls give equal
// bits. Kernel 6 (paged_decode.cu) splits the same way but keeps an online
// softmax per thread and folds the scales into scores and probabilities;
// this kernel keeps the exact softmax of the chunk and dequantizes first.

#include "decode_split.cuh"
#include "smem_rows.cuh"

namespace {

using hpc_decode::G_MAX;
using hpc_decode::NEG_INF;
using hpc_decode::PAGED_CHUNK_MAX;
using hpc_decode::PagedRows;
using hpc_decode::THREADS;
using hpc_decode::Vec;
using hpc_decode::WARPS;

// Pass 1: one CTA per (b * Hkv + hk, chunk). Chunks past pos[b] exit.
// (With the thread count alone as its bound, ptxas capped most of these
// instantiations at 48-96 registers and spilled a few; asking for one
// resident block lets it take what it needs, and none spills.)
template <typename TK, int D, int G>
__global__ void __launch_bounds__(THREADS, 1)
paged_attention_chunk_kernel(const void* __restrict__ q, int q_bf16,
                             const TK* __restrict__ k_pool,
                             const TK* __restrict__ v_pool,
                             const float* __restrict__ ks_pool,
                             const float* __restrict__ vs_pool,
                             const int* __restrict__ table,
                             const int* __restrict__ pos_vec, int pos_scalar,
                             float* __restrict__ out,
                             float* __restrict__ part_acc,
                             float* __restrict__ part_ml, int n_chunks,
                             int chunk, int H, int Hkv, int P, int p_shift,
                             int pages, int n_pool, float scale) {
  // the lanes of decode_split.cuh: N values a 16-byte load, CG threads
  // across a row, RG rows side by side; a thread's K rows a step (RK) and
  // V rows a step (RV, fewer as the (G, N) accumulator grows), at most 8
  // (of 8 and 16 rows a step, 8 measured as fast or faster on an H100 at
  // the serving shape): one-byte pools at D 128 take a 128-row chunk in
  // one K step, and in one V step at g <= 4
  using L = hpc_decode::Lanes<TK, D, G>;
  constexpr int N = L::N, CG = L::CG, RG = L::RG;
  constexpr int R_CHUNK = 128 / RG > 1 ? 128 / RG : 1;
  constexpr int RK = R_CHUNK < 8 ? R_CHUNK : 8;
  constexpr int RV = RK < 32 / G ? RK : (32 / G > 1 ? 32 / G : 1);
  __shared__ long page_base[PAGED_CHUNK_MAX + 2];
  __shared__ __align__(16) float qs[G * D];
  __shared__ float ss[G][PAGED_CHUNK_MAX];  // scores, then probabilities
  __shared__ __align__(16) float red[WARPS][G][D];
  __shared__ float ms[G], ls[G];

  // the merge kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int c = blockIdx.y;
  const int pos = hpc_decode::live_pos(pos_vec, pos_scalar, b, pages * P);
  const int lo = c * chunk;
  if (lo > pos) return;  // past the fill: the merge does not read it
  const int n = min(chunk, pos + 1 - lo);
  const bool one = pos < chunk;  // this chunk holds every live row
  const long bh0 = (long)b * H + (long)hk * g;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < g * D; i += THREADS)
    qs[i] = q_bf16 ? hpc_decode::to_f32(
                         static_cast<const __nv_bfloat16*>(q)[bh0 * D + i])
                   : static_cast<const float*>(q)[bh0 * D + i];
  const PagedRows<TK> rows = hpc_decode::stage_pages(
      page_base, k_pool, v_pool, ks_pool, vs_pool, table, b, hk, lo, lo + n,
      Hkv, P, p_shift, pages, n_pool);  // its barrier also covers qs
  const TK* kc = rows.k + cg * N;
  const TK* vc = rows.v + cg * N;

  // the V rows of a step, loaded ahead of their use: the first step's go
  // out with the first K loads, so the chunk's K and V are in flight at
  // once; rows past n load nothing and stay 0
  uint4 vraw[RV];
  float vsc[RV];
  auto load_v = [&](int base) {
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      const int r = base + rg + j * RG;
      vraw[j] = make_uint4(0u, 0u, 0u, 0u);
      vsc[j] = 1.f;
      if (r < n) {
        const long ri = rows.index(lo + r);
        vraw[j] = __ldg(reinterpret_cast<const uint4*>(vc + ri * D));
        if (rows.vs) vsc[j] = __ldg(rows.vs + ri);
      }
    }
  };

  // 1. scores of the chunk's rows. The trip counts are the CTA's, so every
  // lane runs every shuffle; rows past n load nothing.
  for (int base = 0; base < n; base += RG * RK) {
    uint4 raw[RK];
    float sc[RK];
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int r = base + rg + j * RG;
      raw[j] = make_uint4(0u, 0u, 0u, 0u);
      sc[j] = 1.f;
      if (r < n) {
        const long ri = rows.index(lo + r);
        raw[j] = __ldg(reinterpret_cast<const uint4*>(kc + ri * D));
        if (rows.ks) sc[j] = __ldg(rows.ks + ri);
      }
    }
    if (base == 0) load_v(0);
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int r = base + rg + j * RG;
      float kd[N];
      Vec<TK>::cvt(raw[j], kd);
      if (rows.ks) {  // dequantize first, as the gather view does
#pragma unroll
        for (int e = 0; e < N; ++e) kd[e] *= sc[j];
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
        if (gi < g) {
#pragma unroll
          for (int e = 0; e < N; ++e)
            d = fmaf(qs[gi * D + cg * N + e], kd[e], d);
        }
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (gi < g && cg == 0 && r < n) ss[gi][r] = d * scale;
      }
    }
  }
  __syncthreads();

  // 2. the exact softmax of the chunk, one warp per query row
  for (int gi = warp; gi < g; gi += WARPS) {
    float mx = NEG_INF;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ss[gi][r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(ss[gi][r] - mx);
      ss[gi][r] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ms[gi] = mx;
      ls[gi] = sum;
    }
  }
  __syncthreads();

  // 3. p . vd over the chunk's rows
  float acc[G][N];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[gi][e] = 0.f;
  for (int base = 0; base < n; base += RG * RV) {
    if (base > 0) load_v(base);
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      const int r = base + rg + j * RG;
      if (r >= n) continue;
      float vd[N];
      Vec<TK>::cvt(vraw[j], vd);
      if (rows.vs) {
#pragma unroll
        for (int e = 0; e < N; ++e) vd[e] *= vsc[j];
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < g) {
          const float p = ss[gi][r];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[gi][e] = fmaf(p, vd[e], acc[gi][e]);
        }
      }
    }
  }
  // the row groups of a warp (lanes CG apart share a slice), then the
  // warps in order through shared memory
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
  if (lane < CG) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int e = 0; e < N; ++e) red[warp][gi][cg * N + e] = acc[gi][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += red[w][gi][d];
    const long bh = bh0 + gi;
    if (one) {
      out[bh * D + d] = a / ls[gi];
      continue;
    }
    part_acc[(bh * n_chunks + c) * D + d] = a;
    if (d == 0) {
      part_ml[(bh * n_chunks + c) * 2] = ms[gi];
      part_ml[(bh * n_chunks + c) * 2 + 1] = ls[gi];
    }
  }
}

template <typename TK, int D, int G>
int launch(const void* q, int q_bf16, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* table,
           const int* pos_vec, int pos_scalar, void* out, float* part,
           int n_chunks, int chunk, int B, int H, int Hkv, int P, int pages,
           int n_pool, float scale, cudaStream_t stream) {
  float* part_acc = part;
  float* part_ml = n_chunks > 1 ? part + (long)B * H * n_chunks * D : nullptr;
  paged_attention_chunk_kernel<TK, D, G>
      <<<dim3(B * Hkv, n_chunks), THREADS, 0, stream>>>(
          q, q_bf16, static_cast<const TK*>(kp), static_cast<const TK*>(vp),
          ks, vs, table, pos_vec, pos_scalar, static_cast<float*>(out),
          part_acc, part_ml, n_chunks, chunk, H, Hkv, P,
          hpc_decode::page_shift(P), pages, n_pool, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  return (int)hpc_decode::launch_merge(
      hpc_decode::paged_merge_kernel, B * H, D, n_chunks, stream,
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      pos_vec, pos_scalar, pages * P, n_chunks, chunk, H, D,
      static_cast<float*>(out));
}

template <typename TK, int D>
int launch_g(const void* q, int q_bf16, const void* kp, const void* vp,
             const float* ks, const float* vs, const int* table,
             const int* pos_vec, int pos_scalar, void* out, float* part,
             int n_chunks, int chunk, int B, int H, int Hkv, int P, int pages,
             int n_pool, float scale, cudaStream_t s) {
  const int g = H / Hkv;
#define HPC_EXACT_G(GG)                                                     \
  return launch<TK, D, GG>(q, q_bf16, kp, vp, ks, vs, table, pos_vec,      \
                           pos_scalar, out, part, n_chunks, chunk, B, H,   \
                           Hkv, P, pages, n_pool, scale, s)
  if (g <= 1) HPC_EXACT_G(1);
  if (g <= 2) HPC_EXACT_G(2);
  if (g <= 4) HPC_EXACT_G(4);
  HPC_EXACT_G(8);
#undef HPC_EXACT_G
}

}  // namespace

extern "C" {

// The arguments, dtype codes and return codes of paged_decode_split
// (paged_decode.cu): q_dtype 0 = float32, 1 = bfloat16; kv_dtype 0 =
// float32, 1 = bfloat16 (both as q), 2 = int8, 3 = float8_e4m3fn (with
// ks/vs scale pools; null for compute-dtype pools); pos a (B,) int32
// device array, or null with the shared position in pos_scalar; the
// table's pages * P rows in n_chunks = ceil(pages * P / chunk) chunks
// (chunk <= 256); `part` the f32 workspace of B * H * n_chunks * (D + 2)
// values (null when n_chunks is 1). Returns cudaGetLastError() after the
// launches (0 = launched), -1 for an unsupported (q, kv, head_dim)
// combination, -2 for g > G_MAX, -3 for a plan that does not cover the
// table or a missing workspace.
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const float* ks_pool, const float* vs_pool,
                    const int* table, const int* pos, int pos_scalar,
                    void* out, float* part, int n_chunks, int chunk, int B,
                    int H, int Hkv, int D, int P, int pages, int n_pool,
                    float scale, int q_dtype, int kv_dtype, void* stream) {
  using hpc_decode::BF16;
  using hpc_decode::F32;
  using hpc_decode::FP8;
  using hpc_decode::I8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > G_MAX) return -2;
  if (chunk < 1 || chunk > PAGED_CHUNK_MAX || P < 1 || pages < 1 ||
      n_chunks != (int)(((long)pages * P + chunk - 1) / chunk) ||
      (n_chunks > 1 && part == nullptr))
    return -3;
  if (q_dtype != F32 && q_dtype != BF16) return -1;
  const int qb = q_dtype == BF16;
#define HPC_EXACT(TK, DD)                                                   \
  return launch_g<TK, DD>(q, qb, k_pool, v_pool, ks_pool, vs_pool, table,  \
                          pos, pos_scalar, out, part, n_chunks, chunk, B, H, \
                          Hkv, P, pages, n_pool, scale, s)
#define HPC_EXACT_D(TK)                      \
  do {                                       \
    if (D == 16) HPC_EXACT(TK, 16);          \
    if (D == 32) HPC_EXACT(TK, 32);          \
    if (D == 64) HPC_EXACT(TK, 64);          \
    if (D == 128) HPC_EXACT(TK, 128);        \
  } while (0)
  // compute-dtype pools match q; one-byte pools take either q
  if (kv_dtype == F32 && q_dtype == F32) HPC_EXACT_D(float);
  if (kv_dtype == BF16 && q_dtype == BF16) HPC_EXACT_D(__nv_bfloat16);
  if (kv_dtype == I8) HPC_EXACT_D(int8_t);
  if (kv_dtype == FP8) HPC_EXACT_D(__nv_fp8_e4m3);
#undef HPC_EXACT_D
#undef HPC_EXACT
  return -1;
}

}  // extern "C"

#define HPCPAT_G_ROWS(K, TK, DD)                                          \
  HPCPAT_SMEM_ROW(0, K<TK, DD, 1>), HPCPAT_SMEM_ROW(0, K<TK, DD, 2>),       \
      HPCPAT_SMEM_ROW(0, K<TK, DD, 4>), HPCPAT_SMEM_ROW(0, K<TK, DD, 8>)
#define HPCPAT_D_ROWS(K, TK)                                                \
  HPCPAT_G_ROWS(K, TK, 16), HPCPAT_G_ROWS(K, TK, 32), HPCPAT_G_ROWS(K, TK, 64), \
      HPCPAT_G_ROWS(K, TK, 128)
#define HPCPAT_T_ROWS(K)                                                    \
  HPCPAT_D_ROWS(K, float), HPCPAT_D_ROWS(K, __nv_bfloat16),                 \
      HPCPAT_D_ROWS(K, int8_t), HPCPAT_D_ROWS(K, __nv_fp8_e4m3)
// the merge's dynamic bytes are n_chunks floats, set per call
HPCPAT_SMEM_EXPORT(HPCPAT_T_ROWS(paged_attention_chunk_kernel),
                   HPCPAT_SMEM_ROW(-1, hpc_decode::paged_merge_kernel))
#undef HPCPAT_T_ROWS
#undef HPCPAT_D_ROWS
#undef HPCPAT_G_ROWS
