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
// int pos, B * Hkv and the SM count: decode_chunks()): the split of
// decode_split.cuh, shared with the paged kernel (paged_decode.cu) through
// a row functor (LinearRows: row r of the sequence's cache block).
// - pass 1 runs one CTA per (b * Hkv + hk, chunk), every load of a step in
//   flight before any is widened, a per-thread online state merged by lse
//   across row groups and warps in a fixed order. With one chunk (a shape
//   whose kv rows fill the card, or few live rows) the CTA writes
//   acc / max(l, 1e-30) to out and nothing else runs; with more, the
//   chunk's unnormalised accumulator and (m, l) go to the f32 workspace
//   the wrapper allocated;
// - pass 2 (decode_merge_kernel, one CTA of D threads per (b, h), n_chunks
//   > 1 only) merges the chunks by lse in index order, launched as a
//   programmatic dependent of pass 1 (griddepcontrol).
// No atomics, and every sum runs in a fixed order: two calls give equal
// bits. No tensor cores: g <= 8 query rows is far below wgmma's 64.

#include "decode_split.cuh"
#include "smem_rows.cuh"

namespace {

using hpc_decode::G_MAX;
using hpc_decode::THREADS;

// Row r of a (sequence, kv head) of the linear cache: row r of its
// (S_max, D) block, its scales at row r of its (S_max,) block.
template <typename TK>
struct LinearRows {
  const TK* k;
  const TK* v;
  const float* ks;
  const float* vs;
  __device__ __forceinline__ long index(int r) const { return r; }
};

// Pass 1: one CTA per (cache row b * Hkv + hk, chunk); the chunk's rows
// [lo, hi) with hi <= pos + 1 (hpc_decode::split_chunk). One chunk stores
// the normalised rows to out, more their partials to part_*.
template <typename TK, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_chunk_kernel(const void* __restrict__ q, int q_bf16,
                    const TK* __restrict__ k, const TK* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs, int pos,
                    float* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int n_chunks, int chunk,
                    int H, int Hkv, int S, float scale) {
  // the merge kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int g = H / Hkv;
  const long row = blockIdx.x;  // b * Hkv + hk
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int c = blockIdx.y;
  const int lo = c * chunk, hi = min(lo + chunk, pos + 1);
  const LinearRows<TK> rows{k + row * S * D, v + row * S * D,
                            ks ? ks + row * S : nullptr,
                            vs ? vs + row * S : nullptr};
  const long bh0 = (long)b * H + (long)hk * g;
  hpc_decode::split_chunk<TK, D, G>(q, q_bf16, rows, lo, hi, bh0 * D, bh0, g,
                                    c, n_chunks == 1, out, part_acc, part_ml,
                                    n_chunks, scale);
}

// Pass 2: one CTA of D threads per query row b * H + h, over every chunk
// (the plan has none empty).
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    int n_chunks, int D,
                                    float* __restrict__ out) {
  // pass 1's writes are complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  hpc_decode::merge_chunks(part_acc, part_ml, blockIdx.x, n_chunks, n_chunks,
                           D, out);
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
  return (int)hpc_decode::launch_merge(
      decode_merge_kernel, B * H, D, n_chunks, stream,
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      n_chunks, D, static_cast<float*>(out));
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

#define HPCPAT_G_ROWS(K, TK, DD)                                          \
  HPCPAT_SMEM_ROW(0, K<TK, DD, 1>), HPCPAT_SMEM_ROW(0, K<TK, DD, 2>),       \
      HPCPAT_SMEM_ROW(0, K<TK, DD, 4>), HPCPAT_SMEM_ROW(0, K<TK, DD, 8>)
#define HPCPAT_D_ROWS(K, TK)                                                \
  HPCPAT_G_ROWS(K, TK, 16), HPCPAT_G_ROWS(K, TK, 32), HPCPAT_G_ROWS(K, TK, 64), \
      HPCPAT_G_ROWS(K, TK, 128)
#define HPCPAT_T_ROWS(K)                                                    \
  HPCPAT_D_ROWS(K, float), HPCPAT_D_ROWS(K, __nv_bfloat16),                 \
      HPCPAT_D_ROWS(K, int8_t), HPCPAT_D_ROWS(K, __nv_fp8_e4m3)
// the merges' dynamic bytes are n_chunks floats, set per call; this library
// holds the paged merge but does not launch it
HPCPAT_SMEM_EXPORT(HPCPAT_T_ROWS(decode_chunk_kernel),
                   HPCPAT_SMEM_ROW(-1, decode_merge_kernel),
                   HPCPAT_SMEM_ROW(-1, hpc_decode::paged_merge_kernel))
#undef HPCPAT_T_ROWS
#undef HPCPAT_D_ROWS
#undef HPCPAT_G_ROWS
