// Single-query attention through a page table, for Hopper (sm_90a):
// flash-decoding, each sequence's rows split into fixed chunks and merged
// by lse.
//
// Replaces: hpc_patterns_tpu/ops/flash_decode.py::_decode_kernel_paged
// (the Pallas kernel behind flash_decode_paged, run once per layer per
// decode step by paged_decode_step). Same math: the g = H / Hkv query rows
// that share a kv head attend the live prefix rows [0, pos[b]] of that
// head, gathered page by page through the sequence's table row; scores
// and values in f32 (flash_decode.py::_softmax_block), per-row dequant
// scales folded into the scores and probabilities for one-byte pools, mask
// -1e30, out = acc / max(l, 1e-30) in f32.
//
// Layout: q (B, H, D) f32 or bf16; k_pool, v_pool (n_pool, Hkv, P, D) in
// the compute dtype (as q) or one byte per value (int8, float8_e4m3fn) with
// per-row f32 scale pools ks_pool, vs_pool (n_pool, Hkv, 1, P) read through
// the same table entry; table (B, pages) int32; pos (B,) int32 on the
// device or one scalar; out (B, H, D) f32.
//
// What bounds it on the H100: bytes, and at the sizes decode sees, the
// latency of getting them in flight. A decode step reads each live K/V row
// once, 2 * Hkv * D * 2 bytes per position and layer in bf16 (half that
// plus 8 bytes of scales a row and kv head in int8/fp8): at the serving
// shape (B 8, Hkv 8, D 128, page 256, fills up to 1023) at most 33.5 MB,
// 10 us at 3.35 TB/s. One CTA per (sequence, kv head) is 64 CTAs on 132
// SMs there, each walking up to 1024 rows.
//
// Design: the split of decode_split.cuh (shared with the linear cache's
// kernel 5, flash_decode.cu), with rows read through the table.
// - The chunk is `chunk` rows, fixed by the wrapper per page size (128
//   rows at the serving page) and never by the batch, the kv heads or the
//   card, so a sequence's output depends only on its own q, pages and pos
//   (the serving engine's batched step and a standalone decode give equal
//   bits). pos lives on the device, so the host plans n_chunks from the
//   table width, pages * P, the largest fill.
// - Pass 1 runs one CTA per (b * Hkv + hk, chunk c). It reads pos[b]
//   (clamped into the table, as the Pallas kernel's index map clamps); a
//   chunk that starts past pos[b] exits without writing. The live chunk
//   first loads the (pool row * Hkv + hk) * P of every page it touches into
//   shared memory (stage_pages), then streams its rows through
//   split_chunk: row r's values start at ((table[b, r / P] * Hkv + hk) * P
//   + r % P) * D, its scales at that row index of the scale pools. When
//   pos[b] lies in chunk 0 that CTA normalises its rows in place.
// - Pass 2 (paged_merge_kernel, a programmatic dependent launch, only when
//   the table holds more than one chunk) runs one CTA of D threads per
//   (b, h): it reads pos[b] the same way, returns when chunk 0 held every
//   live row, and otherwise merges chunks 0 .. pos[b] / chunk by lse in
//   index order. Both readers of pos clamp it alike, so they agree on
//   which case a sequence is. The host never reads pos.
// The paged helpers (PagedRows, stage_pages, the merge) live in
// decode_split.cuh, shared with the exact-softmax kernel 7
// (paged_attention.cu).
// The workspace is (B*H, n_chunks, D + 2) f32, from the caller.

#include "decode_split.cuh"
#include "smem_rows.cuh"

namespace {

using hpc_decode::G_MAX;
using hpc_decode::PAGED_CHUNK_MAX;
using hpc_decode::PagedRows;
using hpc_decode::THREADS;

// Pass 1: one CTA per (b * Hkv + hk, chunk). Chunks past pos[b] exit.
template <typename TK, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_chunk_kernel(const void* __restrict__ q, int q_bf16,
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
  __shared__ long page_base[PAGED_CHUNK_MAX + 2];
  // the merge kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int c = blockIdx.y;
  const int pos = hpc_decode::live_pos(pos_vec, pos_scalar, b, pages * P);
  const int lo = c * chunk;
  if (lo > pos) return;  // past the fill: the merge does not read it
  const int hi = min(lo + chunk, pos + 1);
  const PagedRows<TK> rows = hpc_decode::stage_pages(
      page_base, k_pool, v_pool, ks_pool, vs_pool, table, b, hk, lo, hi, Hkv,
      P, p_shift, pages, n_pool);
  const long bh0 = (long)b * H + (long)hk * g;
  hpc_decode::split_chunk<TK, D, G>(q, q_bf16, rows, lo, hi, bh0 * D, bh0, g,
                                    c, pos < chunk, out, part_acc, part_ml,
                                    n_chunks, scale);
}

template <typename TK, int D, int G>
int launch(const void* q, int q_bf16, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* table,
           const int* pos_vec, int pos_scalar, void* out, float* part,
           int n_chunks, int chunk, int B, int H, int Hkv, int P, int pages,
           int n_pool, float scale, cudaStream_t stream) {
  const int p_shift = hpc_decode::page_shift(P);
  float* part_acc = part;
  float* part_ml = n_chunks > 1 ? part + (long)B * H * n_chunks * D : nullptr;
  paged_decode_chunk_kernel<TK, D, G>
      <<<dim3(B * Hkv, n_chunks), THREADS, 0, stream>>>(
          q, q_bf16, static_cast<const TK*>(kp), static_cast<const TK*>(vp),
          ks, vs, table, pos_vec, pos_scalar, static_cast<float*>(out),
          part_acc, part_ml, n_chunks, chunk, H, Hkv, P, p_shift, pages,
          n_pool, scale);
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
#define HPC_PAGED_G(GG)                                                      \
  return launch<TK, D, GG>(q, q_bf16, kp, vp, ks, vs, table, pos_vec,       \
                           pos_scalar, out, part, n_chunks, chunk, B, H, Hkv, \
                           P, pages, n_pool, scale, s)
  if (g <= 1) HPC_PAGED_G(1);
  if (g <= 2) HPC_PAGED_G(2);
  if (g <= 4) HPC_PAGED_G(4);
  HPC_PAGED_G(8);
#undef HPC_PAGED_G
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 =
// bfloat16 (both as q), 2 = int8, 3 = float8_e4m3fn (with ks/vs scale
// pools; null for compute-dtype pools). pos: a (B,) int32 device array,
// or null with the shared position in pos_scalar. The table's pages * P
// rows in n_chunks = ceil(pages * P / chunk) chunks (chunk <= 256); `part`
// the f32 workspace of B * H * n_chunks * (D + 2) values (null when
// n_chunks is 1). Returns cudaGetLastError() after the launches (0 =
// launched), -1 for an unsupported (q, kv, head_dim) combination, -2 for
// g > G_MAX, -3 for a plan that does not cover the table or a missing
// workspace.
int paged_decode_split(const void* q, const void* k_pool, const void* v_pool,
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
#define HPC_PAGED(TK, DD)                                                   \
  return launch_g<TK, DD>(q, qb, k_pool, v_pool, ks_pool, vs_pool, table,  \
                          pos, pos_scalar, out, part, n_chunks, chunk, B, H, \
                          Hkv, P, pages, n_pool, scale, s)
#define HPC_PAGED_D(TK)                      \
  do {                                       \
    if (D == 16) HPC_PAGED(TK, 16);          \
    if (D == 32) HPC_PAGED(TK, 32);          \
    if (D == 64) HPC_PAGED(TK, 64);          \
    if (D == 128) HPC_PAGED(TK, 128);        \
  } while (0)
  // compute-dtype pools match q; one-byte pools take either q
  if (kv_dtype == F32 && q_dtype == F32) HPC_PAGED_D(float);
  if (kv_dtype == BF16 && q_dtype == BF16) HPC_PAGED_D(__nv_bfloat16);
  if (kv_dtype == I8) HPC_PAGED_D(int8_t);
  if (kv_dtype == FP8) HPC_PAGED_D(__nv_fp8_e4m3);
#undef HPC_PAGED_D
#undef HPC_PAGED
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
HPCPAT_SMEM_EXPORT(HPCPAT_T_ROWS(paged_decode_chunk_kernel),
                   HPCPAT_SMEM_ROW(-1, hpc_decode::paged_merge_kernel))
#undef HPCPAT_T_ROWS
#undef HPCPAT_D_ROWS
#undef HPCPAT_G_ROWS
