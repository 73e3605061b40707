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
// Layout: q (B, H, D) f32 or bf16; k_pool, v_pool (n_pool, Hkv, P, D) in
// the compute dtype (as q) or one byte per value (int8, float8_e4m3fn) with
// per-row f32 scale pools ks_pool, vs_pool (n_pool, Hkv, 1, P) read through
// the same table entry; table (B, pages) int32; pos (B,) int32 or one
// scalar; out (B, H, D) f32.
//
// Design: one CTA (128 threads) per (b, kv head). The block reads its own
// table row and pos[b] and walks pages 0 .. pos[b] / P only: pages past
// the fill are never read (the clamped index map of the Pallas kernel).
// Each page is streamed in blocks of at most BLOCK_ROWS rows through the
// shared online-softmax body (decode_common.cuh); thread (rg, cg) owns a
// 16-byte column slice cg of the head (4 f32, 8 bf16, or 16 int8/fp8
// values widened to f32) and the block rows r = rg (mod RG). Per block:
//   A. scores: each thread dots its K slice with the g query slices, the
//      CG threads of a row reduce with warp shuffles, and one writes
//      s[gi][r] (times the row's k scale for one-byte pools) to shared
//      memory (rows past pos: -1e30);
//   B. softmax: one warp per query row updates m and l and turns the
//      page's scores into probabilities;
//   C. values: each thread rescales its partial accumulator and adds
//      p * vscale * v over its rows (rows past pos are skipped, not read).
// At the end the RG partial accumulators are summed in a fixed order
// (deterministic) and normalised.
//
// What bounds it on the H100: bytes. A decode step reads each live K/V
// row once, 2 * Hkv * D * 2 bytes per position and layer (bf16): at
// B=8, Hkv=8, D=128 and a fill of 1024 that is 33.5 MB, about 10 us at
// 3.35 TB/s, against ~0.07 GFLOP. With one CTA per (b, kv head) the bench
// shape launches 8 * 8 = 64 CTAs on 132 SMs, and each CTA walks its pages
// with no load/compute overlap, so the kernel cannot reach the memory
// rate at that shape. One-byte pools halve the bytes against bf16 (a
// quarter against f32), plus 2 * 4 bytes of scales per row and kv head;
// splitting each sequence's pages over several CTAs
// (flash-decoding, with a merge pass) is the later step.

#include "decode_common.cuh"

namespace {

using hpc_decode::BLOCK_ROWS;
using hpc_decode::G_MAX;
using hpc_decode::Online;
using hpc_decode::THREADS;

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k_pool,
                    const TK* __restrict__ v_pool,
                    const float* __restrict__ ks_pool,
                    const float* __restrict__ vs_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos_vec, int pos_scalar,
                    float* __restrict__ out, int H, int Hkv, int P,
                    int pages, int n_pool, int blk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  int pos = pos_vec ? pos_vec[b] : pos_scalar;
  pos = min(max(pos, 0), pages * P - 1);  // the table holds `pages` pages
  const int n_live = pos / P + 1;

  Online<TK, D> st;
  st.init(smem, q + ((long)b * H + (long)hk * g) * D, g, blk);
  const long page_stride = (long)Hkv * P * D;
  const long head_off = (long)hk * P * D;
  for (int j = 0; j < n_live; ++j) {
    int pid = table[(long)b * pages + j];
    pid = min(max(pid, 0), n_pool - 1);
    const TK* kp = k_pool + pid * page_stride + head_off;
    const TK* vp = v_pool + pid * page_stride + head_off;
    const long srow = ((long)pid * Hkv + hk) * P;  // scale pool row
    for (int r0 = 0; r0 < P && j * P + r0 <= pos; r0 += blk) {
      st.block(kp + (long)r0 * D, vp + (long)r0 * D,
               ks_pool ? ks_pool + srow + r0 : nullptr,
               vs_pool ? vs_pool + srow + r0 : nullptr, min(blk, P - r0),
               j * P + r0, pos, scale);
    }
  }
  st.finish(out + ((long)b * H + (long)hk * g) * D);
}

template <typename TQ, typename TK, int D>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* table, const int* pos_vec,
           int pos_scalar, void* out, int B, int H, int Hkv, int P,
           int pages, int n_pool, float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const int blk = P < BLOCK_ROWS ? P : BLOCK_ROWS;
  const size_t bytes = Online<TK, D>::smem_bytes(g, blk);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TK, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<TQ, TK, D><<<B * Hkv, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(kp),
      static_cast<const TK*>(vp), ks, vs, table, pos_vec, pos_scalar,
      static_cast<float*>(out), H, Hkv, P, pages, n_pool, blk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 =
// bfloat16 (both as q), 2 = int8, 3 = float8_e4m3fn (with ks/vs scale
// pools; null for compute-dtype pools). pos: a (B,) int32 device array,
// or null with the shared position in pos_scalar. Returns
// cudaGetLastError() after the launch (0 = launched), -1 for an
// unsupported (q, kv, head_dim) combination, -2 for g > G_MAX.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const float* ks_pool, const float* vs_pool,
                 const int* table, const int* pos, int pos_scalar, void* out,
                 int B, int H, int Hkv, int D, int P, int pages, int n_pool,
                 float scale, int q_dtype, int kv_dtype, void* stream) {
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
