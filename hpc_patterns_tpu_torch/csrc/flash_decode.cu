// Single-query attention against the LINEAR KV cache, for Hopper (sm_90a).
//
// Replaces: hpc_patterns_tpu/ops/flash_decode.py::_decode_kernel (the
// Pallas kernel behind flash_decode_attention, run once per layer per
// decode step by decode_step on the linear cache). Same math as the paged
// kernel (paged_decode.cu): the g = H / Hkv query rows sharing a kv head
// attend rows [0, pos] of that head's cache; scores and values in f32,
// per-row dequant scales folded into the scores and probabilities for
// one-byte caches, mask -1e30, online softmax across blocks,
// out = acc / max(l, 1e-30) in f32.
//
// Layout: q (B, H, D) f32 or bf16; k, v (B, Hkv, S_max, D) in the compute
// dtype (as q) or int8 / float8_e4m3fn with f32 scales ks, vs
// (B, Hkv, S_max); pos one host int shared by the batch; out (B, H, D) f32.
//
// Design: a linear cache is a paged cache with one page of S_max rows per
// (sequence, kv head). One CTA (128 threads) per (b, kv head) streams rows
// [0, pos] in blocks of BLOCK_ROWS through the online-softmax body it
// shares with the paged kernel (decode_common.cuh), so shared memory is
// (g, BLOCK_ROWS) scores plus the accumulators whatever S_max is, and rows
// past pos are neither read nor computed (the Pallas kernel's clamped
// index map).
//
// What bounds it on the H100: bytes. A step reads each live K/V row once:
// 2 * Hkv * D bytes per position and layer in int8/fp8 (plus 8 bytes of
// scales per kv head), twice that in bf16. At B=4, Hkv=8, D=128 and a fill
// of 512 in int8 that is 4.2 MB, about 1.3 us at 3.35 TB/s. With one CTA
// per (b, kv head) that shape launches 32 CTAs on 132 SMs, each walking its
// blocks with no load/compute overlap, so the kernel is latency-bound far
// from that rate; a split over the sequence (flash-decoding) is the later
// step.

#include "decode_common.cuh"

namespace {

using hpc_decode::BLOCK_ROWS;
using hpc_decode::G_MAX;
using hpc_decode::Online;
using hpc_decode::THREADS;

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, int pos,
                    float* __restrict__ out, int H, int Hkv, int S,
                    int blk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const long row = (long)b * Hkv + hk;  // this CTA's cache row
  pos = min(max(pos, 0), S - 1);

  Online<TK, D> st;
  st.init(smem, q + ((long)b * H + (long)hk * g) * D, g, blk);
  const TK* kr = k + row * S * D;
  const TK* vr = v + row * S * D;
  for (int base = 0; base <= pos; base += blk) {
    st.block(kr + (long)base * D, vr + (long)base * D,
             ks ? ks + row * S + base : nullptr,
             vs ? vs + row * S + base : nullptr, min(blk, S - base), base,
             pos, scale);
  }
  st.finish(out + ((long)b * H + (long)hk * g) * D);
}

template <typename TQ, typename TK, int D>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, int pos, void* out, int B, int H, int Hkv, int S,
           float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const int blk = S < BLOCK_ROWS ? S : BLOCK_ROWS;
  const size_t bytes = Online<TK, D>::smem_bytes(g, blk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TK, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<TQ, TK, D><<<B * Hkv, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), ks, vs, pos, static_cast<float*>(out), H,
      Hkv, S, blk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 =
// bfloat16 (both as q), 2 = int8, 3 = float8_e4m3fn (with ks/vs scales;
// null for compute-dtype caches). Returns cudaGetLastError() after the
// launch (0 = launched), -1 for an unsupported (q, kv, head_dim)
// combination, -2 for g > G_MAX.
int flash_decode(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, int pos, void* out, int B,
                 int H, int Hkv, int D, int S, float scale, int q_dtype,
                 int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H / Hkv > G_MAX) return -2;
#define LAUNCH(TQ, TK, DD)                                                 \
  return launch<TQ, TK, DD>(q, k, v, ks, vs, pos, out, B, H, Hkv, S,      \
                            scale, s)
  HPC_DECODE_DISPATCH(q_dtype, kv_dtype);
#undef LAUNCH
  return -1;
}

}  // extern "C"
