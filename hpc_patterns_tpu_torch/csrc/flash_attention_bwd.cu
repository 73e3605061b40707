// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out: the
// three Pallas backward kernels of hpc_patterns_tpu/ops/flash_attention.py.
//
// Replaces:
//   _fused_bwd_kernel (:235, call :692) -> flash_attention_fused_bwd: dK, dV
//     per kv tile plus each visible (q head, q tile) pair's dQ contribution,
//     written to its own slot of a partial-dQ slab (n_kv, B*H, Tq, D) in the
//     input dtype and summed outside (5 products per visible pair);
//   _dq_kernel (:188, call :748)        -> flash_attention_dq: dQ per q tile;
//   _dkv_kernel (:297, call :761)       -> flash_attention_dkv: the fused
//     kernel's walk without dQ (the split route runs it after the dq pass).
//
// Same math as the Pallas kernels, tile by tile: S = Q K^T * scale with the
// causal mask in GLOBAL positions (q_offset + i >= k_offset + j); P is
// recomputed from the saved lse as exp(S - lse), forced to 0 on masked
// entries (a dead row has lse ~ -1e30, where exp would give 1 there); dP =
// dO V^T; dS = P * (dP - Delta) with Delta = rowsum(dO * O) (shifted by the
// lse cotangent) computed outside; P is rounded to bf16 before P^T dO, dS
// before dS^T Q and dS K; every product takes bf16 operands with f32
// accumulation; scale is applied at the end to dQ (and to each slab slot)
// and to dK. GQA: the dK/dV kernels walk every (q head of the kv head's
// group, q tile) pair into one f32 accumulator, so dk/dv come back narrow
// (B, Tk, Hkv, D). Tiles wholly in the future are skipped (neither read nor
// computed); a slab slot of a skipped pair is never written.
//
// Deterministic: every CTA owns its outputs (a kv tile's dK/dV, a q tile's
// dQ, a (kv tile, q head, q tile) slab slot) and walks its loop in a fixed
// order, so two calls give the same bits. dQ of the fused route goes
// through the slab, never through float atomics.
//
// Layout: q, do, dq (B, Tq, H, D); k, v, dk, dv (B, Tk, Hkv, D); lse,
// delta (B*H, Tq) f32.
//
// Design: 8 warps per CTA, 64-row q and kv tiles, WMMA 16x16x16 bf16
// fragments. Tiles are staged in shared memory with padded rows (D + 8
// bf16; 64 + 4 f32) against bank conflicts of the fragment loads. Each
// pair's S and dP (64 x 64 f32) go through shared memory for the
// elementwise step (the fragment layout is opaque); the persistent
// accumulators (dK and dV, or dQ) stay in registers as fragments, the 16 x
// 16 output tiles dealt round-robin over the warps. The TPU's sequential
// grid axis (j over group * n_q, or kv tiles for dQ) becomes a loop inside
// the CTA.
//
// What bounds it on the H100: at the training shape (B 8, T 2048, H 8, D
// 128, causal) the fused kernel does 5 products of 2*64*64*128 FLOP per
// visible pair, 1.72e11 FLOP in all (0.17 ms at 989 TF/s) against 202 MB
// of q/k/v/do/lse/delta/dk/dv plus the slab slots it writes: only the 528
// visible (kv tile, q tile) pairs of the 32 x 32, 0.55 GB of the 1.07 GB
// slab. 0.76 GB in all is 0.23 ms at 3.35 TB/s, so the slab makes the
// kernel bytes-bound at 64-row kv tiles (and the route's slab sum reads
// the whole 1.07 GB again). This version is the
// simple correct one (single-buffered tiles, WMMA, no load/compute
// overlap): wgmma, TMA and a register-resident P are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // f32 score rows (padded)
constexpr int LDP = BK + 8;  // bf16 P / dS rows (padded)
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded bf16 tile row
  // byte offsets into the dynamic shared buffer; every region 128-aligned
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + BQ * LD * 2;
  static constexpr size_t k = dout + BQ * LD * 2;
  static constexpr size_t v = k + BK * LD * 2;
  static constexpr size_t s = v + BK * LD * 2;       // S, then scratch
  static constexpr size_t dp = s + BQ * LDS * 4;     // dP (scratch, cont.)
  static constexpr size_t p = dp + BQ * LDS * 4;
  static constexpr size_t ds = p + BQ * LDP * 2;
  static constexpr size_t lse = ds + BQ * LDP * 2;
  static constexpr size_t delta = lse + BQ * 4;
  static constexpr size_t bytes = delta + BQ * 4;
  // the f32 staging of a 64 x D output tile (row stride D + 4) reuses S+dP
  static_assert(64 * (D + 4) * 4 <= 2 * BQ * LDS * 4, "scratch too small");
};

// `rows` rows of D bf16 (global row stride `stride` elements) into smem
// rows of `ld` elements, 16 bytes per thread per step
template <int D>
__device__ void load_tile(bf16* dst, int ld, const bf16* src, long stride,
                          int rows) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
  }
}

// S = Q K^T and dP = dO V^T for one (q tile, kv tile) pair, f32 into smem
template <int D>
__device__ void scores(const bf16* qs, const bf16* dos, const bf16* ks,
                       const bf16* vs, float* ss, float* dps) {
  constexpr int LD = Smem<D>::LD;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (BQ / 16) * (BK / 16); t += WARPS) {
    const int mi = t / (BK / 16), ni = t % (BK / 16);
    FragC s, dp;
    wmma::fill_fragment(s, 0.f);
    wmma::fill_fragment(dp, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBc b;
      wmma::load_matrix_sync(a, qs + mi * 16 * LD + kk * 16, LD);
      wmma::load_matrix_sync(b, ks + ni * 16 * LD + kk * 16, LD);
      wmma::mma_sync(s, a, b, s);
      wmma::load_matrix_sync(a, dos + mi * 16 * LD + kk * 16, LD);
      wmma::load_matrix_sync(b, vs + ni * 16 * LD + kk * 16, LD);
      wmma::mma_sync(dp, a, b, dp);
    }
    wmma::store_matrix_sync(ss + mi * 16 * LDS + ni * 16, s, LDS,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dps + mi * 16 * LDS + ni * 16, dp, LDS,
                            wmma::mem_row_major);
  }
}

// P = exp(S * scale - lse) on visible entries (0 elsewhere) and
// dS = P * (dP - delta), both rounded to bf16 (P only when `ps` is given)
__device__ void softmax_grad(const float* ss, const float* dps,
                             const float* lse_s, const float* delta_s,
                             bf16* ps, bf16* dss, float scale, int causal,
                             int qg0, int kg0) {
  for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const bool vis = !causal || kg0 + c <= qg0 + r;
    const float p = vis ? expf(ss[r * LDS + c] * scale - lse_s[r]) : 0.f;
    const float ds = p * (dps[r * LDS + c] - delta_s[r]);
    if (ps != nullptr) ps[r * LDP + c] = __float2bfloat16(p);
    dss[r * LDP + c] = __float2bfloat16(ds);
  }
}

// a 64 x D f32 tile staged in smem (row stride D + 4) -> global bf16 rows
// (row stride `stride`), times `mul`
template <int D>
__device__ void write_rows(bf16* dst, long stride, const float* src,
                           float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * stride + c] = __float2bfloat16(src[r * (D + 4) + c] * mul);
  }
}

// the q-side tiles of one (q head, q tile) pair: Q, dO, lse, delta
template <int D>
__device__ void load_q_side(bf16* qs, bf16* dos, float* lse_s,
                            float* delta_s, const bf16* q, const bf16* dout,
                            const float* lse, const float* delta, int b,
                            int h, int H, int Tq, int q0) {
  const long stride = (long)H * D;
  const long off = ((long)b * Tq + q0) * stride + (long)h * D;
  load_tile<D>(qs, Smem<D>::LD, q + off, stride, BQ);
  load_tile<D>(dos, Smem<D>::LD, dout + off, stride, BQ);
  const long row = ((long)b * H + h) * Tq + q0;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    lse_s[i] = lse[row + i];
    delta_s[i] = delta[row + i];
  }
}

// dK/dV (and, FUSED, the partial-dQ slab): one CTA per (kv tile, b*Hkv+hk)
template <int D, bool FUSED>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv,
           bf16* __restrict__ slab, int B, int Tq, int Tk, int H, int Hkv,
           float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Smem<D>;
  constexpr int LD = S::LD;
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q);
  bf16* dos = reinterpret_cast<bf16*>(smem + S::dout);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* dps = reinterpret_cast<float*>(smem + S::dp);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::p);
  bf16* dss = reinterpret_cast<bf16*>(smem + S::ds);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta);
  float* scratch = ss;  // S + dP, once both are consumed

  const int kt = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int n_q = Tq / BQ;
  const int k0 = kt * BK;
  const int kg0 = k_off + k0;
  const int warp = threadIdx.x / 32;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * Tk + k0) * kv_stride + (long)hk * D;
  load_tile<D>(ks, LD, k + kv_off, kv_stride, BK);
  load_tile<D>(vs, LD, v + kv_off, kv_stride, BK);

  // this warp's share of the (BK/16) x (D/16) output tiles of dK and dV
  constexpr int NT = (BK / 16) * (D / 16);
  constexpr int TPW = (NT + WARPS - 1) / WARPS;
  FragC dk_acc[TPW], dv_acc[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    wmma::fill_fragment(dk_acc[i], 0.f);
    wmma::fill_fragment(dv_acc[i], 0.f);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qi = 0; qi < n_q; ++qi) {
      const int q0 = qi * BQ;
      const int qg0 = q_off + q0;
      // causal: a q tile wholly before this kv tile sees none of it
      if (causal && qg0 + BQ - 1 < kg0) continue;
      __syncthreads();  // the previous pair's tiles are consumed
      load_q_side<D>(qs, dos, lse_s, delta_s, q, dout, lse, delta, b, h, H,
                     Tq, q0);
      __syncthreads();
      scores<D>(qs, dos, ks, vs, ss, dps);
      __syncthreads();
      softmax_grad(ss, dps, lse_s, delta_s, ps, dss, scale, causal, qg0,
                   kg0);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (the group sum rides the same acc)
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int t = warp + i * WARPS;
        if (t >= NT) break;
        const int mi = t / (D / 16), ni = t % (D / 16);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          FragAc a;
          FragB bm;
          wmma::load_matrix_sync(a, ps + kk * 16 * LDP + mi * 16, LDP);
          wmma::load_matrix_sync(bm, dos + kk * 16 * LD + ni * 16, LD);
          wmma::mma_sync(dv_acc[i], a, bm, dv_acc[i]);
          wmma::load_matrix_sync(a, dss + kk * 16 * LDP + mi * 16, LDP);
          wmma::load_matrix_sync(bm, qs + kk * 16 * LD + ni * 16, LD);
          wmma::mma_sync(dk_acc[i], a, bm, dk_acc[i]);
        }
      }
      if constexpr (FUSED) {
        // this pair's dQ contribution dS K, into its own slab slot
        for (int t = warp; t < (BQ / 16) * (D / 16); t += WARPS) {
          const int mi = t / (D / 16), ni = t % (D / 16);
          FragC acc;
          wmma::fill_fragment(acc, 0.f);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            FragA a;
            FragB bm;
            wmma::load_matrix_sync(a, dss + mi * 16 * LDP + kk * 16, LDP);
            wmma::load_matrix_sync(bm, ks + kk * 16 * LD + ni * 16, LD);
            wmma::mma_sync(acc, a, bm, acc);
          }
          wmma::store_matrix_sync(scratch + mi * 16 * (D + 4) + ni * 16, acc,
                                  D + 4, wmma::mem_row_major);
        }
        __syncthreads();
        const long slot = (((long)kt * B * H + (long)b * H + h) * Tq + q0);
        write_rows<D>(slab + slot * D, D, scratch, scale);
      }
    }
  }

  // epilogue: dk = acc * scale, dv = acc, staged through smem
  const long out_off = ((long)b * Tk + k0) * kv_stride + (long)hk * D;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int t = warp + i * WARPS;
    if (t >= NT) break;
    const int mi = t / (D / 16), ni = t % (D / 16);
    wmma::store_matrix_sync(scratch + mi * 16 * (D + 4) + ni * 16, dk_acc[i],
                            D + 4, wmma::mem_row_major);
  }
  __syncthreads();
  write_rows<D>(dk + out_off, kv_stride, scratch, scale);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int t = warp + i * WARPS;
    if (t >= NT) break;
    const int mi = t / (D / 16), ni = t % (D / 16);
    wmma::store_matrix_sync(scratch + mi * 16 * (D + 4) + ni * 16, dv_acc[i],
                            D + 4, wmma::mem_row_major);
  }
  __syncthreads();
  write_rows<D>(dv + out_off, kv_stride, scratch, 1.f);
}

// dQ: one CTA per (q tile, b*H+h), walking the visible kv tiles
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Tq, int Tk, int H, int Hkv, float scale,
          int causal, int q_off, int k_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Smem<D>;
  constexpr int LD = S::LD;
  bf16* qs = reinterpret_cast<bf16*>(smem + S::q);
  bf16* dos = reinterpret_cast<bf16*>(smem + S::dout);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* dps = reinterpret_cast<float*>(smem + S::dp);
  bf16* dss = reinterpret_cast<bf16*>(smem + S::ds);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta);
  float* scratch = ss;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int qg0 = q_off + q0;
  const int warp = threadIdx.x / 32;
  load_q_side<D>(qs, dos, lse_s, delta_s, q, dout, lse, delta, b, h, H, Tq,
                 q0);

  constexpr int NT = (BQ / 16) * (D / 16);
  constexpr int TPW = (NT + WARPS - 1) / WARPS;
  FragC dq_acc[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) wmma::fill_fragment(dq_acc[i], 0.f);

  int n_kt = Tk / BK;
  if (causal) {
    const int last = qg0 + BQ - 1 - k_off;
    n_kt = last < 0 ? 0 : min(last / BK + 1, n_kt);
  }
  const long kv_stride = (long)Hkv * D;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and dS are consumed
    const long kv_off = ((long)b * Tk + k0) * kv_stride + (long)hk * D;
    load_tile<D>(ks, LD, k + kv_off, kv_stride, BK);
    load_tile<D>(vs, LD, v + kv_off, kv_stride, BK);
    __syncthreads();
    scores<D>(qs, dos, ks, vs, ss, dps);
    __syncthreads();
    softmax_grad(ss, dps, lse_s, delta_s, nullptr, dss, scale, causal, qg0,
                 k_off + k0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = warp + i * WARPS;
      if (t >= NT) break;
      const int mi = t / (D / 16), ni = t % (D / 16);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragA a;
        FragB bm;
        wmma::load_matrix_sync(a, dss + mi * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(bm, ks + kk * 16 * LD + ni * 16, LD);
        wmma::mma_sync(dq_acc[i], a, bm, dq_acc[i]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int t = warp + i * WARPS;
    if (t >= NT) break;
    const int mi = t / (D / 16), ni = t % (D / 16);
    wmma::store_matrix_sync(scratch + mi * 16 * (D + 4) + ni * 16, dq_acc[i],
                            D + 4, wmma::mem_row_major);
  }
  __syncthreads();
  const long stride = (long)H * D;
  write_rows<D>(dq + ((long)b * Tq + q0) * stride + (long)h * D, stride,
                scratch, scale);
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, bool FUSED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* slab, int B, int Tq, int Tk, int H, int Hkv, float scale,
               int causal, int q_off, int k_off, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = prepare(dkv_kernel<D, FUSED>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tk / BK, B * Hkv);
  dkv_kernel<D, FUSED><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(slab), B, Tq, Tk, H, Hkv, scale, causal, q_off,
      k_off);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq,
              int Tk, int H, int Hkv, float scale, int causal, int q_off,
              int k_off, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = prepare(dq_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tq / BQ, B * H);
  dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Tq, Tk, H, Hkv, scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, void* slab, int B, int Tq, int Tk, int H,
                 int Hkv, int D, float scale, int causal, int q_off,
                 int k_off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HPCPAT_DKV(DD)                                                      \
  return launch_dkv<DD, FUSED>(q, k, v, dout, lse, delta, dk, dv, slab, B, \
                               Tq, Tk, H, Hkv, scale, causal, q_off, k_off, \
                               s)
  switch (D) {
    case 16: HPCPAT_DKV(16);
    case 32: HPCPAT_DKV(32);
    case 64: HPCPAT_DKV(64);
    case 128: HPCPAT_DKV(128);
    default: return -1;
  }
#undef HPCPAT_DKV
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or -1
// for a head_dim this build does not take. Tq and Tk must be multiples of
// 64 (ops/flash_attention.py::BWD_BLOCK_Q / BWD_BLOCK_K); the wrapper checks
// shapes, dtypes and contiguity.

// dK, dV and the partial-dQ slab (n_kv = Tk / 64, B*H, Tq, D): the slot of
// a (kv tile, q head, q tile) pair is written iff the pair is visible.
int flash_attention_fused_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              void* slab, int B, int Tq, int Tk, int H,
                              int Hkv, int D, float scale, int causal,
                              int q_off, int k_off, void* stream) {
  return dispatch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, slab, B, Tq,
                            Tk, H, Hkv, D, scale, causal, q_off, k_off,
                            stream);
}

int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int Tq, int Tk, int H,
                        int Hkv, int D, float scale, int causal, int q_off,
                        int k_off, void* stream) {
  return dispatch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, nullptr, B,
                             Tq, Tk, H, Hkv, D, scale, causal, q_off, k_off,
                             stream);
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int Tq, int Tk, int H, int Hkv, int D,
                       float scale, int causal, int q_off, int k_off,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HPCPAT_DQ(DD)                                                        \
  return launch_dq<DD>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hkv,     \
                       scale, causal, q_off, k_off, s)
  switch (D) {
    case 16: HPCPAT_DQ(16);
    case 32: HPCPAT_DQ(32);
    case 64: HPCPAT_DQ(64);
    case 128: HPCPAT_DQ(128);
    default: return -1;
  }
#undef HPCPAT_DQ
}

}  // extern "C"
