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
// dK/dV (kernels 2 and 4: dkv::dkv_kernel<D, FUSED>). One CTA per (kv tile
// of 128 keys, b*Hkv + hk), the kv tiles in order, so that under a causal
// mask the longest CTAs (the first keys, seen by every later query) start
// first. Two consumer warpgroups own 64 keys each; a producer warpgroup,
// of which one thread issues every copy, loads K and V once and streams the
// pairs' Q and dO tiles (64 queries), lse and Delta through a ring of
// STAGES slots (TMA tensor loads and bulk copies completing a full
// mbarrier; the 256 consumer threads release a slot on its empty barrier).
// The tensor maps are 4-D (D, heads, T, B), so keys past Tk load as zeros
// and dK/dV rows past Tk are dropped by the store; those keys are masked
// explicitly (with K = 0, S = 0 and exp(0 - lse) is not 0), causal or not.
// Per pair, in each consumer warpgroup (transposed, so that P and dS come
// out in the layout of wgmma's register A operand):
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands K-major
//   in shared memory with the TMA's swizzle (128B at D >= 64, 64B at 32,
//   32B at 16);
// - P^T = 2^(S^T scale log2e - lse log2e) with the mask (selects, only on
//   tiles that cross the diagonal or Tk), dS^T = P^T (dP^T - Delta), both
//   in registers, rounded to bf16 as A fragments;
// - dV += P^T dO and dK += dS^T Q: wgmma m64n{D}k16 with A in registers
//   and dO, Q the MN-major B operands; dK and dV (64 x D f32 each) stay in
//   registers for the whole walk over the group's (q head, q tile) pairs;
// - FUSED: dS^T goes to shared memory as bf16 (128 keys x 64 queries, two
//   buffers taken in turns), the warpgroups meet at one named barrier, and
//   the pair's dQ partial dS K (wgmma m64n{64,D}k16, dS the MN-major A and
//   K the MN-major B) is computed by both warpgroups, one 64-column atom of
//   D each, at D 128, and by one warpgroup, the pairs in turns, below it
//   (an atom is the narrowest MN-major operand); it is scaled, rounded to
//   bf16 in a staging buffer and TMA-stored to its slab slot.
// dK (scaled) and dV leave through the CTA's own K and V tiles by TMA
// stores. With two consumer warpgroups the producer drops to 24 registers
// and the consumers rise to 240 (setmaxnreg).
//
// dQ (kernel 3: dq_kernel<D>, the first version, WMMA): 8 warps per CTA,
// 64-row q and kv tiles, WMMA 16x16x16 bf16 fragments, tiles staged in
// shared memory with padded rows (D + 8 bf16; 64 + 4 f32); S and dP (64 x
// 64 f32) go through shared memory for the elementwise step; the dQ
// accumulator stays in registers as fragments. The TPU's sequential grid
// axis (kv tiles) becomes a loop inside the CTA.
//
// What bounds them on the H100 at the training shape (B 8, T 2048, H 8, D
// 128, causal): the fused kernel does 5 products of 2*64*64*128 FLOP per
// visible (64-query, 64-key) pair, 1.72e11 FLOP (0.174 ms at 989 TF/s),
// against 202 MB of q/k/v/do/lse/delta/dk/dv plus the slab slots it
// writes: with 128-key tiles 272 of the 512 (kv tile, q tile) pairs are
// visible, 0.285 GB of the 0.54 GB slab, 0.487 GB in all (0.145 ms at 3.35
// TB/s): bound by the tensor cores. The dK/dV kernel: 1.38e11 FLOP, 0.139
// ms. On an H100 80GB HBM3 at 700 W (bench_flash.py) the fused kernel
// takes 0.367 ms (468 TF/s, 2.1x its bound) and the dK/dV one 0.248 ms
// (555 TF/s, 1.8x): the two warpgroups meet at the dS barrier every pair,
// so each one's elementwise work (P, dS, the dS and dQ stores) sits
// between its own products, overlapped only by the other's. ptxas: 168
// registers at launch (setmaxnreg lifts the consumers to 240), no
// spills. The dQ kernel keeps the
// simple design (single-buffered tiles, WMMA, no load/compute overlap)
// until its own redesign.

#include "hopper.cuh"  // first: cuda_bf16.h before mma.h

#include <mma.h>

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- dQ
//
// Kernel 3 and the helpers it uses.

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // f32 score rows (padded)
constexpr int LDP = BK + 8;  // bf16 P / dS rows (padded)

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

// ---------------------------------------------------------------- dK/dV
//
// Kernels 2 and 4 (the note at the top of the file); the shared helpers
// (mbarriers, TMA, wgmma, descriptors) are in hopper.cuh.

namespace dkv {

constexpr int Q_ROWS = 64;    // queries of a pair: one ring slot
constexpr int KV_ROWS = 128;  // keys of a CTA
constexpr int WG_KV = 64;     // keys of one consumer warpgroup
constexpr int NWG = 2;        // consumer warpgroups
constexpr int THREADS = (NWG + 1) * 128;
constexpr int STAGES = 2;     // ring slots
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool FUSED>
struct Cfg {
  static constexpr int W = D < 64 ? D : 64;  // columns of one swizzle atom
  static constexpr int NCH = D / W;          // atoms across a row
  static constexpr int ROW_BYTES = W * 2;    // 32, 64 or 128: the swizzle
  // log2 of the 16-byte groups a swizzle row holds; the wgmma layout code
  static constexpr int SWZ_BITS =
      ROW_BYTES == 128 ? 3 : ROW_BYTES == 64 ? 2 : 1;
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static constexpr int Q_CHUNK = Q_ROWS * ROW_BYTES;    // one atom column
  static constexpr int Q_TILE = NCH * Q_CHUNK;          // a Q or dO tile
  static constexpr int KV_CHUNK = KV_ROWS * ROW_BYTES;
  static constexpr int KV_TILE = NCH * KV_CHUNK;        // K or V
  static constexpr int WG_ROWS = WG_KV * ROW_BYTES;     // a warpgroup's keys
  // the pair's dQ partial: one atom of D for each warpgroup at D 128, all
  // of D for one warpgroup (the pairs in turns) below it
  static constexpr bool SPLIT = NCH == NWG;
  static constexpr int DQ_N = SPLIT ? D / NWG : D;
  static constexpr int DQ_BUFS = SPLIT ? 2 : 1;  // a warpgroup's staging
  static constexpr int DQ_STAGE = DQ_N / W * Q_CHUNK;
  static constexpr int DS_BYTES = KV_ROWS * Q_ROWS * 2;  // dS^T, bf16
  // byte offsets from the 1024-aligned base (every tile a multiple of
  // 1024 bytes, so each swizzle atom starts on its repeat)
  static constexpr int k = 0;
  static constexpr int v = k + KV_TILE;
  static constexpr int ring = v + KV_TILE;  // a slot: Q tile, dO tile
  static constexpr int ds = ring + STAGES * 2 * Q_TILE;
  static constexpr int dq = ds + (FUSED ? 2 * DS_BYTES : 0);
  static constexpr int stats = dq + (FUSED ? NWG * DQ_BUFS * DQ_STAGE : 0);
  static constexpr int bar = stats + STAGES * 2 * Q_ROWS * 4;  // lse, Delta
  static constexpr int bytes = bar + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(D != 128 || SPLIT, "D 128 splits the dQ partial");
  static_assert(bytes <= 232448, "shared memory of one CTA");
};

// barriers after kv_full (K and V landed): the ring's full and empty
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// the threads of warpgroups `count` / 128 (named barrier `id`; 0 is
// __syncthreads')
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// an accumulator whose first product ignores it (scale-d 0): defined for
// the compiler without an instruction
template <int N>
__device__ __forceinline__ void undefined(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(r[i]));
}

// X^T = A B^T for this warpgroup's 64 keys (A: its rows of K or V) against
// the pair's 64 queries (B: the Q or dO tile), both K-major: D / 16 steps
// of k16, 32 bytes apart inside a swizzle atom, the next atom a chunk
// away. `zero` and `one` are the scale-d flags as registers defined once,
// before any product (no register a running product reads is defined
// between two products). The first step ignores the accumulator.
template <class C, int D>
__device__ __forceinline__ void issue_scores(float (&x)[32], uint32_t a_base,
                                             uint32_t b_base, int zero,
                                             int one) {
  undefined(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk * 16 % C::W * 2, c = kk * 16 / C::W;
    wgmma_ss<64, 0, 0>(x,
                       make_desc(a_base + c * C::KV_CHUNK + off, 16,
                                 8 * C::ROW_BYTES, C::LAYOUT),
                       make_desc(b_base + c * C::Q_CHUNK + off, 16,
                                 8 * C::ROW_BYTES, C::LAYOUT),
                       kk > 0 ? one : zero);
  }
  wgmma_commit();
}

// acc (m64n{D}) += A (m64k64, four k16 fragments in registers) B, B the
// slot's 64 x D tile (Q or dO) as the MN-major operand: 16 rows a step
template <class C, int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b_base, int one) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, a[kk],
                make_desc(b_base + kk * 16 * C::ROW_BYTES, C::Q_CHUNK,
                          8 * C::ROW_BYTES, C::LAYOUT),
                one);
}

// P^T in place on the S^T fragment (x[4j + 2i + e] is key row + 8i of the
// tile, query column 8j + 2cq + e of the pair): 2^(S scale log2e - lse
// log2e), 0 where masked (EDGE: the key past Tk, or in the query's future)
template <bool EDGE>
__device__ __forceinline__ void probs(float (&x)[32], const float* lse_s,
                                      int krow, int Tk, int kg, int qg,
                                      int cq, int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * cq + e;
      const float l2 = lse_s[col] * LOG2E;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p = exp2_ftz(fmaf(x[4 * j + 2 * i + e], scale_log2, -l2));
        if constexpr (EDGE) {  // a select, no branch
          const bool vis = krow + 8 * i < Tk &&
                           (!causal || kg + 8 * i <= qg + col);
          p = vis ? p : 0.f;
        }
        x[4 * j + 2 * i + e] = p;
      }
    }
}

// the f32 fragment rounded to bf16 as wgmma's A fragments: the m64n64
// fragment of a k16 slice is the A fragment of that slice
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// an m64n{N} fragment (rows row0 + 8i, columns 8j + 2cq + e), times `mul`,
// as bf16 into a tile of atoms `chunk` bytes apart with the swizzle of C
template <class C, int N>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int chunk,
                                           const float (&x)[N / 2], int row0,
                                           int cq, float mul) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 8 * j + 2 * cq;
      int off = col / C::W * chunk + (row0 + 8 * i) * C::ROW_BYTES
                + col % C::W * 2;
      off ^= ((off >> 7) & ((1 << C::SWZ_BITS) - 1)) << 4;
      *reinterpret_cast<uint32_t*>(dst + off) =
          pack_bf16(x[4 * j + 2 * i] * mul, x[4 * j + 2 * i + 1] * mul);
    }
}

// FUSED, one pair: dS^T (this warpgroup's 64 keys, the A fragments) into
// the pair's buffer, the two warpgroups meet, then this warpgroup's share
// of dQ = dS K, if it has one, is issued. Returns whether it has.
template <class C>
__device__ __forceinline__ bool dq_issue(
    float (&dq)[C::DQ_N / 2], uint32_t base, unsigned char* gbase,
    const uint32_t (&dsa)[4][4], int p, int wg, int t, int row, int cq,
    int zero, int one) {
  unsigned char* dsg = gbase + C::ds + (p & 1) * C::DS_BYTES;
  // dS^T rows of 64 queries (128 bytes, the 128B swizzle at every D)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int off = (row + 8 * i) * 128 + (8 * j + 2 * cq) * 2;
      off ^= ((off >> 7) & 7) << 4;
      *reinterpret_cast<uint32_t*>(dsg + off) = dsa[j / 2][2 * (j % 2) + i];
    }
  fence_proxy_async();
  // this warpgroup's staging buffer for the pair is free once the store
  // that last read it has
  if (t == 0) {
    if constexpr (C::DQ_BUFS == 2)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    else
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  named_bar(1, NWG * 128);
  if (!C::SPLIT && wg != (p & 1)) return false;
  // dS (M = 64 queries, K = 128 keys) is MN-major in its buffer, K (the
  // keys, N = this warpgroup's columns of D) MN-major in its tile
  const uint32_t dsb = base + C::ds + (p & 1) * C::DS_BYTES;
  const uint32_t kb = base + C::k + (C::SPLIT ? wg * C::KV_CHUNK : 0);
  undefined(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KV_ROWS / 16; ++kk)
    wgmma_ss<C::DQ_N, 1, 1>(
        dq, make_desc(dsb + kk * 16 * 128, C::DS_BYTES, 1024, 1),
        make_desc(kb + kk * 16 * C::ROW_BYTES, C::KV_CHUNK,
                  8 * C::ROW_BYTES, C::LAYOUT),
        kk > 0 ? one : zero);
  wgmma_commit();
  return true;
}

// FUSED: once it has landed, this warpgroup's dQ partial times scale as
// bf16 into its staging buffer, then one TMA store to the pair's slab slot
// (rows q0.. of slot (kt, bh))
template <class C>
__device__ __forceinline__ void dq_store(const CUtensorMap* slabmap,
                                         uint32_t base, unsigned char* gbase,
                                         float (&dq)[C::DQ_N / 2], int p,
                                         int wg, int t, int cq, float scale,
                                         int q0, int bh, int kt) {
  wgmma_wait<0>();
  fence_regs(dq);
  const int buf = C::SPLIT ? (p & 1) : 0;
  const int off = C::dq + (wg * C::DQ_BUFS + buf) * C::DQ_STAGE;
  stage_rows<C, C::DQ_N>(gbase + off, C::Q_CHUNK, dq, t / 32 * 16 + t % 32 / 4,
                         cq, scale);
  fence_proxy_async();
  named_bar(2 + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C::DQ_N / C::W; ++c)
      tma_store(slabmap, base + off + c * C::Q_CHUNK,
                (C::SPLIT ? wg * C::DQ_N : 0) + c * C::W, q0, bh, kt);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// One consumer warpgroup: its 64 keys against every visible pair, dK and
// dV in registers, then both stored through its rows of the K and V tiles.
template <int D, bool FUSED>
__device__ __forceinline__ void consume(
    const CUtensorMap* dkmap, const CUtensorMap* dvmap,
    const CUtensorMap* slabmap, uint32_t base, unsigned char* gbase, int wg,
    int q_first, int n_q, int kt, int b, int hk, int group, int H, int Tk,
    float scale, float scale_log2, int causal, int q_off, int k_off) {
  using C = Cfg<D, FUSED>;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int cq = lane % 4;
  const int k0 = kt * KV_ROWS;
  const int row = wg * WG_KV + warp * 16 + lane / 4;  // key row i = 0: + 8 i
  const int kwg = k0 + wg * WG_KV;                    // this warpgroup's first
  const uint32_t bars = base + C::bar;
  const uint32_t k_wg = base + C::k + wg * C::WG_ROWS;
  const uint32_t v_wg = base + C::v + wg * C::WG_ROWS;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));

  if (q_first < n_q) mbar_wait(bars, 0);  // K and V
  int p = 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qi = q_first; qi < n_q; ++qi, ++p) {
      const int s = p % STAGES;
      const uint32_t slot = base + C::ring + s * 2 * C::Q_TILE;
      const float* lse_s = reinterpret_cast<const float*>(
          gbase + C::stats + s * 2 * Q_ROWS * 4);
      const int qg = q_off + qi * Q_ROWS;  // the pair's first query, global
      mbar_wait(full_bar(bars, s), (p / STAGES) & 1);
      float st[32], dpt[32];
      issue_scores<C, D>(st, k_wg, slot, zero, one);
      issue_scores<C, D>(dpt, v_wg, slot + C::Q_TILE, zero, one);
      wgmma_wait<1>();  // S^T has landed; dP^T may still run
      fence_regs(st);
      if (kwg + WG_KV > Tk || (causal && k_off + kwg + WG_KV - 1 > qg))
        probs<true>(st, lse_s, k0 + row, Tk, k_off + k0 + row, qg, cq,
                    causal, scale_log2);
      else
        probs<false>(st, lse_s, k0 + row, Tk, k_off + k0 + row, qg, cq,
                     causal, scale_log2);
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - Delta), in place on dP^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = lse_s[Q_ROWS + 8 * j + 2 * cq + e];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            dpt[4 * j + 2 * i + e] =
                st[4 * j + 2 * i + e] * (dpt[4 * j + 2 * i + e] - dl);
        }
      uint32_t pa[4][4], dsa[4][4];
      pack_a(st, pa);
      pack_a(dpt, dsa);
      // dV += P^T dO, dK += dS^T Q (the group sum rides the same
      // accumulators)
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_rs<C, D>(dv, pa, slot + C::Q_TILE, one);
      issue_rs<C, D>(dk, dsa, slot, one);
      wgmma_commit();
      float dq[C::DQ_N / 2];
      bool mine = false;
      if constexpr (FUSED)
        mine = dq_issue<C>(dq, base, gbase, dsa, p, wg, t, row, cq, zero,
                           one);
      if (mine)
        wgmma_wait<1>();  // dV/dK have landed; dS K may still run
      else
        wgmma_wait<0>();
      // the products that read them have completed: the slot is free
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(empty_bar(bars, s));
      if (mine)
        dq_store<C>(slabmap, base, gbase, dq, p, wg, t, cq, scale,
                    qi * Q_ROWS, b * H + h, kt);
    }
  }

  // epilogue: dK * scale and dV as bf16 into this warpgroup's rows of the
  // K and V tiles (in the layout the loads wrote), then one TMA store each;
  // FUSED: the other warpgroup's last dS K product has read K first
  if constexpr (FUSED) named_bar(1, NWG * 128);
  stage_rows<C, D>(gbase + C::k, C::KV_CHUNK, dk, row, cq, scale);
  stage_rows<C, D>(gbase + C::v, C::KV_CHUNK, dv, row, cq, 1.f);
  fence_proxy_async();
  named_bar(2 + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_store(dkmap, k_wg + c * C::KV_CHUNK, c * C::W, hk, kwg, b);
      tma_store(dvmap, v_wg + c * C::KV_CHUNK, c * C::W, hk, kwg, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The producer's one thread: K and V once (two 64-row boxes an atom), then
// each pair's Q and dO tiles, lse and Delta rows into the ring, in the
// consumers' order.
template <class C>
__device__ __forceinline__ void produce(
    const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* kmap, const CUtensorMap* vmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    uint32_t base, int q_first, int n_q, int kt, int b, int hk, int group,
    int H, int Tq) {
  const uint32_t bars = base + C::bar;
  const int k0 = kt * KV_ROWS;
  mbar_expect_tx(bars, 2 * C::KV_TILE);
  for (int c = 0; c < C::NCH; ++c)
    for (int w = 0; w < NWG; ++w) {
      const uint32_t off = c * C::KV_CHUNK + w * C::WG_ROWS;
      tma_load(base + C::k + off, kmap, c * C::W, hk, k0 + w * WG_KV, b,
               bars);
      tma_load(base + C::v + off, vmap, c * C::W, hk, k0 + w * WG_KV, b,
               bars);
    }
  int p = 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long row = ((long)b * H + h) * Tq;
    for (int qi = q_first; qi < n_q; ++qi, ++p) {
      const int s = p % STAGES;
      // each slot is refilled once the consumers released its last pair
      if (p >= STAGES) mbar_wait(empty_bar(bars, s), (p / STAGES - 1) & 1);
      const uint32_t full = full_bar(bars, s);
      const uint32_t slot = base + C::ring + s * 2 * C::Q_TILE;
      mbar_expect_tx(full, 2 * C::Q_TILE + 2 * Q_ROWS * 4);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load(slot + c * C::Q_CHUNK, qmap, c * C::W, h, qi * Q_ROWS, b,
                 full);
        tma_load(slot + C::Q_TILE + c * C::Q_CHUNK, domap, c * C::W, h,
                 qi * Q_ROWS, b, full);
      }
      const uint32_t st = base + C::stats + s * 2 * Q_ROWS * 4;
      bulk_load(st, lse + row + qi * Q_ROWS, Q_ROWS * 4, full);
      bulk_load(st + Q_ROWS * 4, delta + row + qi * Q_ROWS, Q_ROWS * 4, full);
    }
  }
}

// dK/dV (and, FUSED, the partial-dQ slab): one CTA per (kv tile of 128
// keys, b*Hkv + hk)
template <int D, bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap domap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap dkmap,
           const __grid_constant__ CUtensorMap dvmap,
           const __grid_constant__ CUtensorMap slabmap,
           const float* __restrict__ lse, const float* __restrict__ delta,
           int Tq, int Tk, int H, int Hkv, float scale, float scale_log2,
           int causal, int q_off, int k_off) {
  using C = Cfg<D, FUSED>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::bar;  // kv_full, then the ring's

  // the kv tiles in order: blocks launch in x-major order, so under a
  // causal mask the first keys (the longest walks) start first
  const int kt = blockIdx.y;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = H / Hkv, n_q = Tq / Q_ROWS;
  // causal: the first q tile whose last query sees the tile's first key
  // (the Pallas kernel's pl.when(visible)); a CTA with none loads nothing
  // and stores zeros
  int q_first = 0;
  if (causal) {
    const int lag = k_off + kt * KV_ROWS - q_off - (Q_ROWS - 1);
    q_first = lag <= 0 ? 0 : min((lag + Q_ROWS - 1) / Q_ROWS, n_q);
  }
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler knows it
  // (and all derived from it) is warp-uniform: wgmma descriptors then stay
  // in uniform registers (ptxas would otherwise serialize the products,
  // C7513)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x % 128 == 0 && q_first < n_q)
      produce<C>(&qmap, &domap, &kmap, &vmap, lse, delta, base, q_first, n_q,
                 kt, b, hk, group, H, Tq);
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, FUSED>(&dkmap, &dvmap, &slabmap, base, gbase, wg, q_first,
                      n_q, kt, b, hk, group, H, Tk, scale, scale_log2,
                      causal, q_off, k_off);
  }
}

// the (n_kv, B*H, Tq, D) slab as a 4-D map (D, Tq, B*H, n_kv) whose box is
// one swizzle atom's columns of 64 rows of one slot
CUresult make_slab_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                       int n_kv, int BH, int Tq, int D) {
  const int W = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Tq,
                              (cuuint64_t)BH, (cuuint64_t)n_kv};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Tq * D * 2,
                                 (cuuint64_t)BH * Tq * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)W, (cuuint32_t)Q_ROWS, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// error codes besides cudaError_t: no encode entry point, a refused map
constexpr int ERR_NO_ENCODE = -2;
constexpr int ERR_ENCODE = 100000;  // + the CUresult

template <int D, bool FUSED>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           void* slab, int B, int Tq, int Tk, int H, int Hkv, float scale,
           int causal, int q_off, int k_off, cudaStream_t stream) {
  using C = Cfg<D, FUSED>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const int n_kt = (Tk + KV_ROWS - 1) / KV_ROWS;
  CUtensorMap maps[7];
  const CUresult rs[7] = {
      make_map(encode, &maps[0], q, B, Tq, H, D, Q_ROWS),
      make_map(encode, &maps[1], dout, B, Tq, H, D, Q_ROWS),
      make_map(encode, &maps[2], k, B, Tk, Hkv, D, WG_KV),
      make_map(encode, &maps[3], v, B, Tk, Hkv, D, WG_KV),
      make_map(encode, &maps[4], dk, B, Tk, Hkv, D, WG_KV),
      make_map(encode, &maps[5], dv, B, Tk, Hkv, D, WG_KV),
      // kernel 4 writes no slab: its map is never read
      FUSED ? make_slab_map(encode, &maps[6], slab, n_kt, B * H, Tq, D)
            : make_map(encode, &maps[6], q, B, Tq, H, D, Q_ROWS)};
  for (CUresult r : rs)
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, n_kt);
  dkv_kernel<D, FUSED><<<grid, THREADS, C::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6],
      static_cast<const float*>(lse), static_cast<const float*>(delta), Tq,
      Tk, H, Hkv, scale, scale * LOG2E, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv,
             void* slab, int B, int Tq, int Tk, int H, int Hkv, int D,
             float scale, int causal, int q_off, int k_off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HPCPAT_DKV(DD)                                                      \
  return launch<DD, FUSED>(q, k, v, dout, lse, delta, dk, dv, slab, B, Tq,  \
                           Tk, H, Hkv, scale, causal, q_off, k_off, s)
  switch (D) {
    case 16: HPCPAT_DKV(16);
    case 32: HPCPAT_DKV(32);
    case 64: HPCPAT_DKV(64);
    case 128: HPCPAT_DKV(128);
    default: return -1;
  }
#undef HPCPAT_DKV
}

}  // namespace dkv

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or -1
// for a head_dim this build does not take; the dK/dV entry points also
// -2 when cuTensorMapEncodeTiled cannot be reached and 100000 + the
// CUresult of a refused tensor map. Tq and Tk must be multiples of 64
// (ops/flash_attention.py::BLOCK); the wrapper checks shapes, dtypes and
// contiguity.

// dK, dV and the partial-dQ slab (n_kv = ceil(Tk / 128), B*H, Tq, D): the
// slot of a (128-key tile, q head, 64-query tile) pair is written iff the
// pair is visible.
int flash_attention_fused_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              void* slab, int B, int Tq, int Tk, int H,
                              int Hkv, int D, float scale, int causal,
                              int q_off, int k_off, void* stream) {
  return dkv::dispatch<true>(q, k, v, dout, lse, delta, dk, dv, slab, B, Tq,
                             Tk, H, Hkv, D, scale, causal, q_off, k_off,
                             stream);
}

int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int Tq, int Tk, int H,
                        int Hkv, int D, float scale, int causal, int q_off,
                        int k_off, void* stream) {
  return dkv::dispatch<false>(q, k, v, dout, lse, delta, dk, dv, nullptr, B,
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
