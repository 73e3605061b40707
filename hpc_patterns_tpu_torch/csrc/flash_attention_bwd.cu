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
// dQ (kernel 3: dq::dq_kernel<D>): the dK/dV template turned round, queries
// as M. One CTA per (block of 128 queries, b*H + h), the query blocks from
// the last (under a causal mask the longest walks start first). A producer
// warpgroup (24 registers) loads the CTA's Q and dO tiles once and streams
// K and V tiles of 64 keys through a ring of STAGES (3) slots; two
// consumer warpgroups (240 registers) own 64 queries each, their lse and
// Delta in registers, and per kv tile:
// - S = Q K^T and dP = dO V^T: wgmma m64n64k16, both operands K-major with
//   the TMA's swizzle;
// - P and dS in registers (the mask, a select, only on tiles that cross
//   the warpgroup's diagonal; Tk is a multiple of the tile, so no Tk edge);
// - dQ += dS K: wgmma m64n{D}k16 with dS rounded to bf16 as the register A
//   operand and K the MN-major B (kernel 1's P V), dQ in registers for the
//   whole walk. dS never touches shared memory and the warpgroups never
//   meet: each owns its queries outright.
// The products of a tile overlap the previous tile's dQ product (S_j,
// dP_j and dS_{j-1} K_{j-1} in flight together; P and dS are taken while
// the last runs). A warpgroup stops at its own diagonal and lets the
// other's tiles pass. dQ * scale leaves through the warpgroup's Q slot by
// a TMA store. With Tq % 128 == 64 the last CTA's second warpgroup has no
// queries: it loads, computes and stores nothing.
//
// What bounds them on the H100 at the training shape (B 8, T 2048, H 8, D
// 128, causal): the fused kernel does 5 products of 2*64*64*128 FLOP per
// visible (64-query, 64-key) pair, 1.72e11 FLOP (0.174 ms at 989 TF/s),
// against 202 MB of q/k/v/do/lse/delta/dk/dv plus the slab slots it
// writes: with 128-key tiles 272 of the 512 (kv tile, q tile) pairs are
// visible, 0.285 GB of the 0.54 GB slab, 0.487 GB in all (0.145 ms at 3.35
// TB/s): bound by the tensor cores. The dK/dV kernel: 1.38e11 FLOP, 0.139
// ms; the dQ kernel: 3 products, 1.03e11 FLOP, 0.104 ms. On an H100 80GB
// HBM3 at 700 W (bench_flash.py) the fused kernel takes 0.367 ms (468
// TF/s, 2.1x its bound) and the dK/dV one 0.248 ms (555 TF/s, 1.8x): the
// two warpgroups meet at the dS barrier every pair, so each one's
// elementwise work (P, dS, the dS and dQ stores) sits between its own
// products, overlapped only by the other's. ptxas: 168 registers at
// launch (setmaxnreg moves them to the consumers), no spills.

#include <type_traits>

#include "hopper.cuh"
#include "smem_rows.cuh"

namespace {

// ---------------------------------------------------------------- shared
//
// Helpers of both templates (dK/dV and dQ) beyond hopper.cuh's.

constexpr float LOG2E = 1.4426950408889634f;

// error codes besides cudaError_t: no encode entry point, a refused map
constexpr int ERR_NO_ENCODE = -2;
constexpr int ERR_ENCODE = 100000;  // + the CUresult

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

// A bf16 row of D values as the TMA loads it: W columns a swizzle atom
// (64, or D below 64), NCH atoms across, ROW_BYTES (128, 64 or 32) the
// swizzle; SWZ_BITS the log2 of the 16-byte groups a swizzle row holds,
// LAYOUT the wgmma descriptor's code for it. Each template's Cfg adds its
// tiles' offsets.
template <int D>
struct Atoms {
  static constexpr int W = D < 64 ? D : 64;  // columns of one swizzle atom
  static constexpr int NCH = D / W;          // atoms across a row
  static constexpr int ROW_BYTES = W * 2;    // 32, 64 or 128: the swizzle
  // log2 of the 16-byte groups a swizzle row holds; the wgmma layout code
  static constexpr int SWZ_BITS =
      ROW_BYTES == 128 ? 3 : ROW_BYTES == 64 ? 2 : 1;
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
};

// X = A B^T (m64n64) for 64 rows of A against 64 rows of B, both K-major
// tiles of D columns (atoms A_CHUNK and B_CHUNK bytes apart): D / 16
// steps of k16, 32 bytes apart inside a swizzle atom. `zero` and `one`
// are the scale-d flags as registers defined once, before any product (no
// register a running product reads is defined between two products). The
// first step ignores the accumulator.
template <class C, int D, int A_CHUNK, int B_CHUNK>
__device__ __forceinline__ void issue_ss(float (&x)[32], uint32_t a_base,
                                         uint32_t b_base, int zero, int one) {
  undefined(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk * 16 % C::W * 2, c = kk * 16 / C::W;
    wgmma_ss<64, 0, 0>(x,
                       make_desc(a_base + c * A_CHUNK + off, 16,
                                 8 * C::ROW_BYTES, C::LAYOUT),
                       make_desc(b_base + c * B_CHUNK + off, 16,
                                 8 * C::ROW_BYTES, C::LAYOUT),
                       kk > 0 ? one : zero);
  }
  wgmma_commit();
}

// acc (m64n{D}) += A (m64k64, four k16 fragments in registers) B, B a
// 64 x D tile as the MN-major operand (atoms CHUNK bytes apart): 16 rows
// a step. The caller fences and commits.
template <class C, int D, int CHUNK>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b_base, int one) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, a[kk],
                make_desc(b_base + kk * 16 * C::ROW_BYTES, CHUNK,
                          8 * C::ROW_BYTES, C::LAYOUT),
                one);
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

template <int D, bool FUSED>
struct Cfg : Atoms<D> {
  using A = Atoms<D>;
  static constexpr int Q_CHUNK = Q_ROWS * A::ROW_BYTES;  // one atom column
  static constexpr int Q_TILE = A::NCH * Q_CHUNK;       // a Q or dO tile
  static constexpr int KV_CHUNK = KV_ROWS * A::ROW_BYTES;
  static constexpr int KV_TILE = A::NCH * KV_CHUNK;     // K or V
  static constexpr int WG_ROWS = WG_KV * A::ROW_BYTES;  // a warpgroup's keys
  // the pair's dQ partial: one atom of D for each warpgroup at D 128, all
  // of D for one warpgroup (the pairs in turns) below it
  static constexpr bool SPLIT = A::NCH == NWG;
  static constexpr int DQ_N = SPLIT ? D / NWG : D;
  static constexpr int DQ_BUFS = SPLIT ? 2 : 1;  // a warpgroup's staging
  static constexpr int DQ_STAGE = DQ_N / A::W * Q_CHUNK;
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
      // S^T = K Q^T, dP^T = V dO^T for this warpgroup's 64 keys
      issue_ss<C, D, C::KV_CHUNK, C::Q_CHUNK>(st, k_wg, slot, zero, one);
      issue_ss<C, D, C::KV_CHUNK, C::Q_CHUNK>(dpt, v_wg, slot + C::Q_TILE,
                                              zero, one);
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
      issue_rs<C, D, C::Q_CHUNK>(dv, pa, slot + C::Q_TILE, one);
      issue_rs<C, D, C::Q_CHUNK>(dk, dsa, slot, one);
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

// ---------------------------------------------------------------- dQ
//
// Kernel 3 (the note at the top of the file): dkv's template turned round,
// queries as M.

namespace dq {

constexpr int WG_Q = 64;              // queries of one consumer warpgroup
constexpr int NWG = 2;                // consumer warpgroups
constexpr int Q_ROWS = NWG * WG_Q;    // queries of a CTA
constexpr int BK = 64;                // keys of a ring slot
constexpr int THREADS = (NWG + 1) * 128;
constexpr int STAGES = 3;             // ring slots

template <int D>
struct Cfg : Atoms<D> {
  using A = Atoms<D>;
  static constexpr int Q_CHUNK = WG_Q * A::ROW_BYTES;  // one atom column
  static constexpr int Q_WG = A::NCH * Q_CHUNK;        // a warpgroup's Q or dO
  static constexpr int KV_CHUNK = BK * A::ROW_BYTES;
  static constexpr int KV_TILE = A::NCH * KV_CHUNK;    // a K or V tile
  // byte offsets from the 1024-aligned base (every tile a multiple of
  // 1024 bytes, so each swizzle atom starts on its repeat); a ring slot
  // is a K tile and the V tile of the same keys
  static constexpr int q = 0;
  static constexpr int dout = q + NWG * Q_WG;
  static constexpr int ring = dout + NWG * Q_WG;
  static constexpr int bar = ring + STAGES * 2 * KV_TILE;  // q_full, ring
  static constexpr int bytes = bar + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(bytes <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

static_assert(BK == 64, "issue_ss and issue_rs take 64-key tiles");

// dQ (m64n{D}) += dS (m64k64 in registers) K, K the slot's 64 x D tile
// as the MN-major operand
template <class C, int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2],
                                         const uint32_t (&ds)[BK / 16][4],
                                         uint32_t k_base, int one) {
  wgmma_fence();
  issue_rs<C, D, C::KV_CHUNK>(dq, ds, k_base, one);
  wgmma_commit();
}

// P in place on the S fragment (x[4j + 2i + e] is query row + 8i, key
// column 8j + 2cq + e of the tile): 2^(S scale log2e - lse log2e), 0 where
// masked (EDGE: the key in the query's future; the only mask, since Tk is
// a multiple of the tile). kg: the tile's first key, qg: row 0's query,
// both global.
template <bool EDGE>
__device__ __forceinline__ void probs(float (&x)[BK / 2],
                                      const float (&l2)[2], int kg, int qg,
                                      int cq, float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = exp2_ftz(fmaf(x[4 * j + 2 * i + e], scale_log2, -l2[i]));
        if constexpr (EDGE)  // a select, no branch
          p = kg + 8 * j + 2 * cq + e <= qg + 8 * i ? p : 0.f;
        x[4 * j + 2 * i + e] = p;
      }
}

// One consumer warpgroup: its 64 queries against the ring's kv tiles up
// to its own diagonal (the CTA's others it only lets pass), dQ in
// registers. In step j, S_j = Q K_j^T, dP_j = dO V_j^T and dQ += dS_{j-1}
// K_{j-1} are in flight together: P_j is taken once S_j has landed, dS_j
// once dP_j has, both while the dQ product still runs; dS_j is packed
// (and slot j-1 released) only once that product has completed, so no
// register a running product reads is defined (C7513).
template <int D>
__device__ __forceinline__ void consume(
    const CUtensorMap* dqmap, uint32_t base, unsigned char* gbase,
    const float* __restrict__ lse, const float* __restrict__ delta, int wg,
    int n_kt, int q0, int bh, int b, int h, int Tq, float scale,
    float scale_log2, int causal, int q_off, int k_off) {
  using C = Cfg<D>;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int cq = lane % 4;
  const int wrow = warp * 16 + lane / 4;     // row i = 0 of the fragment
  const int qloc = q0 + wg * WG_Q + wrow;     // its query in [0, Tq)
  const int qfirst = q_off + q0 + wg * WG_Q;  // the warpgroup's first, global
  const uint32_t q_base = base + C::q + wg * C::Q_WG;
  const uint32_t do_base = base + C::dout + wg * C::Q_WG;
  const uint32_t bars = base + C::bar;
  auto k_base = [&](int s) { return base + C::ring + s * 2 * C::KV_TILE; };
  auto v_base = [&](int s) { return k_base(s) + C::KV_TILE; };
  // the thread's two rows: lse (log2 domain) and Delta, read once
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long r = (long)bh * Tq + qloc + 8 * i;
    l2[i] = lse[r] * LOG2E;
    dl[i] = delta[r];
  }
  // tiles this warpgroup reads: up to its own last row's diagonal
  int n_wg = n_kt;
  if (causal) {
    const int last = qfirst + WG_Q - 1 - k_off;
    n_wg = last < 0 ? 0 : min(last / BK + 1, n_kt);
  }
  const int qg = q_off + qloc;  // row i's global position: + 8 i

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float st[BK / 2], dpt[BK / 2];
  uint32_t dsa[BK / 16][4];
  int zero = 0, one = 1;
  asm volatile("" : "+r"(zero), "+r"(one));

  // step j (FIRST: j = 0, no dQ product of a previous tile in flight)
  auto step = [&](int j, auto first) {
    constexpr bool FIRST = decltype(first)::value;
    const int s = j % STAGES, sp = (j + STAGES - 1) % STAGES;
    const int k0 = j * BK;
    mbar_wait(full_bar(bars, s), (j / STAGES) & 1);
    issue_ss<C, D, C::Q_CHUNK, C::KV_CHUNK>(st, q_base, k_base(s), zero,
                                            one);
    issue_ss<C, D, C::Q_CHUNK, C::KV_CHUNK>(dpt, do_base, v_base(s), zero,
                                            one);
    if constexpr (!FIRST) issue_dq<C, D>(dq, dsa, k_base(sp), one);
    wgmma_wait<FIRST ? 1 : 2>();  // S_j has landed
    fence_regs(st);
    // P, masked only where the tile crosses the warpgroup's diagonal
    if (causal && k_off + k0 + BK - 1 > qfirst)
      probs<true>(st, l2, k_off + k0, qg, cq, scale_log2);
    else
      probs<false>(st, l2, k_off + k0, qg, cq, scale_log2);
    wgmma_wait<FIRST ? 0 : 1>();  // dP_j has landed
    fence_regs(dpt);
    // dS = P (dP - Delta), in place on dP
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dpt[4 * jj + 2 * i + e] =
              st[4 * jj + 2 * i + e] * (dpt[4 * jj + 2 * i + e] - dl[i]);
    if constexpr (!FIRST) {
      wgmma_wait<0>();  // dS_{j-1} K_{j-1} has completed
      fence_regs(dq);
      fence_regs(dsa);
      mbar_arrive(empty_bar(bars, sp));
    }
    pack_a(dpt, dsa);
  };

  // the Q slot is also where dQ is staged: wait for its load in any case
  if (n_kt > 0) mbar_wait(bars, 0);
  if (n_wg > 0) {
    step(0, std::true_type{});
    for (int j = 1; j < n_wg; ++j) step(j, std::false_type{});
    const int sl = (n_wg - 1) % STAGES;
    issue_dq<C, D>(dq, dsa, k_base(sl), one);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsa);
    mbar_arrive(empty_bar(bars, sl));
  }
  // tiles past this warpgroup's diagonal that the other one reads: take
  // part in their slots' phases without reading them
  for (int j = n_wg; j < n_kt; ++j) {
    const int s = j % STAGES;
    mbar_wait(full_bar(bars, s), (j / STAGES) & 1);
    mbar_arrive(empty_bar(bars, s));
  }

  // epilogue: dQ * scale as bf16 into this warpgroup's Q slot (its last
  // product has completed), in the swizzled layout the map expects, then
  // one TMA store (rows past Tq never reach here: a warpgroup is all in or
  // all out)
  stage_rows<C, D>(gbase + C::q + wg * C::Q_WG, C::Q_CHUNK, dq, wrow, cq,
                   scale);
  fence_proxy_async();
  named_bar(1 + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_store(dqmap, q_base + c * C::Q_CHUNK, c * C::W, h,
                q0 + wg * WG_Q, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// dQ: one CTA per (block of 128 queries, b*H + h), the query blocks from
// the last (under a causal mask the longest walks start first)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap domap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const __grid_constant__ CUtensorMap dqmap,
          const float* __restrict__ lse, const float* __restrict__ delta,
          int Tq, int Tk, int H, int Hkv, float scale, float scale_log2,
          int causal, int q_off, int k_off) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::bar;  // q_full, then the ring's

  const int q0 = (gridDim.y - 1 - blockIdx.y) * Q_ROWS;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // warpgroups with queries below Tq (Tq % 64 == 0: a warpgroup is all in
  // or all out); the others load, compute and store nothing
  const int n_live = min(NWG, (Tq - q0) / WG_Q);
  // kv tiles up to the causal diagonal of the last live query (the Pallas
  // kernel's clamped index map + pl.when(visible)); a block with none
  // loads nothing and stores zeros
  int n_kt = Tk / BK;
  if (causal) {
    const int last = q_off + q0 + n_live * WG_Q - 1 - k_off;
    n_kt = last < 0 ? 0 : min(last / BK + 1, n_kt);
  }
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), n_live * 128);
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
    if (threadIdx.x % 128 == 0 && n_kt > 0) {
      mbar_expect_tx(bars, 2 * n_live * C::Q_WG);
      for (int w = 0; w < n_live; ++w)
        for (int c = 0; c < C::NCH; ++c) {
          tma_load(base + C::q + w * C::Q_WG + c * C::Q_CHUNK, &qmap,
                   c * C::W, h, q0 + w * WG_Q, b, bars);
          tma_load(base + C::dout + w * C::Q_WG + c * C::Q_CHUNK, &domap,
                   c * C::W, h, q0 + w * WG_Q, b, bars);
        }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        // each slot is refilled once the consumers released its last tile
        if (kt >= STAGES) mbar_wait(empty_bar(bars, s), (kt / STAGES - 1) & 1);
        const uint32_t full = full_bar(bars, s);
        const uint32_t slot = base + C::ring + s * 2 * C::KV_TILE;
        mbar_expect_tx(full, 2 * C::KV_TILE);
        for (int c = 0; c < C::NCH; ++c) {
          tma_load(slot + c * C::KV_CHUNK, &kmap, c * C::W, hk, kt * BK, b,
                   full);
          tma_load(slot + C::KV_TILE + c * C::KV_CHUNK, &vmap, c * C::W, hk,
                   kt * BK, b, full);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (wg < n_live)
      consume<D>(&dqmap, base, gbase, lse, delta, wg, n_kt, q0, bh, b, h, Tq,
                 scale, scale_log2, causal, q_off, k_off);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Tq,
           int Tk, int H, int Hkv, float scale, int causal, int q_off,
           int k_off, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap maps[5];
  const CUresult rs[5] = {
      make_map(encode, &maps[0], q, B, Tq, H, D, WG_Q),
      make_map(encode, &maps[1], dout, B, Tq, H, D, WG_Q),
      make_map(encode, &maps[2], k, B, Tk, Hkv, D, BK),
      make_map(encode, &maps[3], v, B, Tk, Hkv, D, BK),
      make_map(encode, &maps[4], dq, B, Tq, H, D, WG_Q)};
  for (CUresult r : rs)
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + Q_ROWS - 1) / Q_ROWS);
  dq_kernel<D><<<grid, THREADS, C::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(lse), static_cast<const float*>(delta), Tq,
      Tk, H, Hkv, scale, scale * LOG2E, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

}  // namespace dq

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), -1 for
// a head_dim this build does not take, -2 when cuTensorMapEncodeTiled
// cannot be reached and 100000 + the CUresult of a refused tensor map. Tq and Tk must be multiples of 64
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
  return dq::launch<DD>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hkv,   \
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

#define HPCPAT_BWD_ROWS(DD)                                                   \
  HPCPAT_SMEM_ROW((dkv::Cfg<DD, true>::bytes), dkv::dkv_kernel<DD, true>),    \
      HPCPAT_SMEM_ROW((dkv::Cfg<DD, false>::bytes), dkv::dkv_kernel<DD, false>), \
      HPCPAT_SMEM_ROW((dq::Cfg<DD>::bytes), dq::dq_kernel<DD>)
HPCPAT_SMEM_EXPORT(HPCPAT_BWD_ROWS(16), HPCPAT_BWD_ROWS(32), HPCPAT_BWD_ROWS(64),
                   HPCPAT_BWD_ROWS(128))
#undef HPCPAT_BWD_ROWS
