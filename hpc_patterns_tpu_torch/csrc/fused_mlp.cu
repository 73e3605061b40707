// Fused transformer MLP for Hopper (sm_90a), bf16 in / bf16 out: the two
// Pallas kernels of hpc_patterns_tpu/ops/fused_mlp.py, on wgmma fed by
// TMA rings; the forward in thread block clusters that share each g panel.
//
// Replaces:
//   _fwd_kernel / _fwd_kernel_save_a (:65 / :148, call :165)
//     -> fused_mlp_fwd: y = gelu(x W1) W2 with the (N, F) activation never
//        in device memory; with `a` given, also writes a = x W1 (N, F);
//   _bwd_kernel (:93, call :193)
//     -> fused_mlp_bwd_dx + fused_mlp_bwd_dw: dx, dW1, dW2 of the same
//        function, in three launches (below).
//
// Math, as the TPU kernels: a = x W1f in f32; gelu is the tanh
// approximation in f32; g = gelu(a) is rounded to bf16 before g W2f; y
// accumulates over all of d_ff in f32 and is rounded once. Backward:
// dh = dy W2fᵀ in f32, da = dh gelu'(a) rounded to bf16, dx = da W1fᵀ
// summed in f32 over all of d_ff and rounded once (the TPU kernel rounds
// each panel's partial into its bf16 slab), dW1 = xᵀ da and dW2 = gᵀ dy
// in f32. Every product takes bf16 operands with f32 accumulation.
//
// The forward (mlp_kernel). The TPU kernel keeps a (512 x D) f32 y
// accumulator in VMEM; an SM holds y for about 32 tokens at D 1024 in its
// registers, and 32-token CTAs each read all 16 MB of W1 and W2 from L2
// (8.4 GB a call at the chip model's layer). Here a cluster of C CTAs
// shares a tile of 128 tokens. CTA r owns the DS = D / C columns r DS..
// of y: two consumer warpgroups of 64 tokens hold 64 x DS f32 each (128
// registers a thread at DS 256). d_ff is walked in panels of BF = 64 C
// columns, two panels a pass:
// - stage A: CTA r forms a = x W1f for the 64 columns r 64.. of both
//   panels of the pass at once (wgmma m64n128k16: x K-major, the two
//   64 x 64 W1 tiles side by side N-major), over D in 64-wide chunks. Two
//   panels a pass halve the x bytes a product needs: a stage-A chunk is
//   32 KB for 512 cycles of products (one panel: 24 KB for 256);
// - epilogue, each panel in turn: g = gelu(a) rounded to bf16 (save-a:
//   a stored) into this CTA's 64-column atom of the (128 x BF) panel in
//   shared memory, then copied by the bulk-copy engine into the same atom
//   of every peer (cp.async.bulk shared::cta -> shared::cluster,
//   completing the peer's panel barrier). A warpgroup exchanges its own
//   64 rows (a peer's warpgroup w reads only rows of warpgroup w); the
//   panel's full barrier takes the peers' bytes, its empty barrier one
//   arrival of every CTA's warpgroup w once its stage B is done, so no
//   peer overwrites rows that a product still reads;
// - stage B: y += panel W2f[panel rows, r DS..] in C chunks of 64 rows,
//   wgmma m64n{DS}k16 (W2 N-major), this CTA's own sub-panel first (its
//   rows are local; the peers' arrive meanwhile).
// One producer thread keeps the CTA's ring full by TMA (full/empty
// mbarriers over 32 KB slots: a stage-A chunk of x and two W1 tiles, or a
// stage-B chunk of W2); the ring runs ahead across stages and passes. The
// ring is the CTA's own: x is loaded by each CTA, not multicast to the
// cluster, because a multicast slot may be refilled only once every
// warpgroup of the cluster has released it, and that coupling made the
// forward 1.76x slower (1.125 against 0.641 ms at the chip model's layer,
// H100 80GB HBM3 at 700 W, one call of a build with each ring; PERF.md).
//
// The backward. dx in the forward's walk would hold dx, a and dh in
// registers (192 a thread) and take 48 KB stage-A slots of which only 3
// fit beside the panel: 2.01 ms, latency-bound. Split instead (0.83 ms,
// the same bits):
// * gda_kernel: a = x W1 and dh = dy W2ᵀ for one 128 x 128 tile of
//   (tokens, d_ff) a CTA (both products m64n128k16, 64 KB a chunk), then
//   g = gelu(a) and da = dh gelu'(a), both stored as bf16 (the dW kernel
//   needs them anyway);
// * gemm_kernel<0, 0, bf16>: dx = da W1ᵀ, 128 x 256 tiles over d_ff
//   (da K-major, W1's rows K-major), rounded once;
// * gemm_kernel<1, 1, float>: dW1 = xᵀ da and dW2 = gᵀ dy in one launch,
//   128 x 256 f32 tiles over the tokens, both operands MN-major (the
//   transpose bits).
// Each GEMM tile belongs to one CTA and walks its K in one fixed order:
// no split-K, no float atomics; two calls give equal bits.
//
// The shape rule (Plan, host and device alike; no knob): DS = 256 when
// D % 256 == 0, else 128, and C = D / DS (clusters of 1-4 CTAs at
// D 256..1024 even, 1, 3, 5 or 7 at the odd multiples of 128); as many
// 32 KB ring slots as the 227 KB leave beside the panel (5 at D 1024). A
// CTA whose sub-panel lies past F (ragged d_ff, F < BF) takes part in
// every barrier all the same: the TMA fills loads past N and F with zeros
// (gelu(0) = 0, so they add nothing) and the stores are guarded.
//
// L2 traffic of the forward at the chip model's layer (N 16384, D 1024,
// F 4096; C 4, 8 passes of two 256-column panels, 512 CTAs): per CTA a
// pass x 256 KB, W1 256 KB and W2 2 x 128 KB, in all 512 x 8 x 768 KB =
// 3.1 GB a call (the 32-token design: 8.4 GB).
//
// What bounds it on the H100: the forward does 2 products of 2 N D F =
// 1.37e11 FLOP each (0.278 ms at 989 TF/s) against ~80 MB moved, so it is
// bound by operations; the backward's 5 products, 0.695 ms. What still
// separates the forward from it: the epilogue and the panel exchange sit
// between a warpgroup's stage A and stage B, and stage A's chunks are
// small beside the loads' round trip.
//
// Contract (checked by ops/fused_mlp.py): bf16, contiguous, 16-byte
// aligned; D % 128 == 0, 128 <= D <= 1024; F % 8 == 0; any N >= 1.
// Layouts row-major: x, y, dy, dx (N, D); W1 (D, F); W2 (F, D); a, g, da
// (N, F); dW1 (D, F) and dW2 (F, D) f32.

#include <math.h>

#include "hopper.cuh"
#include "smem_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 128;            // tokens of a cluster's tile
constexpr int NWG = 2;             // consumer warpgroups, 64 tokens each
constexpr int THREADS = (NWG + 1) * 128;
constexpr int KC = 64;             // K chunk: one 128-byte atom of bf16
constexpr int SUB = 64;            // d_ff columns a CTA forms per panel
constexpr int X_TILE = BT * 128;   // a (128 x 64) x or dy chunk: 16 KB
constexpr int W_TILE = 64 * 128;   // a (64 x 64) weight tile: 8 KB
constexpr int WG_PART = 64 * 128;  // a warpgroup's rows of one atom: 8 KB
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;   // the opt-in limit of one block
constexpr int BAR_BYTES = 1024;    // the barriers, at the aligned base
constexpr int MAX_D = 1024;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

// d_ff panels whose stage A shares one pass over x: a of both
// sub-panels (64 registers a thread) beside y (128)
constexpr int NP = 2;

__device__ __forceinline__ float gelu(float a) {
  const float u = SQRT_2_OVER_PI * (a + GELU_C * a * a * a);
  return 0.5f * a * (1.f + tanhf(u));
}

// gelu and its derivative, sharing the tanh
__device__ __forceinline__ void gelu_grad(float a, float& g, float& dg) {
  const float u = SQRT_2_OVER_PI * (a + GELU_C * a * a * a);
  const float t = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.f + 3.f * GELU_C * a * a);
  g = 0.5f * a * (1.f + t);
  dg = 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * du;
}

// The shape rule of mlp_kernel (see the note above).
struct Plan {
  int C, DS, BF, panels, kch, slot, panel, stages, smem, tiles;
  __host__ __device__ Plan(int N, int D, int F) {
    DS = D % 256 == 0 ? 256 : 128;
    C = D / DS;
    BF = SUB * C;
    panels = (F + BF - 1) / BF;
    kch = D / KC;
    const int a_slot = X_TILE + NP * W_TILE;
    const int b_slot = 64 * DS * 2;
    slot = a_slot > b_slot ? a_slot : b_slot;
    panel = C * X_TILE;
    stages = (SMEM_MAX - 1024 - BAR_BYTES - panel) / slot;
    stages = stages < MAX_STAGES ? stages : MAX_STAGES;
    smem = 1024 + BAR_BYTES + panel + stages * slot;
    tiles = (N + BT - 1) / BT;
  }
};

// a ring position: slot and the parity of its current phase
struct RingPos {
  int s = 0, n;
  uint32_t ph = 0;
  __device__ explicit RingPos(int stages) : n(stages) {}
  __device__ void next() {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

// barriers at the base: full[MAX_STAGES], empty[MAX_STAGES], then the
// panel's full[NWG] and empty[NWG] (one pair for each warpgroup's rows)
__device__ __forceinline__ uint32_t full_bar(uint32_t b, int s) {
  return b + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t b, int s) {
  return b + 8 * (MAX_STAGES + s);
}
__device__ __forceinline__ uint32_t pfull_bar(uint32_t b, int w) {
  return b + 8 * (2 * MAX_STAGES + w);
}
__device__ __forceinline__ uint32_t pempty_bar(uint32_t b, int w) {
  return b + 8 * (2 * MAX_STAGES + NWG + w);
}

__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {  // K-major
  return make_desc(addr, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {  // MN-major
  return make_desc(addr, W_TILE, 1024, 1);
}

// y (m64n{DS}) += A B, A K-major and B N-major in shared memory
template <int DS>
__device__ __forceinline__ void wgmma_ds(float (&d)[DS / 2], uint64_t a,
                                         uint64_t b, int one) {
  if constexpr (DS == 256) wgmma_ss_n256<0, 1>(d, a, b, one);
  else wgmma_ss_n128<0, 1>(d, a, b, one);
}

// The producer: one thread walks the consumers' order of ring uses —
// per pass kch stage-A chunks, then C stage-B chunks for each of its
// panels, this CTA's own sub-panel's chunk first. The ring is this CTA's
// alone: a slot is refilled once its own two warpgroups released it.
template <int DS>
__device__ __forceinline__ void produce(const Plan& P, const CUtensorMap* xmap,
                                        const CUtensorMap* w1map,
                                        const CUtensorMap* w2map,
                                        uint32_t bars, uint32_t ring, int r,
                                        int t0) {
  const int C = P.C;
  const uint32_t a_bytes = X_TILE + NP * W_TILE;
  const uint32_t b_bytes = 64 * DS * 2;
  RingPos pos(P.stages);
  for (int p = 0; p < P.panels; p += NP) {
    const int f0 = p * P.BF + r * SUB;
    for (int k = 0; k < P.kch; ++k, pos.next()) {
      // (the first round waits on the phase before the first: passes)
      mbar_wait(empty_bar(bars, pos.s), pos.ph ^ 1);
      const uint32_t sb = ring + pos.s * P.slot, full = full_bar(bars, pos.s);
      mbar_expect_tx(full, a_bytes);
      tma_load_2d(sb, xmap, k * KC, t0, full);
      // W1's columns of this CTA's sub-panel of each panel of the pass
      // (past F the TMA fills zeros), side by side: one N-major operand
#pragma unroll
      for (int h = 0; h < NP; ++h)
        tma_load_2d(sb + X_TILE + h * W_TILE, w1map, f0 + h * P.BF, k * KC,
                    full);
    }
    for (int h = 0; h < NP && p + h < P.panels; ++h)
      for (int c = 0; c < C; ++c, pos.next()) {
        mbar_wait(empty_bar(bars, pos.s), pos.ph ^ 1);
        const uint32_t sb = ring + pos.s * P.slot;
        const uint32_t full = full_bar(bars, pos.s);
        mbar_expect_tx(full, b_bytes);
        // W2's rows of sub-panel (r + c) % C, its columns r DS.. (N-major)
        const int fc = (p + h) * P.BF + (r + c) % C * SUB;
#pragma unroll
        for (int n = 0; n < DS / 64; ++n)
          tma_load_2d(sb + n * W_TILE, w2map, r * DS + n * 64, fc, full);
      }
  }
}

// One consumer warpgroup: its 64 tokens of the tile, the CTA's DS columns
// of y in registers over the whole walk.
template <int DS, bool SAVE_A>
__device__ __forceinline__ void consume(
    const Plan& P, uint32_t bars, uint32_t panel, uint32_t ring,
    unsigned char* gpanel, int r, int t0, int w, bf16* __restrict__ y_out,
    bf16* __restrict__ a_out, int N, int D, int F) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g8 = lane / 4, cq = lane % 4;
  const int C = P.C;
  // the CTA whose barriers this thread signals for the warpgroup (one
  // thread for each CTA, spread over the warps)
  const int dst = lane * 4 + warp;
  const int row0 = t0 + w * 64 + warp * 16 + g8;  // token of row i = 0
  float y[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) y[i] = 0.f;
  float a[32 * NP];  // a of the pass's sub-panels (columns 64 h.. : p + h)
  // the scale-d flag, defined once before any product (a constant would
  // be materialized between two products, which serializes them)
  int one = 1;
  asm volatile("" : "+r"(one));
  RingPos pos(P.stages);
  auto release = [&](int s) { mbar_arrive(empty_bar(bars, s)); };
  const uint32_t part = panel + r * X_TILE + w * WG_PART;
  unsigned char* gpart = gpanel + r * X_TILE + w * WG_PART;

  for (int p = 0; p < P.panels; p += NP) {
    // stage A: a over D, one chunk in flight behind the next
#pragma unroll
    for (int i = 0; i < 32 * NP; ++i) a[i] = 0.f;
    int prev = 0;
    for (int k = 0; k < P.kch; ++k) {
      mbar_wait(full_bar(bars, pos.s), pos.ph);
      const uint32_t sb = ring + pos.s * P.slot;
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // x K-major, W1 N-major
        wgmma_ss_n128<0, 1>(a, desc_k(sb + w * WG_PART + kk * 32),
                            desc_mn(sb + X_TILE + kk * 2048), one);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        fence_regs(a);
        release(prev);
      }
      prev = pos.s;
      pos.next();
    }
    wgmma_wait<0>();
    fence_regs(a);
    release(prev);

#pragma unroll
    for (int h = 0; h < NP; ++h) {
      const int q = p + h;  // the panel
      if (q >= P.panels) break;
      const int f0 = q * P.BF + r * SUB;
      // epilogue: g into this CTA's atom of the panel, rows of this
      // warpgroup, once every CTA's warpgroup w is done with the last
      // panel; then to the same rows of every peer
      if (q > 0) mbar_wait_cluster(pempty_bar(bars, w), (q - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a0 = a[32 * h + 4 * j + 2 * i];
          const float a1 = a[32 * h + 4 * j + 2 * i + 1];
          const int col = 8 * j + 2 * cq, tok = row0 + 8 * i;
          if (SAVE_A && tok < N && f0 + col < F)
            *reinterpret_cast<uint32_t*>(a_out + (long)tok * F + f0 + col) =
                pack_bf16(a0, a1);
          int off = (warp * 16 + g8 + 8 * i) * 128 + col * 2;
          off ^= ((off >> 7) & 7) << 4;  // the 128-byte swizzle
          *reinterpret_cast<uint32_t*>(gpart + off) =
              pack_bf16(gelu(a0), gelu(a1));
        }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
      if (t == 0) {
        mbar_expect_tx(pfull_bar(bars, w), (C - 1) * WG_PART);
        for (int c = 0; c < C; ++c)
          if (c != r)
            bulk_copy_to_peer(mapa(part, c), part, WG_PART,
                              mapa(pfull_bar(bars, w), c));
      }

      // stage B: y += the panel's rows of this warpgroup times W2's rows
      // of each CTA's sub-panel, this CTA's own first (its rows are here
      // already; the peers' arrive meanwhile)
      for (int c = 0; c < C; ++c) {
        if (c == 1) mbar_wait_cluster(pfull_bar(bars, w), q & 1);
        mbar_wait(full_bar(bars, pos.s), pos.ph);
        const uint32_t sb = ring + pos.s * P.slot;
        const uint32_t pa = panel + (r + c) % C * X_TILE + w * WG_PART;
        fence_regs(y);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // the panel K-major, W2 N-major
          wgmma_ds<DS>(y, desc_k(pa + kk * 32), desc_mn(sb + kk * 2048),
                       one);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          fence_regs(y);
          release(prev);
        }
        prev = pos.s;
        pos.next();
      }
      wgmma_wait<0>();
      fence_regs(y);
      release(prev);
      // this warpgroup's rows of the panel are read: every CTA may refill
      // its own atom of them in the next panel
      if (dst < C) mbar_arrive_cluster(mapa(pempty_bar(bars, w), dst));
    }
  }

  // y rounded once, columns r DS.. of the tile's live tokens
#pragma unroll
  for (int j = 0; j < DS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tok = row0 + 8 * i;
      if (tok < N)
        *reinterpret_cast<uint32_t*>(y_out + (long)tok * D + r * DS + 8 * j +
                                     2 * cq) =
            pack_bf16(y[4 * j + 2 * i], y[4 * j + 2 * i + 1]);
    }
}

// y = gelu(x W1) W2 (and a = x W1 with SAVE_A): one cluster of C CTAs per
// 128-token tile. Maps (2-D, 128-byte swizzle): x box {64, 128}, W1 and
// W2 {64, 64}.
template <int DS, bool SAVE_A>
__global__ void __launch_bounds__(THREADS, 1)
mlp_kernel(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap w1map,
           const __grid_constant__ CUtensorMap w2map, bf16* __restrict__ y,
           bf16* __restrict__ a, int N, int D, int F) {
  const Plan P(N, D, F);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // the same offset in every CTA of the cluster (multicast, mapa)
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base, panel = base + BAR_BYTES;
  const uint32_t ring = panel + P.panel;
  unsigned char* gpanel = smem_raw + (panel - raw);
  const int r = (int)cluster_rank();
  const int t0 = (blockIdx.x / P.C) * BT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), NWG * 128);
    }
    for (int w = 0; w < NWG; ++w) {
      mbar_init(pfull_bar(bars, w), 1);
      mbar_init(pempty_bar(bars, w), P.C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before a peer signals one

  // warp-uniform (broadcast), so the descriptors stay uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0)
      produce<DS>(P, &xmap, &w1map, &w2map, bars, ring, r, t0);
    // no CTA leaves while a peer may still signal or fill it
    cluster_sync_diverged();
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<DS, SAVE_A>(P, bars, panel, ring, gpanel, r, t0, wg, y, a, N, D,
                        F);
    cluster_sync();
  }
}

// ---------------------------------------------------------------- GEMMs
//
// The backward's three GEMM-shaped steps, each a TMA + wgmma GEMM: one
// producer thread keeps a ring of K-chunks full, two consumer warpgroups
// each own 64 rows of the CTA's output tile in registers, every output
// element is summed by one CTA in a fixed order (no split over K).

constexpr int H_T = 128, H_F = 128;    // gda_kernel's tile: tokens x d_ff
constexpr int H_SLOT = 4 * X_TILE;     // x, dy, W1 and W2 chunks: 64 KB
constexpr int H_STAGES = 3;
constexpr int H_SMEM = 1024 + BAR_BYTES + H_STAGES * H_SLOT;

// g = gelu(a) and da = (dy W2ᵀ) gelu'(a), a = x W1, both (N, F) bf16: a
// dual GEMM over D, one (128 x 128) tile of each product a CTA. Maps:
// x, dy boxes {64, 128}; W1 {64, 64} (N-major: two atoms side by side);
// W2 {64, 128} (its rows f, K-major).
__global__ void __launch_bounds__(THREADS, 1)
gda_kernel(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap dymap,
           const __grid_constant__ CUtensorMap w1map,
           const __grid_constant__ CUtensorMap w2map, bf16* __restrict__ g,
           bf16* __restrict__ da, int N, int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base, ring = base + BAR_BYTES;
  const int ft = (F + H_F - 1) / H_F;
  const int t0 = blockIdx.x / ft * H_T, f0 = blockIdx.x % ft * H_F;
  const int nk = D / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < H_STAGES; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      RingPos pos(H_STAGES);
      for (int k = 0; k < nk; ++k, pos.next()) {
        mbar_wait(empty_bar(bars, pos.s), pos.ph ^ 1);
        const uint32_t sb = ring + pos.s * H_SLOT;
        const uint32_t full = full_bar(bars, pos.s);
        mbar_expect_tx(full, H_SLOT);
        tma_load_2d(sb, &xmap, k * KC, t0, full);
        tma_load_2d(sb + X_TILE, &dymap, k * KC, t0, full);
        for (int n = 0; n < 2; ++n)
          tma_load_2d(sb + 2 * X_TILE + n * W_TILE, &w1map, f0 + n * 64,
                      k * KC, full);
        tma_load_2d(sb + 3 * X_TILE, &w2map, k * KC, f0, full);
      }
    }
  } else {  // consumers: tokens t0 + 64 wg.. of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float a[64], dh[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) a[i] = dh[i] = 0.f;
    int one = 1;
    asm volatile("" : "+r"(one));
    RingPos pos(H_STAGES);
    int prev = 0;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(full_bar(bars, pos.s), pos.ph);
      const uint32_t sb = ring + pos.s * H_SLOT;
      fence_regs(a);
      fence_regs(dh);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128<0, 1>(a, desc_k(sb + wg * WG_PART + kk * 32),
                            desc_mn(sb + 2 * X_TILE + kk * 2048), one);
        wgmma_ss_n128<0, 0>(dh, desc_k(sb + X_TILE + wg * WG_PART + kk * 32),
                            desc_k(sb + 3 * X_TILE + kk * 32), one);
      }
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        fence_regs(a);
        fence_regs(dh);
        mbar_arrive(empty_bar(bars, prev));
      }
      prev = pos.s;
      pos.next();
    }
    wgmma_wait<0>();
    fence_regs(a);
    fence_regs(dh);
    const int row = t0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tok = row + 8 * i, f = f0 + 8 * j + 2 * (lane % 4);
        float g0, g1, d0, d1;
        gelu_grad(a[4 * j + 2 * i], g0, d0);
        gelu_grad(a[4 * j + 2 * i + 1], g1, d1);
        if (tok < N && f < F) {
          const long o = (long)tok * F + f;
          *reinterpret_cast<uint32_t*>(g + o) = pack_bf16(g0, g1);
          *reinterpret_cast<uint32_t*>(da + o) = pack_bf16(
              dh[4 * j + 2 * i] * d0, dh[4 * j + 2 * i + 1] * d1);
        }
      }
  }
}

constexpr int G_M = 128, G_P = 256;    // gemm_kernel's tile of C
constexpr int G_A = G_M * 128;         // (128 x 64) of A: 16 KB
constexpr int G_SLOT = G_A + 4 * W_TILE;  // + (64 x 256) of B: 48 KB
constexpr int G_STAGES = 4;
constexpr int G_SMEM = 1024 + BAR_BYTES + G_STAGES * G_SLOT;

__host__ __device__ inline int gemm_tiles(int M, int P) {
  return (M + G_M - 1) / G_M * ((P + G_P - 1) / G_P);
}

// C (M x P) = A B over K for one or two GEMMs in one launch (blocks
// [0, gemm_tiles(M0, P0)) form the first), 128 x 256 tiles of C. TA, TB:
// the operands' layouts as wgmma's transpose bits. A K-major (TA 0) is
// an (M, K) array, box {64, 128}; M-major (TA 1) a (K, M) array, box
// {64, 64}. B K-major (TB 0) is a (P, K) array, box {64, 256}; N-major
// (TB 1) a (K, P) array, box {64, 64}. C row-major, f32 or bf16.
template <int TA, int TB, typename Out>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a0,
            const __grid_constant__ CUtensorMap b0,
            const __grid_constant__ CUtensorMap a1,
            const __grid_constant__ CUtensorMap b1, Out* __restrict__ c0,
            Out* __restrict__ c1, int M0, int P0, int M1, int P1, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base, ring = base + BAR_BYTES;
  int tile = blockIdx.x;
  const bool second = tile >= gemm_tiles(M0, P0);
  if (second) tile -= gemm_tiles(M0, P0);
  const int M = second ? M1 : M0, P = second ? P1 : P0;
  const int pt = (P + G_P - 1) / G_P;
  const int m0 = tile / pt * G_M, p0 = tile % pt * G_P;
  const int nk = (K + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      const CUtensorMap* am = second ? &a1 : &a0;
      const CUtensorMap* bm = second ? &b1 : &b0;
      RingPos pos(G_STAGES);
      for (int k = 0; k < nk; ++k, pos.next()) {
        mbar_wait(empty_bar(bars, pos.s), pos.ph ^ 1);
        const uint32_t sb = ring + pos.s * G_SLOT;
        const uint32_t full = full_bar(bars, pos.s);
        mbar_expect_tx(full, G_SLOT);
        if constexpr (TA == 0) {
          tma_load_2d(sb, am, k * KC, m0, full);
        } else {
          for (int n = 0; n < 2; ++n)
            tma_load_2d(sb + n * W_TILE, am, m0 + n * 64, k * KC, full);
        }
        if constexpr (TB == 0) {
          tma_load_2d(sb + G_A, bm, k * KC, p0, full);
        } else {
          for (int n = 0; n < 4; ++n)
            tma_load_2d(sb + G_A + n * W_TILE, bm, p0 + n * 64, k * KC, full);
        }
      }
    }
  } else {  // consumers: rows m0 + 64 wg.. of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int one = 1;
    asm volatile("" : "+r"(one));
    RingPos pos(G_STAGES);
    int prev = 0;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(full_bar(bars, pos.s), pos.ph);
      const uint32_t sb = ring + pos.s * G_SLOT;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // this warpgroup's 64 rows: 8 KB into the A chunk either way
        const uint64_t da = TA == 0 ? desc_k(sb + wg * 8192 + kk * 32)
                                    : desc_mn(sb + wg * 8192 + kk * 2048);
        const uint64_t db = TB == 0 ? desc_k(sb + G_A + kk * 32)
                                    : desc_mn(sb + G_A + kk * 2048);
        wgmma_ss_n256<TA, TB>(acc, da, db, one);
      }
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        fence_regs(acc);
        mbar_arrive(empty_bar(bars, prev));
      }
      prev = pos.s;
      pos.next();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    Out* C = second ? c1 : c0;
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = row + 8 * i, p = p0 + 8 * j + 2 * (lane % 4);
        if (m < M && p < P) {
          const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          if constexpr (sizeof(Out) == 4)
            *reinterpret_cast<float2*>(C + (long)m * P + p) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(C + (long)m * P + p) =
                pack_bf16(v0, v1);
        }
      }
  }
}

// ---------------------------------------------------------------- host

// error codes besides cudaError_t: widths outside the contract, no
// encode entry point, a refused map, a cluster that cannot be resident
constexpr int ERR_WIDTH = -1;
constexpr int ERR_NO_ENCODE = -2;
constexpr int ERR_NO_CLUSTER = -3;
constexpr int ERR_ENCODE = 100000;  // + the CUresult

bool width_ok(int N, int D, int F) {
  return N >= 1 && D % 128 == 0 && D >= 128 && D <= MAX_D && F >= 8 &&
         F % 8 == 0;
}

// a (rows, cols) bf16 row-major array as a 2-D map with a
// {box_cols, box_rows} box and the 128-byte swizzle
CUresult map2d(EncodeTiled encode, CUtensorMap* map, const void* ptr,
               int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the launch's own error (the runtime's last-error slot may hold an
// older one that is not ours), cleared from that slot
int launched(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// the launch configuration of `grid` CTAs in clusters of `cluster`
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int grid, int cluster, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// lets the kernel take a block's whole shared memory (one attribute for
// every configuration of the instance) and asks, once for each
// configuration (`known`, 0 until asked), how many of its clusters the
// card holds at once; none is an error (the launch could never run)
template <typename K>
int resident(K kernel, int smem, int cluster, int* known) {
  if (*known > 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  Launch l(cluster, cluster, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return ERR_NO_CLUSTER;
  *known = n;
  return 0;
}

// resident clusters of mlp_kernel<DS, SAVE_A> at this plan (its shared
// memory depends on DS and C only)
template <int DS, bool SAVE_A>
int clusters_mlp(const Plan& P, int* n) {
  static int known[MAX_D / 128 + 1] = {0};
  const int rc = resident(mlp_kernel<DS, SAVE_A>, P.smem, P.C, &known[P.C]);
  *n = known[P.C];
  return rc;
}

template <bool SAVE_A>
int clusters_of(const Plan& P, int* n) {
  return P.DS == 256 ? clusters_mlp<256, SAVE_A>(P, n)
                     : clusters_mlp<128, SAVE_A>(P, n);
}

// resident blocks of a kernel launched without clusters (cluster 1)
template <typename K>
int clusters_single(K kernel, int smem, int* known, int* n) {
  const int rc = resident(kernel, smem, 1, known);
  *n = *known;
  return rc;
}

CUresult encode_all(const CUresult* rs, int n) {
  for (int i = 0; i < n; ++i)
    if (rs[i] != CUDA_SUCCESS) return rs[i];
  return CUDA_SUCCESS;
}

// y = gelu(x W1) W2, and a = x W1 where a is given
template <bool SAVE_A>
int run_fwd(const void* x, const void* w1, const void* w2, void* y, void* a,
            int N, int D, int F, cudaStream_t stream) {
  if (!width_ok(N, D, F)) return ERR_WIDTH;
  const Plan P(N, D, F);
  int clusters = 0;
  int rc = clusters_of<SAVE_A>(P, &clusters);
  if (rc != 0) return rc;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap m[3];
  const CUresult rs[3] = {map2d(encode, &m[0], x, N, D, KC, BT),
                          map2d(encode, &m[1], w1, D, F, SUB, KC),
                          map2d(encode, &m[2], w2, F, D, KC, SUB)};
  const CUresult bad = encode_all(rs, 3);
  if (bad != CUDA_SUCCESS) return ERR_ENCODE + (int)bad;
  Launch l(P.tiles * P.C, P.C, P.smem, stream);
  cudaError_t err =
      P.DS == 256
          ? cudaLaunchKernelEx(&l.cfg, mlp_kernel<256, SAVE_A>, m[0], m[1],
                               m[2], static_cast<bf16*>(y),
                               static_cast<bf16*>(a), N, D, F)
          : cudaLaunchKernelEx(&l.cfg, mlp_kernel<128, SAVE_A>, m[0], m[1],
                               m[2], static_cast<bf16*>(y),
                               static_cast<bf16*>(a), N, D, F);
  return launched(err);
}

int clusters_gda(int* n) {
  static int known = 0;
  return clusters_single(gda_kernel, H_SMEM, &known, n);
}

template <int TA, int TB, typename Out>
int clusters_gemm(int* n) {
  static int known = 0;
  return clusters_single(gemm_kernel<TA, TB, Out>, G_SMEM, &known, n);
}

// dx, g and da: the dual GEMM (g, da), then dx = da W1ᵀ (rounded once)
int run_dx(const void* x, const void* w1, const void* w2, const void* dy,
           void* dx, void* g, void* da, int N, int D, int F,
           cudaStream_t stream) {
  if (!width_ok(N, D, F)) return ERR_WIDTH;
  int n = 0, rc = clusters_gda(&n);
  if (rc == 0) rc = clusters_gemm<0, 0, bf16>(&n);
  if (rc != 0) return rc;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap m[6];
  const CUresult rs[6] = {map2d(encode, &m[0], x, N, D, KC, H_T),
                          map2d(encode, &m[1], dy, N, D, KC, H_T),
                          map2d(encode, &m[2], w1, D, F, 64, KC),
                          map2d(encode, &m[3], w2, F, D, KC, H_F),
                          map2d(encode, &m[4], da, N, F, KC, G_M),
                          map2d(encode, &m[5], w1, D, F, KC, G_P)};
  const CUresult bad = encode_all(rs, 6);
  if (bad != CUDA_SUCCESS) return ERR_ENCODE + (int)bad;
  Launch l1((N + H_T - 1) / H_T * ((F + H_F - 1) / H_F), 1, H_SMEM, stream);
  cudaError_t err = cudaLaunchKernelEx(
      &l1.cfg, gda_kernel, m[0], m[1], m[2], m[3], static_cast<bf16*>(g),
      static_cast<bf16*>(da), N, D, F);
  if (err != cudaSuccess) return launched(err);
  Launch l2(gemm_tiles(N, D), 1, G_SMEM, stream);
  err = cudaLaunchKernelEx(&l2.cfg, gemm_kernel<0, 0, bf16>, m[4], m[5],
                           m[4], m[5], static_cast<bf16*>(dx),
                           static_cast<bf16*>(dx), N, D, 0, 0, F);
  return launched(err);
}

// dW1 = xᵀ da and dW2 = gᵀ dy in one launch (both operands M/N-major)
int run_dw(const void* x, const void* g, const void* da, const void* dy,
           void* dw1, void* dw2, int N, int D, int F, cudaStream_t stream) {
  if (!width_ok(N, D, F)) return ERR_WIDTH;
  int n = 0;
  int rc = clusters_gemm<1, 1, float>(&n);
  if (rc != 0) return rc;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap m[4];
  const CUresult rs[4] = {map2d(encode, &m[0], x, N, D, 64, KC),
                          map2d(encode, &m[1], da, N, F, 64, KC),
                          map2d(encode, &m[2], g, N, F, 64, KC),
                          map2d(encode, &m[3], dy, N, D, 64, KC)};
  const CUresult bad = encode_all(rs, 4);
  if (bad != CUDA_SUCCESS) return ERR_ENCODE + (int)bad;
  Launch l(gemm_tiles(D, F) + gemm_tiles(F, D), 1, G_SMEM, stream);
  cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, gemm_kernel<1, 1, float>, m[0], m[1], m[2], m[3],
      static_cast<float*>(dw1), static_cast<float*>(dw2), D, F, F, D, N);
  return launched(err);
}

}  // namespace

extern "C" {

// Each returns the launch's error (0 = launched), -1 for widths outside
// the contract above (the wrapper checks them first), -2 when
// cuTensorMapEncodeTiled cannot be reached, -3 when the card cannot hold
// one cluster (or block) of the launch, 100000 + the CUresult of a
// refused tensor map.

int fused_mlp_fwd(const void* x, const void* w1, const void* w2, void* y,
                  void* a, int N, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a == nullptr ? run_fwd<false>(x, w1, w2, y, a, N, D, F, s)
                      : run_fwd<true>(x, w1, w2, y, a, N, D, F, s);
}

int fused_mlp_bwd_dx(const void* x, const void* w1, const void* w2,
                     const void* dy, void* dx, void* g, void* da, int N,
                     int D, int F, void* stream) {
  return run_dx(x, w1, w2, dy, dx, g, da, N, D, F,
                static_cast<cudaStream_t>(stream));
}

int fused_mlp_bwd_dw(const void* x, const void* g, const void* da,
                     const void* dy, void* dw1, void* dw2, int N, int D,
                     int F, void* stream) {
  return run_dw(x, g, da, dy, dw1, dw2, N, D, F,
                static_cast<cudaStream_t>(stream));
}

// The launches the entry points make at (N, D, F), for reports: `kernel`
// 0 the forward, 1 the save-a forward, 2 dx's first launch (g, da), 3 dW,
// 4 dx's second (dx = da W1ᵀ); out[0..7] = CTAs a cluster, tile rows
// (tokens, or rows of C), tile columns (y's columns a CTA, or of C), the
// d_ff panel (or the K chunk), ring slots, grid (CTAs), dynamic shared
// memory bytes, and cudaOccupancyMaxActiveClusters. Returns as the entry
// points (nothing is launched).
int fused_mlp_plan(int kernel, int N, int D, int F, int* out) {
  if (!width_ok(N, D, F)) return ERR_WIDTH;
  int clusters = 0, rc;
  if (kernel == 2) {
    rc = clusters_gda(&clusters);
    const int v[8] = {1, H_T, H_F, KC, H_STAGES,
                      (N + H_T - 1) / H_T * ((F + H_F - 1) / H_F), H_SMEM,
                      clusters};
    memcpy(out, v, sizeof v);
    return rc;
  }
  if (kernel == 3 || kernel == 4) {
    rc = kernel == 3 ? clusters_gemm<1, 1, float>(&clusters)
                     : clusters_gemm<0, 0, bf16>(&clusters);
    const int grid = kernel == 3 ? gemm_tiles(D, F) + gemm_tiles(F, D)
                                 : gemm_tiles(N, D);
    const int v[8] = {1, G_M, G_P, KC, G_STAGES, grid, G_SMEM, clusters};
    memcpy(out, v, sizeof v);
    return rc;
  }
  const Plan P(N, D, F);
  rc = kernel == 0 ? clusters_of<false>(P, &clusters)
                   : clusters_of<true>(P, &clusters);
  const int v[8] = {P.C, BT, P.DS, P.BF, P.stages, P.tiles * P.C, P.smem,
                    clusters};
  memcpy(out, v, sizeof v);
  return rc;
}

}  // extern "C"

// mlp_kernel's dynamic bytes are its plan's (P.smem, set per call)
HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(-1, mlp_kernel<128, false>),
                   HPCPAT_SMEM_ROW(-1, mlp_kernel<128, true>),
                   HPCPAT_SMEM_ROW(-1, mlp_kernel<256, false>),
                   HPCPAT_SMEM_ROW(-1, mlp_kernel<256, true>),
                   HPCPAT_SMEM_ROW(H_SMEM, gda_kernel),
                   HPCPAT_SMEM_ROW(G_SMEM, gemm_kernel<0, 0, bf16>),
                   HPCPAT_SMEM_ROW(G_SMEM, gemm_kernel<1, 1, float>))
