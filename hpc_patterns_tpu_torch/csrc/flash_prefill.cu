// Causal flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out:
// wgmma with register accumulators, a TMA + mbarrier K/V ring, and the
// online softmax on the accumulator fragments.
//
// Replaces: hpc_patterns_tpu/ops/flash_attention.py::_kernel (the Pallas
// forward reached through flash_attention / flash_attention_block /
// _forward_impl). Same math: online softmax over key tiles with m, l and
// the output accumulator in f32; q.k^T and p.v take bf16 inputs with f32
// accumulation (p is rounded to bf16 before p.v, as the Pallas kernel's
// p.astype(v.dtype)); GQA reads kv head h / (H / Hkv). The causal mask is
// in GLOBAL positions: query row i of the call sits at q_offset + i, key j
// at k_offset + j, and Tq may differ from Tk (one block of a ring step).
// Rows with nothing visible (a fully-future block, or a row before every
// key) output 0 and lse ~ -1e30, as the Pallas kernel's epilogue. The lse
// output (f32, (B*H, Tq), natural log: the backward's residual) is written
// only when its pointer is not null — the serving path passes null.
//
// Layout: q, o (B, Tq, H, D); k, v (B, Tk, Hkv, D) — the JAX layout. The
// tensor maps are 4-D (D, heads, T, B), so a tile that runs past T is
// zero-filled by the TMA (never read from the next batch) and a store
// past Tq is dropped by it.
//
// Design. The TPU kernel keeps m, l and acc in VMEM scratch across a
// sequential kv grid axis; here they live in registers and the kv loop
// runs inside the block. One CTA per (block of query rows, b*H + h):
// NWG consumer warpgroups of 64 rows each (one wgmma M) and one producer
// warpgroup, of which one thread issues every copy:
// - copies: Q once per warpgroup, then K and V tiles of BK = 128 keys
//   into two rings of STAGES slots, each slot a full/empty mbarrier pair
//   (the TMA completes full with its bytes; the 128 threads of each live
//   consumer warpgroup arrive on empty once the product reading the slot
//   has completed). K and V have rings of their own because a K tile is
//   done one step before the V tile of the same keys;
// - S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory
//   with the swizzle the TMA map wrote (128B for D >= 64, whose rows are
//   cut into 64-column atoms; 64B at D 32; 32B at D 16);
// - softmax in place on the S fragment: a thread holds 2 rows x 32
//   columns, a row spans the 4 threads of a quad (two shfl_xor); scores
//   go to the log2 domain (scale * log2 e folded in, one MUFU.EX2 each;
//   lse converted back to natural log); only tiles that cross the
//   diagonal or the Tk edge are masked (selects), and a warpgroup stops
//   at its own diagonal;
// - O += P V: P is rounded to bf16 in registers and fed as wgmma's
//   register A operand (m64n{D}k16, the RS form); V is the MN-major B
//   operand (transpose bit). O stays in registers for the whole loop: no
//   S, P or O tile touches shared memory;
// - overlap: in step j, S_j = Q K_j^T and O += P_{j-1} V_{j-1} are in
//   flight together; the softmax of S_j runs once S_j has landed, while
//   the P V product still runs, and P_j is packed only after that product
//   has completed (so no register it reads is redefined while it runs:
//   ptxas would otherwise serialize every product of the kernel, C7513);
// - epilogue: O / max(l, 1e-30), dead rows 0, written bf16 into the
//   warpgroup's own (finished) Q slot with the map's swizzle and stored
//   by one TMA store; lse by one thread of each quad.
// With two consumer warpgroups the producer drops to 24 registers and the
// consumers rise to 240 (setmaxnreg; launch bounds give 168 x 384).
// CTA rows: 128 (two warpgroups), or 64 (one) when the 128-row grid would
// leave SMs idle (the serving prefill: B 1, T 512, H 8 is 32 CTAs of 128
// rows on 132 SMs, 64 of 64) — a shape rule in dispatch(), no knob. The
// grid walks the query blocks from the last, so that under a causal mask
// the longest CTAs start first. No atomics and no split across CTAs: two
// calls give equal bits.
//
// What bounds it on the H100: at the training shape (B 8, T 2048, H 8,
// D 128, causal: 6.9e10 FLOP, 0.069 ms at 989 TF/s against 0.02 ms of
// bytes) the tensor cores, of which it keeps about 40% busy (0.167 ms on
// an H100 80GB HBM3 at 700 W): the softmax and the rescale of O still
// sit between a warpgroup's products, and nothing makes the two consumer
// warpgroups take turns (no ping-pong). At the serving shape (B 1, T 512,
// H 8: ~4 MiB, 1.3 us of bytes, 0.5 us of products) latency: 64 CTAs of
// at most 4 kv tiles each, so the ring never fills and the launch, the Q
// load and the epilogue dominate (0.011 ms on the same card).

#include <math.h>

#include "hopper.cuh"
#include "smem_rows.cuh"

namespace {

constexpr int WG_ROWS = 64;  // query rows of one consumer warpgroup
constexpr int BK = 128;      // keys per K/V tile
constexpr int STAGES = 2;    // K/V ring slots
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float DEAD_LSE = -1e30f;

template <int D, int NWG>
struct Cfg {
  static constexpr int W = D < 64 ? D : 64;  // columns of one swizzle atom
  static constexpr int NCH = D / W;          // atoms across a row
  static constexpr int ROW_BYTES = W * 2;    // 32, 64 or 128: the swizzle
  // log2 of the 16-byte groups a swizzle row holds; the wgmma layout code
  static constexpr int SWZ_BITS =
      ROW_BYTES == 128 ? 3 : ROW_BYTES == 64 ? 2 : 1;
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static constexpr int Q_CHUNK = WG_ROWS * ROW_BYTES;  // one atom column
  static constexpr int Q_WG = NCH * Q_CHUNK;           // a warpgroup's Q / O
  static constexpr int KV_CHUNK = BK * ROW_BYTES;
  static constexpr int KV_TILE = NCH * KV_CHUNK;       // one K or V tile
  static constexpr int THREADS = (NWG + 1) * 128;
  // byte offsets from the 1024-aligned base (every tile a multiple of
  // 1024 bytes, so each swizzle atom starts on its repeat)
  static constexpr int q = 0;
  static constexpr int k = q + NWG * Q_WG;
  static constexpr int v = k + STAGES * KV_TILE;
  static constexpr int bar = v + STAGES * KV_TILE;  // q_full, the ring's
  static constexpr int bytes = bar + (1 + 4 * STAGES) * 8 + 1024;
};

// ---------------------------------------------------------------- PTX
//
// The shared helpers (mbarriers, TMA, wgmma, descriptors, exp2) are in
// hopper.cuh: S = Q K^T is wgmma m64n128k16 with both operands in shared
// memory, O += P V m64n{D}k16 with P in registers and V MN-major.

// ---------------------------------------------------------------- kernel

// the ring's barriers after q_full: K full, K empty, V full, V empty
enum Ring { K_FULL = 0, K_EMPTY, V_FULL, V_EMPTY };

__device__ __forceinline__ uint32_t ring_bar(uint32_t bars, Ring r, int s) {
  return bars + 8 * (1 + r * STAGES + s);
}


// Issue S = Q K^T (D / 16 steps of k16, 32 bytes apart inside a
// swizzle atom, the next atom a chunk away; both operands K-major) or
// O += P V (BK / 16 steps of 16 keys, 16 rows of the MN-major V).
// `zero` and `one` are the scale-d flags as registers defined once,
// before any product (a constant is materialized by a mov between two
// products: no register a product reads is to be defined among them).
// The first S step ignores the accumulator.
template <class C, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_base,
                                         uint32_t k_base, int zero, int one) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk * 16 % C::W * 2, c = kk * 16 / C::W;
    wgmma_ss_n128<0, 0>(sc,
                  make_desc(q_base + c * C::Q_CHUNK + off, 16,
                            8 * C::ROW_BYTES, C::LAYOUT),
                  make_desc(k_base + c * C::KV_CHUNK + off, 16,
                            8 * C::ROW_BYTES, C::LAYOUT),
                  kk > 0 ? one : zero);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <class C, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_base, int one) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o, pa[kk],
                make_desc(v_base + kk * 16 * C::ROW_BYTES, C::KV_CHUNK,
                          8 * C::ROW_BYTES, C::LAYOUT),
                one);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// the online softmax of one tile on its S fragment (sc[4j + 2i + e] is
// row wrow + 8i, column 8j + 2cq + e): updates m and the quad-partial l,
// returns P rounded to bf16 as wgmma's A fragments (the S fragment of a
// k16 slice is the A fragment of that slice) and O's rescale alpha
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int Tk, int causal, int k_off, int qpos, int cq,
    float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * j + 2 * i + e] * scale_log2;
        if constexpr (EDGE) {  // a select, no branch
          const int kc = k0 + 8 * j + 2 * cq + e;
          x = kc >= Tk || (causal && k_off + kc > qpos + 8 * i) ? -INFINITY
                                                                : x;
        }
        sc[4 * j + 2 * i + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
  float mu[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mu[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // nothing seen yet
    alpha[i] = exp2_ftz(m[i] - mu[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_ftz(sc[4 * j + 2 * i + e] - mu[i]);
        rsum[i] += p;
        sc[4 * j + 2 * i + e] = p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
}

// P (in sc, f32) rounded to bf16 as wgmma's A fragments: the S fragment
// of a k16 slice is the A fragment of that slice
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// masked only where the tile crosses the diagonal or the Tk edge
__device__ __forceinline__ void softmax(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool edge, int k0, int Tk, int causal, int k_off, int qpos, int cq,
    float scale_log2) {
  if (edge)
    softmax_tile<true>(sc, m, l, alpha, k0, Tk, causal, k_off, qpos, cq,
                       scale_log2);
  else
    softmax_tile<false>(sc, m, l, alpha, k0, Tk, causal, k_off, qpos, cq,
                        scale_log2);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
}

// One consumer warpgroup: its 64 rows against the ring's kv tiles up to
// its own diagonal (the CTA's others it only lets pass). In step j,
// S_j = Q K_j^T and O += P_{j-1} V_{j-1} are in flight together; the
// softmax of S_j runs once S_j has landed, while P_{j-1} V_{j-1} still
// runs; K_j's slot is released when S_j has landed, V_{j-1}'s and P's
// registers when its product has.
template <int D, int NWG>
__device__ __forceinline__ void consume(
    const CUtensorMap* omap, uint32_t base, unsigned char* gbase,
    float* __restrict__ lse, int wg, int n_kt, int q0, int bh, int b, int h,
    int Tq, int Tk, float scale_log2, int causal, int q_off, int k_off) {
  using C = Cfg<D, NWG>;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, cq = lane % 4;
  const int wrow = warp * 16 + g;                // row i = 0 in the group
  const int qfirst = q_off + q0 + wg * WG_ROWS;  // its first row, global
  const int qpos = qfirst + wrow;                // row i's: + 8 i
  const uint32_t q_base = base + C::q + wg * C::Q_WG;
  const uint32_t bars = base + C::bar;
  auto k_base = [&](int s) { return base + C::k + s * C::KV_TILE; };
  auto v_base = [&](int s) { return base + C::v + s * C::KV_TILE; };
  // tiles this warpgroup reads: up to its own last row's diagonal
  int n_wg = n_kt;
  if (causal) {
    const int last = qfirst + WG_ROWS - 1 - k_off;
    n_wg = last < 0 ? 0 : min(last / BK + 1, n_kt);
  }
  auto edge = [&](int k0) {
    return k0 + BK > Tk || (causal && k_off + k0 + BK - 1 > qfirst);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[BK / 16][4];

  // the Q slot is also where O is staged: wait for its load in any case
  if (n_kt > 0) mbar_wait(bars, 0);
  if (n_wg > 0) {
    int zero = 0, one = 1;
    asm volatile("" : "+r"(zero), "+r"(one));
    mbar_wait(ring_bar(bars, K_FULL, 0), 0);
    issue_qk<C, D>(sc, q_base, k_base(0), zero, one);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(ring_bar(bars, K_EMPTY, 0));
    softmax(sc, m, l, alpha, edge(0), 0, Tk, causal, k_off, qpos, cq,
            scale_log2);
    pack_p(sc, pa);
    for (int j = 1; j < n_wg; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      rescale<D>(o, alpha);  // before either product of the step
      fence_regs(o);
      mbar_wait(ring_bar(bars, K_FULL, s), (j / STAGES) & 1);
      issue_qk<C, D>(sc, q_base, k_base(s), zero, one);
      mbar_wait(ring_bar(bars, V_FULL, sp), ((j - 1) / STAGES) & 1);
      issue_pv<C, D>(o, pa, v_base(sp), one);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_regs(sc);
      mbar_arrive(ring_bar(bars, K_EMPTY, s));
      // in place on S_j's registers; P_{j-1}'s are not touched until
      // its product has completed
      softmax(sc, m, l, alpha, edge(j * BK), j * BK, Tk, causal, k_off,
              qpos, cq, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(ring_bar(bars, V_EMPTY, sp));
      pack_p(sc, pa);
    }
    const int sl = (n_wg - 1) % STAGES;
    rescale<D>(o, alpha);
    fence_regs(o);
    mbar_wait(ring_bar(bars, V_FULL, sl), ((n_wg - 1) / STAGES) & 1);
    issue_pv<C, D>(o, pa, v_base(sl), one);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(ring_bar(bars, V_EMPTY, sl));
  }
  // tiles past this warpgroup's diagonal that the other one reads: take
  // part in their slots' phases without reading them (waiting for the
  // load first keeps each arrival in its own tile's phase)
  for (int j = n_wg; j < n_kt; ++j) {
    const int s = j % STAGES, ph = (j / STAGES) & 1;
    mbar_wait(ring_bar(bars, K_FULL, s), ph);
    mbar_arrive(ring_bar(bars, K_EMPTY, s));
    mbar_wait(ring_bar(bars, V_FULL, s), ph);
    mbar_arrive(ring_bar(bars, V_EMPTY, s));
  }

  // epilogue: out = acc / max(l, 1e-30), dead rows 0; lse when asked
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const bool dead = m[i] == -INFINITY;
    inv[i] = dead ? 0.f : 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && cq == 0)
      lse[(long)bh * Tq + q0 + wg * WG_ROWS + wrow + 8 * i] =
          dead ? DEAD_LSE : m[i] * LN2 + logf(fmaxf(l[i], 1e-30f));
  }
  // bf16 O into this warpgroup's Q slot (its last wgmma has completed),
  // in the swizzled layout the O map expects
  unsigned char* ob = gbase + C::q + wg * C::Q_WG;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 8 * j + 2 * cq;
      int off = col / C::W * C::Q_CHUNK + (wrow + 8 * i) * C::ROW_BYTES
                + col % C::W * 2;
      off ^= ((off >> 7) & ((1 << C::SWZ_BITS) - 1)) << 4;
      *reinterpret_cast<uint32_t*>(ob + off) =
          pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_store(omap, q_base + c * C::Q_CHUNK, c * C::W, h, q0 + wg * WG_ROWS,
                b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap,
                 float* __restrict__ lse, int Tq, int Tk, int H, int Hkv,
                 float scale_log2, int causal, int q_off, int k_off) {
  using C = Cfg<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::bar;  // q_full, then the ring's

  // the longest rows (the last query blocks, under a causal mask) first:
  // blocks launch in x-major order, so the grid's y walks the query
  // blocks from the last
  const int q0 = (gridDim.y - 1 - blockIdx.y) * NWG * WG_ROWS;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // warpgroups with rows below Tq (Tq % 64 == 0: a warpgroup is all in
  // or all out); the others store nothing and take no part in the ring
  const int n_live = min(NWG, (Tq - q0) / WG_ROWS);
  // kv tiles up to the causal diagonal of the last live row (the Pallas
  // kernel's clamped index map + pl.when(visible)); a fully-future block
  // loads nothing
  int n_kt = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = q_off + q0 + n_live * WG_ROWS - 1 - k_off;
    n_kt = last < 0 ? 0 : min(last / BK + 1, n_kt);
  }
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring_bar(bars, K_FULL, s), 1);
      mbar_init(ring_bar(bars, K_EMPTY, s), n_live * 128);
      mbar_init(ring_bar(bars, V_FULL, s), 1);
      mbar_init(ring_bar(bars, V_EMPTY, s), n_live * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler knows it
  // (and all derived from it: row positions, tile counts, shared
  // addresses) is warp-uniform: wgmma descriptors then stay in uniform
  // registers instead of being moved into them between two products,
  // which would serialize the products (ptxas C7513)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {  // producer
    if constexpr (NWG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x % 128 == 0 && n_kt > 0) {
      mbar_expect_tx(bars, n_live * C::Q_WG);
      for (int w = 0; w < n_live; ++w)
        for (int c = 0; c < C::NCH; ++c)
          tma_load(base + C::q + w * C::Q_WG + c * C::Q_CHUNK, &qmap, c * C::W,
                   h, q0 + w * WG_ROWS, b, bars);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, ph = (kt / STAGES - 1) & 1;
        // each slot is refilled once the consumers released its last tile
        if (kt >= STAGES) mbar_wait(ring_bar(bars, K_EMPTY, s), ph);
        mbar_expect_tx(ring_bar(bars, K_FULL, s), C::KV_TILE);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(base + C::k + s * C::KV_TILE + c * C::KV_CHUNK, &kmap,
                   c * C::W, hk, kt * BK, b, ring_bar(bars, K_FULL, s));
        if (kt >= STAGES) mbar_wait(ring_bar(bars, V_EMPTY, s), ph);
        mbar_expect_tx(ring_bar(bars, V_FULL, s), C::KV_TILE);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(base + C::v + s * C::KV_TILE + c * C::KV_CHUNK, &vmap,
                   c * C::W, hk, kt * BK, b, ring_bar(bars, V_FULL, s));
      }
    }
  } else {  // consumers
    if constexpr (NWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (wg < n_live)
      consume<D, NWG>(&omap, base, gbase, lse, wg, n_kt, q0, bh, b, h, Tq,
                      Tk, scale_log2, causal, q_off, k_off);
  }
}

// ---------------------------------------------------------------- host


// error codes besides cudaError_t: no encode entry point, a refused map
constexpr int ERR_NO_ENCODE = -2;
constexpr int ERR_ENCODE = 100000;  // + the CUresult

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int Tk, int H, int Hkv, float scale, int causal,
           int q_off, int k_off, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap maps[4];
  const CUresult rs[4] = {
      make_map(encode, &maps[0], q, B, Tq, H, D, WG_ROWS),
      make_map(encode, &maps[1], k, B, Tk, Hkv, D, BK),
      make_map(encode, &maps[2], v, B, Tk, Hkv, D, BK),
      make_map(encode, &maps[3], o, B, Tq, H, D, WG_ROWS)};
  for (CUresult r : rs)
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = NWG * WG_ROWS;
  dim3 grid(B * H, (Tq + rows - 1) / rows);
  flash_fwd_kernel<D, NWG><<<grid, C::THREADS, C::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), Tq, Tk,
      H, Hkv, scale * LOG2E, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Tq, int Tk, int H, int Hkv, int D, float scale,
             int causal, int q_off, int k_off, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, NWG>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale,
                             causal, q_off, k_off, s);
    case 32:
      return launch<32, NWG>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale,
                             causal, q_off, k_off, s);
    case 64:
      return launch<64, NWG>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale,
                             causal, q_off, k_off, s);
    case 128:
      return launch<128, NWG>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale,
                              causal, q_off, k_off, s);
    default:
      return -1;
  }
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int Tq, int Tk, int H, int Hkv, int D,
             float scale, int causal, int q_off, int k_off, int rows,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) {  // the shape rule: 64-row CTAs when 128 leave SMs idle
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    rows = (long)(Tq + 127) / 128 * B * H < sms ? 64 : 128;
  }
  if (rows == 64)
    return launch_d<1>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, D, scale, causal,
                       q_off, k_off, s);
  if (rows == 128)
    return launch_d<2>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, D, scale, causal,
                       q_off, k_off, s);
  return -1;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), -1 for a
// head_dim this build does not take, -2 when cuTensorMapEncodeTiled
// cannot be reached, 100000 + the CUresult of a refused tensor map. Tq
// and Tk must be multiples of 64 (ops/flash_attention.py::BLOCK:
// a warpgroup's 64 query rows; the 128-key tiles mask a ragged Tk edge
// and the 128-row CTAs a ragged Tq edge). Global offsets; lse (B*H, Tq)
// f32 is written when not null (the serving path passes null,
// self-attention and offsets 0).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int B, int Tq, int Tk, int H,
                        int Hkv, int D, float scale, int causal, int q_off,
                        int k_off, void* stream) {
  return dispatch(q, k, v, o, lse, B, Tq, Tk, H, Hkv, D, scale, causal,
                  q_off, k_off, 0, stream);
}

// The same with the CTA's query rows given (64 or 128) instead of chosen
// by the shape rule: for timing the two tiles against each other.
int flash_attention_fwd_rows(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Tq, int Tk,
                             int H, int Hkv, int D, float scale, int causal,
                             int q_off, int k_off, int rows, void* stream) {
  return dispatch(q, k, v, o, lse, B, Tq, Tk, H, Hkv, D, scale, causal,
                  q_off, k_off, rows, stream);
}

}  // extern "C"

#define HPCPAT_FWD_ROWS(DD)                                   \
  HPCPAT_SMEM_ROW((Cfg<DD, 1>::bytes), flash_fwd_kernel<DD, 1>), \
      HPCPAT_SMEM_ROW((Cfg<DD, 2>::bytes), flash_fwd_kernel<DD, 2>)
HPCPAT_SMEM_EXPORT(HPCPAT_FWD_ROWS(16), HPCPAT_FWD_ROWS(32), HPCPAT_FWD_ROWS(64),
                   HPCPAT_FWD_ROWS(128))
#undef HPCPAT_FWD_ROWS
