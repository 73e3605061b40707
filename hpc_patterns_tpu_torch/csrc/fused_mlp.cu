// Fused transformer MLP for Hopper (sm_90a), bf16 in / bf16 out: the two
// Pallas kernels of hpc_patterns_tpu/ops/fused_mlp.py.
//
// Replaces:
//   _fwd_kernel / _fwd_kernel_save_a (:65 / :148, call :165)
//     -> fused_mlp_fwd: y = gelu(x W1) W2 with the (N, F) activation never
//        in device memory; with `a` given, also writes a = x W1 (N, F);
//   _bwd_kernel (:93, call :193)
//     -> fused_mlp_bwd_dx + fused_mlp_bwd_dw: dx, dW1, dW2 of the same
//        function, in two kernels (below).
//
// Math, as the TPU kernels: a = x W1f in f32; gelu is the tanh
// approximation in f32; g = gelu(a) is rounded to bf16 before g W2f; y
// accumulates over the d_ff panels in f32 and is rounded once. Backward:
// dh = dy W2fᵀ in f32, da = dh gelu'(a) rounded to bf16, dx = sum over
// panels of da W1fᵀ (in f32 here, rounded once: the TPU kernel rounds each
// panel's partial into its bf16 slab), dW1 = xᵀ da and dW2 = gᵀ dy in f32.
// Every product takes bf16 operands with f32 accumulation (WMMA 16x16x16).
//
// Why not block by block. The TPU forward keeps a (512 x D) f32 y
// accumulator in VMEM (2 MiB at D 1024); the backward keeps (D x 512) and
// (512 x D) f32 dW accumulators (4 MiB) and writes an (F/512, N, D) bf16
// partial-dx slab. An SM has 227 KB of shared memory and 256 KB of
// registers. So:
//
// * fused_mlp_fwd — one CTA (8 warps) per 32-token tile, walking d_ff in
//   64-wide panels. y (32 x D f32) lives in registers: 2 x D/16 fragments,
//   D/64 a warp (16 at D 1024, 128 registers a thread). x stays in shared
//   memory; per panel, W1f streams in two K-halves and a (32 x 64) is one
//   fragment a warp, then the whole W2 panel (64 x D) is staged and each
//   warp adds g W2f to its y fragments. D is never split across CTAs, so
//   no CTA recomputes another's a. Shared memory at D 1024: x 66,048 B +
//   one region of 132,096 B (a W1 half 73,728 / the W2 panel 132,096 /
//   y's f32 staging 131,584) + a 8,704 + g 4,608 = 211,456 B; one CTA an
//   SM, __launch_bounds__(256, 1).
// * fused_mlp_bwd_dx — the forward's walk with the backward's first three
//   products: per 32-token tile and 64-wide panel, a = x W1f and
//   dh = dy W2fᵀ (one fragment of each a warp, x/dy/W2 streamed in 128-wide
//   K chunks, the W1 panel kept whole in shared memory), g and da written
//   to device memory (bf16, for the dW kernel), and dx += da W1fᵀ into
//   register fragments laid out as y's. Shared memory at D 1024: the W1
//   panel 147,456 B (dx's f32 staging reuses it) + chunks 34,816 + a, dh
//   17,408 + da 4,608 = 204,288 B.
// * fused_mlp_bwd_dw — dW1 = xᵀ da and dW2 = gᵀ dy in one launch: a GEMM
//   whose 128 x 128 output tiles each belong to one CTA (8 warps of 64 x 32)
//   that walks the whole token axis in 64-row chunks. Shared memory 34,816
//   B plus 8,192 B of edge staging; two CTAs an SM.
//
// The TPU kernel's 5 block products stay 5 (a, dh, dx; dW1, dW2); the
// price is g and da (2 N F bf16) through device memory. Deterministic:
// every CTA owns its outputs and walks its loops in a fixed order; no
// float atomics.
//
// What bounds it on the H100: at the chip model's layer (N 16384, D 1024,
// F 4096) the forward does 2 products of 2 N D F = 1.37e11 FLOP each
// (0.278 ms at 989 TF/s) against ~80 MB moved, so it is bound by
// operations; the backward's 5 products, 0.695 ms. This version is the
// simple correct one: single-buffered tiles filled by cp.async (every
// copy of a tile in flight at once, then one wait), WMMA (mma.sync),
// 32-token CTAs that read every weight panel once per tile from L2.
// wgmma, TMA, multi-stage pipelines and clusters that share a g tile over
// 64+ tokens are the later steps.
//
// Contract (checked by ops/fused_mlp.py): bf16, contiguous, 16-byte
// aligned; D % 128 == 0, 128 <= D <= 1024; F % 8 == 0; any N >= 1 (the
// ragged token tile and d_ff panel are masked: zero-filled loads, guarded
// stores). Layouts row-major: x, y, dy, dx (N, D); W1 (D, F); W2 (F, D);
// a, g, da (N, F); dW1 (D, F) and dW2 (F, D) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BT = 32;     // token rows per CTA
constexpr int BF = 64;     // d_ff panel width
constexpr int KCH = 128;   // K chunk of the dx kernel's first products
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 1024;
constexpr int MAXJ = MAX_D / 128;  // column tiles a warp owns (of 16 cols)
constexpr int LDF = BF + 8;        // padded bf16 panel rows
constexpr int LDA = BF + 4;        // padded f32 panel rows
constexpr int TM = 128, TP = 128, TK = 64;  // the dW GEMM's tiles
constexpr int LDG = TM + 8;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

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

__device__ __forceinline__ float gelu(float a) {
  const float u = SQRT_2_OVER_PI * (a + GELU_C * a * a * a);
  return 0.5f * a * (1.f + tanhf(u));
}

__device__ __forceinline__ float dgelu(float a) {
  const float u = SQRT_2_OVER_PI * (a + GELU_C * a * a * a);
  const float t = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.f + 3.f * GELU_C * a * a);
  return 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * du;
}

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// one 16-byte asynchronous copy global -> shared (cp.async, no register
// staging, many in flight a thread); a masked copy reads nothing and
// writes zeros
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// this thread's copies are in shared memory (a __syncthreads() after it
// publishes everyone's)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `rows` x `cols` bf16 (cols % 8 == 0) from global rows of stride `ld`
// into shared rows of `lds` elements, 16 bytes a copy, issued
// asynchronously (cp_async_wait_all() + __syncthreads() before use);
// elements at row >= vrows or col >= vcols (vcols % 8 == 0) load as zero
__device__ void load_tile(bf16* dst, int lds, const bf16* src, long ld,
                          int rows, int cols, int vrows, int vcols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool valid = r < vrows && c < vcols;
    cp_async16(dst + r * lds + c, valid ? src + r * ld + c : src, valid);
  }
}

// 8 f32 -> 8 bf16 in one 16-byte store
__device__ __forceinline__ void store8(bf16* dst, const float* src) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(src[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// a BT x D f32 tile staged in shared memory (row stride D + 4) -> global
// bf16 rows (stride D), rows < vrows only
__device__ void write_rows(bf16* dst, const float* src, int D, int vrows) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < BT * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    if (r < vrows) store8(dst + (long)r * D + c, src + r * (D + 4) + c);
  }
}

// the warp's y/dx fragments (row tile r, column tile warp + 8 j) into the
// f32 staging tile (row stride D + 4)
__device__ __forceinline__ void stage_acc(float* st, FragC (&acc)[MAXJ][2],
                                          int nj, int D) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    if (j >= nj) break;
    const int ct = warp + WARPS * j;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      wmma::store_matrix_sync(st + r * 16 * (D + 4) + ct * 16, acc[j][r],
                              D + 4, wmma::mem_row_major);
  }
}

struct FwdSmem {
  size_t x, region, a, g, bytes;
  explicit __host__ __device__ FwdSmem(int D) {
    const size_t w1_half = (size_t)(D / 2) * LDF * 2;
    const size_t w2_panel = (size_t)BF * (D + 8) * 2;
    const size_t y_stage = (size_t)BT * (D + 4) * 4;
    size_t r = w1_half > w2_panel ? w1_half : w2_panel;
    r = r > y_stage ? r : y_stage;
    x = 0;
    region = align128(x + (size_t)BT * (D + 8) * 2);
    a = align128(region + r);
    g = align128(a + (size_t)BT * LDA * 4);
    bytes = align128(g + (size_t)BT * LDF * 2);
  }
};

// y = gelu(x W1) W2 (and a = x W1 where `a_out` is given): one CTA per
// 32-token tile, the d_ff axis a loop of 64-wide panels
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const bf16* __restrict__ w2, bf16* __restrict__ y,
           bf16* __restrict__ a_out, int N, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem L(D);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* rs = reinterpret_cast<bf16*>(smem + L.region);
  float* as = reinterpret_cast<float*>(smem + L.a);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);
  const int warp = threadIdx.x / 32;
  const int t0 = blockIdx.x * BT;
  const int vrows = min(BT, N - t0);
  const int nj = D / 128;
  const int KH = D / 2;  // the W1 panel streams in two K halves
  const int LDX = D + 8, LDW2 = D + 8;
  load_tile(xs, LDX, x + (long)t0 * D, D, BT, D, vrows, D);

  FragC acc[MAXJ][2];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    wmma::fill_fragment(acc[j][0], 0.f);
    wmma::fill_fragment(acc[j][1], 0.f);
  }
  const int mi = warp / 4, ni = warp % 4;  // this warp's tile of a

  for (int f0 = 0; f0 < F; f0 += BF) {
    // a = x W1[:, f0:f0+64], one 16 x 16 fragment a warp, its K steps
    // alternating over two accumulators (two independent mma chains)
    FragC fa[2];
    wmma::fill_fragment(fa[0], 0.f);
    wmma::fill_fragment(fa[1], 0.f);
    for (int h = 0; h < 2; ++h) {
      __syncthreads();  // the region and g of the last step are consumed
      load_tile(rs, LDF, w1 + (long)h * KH * F + f0, F, KH, BF, KH, F - f0);
      cp_async_wait_all();
      __syncthreads();
      for (int kk = 0; kk < KH / 16; kk += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          FragA fx;
          FragB fw;
          wmma::load_matrix_sync(
              fx, xs + mi * 16 * LDX + h * KH + (kk + u) * 16, LDX);
          wmma::load_matrix_sync(fw, rs + (kk + u) * 16 * LDF + ni * 16,
                                 LDF);
          wmma::mma_sync(fa[u], fx, fw, fa[u]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < fa[0].num_elements; ++e) fa[0].x[e] += fa[1].x[e];
    wmma::store_matrix_sync(as + mi * 16 * LDA + ni * 16, fa[0], LDA,
                            wmma::mem_row_major);
    __syncthreads();  // a complete; the W1 half consumed
    // the W2 panel's copies fly while gelu runs
    load_tile(rs, LDW2, w2 + (long)f0 * D, D, BF, D, F - f0, D);
    for (int i = threadIdx.x; i < BT * BF; i += THREADS) {
      const int r = i / BF, c = i % BF;
      const float av = as[r * LDA + c];
      gs[r * LDF + c] = __float2bfloat16(gelu(av));
      if (a_out != nullptr && r < vrows && f0 + c < F)
        a_out[(long)(t0 + r) * F + f0 + c] = __float2bfloat16(av);
    }
    cp_async_wait_all();
    __syncthreads();
    // y += g W2[f0:f0+64, :] into this warp's fragments
#pragma unroll
    for (int kk = 0; kk < BF / 16; ++kk) {
      FragA g0, g1;
      wmma::load_matrix_sync(g0, gs + kk * 16, LDF);
      wmma::load_matrix_sync(g1, gs + 16 * LDF + kk * 16, LDF);
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j >= nj) break;
        FragB fw;
        wmma::load_matrix_sync(fw, rs + kk * 16 * LDW2 + (warp + WARPS * j) *
                                        16, LDW2);
        wmma::mma_sync(acc[j][0], g0, fw, acc[j][0]);
        wmma::mma_sync(acc[j][1], g1, fw, acc[j][1]);
      }
    }
  }

  __syncthreads();
  float* st = reinterpret_cast<float*>(rs);
  stage_acc(st, acc, nj, D);
  __syncthreads();
  write_rows(y + (long)t0 * D, st, D, vrows);
}

struct DxSmem {
  size_t w1p, xc, dyc, w2c, a, dh, da, bytes;
  explicit __host__ __device__ DxSmem(int D) {
    const size_t panel = (size_t)D * LDF * 2;
    const size_t stage = (size_t)BT * (D + 4) * 4;
    w1p = 0;
    xc = align128(panel > stage ? panel : stage);
    dyc = align128(xc + (size_t)BT * (KCH + 8) * 2);
    w2c = align128(dyc + (size_t)BT * (KCH + 8) * 2);
    a = align128(w2c + (size_t)BF * (KCH + 8) * 2);
    dh = align128(a + (size_t)BT * LDA * 4);
    da = align128(dh + (size_t)BT * LDA * 4);
    bytes = align128(da + (size_t)BT * LDF * 2);
  }
};

// dx (and g, da for the dW kernel): the forward's walk with a = x W1f,
// dh = dy W2fᵀ, da = dh gelu'(a), dx += da W1fᵀ
__global__ void __launch_bounds__(THREADS, 1)
dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
          const bf16* __restrict__ w2, const bf16* __restrict__ dy,
          bf16* __restrict__ dx, bf16* __restrict__ g_out,
          bf16* __restrict__ da_out, int N, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DxSmem L(D);
  bf16* w1p = reinterpret_cast<bf16*>(smem + L.w1p);
  bf16* xc = reinterpret_cast<bf16*>(smem + L.xc);
  bf16* dyc = reinterpret_cast<bf16*>(smem + L.dyc);
  bf16* w2c = reinterpret_cast<bf16*>(smem + L.w2c);
  float* as = reinterpret_cast<float*>(smem + L.a);
  float* dhs = reinterpret_cast<float*>(smem + L.dh);
  bf16* das = reinterpret_cast<bf16*>(smem + L.da);
  constexpr int LDC = KCH + 8;
  const int warp = threadIdx.x / 32;
  const int t0 = blockIdx.x * BT;
  const int vrows = min(BT, N - t0);
  const int nj = D / 128;

  FragC acc[MAXJ][2];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    wmma::fill_fragment(acc[j][0], 0.f);
    wmma::fill_fragment(acc[j][1], 0.f);
  }
  const int mi = warp / 4, ni = warp % 4;

  for (int f0 = 0; f0 < F; f0 += BF) {
    const int vcols = F - f0;
    FragC fa, fd;
    wmma::fill_fragment(fa, 0.f);
    wmma::fill_fragment(fd, 0.f);
    for (int k0 = 0; k0 < D; k0 += KCH) {
      __syncthreads();  // the last chunk (and panel) consumed
      load_tile(xc, LDC, x + (long)t0 * D + k0, D, BT, KCH, vrows, KCH);
      load_tile(dyc, LDC, dy + (long)t0 * D + k0, D, BT, KCH, vrows, KCH);
      load_tile(w2c, LDC, w2 + (long)f0 * D + k0, D, BF, KCH, vcols, KCH);
      load_tile(w1p + k0 * LDF, LDF, w1 + (long)k0 * F + f0, F, KCH, BF,
                KCH, vcols);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KCH / 16; ++kk) {
        FragA fx;
        FragB fw;
        wmma::load_matrix_sync(fx, xc + mi * 16 * LDC + kk * 16, LDC);
        wmma::load_matrix_sync(fw, w1p + (k0 + kk * 16) * LDF + ni * 16,
                               LDF);
        wmma::mma_sync(fa, fx, fw, fa);
        FragBc fv;  // W2fᵀ: element (k, f) = W2[f0 + f, k0 + k]
        wmma::load_matrix_sync(fx, dyc + mi * 16 * LDC + kk * 16, LDC);
        wmma::load_matrix_sync(fv, w2c + ni * 16 * LDC + kk * 16, LDC);
        wmma::mma_sync(fd, fx, fv, fd);
      }
    }
    wmma::store_matrix_sync(as + mi * 16 * LDA + ni * 16, fa, LDA,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dhs + mi * 16 * LDA + ni * 16, fd, LDA,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BF; i += THREADS) {
      const int r = i / BF, c = i % BF;
      const float av = as[r * LDA + c];
      const bf16 d = __float2bfloat16(dhs[r * LDA + c] * dgelu(av));
      das[r * LDF + c] = d;
      if (r < vrows && c < vcols) {
        const long o = (long)(t0 + r) * F + f0 + c;
        g_out[o] = __float2bfloat16(gelu(av));
        da_out[o] = d;
      }
    }
    __syncthreads();
    // dx += da W1fᵀ: element (f, d) of W1fᵀ = w1p[d * LDF + f]
#pragma unroll
    for (int kk = 0; kk < BF / 16; ++kk) {
      FragA d0, d1;
      wmma::load_matrix_sync(d0, das + kk * 16, LDF);
      wmma::load_matrix_sync(d1, das + 16 * LDF + kk * 16, LDF);
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j >= nj) break;
        FragBc fw;
        wmma::load_matrix_sync(fw, w1p + (warp + WARPS * j) * 16 * LDF +
                                       kk * 16, LDF);
        wmma::mma_sync(acc[j][0], d0, fw, acc[j][0]);
        wmma::mma_sync(acc[j][1], d1, fw, acc[j][1]);
      }
    }
  }

  __syncthreads();
  float* st = reinterpret_cast<float*>(w1p);
  stage_acc(st, acc, nj, D);
  __syncthreads();
  write_rows(dx + (long)t0 * D, st, D, vrows);
}

constexpr size_t DW_SMEM = 2 * TK * LDG * 2 + WARPS * 256 * 4;

// C (M x P) f32 = Aᵀ B over the token axis, A (K x M), B (K x P) bf16
// row-major: blocks [0, n0) form dW1 = xᵀ da (M D, P F), the rest
// dW2 = gᵀ dy (M F, P D); one CTA per 128 x 128 tile of C; two CTAs an
// SM (at most 128 registers a thread), so one's loads overlap the
// other's products
__global__ void __launch_bounds__(THREADS, 2)
dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
          const bf16* __restrict__ da, const bf16* __restrict__ dy,
          float* __restrict__ dw1, float* __restrict__ dw2, int K, int D,
          int F) {
  __shared__ __align__(128) unsigned char smem[DW_SMEM];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + TK * LDG;
  float* edge = reinterpret_cast<float*>(bs + TK * LDG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dt = D / TM, ft = (F + TM - 1) / TM;  // tiles along D, F
  int t = blockIdx.x;
  const bool first = t < dt * ft;
  if (!first) t -= dt * ft;
  const bf16* A = first ? x : g;
  const bf16* B = first ? da : dy;
  float* C = first ? dw1 : dw2;
  const int M = first ? D : F, P = first ? F : D;
  const int pt = first ? ft : dt;
  const int m0 = (t / pt) * TM, p0 = (t % pt) * TP;
  const int wm = (warp / 4) * 64, wp = (warp % 4) * 32;  // warp's 64 x 32

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
  for (int k0 = 0; k0 < K; k0 += TK) {
    __syncthreads();
    load_tile(as, LDG, A + (long)k0 * M + m0, M, TK, TM, K - k0, M - m0);
    load_tile(bs, LDG, B + (long)k0 * P + p0, P, TK, TP, K - k0, P - p0);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      FragB fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * 16 * LDG + wp + j * 16, LDG);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragAc fa;  // Aᵀ: element (m, k) = A[k0 + k, m0 + m]
        wmma::load_matrix_sync(fa, as + kk * 16 * LDG + wm + i * 16, LDG);
        wmma::mma_sync(acc[i][0], fa, fb[0], acc[i][0]);
        wmma::mma_sync(acc[i][1], fa, fb[1], acc[i][1]);
      }
    }
  }
  // whole fragments straight to C; the ragged edge through this warp's
  // 16 x 16 staging tile
  float* e = edge + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm + i * 16, p = p0 + wp + j * 16;
      if (m + 16 <= M && p + 16 <= P) {
        wmma::store_matrix_sync(C + (long)m * P + p, acc[i][j], P,
                                wmma::mem_row_major);
      } else if (m < M && p < P) {
        wmma::store_matrix_sync(e, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int q = lane; q < 256; q += 32) {
          const int r = q / 16, c = q % 16;
          if (m + r < M && p + c < P) C[(long)(m + r) * P + p + c] = e[q];
        }
        __syncwarp();
      }
    }
  }
}

bool width_ok(int N, int D, int F) {
  return N >= 1 && D % 128 == 0 && D >= 128 && D <= MAX_D && F >= 8 &&
         F % 8 == 0;
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or -1
// for widths outside the contract above (the wrapper checks them first).

int fused_mlp_fwd(const void* x, const void* w1, const void* w2, void* y,
                  void* a, int N, int D, int F, void* stream) {
  if (!width_ok(N, D, F)) return -1;
  const size_t bytes = FwdSmem(D).bytes;
  cudaError_t err = prepare(fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<(N + BT - 1) / BT, THREADS, bytes,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(y),
      static_cast<bf16*>(a), N, D, F);
  return (int)cudaGetLastError();
}

int fused_mlp_bwd_dx(const void* x, const void* w1, const void* w2,
                     const void* dy, void* dx, void* g, void* da, int N,
                     int D, int F, void* stream) {
  if (!width_ok(N, D, F)) return -1;
  const size_t bytes = DxSmem(D).bytes;
  cudaError_t err = prepare(dx_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dx_kernel<<<(N + BT - 1) / BT, THREADS, bytes,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<bf16*>(g), static_cast<bf16*>(da),
      N, D, F);
  return (int)cudaGetLastError();
}

int fused_mlp_bwd_dw(const void* x, const void* g, const void* da,
                     const void* dy, void* dw1, void* dw2, int N, int D,
                     int F, void* stream) {
  if (!width_ok(N, D, F)) return -1;
  const int tiles = 2 * (D / TM) * ((F + TM - 1) / TM);
  dw_kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(da), static_cast<const bf16*>(dy),
      static_cast<float*>(dw1), static_cast<float*>(dw2), N, D, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
