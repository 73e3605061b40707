// Causal flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
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
// key) output 0 and lse = m + log(max(l, 1e-30)) ~ -1e30, as the Pallas
// kernel's epilogue. The lse output (f32, (B*H, Tq): the backward's
// residual) is written only when its pointer is not null — the serving
// path's launch passes null and offsets 0.
//
// Layout: q, o (B, Tq, H, D); k, v (B, Tk, Hkv, D) — the JAX layout, so
// the wrapper needs no transpose.
//
// Design: one CTA (4 warps) per (q tile of 64 rows, b*H + h). The TPU's
// sequential kv grid axis becomes a loop inside the block that stops at
// the causal diagonal (the clamped index map + pl.when(visible) of the
// Pallas kernel). K/V tiles are staged in shared memory with 16-byte
// loads into padded rows (no bank conflicts across a fragment's 16 rows);
// both products run on the tensor cores through WMMA 16x16x16 bf16
// fragments. Each warp owns 16 query rows end to end (scores,
// softmax, rescale, p.v), so the only block-wide barriers are around the
// K/V tile loads.
//
// What bounds it on the H100: at the serving shapes (T <= 1024, D = 128)
// the work is small — T=512, H=8 is ~4 MiB of q/k/v/o (1.3 us at
// 3.35 TB/s) and ~0.54 GFLOP causal (0.5 us at 989 TF/s) — so the kernel
// is bound by latency and occupancy, not by either roofline: 64 CTAs on
// 132 SMs, no load/compute overlap (single-buffered tiles), and WMMA
// rather than wgmma. At the training shape (B 8, T 2048, H 8, D 128,
// causal: 2048 CTAs, 6.9e10 FLOP, 0.069 ms at 989 TF/s) it is bound by
// the per-tile work of its 4 warps: the shared-memory accumulator round
// trip of p.v and the row-serial online softmax. Double buffering with
// cp.async/TMA, register accumulators and wgmma are the later steps;
// this version is the simple correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = 4;      // each warp owns BQ / WARPS = 16 rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

constexpr int LDS = BK + 4;  // f32 score rows (padded)
constexpr int LDP = BK + 8;  // bf16 probability rows (padded)

template <int D>
struct Smem {
  // rows are padded (bf16 D + 8, f32 D + 4) so that the 16 rows a
  // fragment load touches fall in different banks
  static constexpr int LD = D + 8;
  static constexpr int LDO = D + 4;
  // byte offsets into the dynamic shared buffer; every region 128-aligned
  static constexpr size_t q = 0;
  static constexpr size_t k = q + BQ * LD * 2;
  static constexpr size_t v = k + BK * LD * 2;
  static constexpr size_t s = v + BK * LD * 2;
  static constexpr size_t p = s + BQ * LDS * 4;
  static constexpr size_t o = p + BQ * LDP * 2;
  static constexpr size_t m = o + BQ * LDO * 4;
  static constexpr size_t l = m + BQ * 4;
  static constexpr size_t bytes = l + BQ * 4;
};

// copy `rows` rows of D bf16 (row stride `stride` elements) into smem
// rows of Smem<D>::LD elements, 16 bytes per thread per step
template <int D>
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                          long stride, int rows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    int r = i / CHUNKS, c = i % CHUNKS;
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LD + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int H, int Hkv,
                     float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Smem<D>;
  constexpr int LD = S::LD, LDO = S::LDO;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + S::p);
  float* os = reinterpret_cast<float*>(smem + S::o);
  float* ms = reinterpret_cast<float*>(smem + S::m);
  float* ls = reinterpret_cast<float*>(smem + S::l);

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first row inside the tile
  const int q0 = qt * BQ;      // first query row of this tile
  const int qg0 = q_off + q0;  // its global position

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  load_tile<D>(qs, q + ((long)b * Tq + q0) * q_stride + (long)h * D,
               q_stride, BQ);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) os[i] = 0.f;
  if (threadIdx.x < BQ) {
    ms[threadIdx.x] = NEG_INF;
    ls[threadIdx.x] = 0.f;
  }

  // causal: tiles wholly in this tile's future contribute nothing and are
  // not read (the Pallas kernel's clamped index map + pl.when(visible));
  // a fully-future block walks no tile at all
  int n_kt = Tk / BK;
  if (causal) {
    const int last = qg0 + BQ - 1 - k_off;  // newest key offset visible
    n_kt = last < 0 ? 0 : min(last / BK + 1, n_kt);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    const long kv_off = ((long)b * Tk + k0) * kv_stride + (long)hk * D;
    load_tile<D>(ks, k + kv_off, kv_stride, BK);
    load_tile<D>(vs, v + kv_off, kv_stride, BK);
    __syncthreads();

    // S[row0:row0+16, :] = Q K^T (f32 accumulate)
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + row0 * LD + kk * 16, LD);
        wmma::load_matrix_sync(bt, ks + n * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + row0 * LDS + n * 16, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; lane covers 2 columns
    for (int r = row0; r < row0 + 16; ++r) {
      const int qpos = qg0 + r;
      float s2[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        float s = ss[r * LDS + c] * scale;
        if (causal && k_off + k0 + c > qpos) s = NEG_INF;
        s2[j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = expf(s2[j] - m_new);
        sum += p;
        ps[r * LDP + lane + 32 * j] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float rescale = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) os[r * LDO + d] *= rescale;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * rescale + sum;
      }
    }
    __syncwarp();

    // O[row0:row0+16, :] += P V (accumulator round-trips through smem)
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + row0 * LDO + n * 16, LDO,
                             wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + row0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(bv, vs + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + row0 * LDO + n * 16, acc, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: out = acc / max(l, 1e-30); rows that saw nothing -> 0;
  // lse = m + log(max(l, 1e-30)) when asked for
  __syncthreads();  // m, l of a row with no tile walked come from init
  for (int r = row0; r < row0 + 16; ++r) {
    const float m = ms[r];
    const float lc = fmaxf(ls[r], 1e-30f);
    const float inv = 1.f / lc;
    if (lse != nullptr && lane == 0)
      lse[(long)bh * Tq + q0 + r] = m + logf(lc);
    __nv_bfloat16* dst =
        o + ((long)b * Tq + q0 + r) * q_stride + (long)h * D;
    for (int d = lane; d < D; d += 32) {
      const float val = (m <= NEG_INF * 0.5f) ? 0.f : os[r * LDO + d] * inv;
      dst[d] = __float2bfloat16(val);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int Tk, int H, int Hkv, float scale, int causal,
           int q_off, int k_off, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tq / BQ, B * H);
  flash_prefill_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Tq, Tk, H,
      Hkv, scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int Tq, int Tk, int H, int Hkv, int D,
             float scale, int causal, int q_off, int k_off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale, causal,
                        q_off, k_off, s);
    case 32:
      return launch<32>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale, causal,
                        q_off, k_off, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale, causal,
                        q_off, k_off, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Tq, Tk, H, Hkv, scale, causal,
                         q_off, k_off, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// head_dim this build does not take. Tq and Tk must be multiples of 64 (BQ
// and BK; the Python wrapper checks it as ops/flash_attention.py::BLOCK).
// Global offsets; lse (B*H, Tq) f32 is written when not null (the serving
// path passes null, self-attention and offsets 0).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int B, int Tq, int Tk, int H,
                        int Hkv, int D, float scale, int causal, int q_off,
                        int k_off, void* stream) {
  return dispatch(q, k, v, o, lse, B, Tq, Tk, H, Hkv, D, scale, causal,
                  q_off, k_off, stream);
}

}  // extern "C"
