// The split decode shared by the linear-cache kernel (flash_decode.cu,
// kernel 5) and the paged one (paged_decode.cu, kernel 6), and the paged
// helpers and lse merge that the exact-softmax kernel 7
// (paged_attention.cu) shares with kernel 6, for Hopper
// (sm_90a): flash-decoding, the live rows of each (sequence, kv head)
// split into chunks of rows, a CTA a chunk, the chunks' partial softmaxes
// merged by lse.
//
// Pass 1 (split_chunk, called by each kernel's chunk kernel): thread (rg,
// cg) owns the 16-byte column slice cg of the head and rows rg + RG j of
// each step of RB rows. It issues all R of its K loads and then all R V
// loads (with their scales) before it reads any, so a CTA has its whole
// step (up to 32 KB) in flight; scores reduce over the slice's lanes by
// shuffles, and each thread keeps its own online softmax state (m, l, acc)
// over its rows (JAX's flash_decode.py::_softmax_block: for one-byte
// caches the per-row dequant scales fold into the score, (q.k8) * scale *
// kscale, and into the probability, p * vscale; mask -1e30; out = acc /
// max(l, 1e-30)). At the end the states merge by lse, first across the row
// groups of a warp (shuffles), then across the four warps (shared memory,
// in warp order). A chunk that holds every live row of its sequence
// writes acc / max(l, 1e-30) to out; otherwise its unnormalised (g x D)
// accumulator and (m, l) of its g query rows go to the f32 workspace
// (B*H, n_chunks, D) then (B*H, n_chunks, 2).
//
// The two caches differ only in where row r of a chunk lives: Rows, a
// functor, maps r to a row index ri so that the row's D values start at
// k + ri * D (and v + ri * D), and its dequant scales sit at ks[ri] and
// vs[ri] (LinearRows: the cache row of the sequence; flash_decode.cu;
// PagedRows: through the page table, below).
//
// Pass 2 (merge_chunks): one CTA of D threads per query row b * H + h:
// m* = max m_i, l = sum l_i e^(m_i - m*), out = sum acc_i e^(m_i - m*) /
// max(l, 1e-30), over the live chunks in index order (each weight taken
// once into shared memory, the sums unrolled so that several chunks' loads
// are in flight). Launched as a programmatic dependent of pass 1
// (griddepcontrol), so its launch overlaps pass 1's tail.
//
// No atomics, and every sum runs in a fixed order: two calls give equal
// bits, and a sequence's bits depend only on its q, its rows, its pos and
// the chunk length. No tensor cores: g <= 8 query rows is far below
// wgmma's 64.

#pragma once

#include "decode_common.cuh"

namespace hpc_decode {

// The lanes of pass 1 for a cache type, head_dim and query-row bound G:
// N values a 16-byte load, CG threads across a row, RG rows side by side,
// R rows a thread a step (all loads of a step issued before any is read:
// up to 64 rows a step, fewer as G grows, since each row keeps G scores
// in registers beside the (G, N) accumulator), RB rows a step.
template <typename TK, int D, int G>
struct Lanes {
  static constexpr int N = Vec<TK>::N;
  static constexpr int CG = D / N;
  static constexpr int RG = THREADS / CG;
  static constexpr int R_ROWS = RG >= 64 ? 1 : 64 / RG;
  static constexpr int R_REGS = 16 / G;
  static constexpr int R = R_ROWS < R_REGS ? R_ROWS : R_REGS > 0 ? R_REGS : 1;
  static constexpr int RB = RG * R;
  static_assert(D % N == 0 && CG <= 32 && (32 % CG) == 0, "head_dim");
};

// Fold the state (mo, lo, ao) into (m, l, a): both sums rescaled to the
// larger max. A state that saw no row has m = -1e30, l = 0, a = 0.
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&a)[N],
                                            float mo, float lo,
                                            const float (&ao)[N]) {
  const float mn = fmaxf(m, mo);
  const float x = expf(m - mn), y = expf(mo - mn);
  l = l * x + lo * y;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * x + ao[e] * y;
  m = mn;
}

// Pass 1 over rows [lo, hi) (hi <= pos + 1) of one (sequence, kv head):
// q0 the element offset of its first query row in q (B, H, D), bh0 = b * H
// + hk * g that row's index, c the chunk. G >= g is the compile-time bound
// on the query rows (the registers of acc); rows gi >= g are never stored.
// `one`: the chunk holds every live row, and its normalised rows go to out.
template <typename TK, int D, int G, class Rows>
__device__ __forceinline__ void split_chunk(
    const void* __restrict__ q, int q_bf16, const Rows& rows, int lo, int hi,
    long q0, long bh0, int g, int c, bool one, float* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int n_chunks,
    float scale) {
  using L = Lanes<TK, D, G>;
  constexpr int N = L::N, CG = L::CG, RG = L::RG, R = L::R;
  __shared__ __align__(16) float qs[G * D];
  __shared__ __align__(16) float red[WARPS][G][D];
  __shared__ float red_m[WARPS][G], red_l[WARPS][G];

  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < g * D; i += THREADS)
    qs[i] = q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[q0 + i])
                   : static_cast<const float*>(q)[q0 + i];
  __syncthreads();
  const TK* kc = rows.k + cg * N;
  const TK* vc = rows.v + cg * N;

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[gi][e] = 0.f;
  }

  for (int base = lo; base < hi; base += L::RB) {
    // every load of the step in flight before any is read; rows past hi
    // load nothing and stay 0 (so 0 * value is never 0 * garbage)
    uint4 kraw[R], vraw[R];
    float ksc[R], vsc[R];
    long ri[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = base + rg + j * RG;
      kraw[j] = make_uint4(0u, 0u, 0u, 0u);
      ksc[j] = 1.f;
      ri[j] = 0;
      if (r < hi) {
        ri[j] = rows.index(r);
        kraw[j] = __ldg(reinterpret_cast<const uint4*>(kc + ri[j] * D));
        if (rows.ks) ksc[j] = __ldg(rows.ks + ri[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = base + rg + j * RG;
      vraw[j] = make_uint4(0u, 0u, 0u, 0u);
      vsc[j] = 1.f;
      if (r < hi) {
        vraw[j] = __ldg(reinterpret_cast<const uint4*>(vc + ri[j] * D));
        if (rows.vs) vsc[j] = __ldg(rows.vs + ri[j]);
      }
    }
    // scores of the thread's rows (every lane runs every shuffle: the
    // lanes of a row share its liveness)
    float s[R][G];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = base + rg + j * RG < hi;
      float kv[N];
      Vec<TK>::cvt(kraw[j], kv);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
        if (gi < g) {
          const float4* qv =
              reinterpret_cast<const float4*>(qs + gi * D + cg * N);
#pragma unroll
          for (int e4 = 0; e4 < N / 4; ++e4) {
            const float4 x = qv[e4];
            d = fmaf(x.x, kv[4 * e4], d);
            d = fmaf(x.y, kv[4 * e4 + 1], d);
            d = fmaf(x.z, kv[4 * e4 + 2], d);
            d = fmaf(x.w, kv[4 * e4 + 3], d);
          }
        }
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[j][gi] = live ? d * scale * ksc[j] : NEG_INF;
      }
    }
    // the thread's online softmax over its rows of the step
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int j = 0; j < R; ++j) mx = fmaxf(mx, s[j][gi]);
      const float alpha = expf(m[gi] - mx);
      m[gi] = mx;
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[gi][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = base + rg + j * RG < hi;
      float vv[N];
      Vec<TK>::cvt(vraw[j], vv);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = live ? expf(s[j][gi] - m[gi]) : 0.f;
        l[gi] += p;
        const float pv = p * vsc[j];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[gi][e] = fmaf(pv, vv[e], acc[gi][e]);
      }
    }
  }

  // merge the row groups of each warp (lanes CG apart share a slice)
#pragma unroll
  for (int off = CG; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float ao[N];
#pragma unroll
      for (int e = 0; e < N; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], off);
      merge_state<N>(m[gi], l[gi], acc[gi], mo, lo_, ao);
    }
  }
  // then the warps, in order, through shared memory
  if (lane < CG) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int e = 0; e < N; ++e) red[warp][gi][cg * N + e] = acc[gi][e];
        if (lane == 0) {
          red_m[warp][gi] = m[gi];
          red_l[warp][gi] = l[gi];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w][gi]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = expf(red_m[w][gi] - mx);
      ls += red_l[w][gi] * x;
      a += red[w][gi][d] * x;
    }
    const long bh = bh0 + gi;
    if (one) {
      out[bh * D + d] = a / fmaxf(ls, 1e-30f);
      continue;
    }
    part_acc[(bh * n_chunks + c) * D + d] = a;
    if (d == 0) {
      part_ml[(bh * n_chunks + c) * 2] = mx;
      part_ml[(bh * n_chunks + c) * 2 + 1] = ls;
    }
  }
}

// Pass 2 for query row bh over its `live` first chunks of the n_chunks the
// workspace holds a row. A CTA of D threads; dynamic shared memory of
// n_chunks floats.
__device__ __forceinline__ void merge_chunks(const float* __restrict__ part_acc,
                                             const float* __restrict__ part_ml,
                                             long bh, int n_chunks, int live,
                                             int D, float* __restrict__ out) {
  extern __shared__ float wts[];  // (n_chunks,)
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * n_chunks * 2;
  float mx = NEG_INF;
#pragma unroll 8
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, ml[2 * i]);
  for (int i = d; i < live; i += blockDim.x) wts[i] = expf(ml[2 * i] - mx);
  __syncthreads();
  const float* acc = part_acc + bh * n_chunks * D + d;
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int i = 0; i < live; ++i) {
    l += ml[2 * i + 1] * wts[i];
    a += acc[(long)i * D] * wts[i];
  }
  out[bh * D + d] = a / fmaxf(l, 1e-30f);
}

// Launch pass 2 (grid B * H, D threads) as a programmatic dependent of the
// pass 1 just launched on `stream`.
template <typename... Exp, typename... Act>
cudaError_t launch_merge(void (*kernel)(Exp...), int rows, int D,
                         int n_chunks, cudaStream_t stream, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = sizeof(float) * n_chunks;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// --- The paged cache: what kernel 6 (paged_decode.cu) and kernel 7
// (paged_attention.cu) share. Both split a sequence's rows into chunks of a
// length fixed by the page size alone, a pass-1 CTA each; the host plans
// n_chunks from the table width (pages * P) and never reads pos.

// the longest chunk a paged CTA takes (the wrappers' plans stay within
// it): it bounds the pages a chunk touches, chunk / P + 2 with ragged pages
constexpr int PAGED_CHUNK_MAX = 256;

// Row r of sequence b, kv head hk through the table: the row index
// (pool row * Hkv + hk) * P + r % P, from the chunk's page bases that
// stage_pages put in shared memory (page - first). P a power of two takes
// a shift (p_shift >= 0), any other P a division.
template <typename TK>
struct PagedRows {
  const TK* k;
  const TK* v;
  const float* ks;
  const float* vs;
  const long* page_base;  // shared: (pid * Hkv + hk) * P for pages first..
  int first, P, p_shift;
  __device__ __forceinline__ long index(int r) const {
    const int page = p_shift >= 0 ? r >> p_shift : r / P;
    const int in = r - page * P;
    return page_base[page - first] + in;
  }
};

// log2(P) for a power of two, else -1 (PagedRows divides)
inline int page_shift(int P) {
  for (int s = 0; s < 31; ++s)
    if ((1 << s) == P) return s;
  return -1;
}

// pos[b] (or the shared pos) clamped into the table's `rows` rows, as the
// Pallas kernels' index maps clamp; every reader of pos clamps alike, so
// the passes agree on which chunks a sequence has
__device__ __forceinline__ int live_pos(const int* pos_vec, int pos_scalar,
                                        int b, int rows) {
  const int pos = pos_vec ? pos_vec[b] : pos_scalar;
  return min(max(pos, 0), rows - 1);
}

// The page bases of rows [lo, hi) of sequence b, kv head hk into
// page_base (shared, PAGED_CHUNK_MAX + 2 entries), each table entry
// clamped into the pool; ends with a block barrier.
template <typename TK>
__device__ __forceinline__ PagedRows<TK> stage_pages(
    long* page_base, const TK* k_pool, const TK* v_pool,
    const float* ks_pool, const float* vs_pool, const int* table, int b,
    int hk, int lo, int hi, int Hkv, int P, int p_shift, int pages,
    int n_pool) {
  const int first = lo / P, last = (hi - 1) / P;
  for (int j = first + (int)threadIdx.x; j <= last; j += blockDim.x) {
    int pid = table[(long)b * pages + j];
    pid = min(max(pid, 0), n_pool - 1);
    page_base[j - first] = ((long)pid * Hkv + hk) * P;
  }
  __syncthreads();
  return PagedRows<TK>{k_pool, v_pool, ks_pool, vs_pool, page_base, first,
                       P, p_shift};
}

// Pass 2 of a paged kernel: one CTA of D threads per query row b * H + h,
// over chunks 0 .. pos[b] / chunk; nothing when chunk 0 held them all.
__global__ void paged_merge_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ pos_vec,
                                   int pos_scalar, int rows, int n_chunks,
                                   int chunk, int H, int D,
                                   float* __restrict__ out) {
  const long bh = blockIdx.x;
  const int live = live_pos(pos_vec, pos_scalar, (int)(bh / H), rows) / chunk
                   + 1;
  // pass 1's writes are complete and visible past this point; every CTA
  // waits, so this grid never ends before pass 1 does
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (live == 1) return;  // pass 1 normalised these rows in place
  merge_chunks(part_acc, part_ml, bh, n_chunks, live, D, out);
}

}  // namespace hpc_decode
