// Device-initiated ring collectives over logical ranks on one card, for
// Hopper (sm_90a).
//
// Replaces the three remote-DMA kernels of hpc_patterns_tpu/comm/fused.py:
//   - fused_allreduce / allreduce_into (the kernel at fused.py:424, called
//     at :501): two-phase ring, reduce-scatter then forward-before-write
//     all-gather, sum, optional bias plus a named epilogue;
//   - allgather_matmul (fused.py:570, called at :595): ring all-gather in
//     which each arriving shard is forwarded, then multiplied by the local
//     weight panel, f32 accumulation;
//   - fused_permute (fused.py:335, called at :342): rank s copies its shard
//     into rank d's output for every (s, d).
//
// Ranks are logical: a (total, ...) tensor whose row f is flat rank f's
// buffer. Every rank runs inside the same kernel as a group of G CTAs. A hop
// is a store into the right neighbour's dedicated receive slot in global
// memory followed by a flag the neighbour acquires:
//   sender:   all threads store (st.global.cg), __syncthreads(), then one
//             thread: __threadfence(); st.release.gpu (or red.release.gpu
//             .add for a counter several CTAs feed);
//   receiver: one thread spins on ld.acquire.gpu, then __syncthreads();
//             the slot is read with ld.global.cg (L2, never a stale L1).
// Receive slots are dedicated per (phase, step): no slot is written twice
// in a launch, so the race of fused.py:466-470 (a gather-phase write
// landing in a reduce-scatter slot the neighbour has not read) cannot
// happen. Flags compare against an epoch, the launch count of the scratch
// they live in, so no memset is needed between launches.
//
// Deadlock safety: a CTA spinning on a flag whose writer was never
// scheduled would hang the card, so every kernel launches cooperatively
// (cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident,
// and the wrapper sizes G from the occupancy query), and every spin is
// bounded on %globaltimer. A spin that runs out sets the launch's abort
// word (every other spin then gives up too) and writes an error code into
// a word of mapped host memory, which the Python wrapper reads and raises
// on (fused_ring_status).
//
// What bounds them on the H100: the allreduce and the permute move bytes
// (each input read once, each output written once at 3.35 TB/s; the ring's
// own slot traffic is about 2.25x that for the allreduce). The design
// spreads the ring over the 132 SMs by column stripes: chunk columns are
// independent, so CTA (rank, g) runs its own two-phase ring over stripe g
// of every chunk, with one flag per (rank, stripe, phase, step) and no
// grid-wide barrier, and moves 16-byte vectors. allgather_matmul is bound
// by its f32 FMAs (67 TF/s outside the tensor cores); the kernel is a
// plain shared-memory-tiled FFMA product (64x64 output blocks, k tiles of
// 16, 4x4 outputs a thread), no TF32 and no tensor cores, so that an f32
// input keeps its precision class.
//
// Exactness: the allreduce's adds are mine + incoming in the chunk order of
// ring.ring_allreduce_chunked; the bf16 add is __float2bfloat16_rn(float(a)
// + float(b)), which is what PyTorch's bf16 add does, and int32 wraps. So
// the kernel equals the plain version over the same chunk layout bit for
// bit. The matmul differs from a library GEMM only by summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// synchronization
// ---------------------------------------------------------------------------

unsigned int* g_status_host = nullptr;
unsigned int* g_status_dev = nullptr;

struct Sync {
  unsigned int* abort;   // device word: == epoch once a spin of this launch ran out
  unsigned int* status;  // mapped host word: nonzero = error code
  unsigned int epoch;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag == want; false if this launch gave up (the
// timeout ran out here or elsewhere). Every thread of the CTA gets the
// answer; the CTA must return on false.
__device__ bool cta_wait(const unsigned* flag, unsigned want, const Sync& s,
                         unsigned code) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = 1;
    unsigned long long t0 = globaltimer();
    for (unsigned it = 1; ld_acquire(flag) != want; ++it) {
      if ((it & 63u) == 0) {
        if (*(volatile unsigned*)s.abort == s.epoch) { ok = 0; break; }
        if (globaltimer() - t0 > s.timeout_ns) {
          atomicExch(s.abort, s.epoch);
          *(volatile unsigned*)s.status = code;
          __threadfence_system();
          ok = 0;
          break;
        }
      }
      __nanosleep(32);
    }
  }
  __syncthreads();
  const bool r = ok != 0;
  __syncthreads();  // ok is rewritten by the next wait
  return r;
}

// All threads' stores so far become visible before the flag does.
__device__ __forceinline__ void cta_signal(unsigned* flag, unsigned value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, value);
  }
}

__device__ __forceinline__ void cta_count(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    add_release(counter, 1u);
  }
}

// ---------------------------------------------------------------------------
// element types (16-byte vectors)
// ---------------------------------------------------------------------------

struct F32 {
  using T = float;
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T relu(T v) { return v > 0.f ? v : 0.f; }
  static __device__ __forceinline__ float to_f(T v) { return v; }
  static __device__ __forceinline__ T from_f(float v) { return v; }
};

struct I32 {
  using T = int;
  static __device__ __forceinline__ T add(T a, T b) {
    return (int)((unsigned)a + (unsigned)b);  // wraps, as PyTorch's int add
  }
  static __device__ __forceinline__ T relu(T v) { return v > 0 ? v : 0; }
  static __device__ __forceinline__ float to_f(T v) { return (float)v; }
  static __device__ __forceinline__ T from_f(float v) { return (int)v; }
};

struct BF16 {
  using T = unsigned short;  // raw bits
  static __device__ __forceinline__ float to_f(T v) {
    return __uint_as_float(((unsigned)v) << 16);
  }
  static __device__ __forceinline__ T from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return from_f(to_f(a) + to_f(b));
  }
  static __device__ __forceinline__ T relu(T v) { return to_f(v) > 0.f ? v : (T)0; }
};

template <class Op>
union Vec {
  uint4 u;
  typename Op::T e[16 / sizeof(typename Op::T)];
};

enum { EPI_NONE = 0, EPI_RELU = 1 };

// ---------------------------------------------------------------------------
// fused_allreduce
// ---------------------------------------------------------------------------

struct RingArgs {
  const uint4* x;     // (total, m, n_pad) in 16-byte vectors
  const uint4* bias;  // (m, n_pad) or null
  uint4* out;         // (total, m, n_pad)
  uint4* rs;          // (total, size-1, M) reduce-scatter receive slots
  uint4* ag;          // (total, size-1, M) all-gather receive slots
  unsigned* flags;    // (total, G, 2, size-1)
  int size, stride, total, G, epilogue;
  long long m, cnv, n_padv, M;  // M = m * cnv vectors per chunk
};

template <class Op>
__device__ __forceinline__ uint4 vadd(uint4 a, uint4 b) {
  Vec<Op> va, vb;
  va.u = a;
  vb.u = b;
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(typename Op::T)); ++i) va.e[i] = Op::add(va.e[i], vb.e[i]);
  return va.u;
}

template <class Op>
__device__ __forceinline__ uint4 vepi(uint4 v, const uint4* bias, long long bidx, int epi) {
  if (bias) v = vadd<Op>(v, bias[bidx]);
  if (epi == EPI_RELU) {
    Vec<Op> vv;
    vv.u = v;
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(typename Op::T)); ++i) vv.e[i] = Op::relu(vv.e[i]);
    v = vv.u;
  }
  return v;
}

template <class Op>
__global__ void __launch_bounds__(THREADS)
fused_allreduce_kernel(RingArgs a, Sync sync) {
  const int f = blockIdx.x / a.G;  // flat rank
  const int g = blockIdx.x % a.G;  // column stripe
  const int size = a.size;
  const int pos = (f / a.stride) % size;
  const int dst = f + (((pos + 1) % size) - pos) * a.stride;
  const long long per = (a.M + a.G - 1) / a.G;
  const long long e0 = (long long)g * per;
  const long long e1 = e0 + per < a.M ? e0 + per : a.M;
  const long long S = size - 1;

  auto xoff = [&](int rank, int chunk, long long e) {
    long long row = e / a.cnv, col = e % a.cnv;
    return ((long long)rank * a.m + row) * a.n_padv + chunk * a.cnv + col;
  };
  auto boff = [&](int chunk, long long e) {
    long long row = e / a.cnv, col = e % a.cnv;
    return row * a.n_padv + chunk * a.cnv + col;
  };
  auto slot = [&](uint4* base, int rank, int s) { return base + ((long long)rank * S + s) * a.M; };
  auto flag = [&](int rank, int phase, int s) {
    return a.flags + (((long long)rank * a.G + g) * 2 + phase) * S + s;
  };

  // --- phase 1: reduce-scatter. step 0 sends chunk pos-1 raw; step s adds
  // the local chunk pos-1-s to the partial that arrived (mine + incoming)
  {
    const int j = (pos + size - 1) % size;
    uint4* to = slot(a.rs, dst, 0);
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) __stcg(to + e, a.x[xoff(f, j, e)]);
    cta_signal(flag(dst, 0, 0), sync.epoch);
  }
  for (int s = 1; s < size; ++s) {
    if (!cta_wait(flag(f, 0, s - 1), sync.epoch, sync, 1u)) return;
    const int j = (pos + size - 1 - s) % size;
    const uint4* in = slot(a.rs, f, s - 1);
    if (s < size - 1) {
      uint4* to = slot(a.rs, dst, s);
      for (long long e = e0 + threadIdx.x; e < e1; e += THREADS)
        __stcg(to + e, vadd<Op>(a.x[xoff(f, j, e)], __ldcg(in + e)));
      cta_signal(flag(dst, 0, s), sync.epoch);
    } else {
      // chunk pos is fully reduced: it starts the gather ring and lands
      // in the output through the epilogue
      uint4* to = slot(a.ag, dst, 0);
      for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
        uint4 v = vadd<Op>(a.x[xoff(f, j, e)], __ldcg(in + e));
        __stcg(to + e, v);
        a.out[xoff(f, j, e)] = vepi<Op>(v, a.bias, boff(j, e), a.epilogue);
      }
      cta_signal(flag(dst, 1, 0), sync.epoch);
    }
  }
  // --- phase 2: all-gather, each arriving chunk forwarded before it is
  // written out
  for (int s = 1; s < size; ++s) {
    if (!cta_wait(flag(f, 1, s - 1), sync.epoch, sync, 2u)) return;
    const int j = (pos + size - s) % size;
    const uint4* in = slot(a.ag, f, s - 1);
    uint4* to = s < size - 1 ? slot(a.ag, dst, s) : nullptr;
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
      uint4 v = __ldcg(in + e);
      if (to) __stcg(to + e, v);
      a.out[xoff(f, j, e)] = vepi<Op>(v, a.bias, boff(j, e), a.epilogue);
    }
    if (to) cta_signal(flag(dst, 1, s), sync.epoch);
  }
}

// ---------------------------------------------------------------------------
// allgather_matmul
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16;

struct AgmmArgs {
  const void* x;      // (total, m, k)
  const void* w;      // (total, k, n)
  void* out;          // (total, size*m, n)
  void* buf;          // (total, size-1, m*k) receive slots
  unsigned* counters; // (total, size-1): G arrivals per step
  int size, stride, total, G;
  long long m, k, n;
};

__device__ void copy_stripe(const void* src, void* dst, long long bytes, int g, int G) {
  // 16-byte units; the wrapper guarantees bytes % 16 == 0
  const long long n16 = bytes / 16;
  const long long per = (n16 + G - 1) / G;
  const long long e0 = (long long)g * per;
  const long long e1 = e0 + per < n16 ? e0 + per : n16;
  const uint4* s = (const uint4*)src;
  uint4* d = (uint4*)dst;
  for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) __stcg(d + e, __ldcg(s + e));
}

// out block (bm, bn) of a (m, k) @ (k, n) product, f32 accumulation
template <class Op>
__device__ void matmul_block(const typename Op::T* A, const typename Op::T* W,
                             typename Op::T* C, long long m, long long k, long long n,
                             long long bm, long long bn, bool a_from_l2) {
  using T = typename Op::T;
  __shared__ float As[BK][BM + 1];  // +1: the transposed stores spread over banks
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (long long k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      int idx = tid + i * THREADS, r = idx / BK, c = idx % BK;
      long long gr = bm * BM + r, gc = k0 + c;
      float v = 0.f;
      if (gr < m && gc < k) {
        const T* p = A + gr * k + gc;
        v = Op::to_f(a_from_l2 ? __ldcg(p) : *p);
      }
      As[c][r] = v;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      int idx = tid + i * THREADS, r = idx / BN, c = idx % BN;
      long long gr = k0 + r, gc = bn * BN + c;
      Bs[r][c] = (gr < k && gc < n) ? Op::to_f(W[gr * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long gr = bm * BM + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long long gc = bn * BN + tx * 4 + j;
      if (gc < n) C[gr * n + gc] = Op::from_f(acc[i][j]);
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(THREADS)
allgather_matmul_kernel(AgmmArgs a, Sync sync) {
  using T = typename Op::T;
  const int f = blockIdx.x / a.G;
  const int g = blockIdx.x % a.G;
  const int size = a.size;
  const int pos = (f / a.stride) % size;
  const int dst = f + (((pos + 1) % size) - pos) * a.stride;
  const long long S = size - 1;
  const long long shard = a.m * a.k;
  const long long shard_bytes = shard * (long long)sizeof(T);
  const T* x = (const T*)a.x + (long long)f * shard;
  const T* w = (const T*)a.w + (long long)f * a.k * a.n;
  T* out = (T*)a.out + (long long)f * size * a.m * a.n;
  T* buf = (T*)a.buf;
  const long long nbm = (a.m + BM - 1) / BM, nbn = (a.n + BN - 1) / BN;
  const unsigned want = (unsigned)a.G * sync.epoch;  // G arrivals per launch

  auto tile = [&](const T* A, int j, bool from_l2) {
    for (long long b = g; b < nbm * nbn; b += a.G)
      matmul_block<Op>(A, w, out + (long long)j * a.m * a.n, a.m, a.k, a.n, b / nbn, b % nbn,
                       from_l2);
  };

  // step 0: the local shard leaves for the right neighbour, then the local
  // tile computes while it travels
  copy_stripe(x, buf + ((long long)dst * S) * shard, shard_bytes, g, a.G);
  cta_count(a.counters + (long long)dst * S);
  tile(x, pos, false);
  for (int s = 1; s < size; ++s) {
    if (!cta_wait(a.counters + (long long)f * S + s - 1, want, sync, 3u)) return;
    const T* in = buf + ((long long)f * S + s - 1) * shard;
    if (s < size - 1) {
      // forward the arrived shard first; its tile then overlaps the hop
      copy_stripe(in, buf + ((long long)dst * S + s) * shard, shard_bytes, g, a.G);
      cta_count(a.counters + (long long)dst * S + s);
    }
    tile(in, (pos + size - s) % size, true);
  }
}

// ---------------------------------------------------------------------------
// fused_permute
// ---------------------------------------------------------------------------

struct PermArgs {
  const unsigned char* x;  // (total, row_bytes)
  unsigned char* out;      // (total, row_bytes)
  const int* dst;          // (total,) flat destination of each rank
  unsigned* counters;      // (total,)
  int G;
  long long row_bytes;
};

__global__ void __launch_bounds__(THREADS) fused_permute_kernel(PermArgs a, Sync sync) {
  const int f = blockIdx.x / a.G;
  const int g = blockIdx.x % a.G;
  const int d = a.dst[f];
  const unsigned char* src = a.x + (long long)f * a.row_bytes;
  unsigned char* to = a.out + (long long)d * a.row_bytes;
  if (a.row_bytes % 16 == 0) {
    const long long n16 = a.row_bytes / 16;
    const long long per = (n16 + a.G - 1) / a.G;
    const long long e0 = (long long)g * per, e1 = e0 + per < n16 ? e0 + per : n16;
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS)
      ((uint4*)to)[e] = ((const uint4*)src)[e];
  } else {
    const long long per = (a.row_bytes + a.G - 1) / a.G;
    const long long e0 = (long long)g * per;
    const long long e1 = e0 + per < a.row_bytes ? e0 + per : a.row_bytes;
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) to[e] = src[e];
  }
  cta_count(a.counters + d);
  // every rank waits on its one incoming copy before the kernel ends
  if (g == 0) cta_wait(a.counters + f, (unsigned)a.G * sync.epoch, sync, 4u);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

enum { DT_F32 = 0, DT_BF16 = 1, DT_I32 = 2 };
enum { K_ALLREDUCE = 0, K_AGMM = 1, K_PERMUTE = 2 };

const void* kernel_for(int which, int dtype) {
  if (which == K_ALLREDUCE) {
    if (dtype == DT_F32) return (const void*)fused_allreduce_kernel<F32>;
    if (dtype == DT_BF16) return (const void*)fused_allreduce_kernel<BF16>;
    if (dtype == DT_I32) return (const void*)fused_allreduce_kernel<I32>;
  } else if (which == K_AGMM) {
    if (dtype == DT_F32) return (const void*)allgather_matmul_kernel<F32>;
    if (dtype == DT_BF16) return (const void*)allgather_matmul_kernel<BF16>;
    if (dtype == DT_I32) return (const void*)allgather_matmul_kernel<I32>;
  } else if (which == K_PERMUTE) {
    return (const void*)fused_permute_kernel;
  }
  return nullptr;
}

Sync make_sync(void* abort_word, unsigned epoch, long long timeout_ns) {
  Sync s;
  s.abort = (unsigned*)abort_word;
  s.status = g_status_dev;
  s.epoch = epoch;
  s.timeout_ns = (unsigned long long)timeout_ns;
  return s;
}

int launch(int which, int dtype, int blocks, void* args, Sync* sync, void* stream) {
  const void* fn = kernel_for(which, dtype);
  if (!fn || !g_status_dev) return (int)cudaErrorInvalidValue;
  void* params[] = {args, sync};
  cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), params, 0,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Allocates the mapped host status word once per process (idempotent).
extern "C" int fused_ring_init() {
  if (g_status_host) return 0;
  cudaError_t e = cudaHostAlloc((void**)&g_status_host, sizeof(unsigned),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  *g_status_host = 0;
  e = cudaHostGetDevicePointer((void**)&g_status_dev, g_status_host, 0);
  return (int)e;
}

// The error code a timed-out spin wrote (0 = none): 1/2 allreduce phase
// 1/2, 3 allgather_matmul, 4 permute. Read without synchronizing.
extern "C" unsigned fused_ring_status() {
  return g_status_host ? *(volatile unsigned*)g_status_host : 0u;
}

extern "C" void fused_ring_clear_status() {
  if (g_status_host) *(volatile unsigned*)g_status_host = 0u;
}

// Co-resident CTAs of one kernel on the current device (blocks per SM
// from the occupancy query x SMs): the cooperative grid's ceiling.
extern "C" int fused_ring_capacity(int which, int dtype, int* out) {
  const void* fn = kernel_for(which, dtype);
  if (!fn) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  *out = per_sm * sms;
  return (int)cudaGetLastError();
}

// ranks_launched < total only from the card test that proves a missing
// rank times out instead of hanging.
extern "C" int fused_allreduce(const void* x, const void* bias, void* out, void* rs,
                               void* ag, void* flags, void* abort_word, unsigned epoch,
                               int dtype, int size, int stride, int total, long long m,
                               long long cn, long long n_pad, int G, int epilogue,
                               long long timeout_ns, int ranks_launched, void* stream) {
  const int vec = dtype == DT_BF16 ? 8 : 4;
  if (cn % vec || n_pad % vec) return (int)cudaErrorInvalidValue;
  RingArgs a;
  a.x = (const uint4*)x;
  a.bias = (const uint4*)bias;
  a.out = (uint4*)out;
  a.rs = (uint4*)rs;
  a.ag = (uint4*)ag;
  a.flags = (unsigned*)flags;
  a.size = size;
  a.stride = stride;
  a.total = total;
  a.G = G;
  a.epilogue = epilogue;
  a.m = m;
  a.cnv = cn / vec;
  a.n_padv = n_pad / vec;
  a.M = m * (cn / vec);
  Sync s = make_sync(abort_word, epoch, timeout_ns);
  return launch(K_ALLREDUCE, dtype, ranks_launched * G, &a, &s, stream);
}

extern "C" int allgather_matmul(const void* x, const void* w, void* out, void* buf,
                                void* counters, void* abort_word, unsigned epoch, int dtype,
                                int size, int stride, int total, long long m, long long k,
                                long long n, int G, long long timeout_ns, void* stream) {
  AgmmArgs a;
  a.x = x;
  a.w = w;
  a.out = out;
  a.buf = buf;
  a.counters = (unsigned*)counters;
  a.size = size;
  a.stride = stride;
  a.total = total;
  a.G = G;
  a.m = m;
  a.k = k;
  a.n = n;
  Sync s = make_sync(abort_word, epoch, timeout_ns);
  return launch(K_AGMM, dtype, total * G, &a, &s, stream);
}

extern "C" int fused_permute(const void* x, void* out, const void* dst, void* counters,
                             void* abort_word, unsigned epoch, int total, long long row_bytes,
                             int G, long long timeout_ns, void* stream) {
  PermArgs a;
  a.x = (const unsigned char*)x;
  a.out = (unsigned char*)out;
  a.dst = (const int*)dst;
  a.counters = (unsigned*)counters;
  a.G = G;
  a.row_bytes = row_bytes;
  Sync s = make_sync(abort_word, epoch, timeout_ns);
  return launch(K_PERMUTE, 0, total * G, &a, &s, stream);
}
