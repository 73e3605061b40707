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
// is a store into the right neighbour's receive slot in global memory
// followed by a flag the neighbour acquires:
//   sender:   all threads store (st.global.cg), __syncthreads(), then one
//             thread: __threadfence(); st.release.gpu (or red.release.gpu
//             .add for a counter several CTAs feed);
//   receiver: one thread spins on ld.acquire.gpu, then __syncthreads();
//             the slot is read with ld.global.cg (L2, never a stale L1).
// The all-gather matmul's receive slots are dedicated per step: no slot is
// written twice in a launch, so the race of fused.py:466-470 (a later write
// landing in a slot the neighbour has not read) cannot happen there. The
// allreduce's slots are a small FIFO a ring link reuses round after round,
// guarded by credits (below). Flags compare against the launch's epoch,
// and the allreduce's counters run on from launch to launch (each CTA
// reads where its link's counters stand when it starts), so no memset is
// needed between launches.
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
// (each input read once, each output written once at 3.35 TB/s). The
// allreduce spreads the ring over the 132 SMs by column stripes: chunk
// columns are independent, so CTA (rank, g) runs its own two-phase ring
// over stripe g of every chunk, with no grid-wide barrier, and moves
// 16-byte vectors. Its hops must not add DRAM traffic: a ring of W ranks
// hands 2 (W - 1) partials of every stripe along, so slots that each hop
// writes in full and the neighbour reads back cost 2.5x the bound's bytes
// at W 4 once they outgrow the 50 MB L2. So a hop moves one tile of the
// stripe (TILE = 128 threads x 4 vectors, 8 KiB) into a FIFO of
// SLOTS = 4 tiles a link, and the tile a CTA receives is added and sent on
// at once: the receiver hands a credit back once it has read a slot, and
// the sender waits for that credit before it overwrites it. Every CTA's
// FIFO together stays well inside the L2 (the wrapper plans 16 MiB at
// most), and FIFO stores and loads carry an L2 evict_last policy while x
// is loaded and out stored as streaming (ld/st.global.cs, evict-first),
// so a partial is written and read in L2 and only x and out reach DRAM.
// The partials still cross the L2 twice (written, read back), at W 4 1.5x
// the bound's bytes again: on the H100 the kernel runs where x, out and
// the FIFO together hold the L2 at about 4 TB/s (PERF.md). A CTA
// reads its incoming tile and hands its credit back before it waits for
// credit on its outgoing link, so a ring whose FIFOs are full still moves.
// allgather_matmul is bound
// by its f32 FMAs (67 TF/s outside the tensor cores; 0.128 ms at the bench
// shape, 256 x 1024 x 1024 per rank x 4 ranks), and it keeps an f32 input
// in its precision class: no TF32, no tensor cores. It is a register-blocked
// FFMA GEMM whose CTAs each own one 128 x 64 output tile of their rank for
// all the ring's steps, so a CTA's W column panel stays hot in L2 from step
// to step, and 4 ranks x 32 tiles are one wave of 128 CTAs on the 132 SMs.
// Each thread holds 8 x 8 accumulators and reads both operands from
// shared memory as float4 (one LDS.128 per 16 FFMA); two groups of 128
// threads split every k tile and add their partial sums in a fixed order,
// so two calls give equal bits. k tiles of 32 stream through a 4-stage
// ring with cp.async.cg (16 bytes, L2 only: the arrived shard, which other
// CTAs wrote, is read after the acquire and never through L1), so three
// tiles load while one computes. bf16, int32 and rows that are not whole
// 16-byte vectors take the same products through a register route that
// widens each element to f32 on its way into shared memory.
//
// Exactness: the allreduce's adds are mine + incoming in the chunk order of
// ring.ring_allreduce_chunked; the bf16 add is __float2bfloat16_rn(float(a)
// + float(b)), which is what PyTorch's bf16 add does, and int32 wraps. So
// the kernel equals the plain version over the same chunk layout bit for
// bit (tiling a stripe moves no element's adds). The matmul differs from a
// library GEMM only by summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ledger.cuh"
#include "smem_rows.cuh"

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
  HPCPAT_LEDGER_FLAG(HPCPAT_F_RELEASE);
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  HPCPAT_LEDGER_FLAG(HPCPAT_F_RELEASE);
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A credit: a relaxed store (what orders it is the caller's; see
// cta_credit)
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  HPCPAT_LEDGER_FLAG(HPCPAT_F_CREDIT);
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
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

// The allreduce's counters only grow, from launch to launch, wrapping at
// 2^32. cta_spin (thread 0 alone) keeps the value it last acquired in
// *seen and goes to memory only when that does not reach want (compared
// across the wrap); it spins until the counter does, and returns false if
// this launch gave up. The acquire that saw the value
// precedes the CTA's next barrier, so every thread's accesses after that
// barrier are ordered after the counted tiles.
__device__ bool cta_spin(const unsigned* flag, unsigned want, unsigned* seen, const Sync& s,
                         unsigned code) {
  unsigned long long t0 = 0;
  for (unsigned it = 0; (int)(*seen - want) < 0; ++it) {
    if (it == 1) {
      t0 = globaltimer();
    } else if (it > 1 && (it & 63u) == 0) {
      if (*(volatile unsigned*)s.abort == s.epoch) return false;
      if (globaltimer() - t0 > s.timeout_ns) {
        atomicExch(s.abort, s.epoch);
        *(volatile unsigned*)s.status = code;
        __threadfence_system();
        return false;
      }
    }
    if (it) __nanosleep(32);
    *seen = ld_acquire(flag);
  }
  HPCPAT_LEDGER_FLAG(HPCPAT_F_SPIN_OK);
  return true;
}

// The CTA waits on cta_spin: thread 0 spins and leaves the answer in *ok
// (its own shared word at each wait site, so one barrier suffices: the
// next write to it lies behind another barrier).
__device__ bool cta_wait_ge(const unsigned* flag, unsigned want, unsigned* seen,
                            const Sync& s, unsigned code, volatile int* ok) {
  if (threadIdx.x == 0) *ok = cta_spin(flag, want, seen, s, code);
  __syncthreads();
  return *ok != 0;
}

// A slot's credit handed back: every thread has its values of the slot in
// registers (hold() made each load return before the barrier), so the
// sender's next store into it cannot reach them, and a relaxed store
// suffices (no fence on the receive path).
__device__ __forceinline__ void cta_credit(unsigned* flag, unsigned value) {
  __syncthreads();
  if (threadIdx.x == 0) st_relaxed(flag, value);
}

// The load that produced v has returned: its registers are read here.
__device__ __forceinline__ void hold(const uint4& v) {
  asm volatile("" ::"r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// The allreduce's FIFO traffic: L2 only (never a stale L1), kept in the L2
// ahead of streaming lines (evict_last). x and out stream (evict_first).
__device__ __forceinline__ unsigned long long l2_evict_last() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 ld_fifo(const uint4* p, unsigned long long pol) {
  uint4 v;
  asm volatile("ld.global.cg.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_fifo(uint4* p, uint4 v, unsigned long long pol) {
  asm volatile("st.global.cg.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
               : "memory");
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

// a FIFO counter's stride in words: each counter on its own 128-byte line
constexpr int FLAG_WORDS = 32;
// the allreduce's CTA: 128 threads, so that an SM holds several of its
// rings' CTAs at once, each moving its own tile of AR_VPT vectors a thread
// (8 KiB: on the H100 faster than 2 and 4 KiB tiles), AR_SLOTS receive
// slots a link, walking AR_SLOTS - 1 tiles together (one slot of slack: on
// the H100 at 2^25 f32 x 4 ranks no slower than 6 slots, two of slack or
// a 24-32 MiB FIFO; PERF.md)
constexpr int AR_THREADS = 128, AR_VPT = 4, AR_TILE = AR_THREADS * AR_VPT;
constexpr int AR_SLOTS = 4, AR_INTERLEAVE = AR_SLOTS - 1;

struct RingArgs {
  const uint4* x;     // (total, m, n_pad) in 16-byte vectors
  const uint4* bias;  // (m, n_pad) or null
  uint4* out;         // (total, m, n_pad)
  uint4* fifo;        // (total, G, SLOTS, TILE): each link's receive slots
  unsigned* flags;    // (total, G, 2, FLAG_WORDS): tiles arrived, consumed
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

// CTA (f, g) runs the ring over stripe g of every chunk of flat rank f.
// Its outgoing link is (dst, g): slots fifo[dst, g], counters flags[dst,
// g]; its incoming link (f, g) the same of its own. A tile carries 2S
// messages, S = size - 1: message 0 the raw local chunk pos - 1, 1 .. S -
// 1 the reduce-scatter's partials, S the fully reduced chunk pos, S + 1
// .. 2S - 1 its forwards; message r of a tile leaves once message r - 1
// of the same tile has arrived. The CTA takes its tiles in groups of L =
// AR_INTERLEAVE < SLOTS and walks each group message by message, tile by
// tile (a step: one tile of one message): so a tile it sends depends on
// one its left neighbour sent L steps earlier, whose hop latency hides
// behind L steps of work. Item k of a launch is the k-th tile a link
// carries; base + k + 1 the counters' value once it has arrived (and once
// it has been consumed), base where the launch found them: every link of
// stripe g carries the same 2S x tiles items a launch, so all of them
// stand at the same base, which thread 0 reads from its incoming link's
// consumed counter (written by this CTA alone, in an earlier
// launch). Counters that run on cost nothing at a launch's start: on the
// H100, two sets of counters by the epoch's parity, each launch zeroing
// the next one's, ran 9% slower at 2^25 f32 x 4 ranks (PERF.md).
// A step: thread 0 waits for the incoming tile and probes, never waits
// for, the outgoing credit; one barrier; the tile is read (with the x tile
// loaded a step ahead), added, written out and stored into the outgoing
// slot; one barrier; thread 0 hands the read slot's credit back (a relaxed
// store: every value read from it has landed) and publishes the sent
// tile (a release store). Only when the probe found no credit does the
// step hand its credit back first and then wait (two barriers more), so a
// CTA never holds a slot while it waits: a CTA waiting on credit for item
// k faces a neighbour that waits on an earlier item, and around the ring
// someone moves.
template <class Op>
__global__ void __launch_bounds__(AR_THREADS)
fused_allreduce_kernel(RingArgs a, Sync sync) {
  constexpr int VPT = AR_VPT, TILE = AR_TILE, SLOTS = AR_SLOTS, L = AR_INTERLEAVE;
  __shared__ int ok_in, ok_out, ok_wait;
  const int f = blockIdx.x / a.G;  // flat rank
  const int g = blockIdx.x % a.G;  // column stripe
  const int tid = threadIdx.x;
  const int size = a.size, S = size - 1;
  const int pos = (f / a.stride) % size;
  const int dst = f + (((pos + 1) % size) - pos) * a.stride;
  const long long per = (a.M + a.G - 1) / a.G;
  const long long e0 = (long long)g * per;
  const long long e1 = e0 + per < a.M ? e0 + per : a.M;
  const int tiles = e1 > e0 ? (int)((e1 - e0 + TILE - 1) / TILE) : 0;
  const long long in_link = (long long)f * a.G + g;
  const long long out_link = (long long)dst * a.G + g;
  unsigned* arrived_in = a.flags + in_link * 2 * FLAG_WORDS;
  unsigned* consumed_in = arrived_in + FLAG_WORDS;
  unsigned* arrived_out = a.flags + out_link * 2 * FLAG_WORDS;
  const unsigned* consumed_out = arrived_out + FLAG_WORDS;
  const uint4* fifo_in = a.fifo + in_link * SLOTS * TILE;
  uint4* fifo_out = a.fifo + out_link * SLOTS * TILE;
  const unsigned long long keep = l2_evict_last();
  const unsigned cnv = (unsigned)a.cnv;  // the host checked M < 2^31
  // where this launch finds the links' counters, and thread 0's last
  // acquired counters
  const unsigned base = tid == 0 ? *(volatile const unsigned*)consumed_in : 0u;
  unsigned seen_in = base, seen_out = base;

  auto xoff = [&](int rank, int chunk, unsigned e) {
    const unsigned row = e / cnv, col = e - row * cnv;
    return ((long long)rank * a.m + row) * a.n_padv + (long long)chunk * cnv + col;
  };
  auto boff = [&](int chunk, unsigned e) {
    const unsigned row = e / cnv, col = e - row * cnv;
    return (long long)row * a.n_padv + (long long)chunk * cnv + col;
  };
  auto load_x = [&](uint4 (&v)[VPT], int chunk, long long lo) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const long long e = lo + tid + i * AR_THREADS;
      v[i] = e < e1 ? __ldcs(a.x + xoff(f, chunk, (unsigned)e)) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // the local chunk that message r (<= S) carries or adds: 0 the raw
  // chunk pos - 1, r = s the reduce-scatter step's chunk pos - 1 - s
  auto x_chunk = [&](int r) { return (pos + 2 * size - 1 - r) % size; };

  // The walk: groups of n <= L tiles from tile t0, message r, tile u of the
  // group. xn holds the x tile of the step the walk takes next, loaded a
  // step ahead so that its DRAM latency hides behind the current step.
  int t0 = 0, n = tiles < L ? tiles : L, r = 0, u = 0;
  uint4 xn[VPT];
  if (tiles) load_x(xn, x_chunk(0), e0);
  while (t0 < tiles) {
    const long long lo = e0 + (long long)(t0 + u) * TILE;
    const unsigned first = (unsigned)t0 * 2u * (unsigned)S;  // the group's first item
    uint4 v[VPT], xv[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) xv[i] = xn[i];
    int t1 = t0, n1 = n, r1 = r, u1 = u + 1;  // the next step
    if (u1 == n) {
      u1 = 0;
      if (++r1 > 2 * S) {
        r1 = 0;
        t1 += n;
        n1 = tiles - t1 < L ? tiles - t1 : L;
      }
    }
    if (t1 < tiles && r1 <= S) load_x(xn, x_chunk(r1), e0 + (long long)(t1 + u1) * TILE);

    // items: k_in arrives (message r - 1), k_out leaves (message r)
    const unsigned k_in = first + (unsigned)((r - 1) * n + u);
    const unsigned k_out = first + (unsigned)(r * n + u);
    const bool recv = r > 0, send = r < 2 * S;
    // the outgoing slot is free once the neighbour consumed item k_out -
    // SLOTS (a launch's first SLOTS items find theirs free)
    const bool credit = send && k_out >= (unsigned)SLOTS;
    const unsigned want_credit = base + k_out + 1u - (unsigned)SLOTS;
    if (tid == 0) {
      ok_in = !recv ||
              cta_spin(arrived_in, base + k_in + 1u, &seen_in, sync, r <= S ? 1u : 2u);
      ok_out = !credit || (int)(seen_out - want_credit) >= 0 ||
               (int)((seen_out = ld_acquire(consumed_out)) - want_credit) >= 0;
    }
    __syncthreads();
    if (!ok_in) return;  // the launch gave up
    const bool credit_later = !ok_out;  // every thread reads it before the next barrier
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) v[i] = xv[i];  // message 0 leaves raw
    } else {
      // message r - 1 arrives; reduce-scatter step s = r adds xv to it
      const uint4* slot = fifo_in + (long long)(k_in % (unsigned)SLOTS) * TILE;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        if (lo + tid + i * AR_THREADS < e1) v[i] = ld_fifo(slot + tid + i * AR_THREADS, keep);
      }
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        hold(v[i]);
        if (r <= S) v[i] = vadd<Op>(xv[i], v[i]);  // mine + incoming
      }
      if (r >= S) {
        // chunk jo is fully reduced: it lands in the output through the
        // epilogue (r = S: chunk pos, which starts the gather)
        const int jo = (pos + size - (r - S)) % size;
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const long long e = lo + tid + i * AR_THREADS;
          if (e < e1)
            __stcs(a.out + xoff(f, jo, (unsigned)e),
                   vepi<Op>(v[i], a.bias, boff(jo, (unsigned)e), a.epilogue));
        }
      }
    }
    if (credit_later) {
      // no credit yet: hand back the slot just read before waiting for one
      if (recv) cta_credit(consumed_in, base + k_in + 1u);
      if (!cta_wait_ge(consumed_out, want_credit, &seen_out, sync, 5u, &ok_wait)) return;
    }
    if (send) {
      uint4* slot = fifo_out + (long long)(k_out % (unsigned)SLOTS) * TILE;
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        if (lo + tid + i * AR_THREADS < e1) st_fifo(slot + tid + i * AR_THREADS, v[i], keep);
    }
    // one barrier: the slot read is handed back (every value read from it
    // is in registers: a relaxed store) and the tile sent is published
    __syncthreads();
    if (tid == 0) {
      if (recv && !credit_later) st_relaxed(consumed_in, base + k_in + 1u);
      if (send) st_release(arrived_out, base + k_out + 1u);
    }
    t0 = t1;
    n = n1;
    r = r1;
    u = u1;
  }
}

// ---------------------------------------------------------------------------
// allgather_matmul
// ---------------------------------------------------------------------------

// The product: one CTA owns an AG_BM x AG_BN output tile of its rank for
// every ring step (several tiles when the grid is short of them). Its
// two groups (AG_KSPLIT) of AG_GROUP threads each take half of every k
// tile and add their partial sums in a fixed order once a tile; thread
// (ty, tx) of a group owns rows ty + 16 i (i < 8) and columns tx*4 + j,
// 32 + tx*4 + j (j < 4): 8 x 8 f32 accumulators. k tiles of A (m-major,
// rows padded to AG_LDA so that the four rows a warp reads at once sit on
// distinct banks) and W (k-major) stream through an AG_STAGES ring. Both
// reach registers as float4: per 4 k steps a thread reads each of its 8
// rows once and W's 8 columns of each step once, one LDS.128 per 16 FFMA;
// 86% of the main loop's instructions are FFMA. Each thread's cp.async
// sources are set once a tile, so a k tile costs it 6 cp.async and a few
// adds. What still bounds it is the FFMA stream as nvcc schedules it (two
// warps a scheduler): on the H100 the products run as slowly with their
// shared-memory loads taken out as with them (PERF.md, PR 12).
constexpr int AG_BM = 128, AG_BN = 64, AG_BK = 32, AG_STAGES = 4;
constexpr int AG_GROUP = 128, AG_KSPLIT = 2, AG_TM = 8;
constexpr int AG_THREADS = AG_GROUP * AG_KSPLIT;
constexpr int AG_LDA = AG_BK + 4;
constexpr int AG_A_FLOATS = AG_BM * AG_LDA;
constexpr int AG_STAGE_FLOATS = AG_A_FLOATS + AG_BK * AG_BN;
constexpr int AG_SMEM = AG_STAGES * AG_STAGE_FLOATS * 4;  // 106,496 bytes
// 16-byte chunks each thread copies a tile (cp.async route), and elements
// it widens a tile (the register route)
constexpr int AG_A_CHUNKS = AG_BM * AG_BK / 4 / AG_THREADS;
constexpr int AG_B_CHUNKS = AG_BK * AG_BN / 4 / AG_THREADS;
constexpr int AG_A_PER = AG_BM * AG_BK / AG_THREADS, AG_B_PER = AG_BK * AG_BN / AG_THREADS;
static_assert(AG_BK % (4 * AG_KSPLIT) == 0, "each group takes whole float4s of k");
static_assert(AG_GROUP * AG_TM * 8 == AG_BM * AG_BN, "a group covers the tile");
constexpr int AG_ROW_STEP = AG_GROUP / 8;  // a thread's rows: ty + AG_ROW_STEP * i
static_assert(AG_THREADS % (AG_BK / 4) == 0 && AG_THREADS % (AG_BN / 4) == 0,
              "a thread copies one column chunk of A and of W");
static_assert(AG_KSPLIT == 2 && AG_GROUP * AG_TM * 8 <= AG_STAGES * AG_STAGE_FLOATS,
              "two groups, whose partial sums fit the ring");

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
  for (long long e = e0 + threadIdx.x; e < e1; e += AG_THREADS) __stcg(d + e, __ldcg(s + e));
}

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // L2 only (.cg): an arrived shard is never read through a stale L1 line;
  // a source size of 0 fills the 16 bytes with zeros (the ragged edges)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One tile's loads. On the cp.async route (f32, k % 4 == 0, n % 4 == 0)
// every thread copies the same column chunk of A and of W each k tile:
// rows r_a + i * (AG_THREADS / (AG_BK / 4)) of A and r_b + i * ... of W.
template <class Op>
struct AgmmTile {
  using T = typename Op::T;
  static constexpr int A_ROW_STEP = AG_THREADS / (AG_BK / 4);
  static constexpr int B_ROW_STEP = AG_THREADS / (AG_BN / 4);
  const T* A;  // (m, k) rows of the shard
  const T* W;  // (k, n) panel
  long long m, k, n, row0, col0;
  // the cp.async route's per-thread state: its column chunk of A and of W
  const T* a_src;  // row0 + ra of A at k 0
  const T* b_src;  // row rb of W at col0 + cb * 4
  int a_col, b_row;  // k of its A chunk in a tile, its first W row
  int a_rows;        // its A rows inside m
  bool b_in;         // its W chunk inside n
  int a_off, b_off;  // where its chunks land in a stage (floats)

  __device__ AgmmTile(const T* A_, const T* W_, long long m_, long long k_, long long n_,
                      long long row0_, long long col0_)
      : A(A_), W(W_), m(m_), k(k_), n(n_), row0(row0_), col0(col0_) {
    const int ca = threadIdx.x % (AG_BK / 4), ra = threadIdx.x / (AG_BK / 4);
    const int cb = threadIdx.x % (AG_BN / 4), rb = threadIdx.x / (AG_BN / 4);
    a_col = ca * 4;
    b_row = rb;
    a_rows = 0;
#pragma unroll
    for (int i = 0; i < AG_A_CHUNKS; ++i) a_rows += row0 + ra + i * A_ROW_STEP < m;
    b_in = col0 + cb * 4 < n;
    a_src = A + (row0 + ra) * k + a_col;
    b_src = W + rb * n + col0 + cb * 4;
    a_off = ra * AG_LDA + a_col;
    b_off = AG_A_FLOATS + rb * AG_BN + cb * 4;
  }

  __device__ void issue(float* stage, long long k0) const {
    const bool ka = k0 + a_col < k;
    const T* a = a_src + k0;
    float* as = stage + a_off;
#pragma unroll
    for (int i = 0; i < AG_A_CHUNKS; ++i) {
      const bool ok = ka && i < a_rows;
      cp_async16(as + i * A_ROW_STEP * AG_LDA, ok ? (const void*)(a + i * A_ROW_STEP * k)
                                                  : (const void*)A, ok);
    }
    const T* b = b_src + k0 * n;
    float* bs = stage + b_off;
#pragma unroll
    for (int i = 0; i < AG_B_CHUNKS; ++i) {
      const bool ok = b_in && k0 + b_row + i * B_ROW_STEP < k;
      cp_async16(bs + i * B_ROW_STEP * AG_BN, ok ? (const void*)(b + i * B_ROW_STEP * n)
                                                 : (const void*)W, ok);
    }
  }

  // the widening route: each thread widens column tid % AG_BK of every
  // AG_THREADS / AG_BK-th A row and column tid % AG_BN of every
  // AG_THREADS / AG_BN-th W row, eight loads in flight before their stores
  __device__ void fill(float* stage, long long k0) const {
    constexpr int BATCH = 8, A_STEP = AG_THREADS / AG_BK, B_STEP = AG_THREADS / AG_BN;
    static_assert(AG_A_PER % BATCH == 0 && AG_B_PER % BATCH == 0, "whole batches");
    const int ac = threadIdx.x % AG_BK, ar = threadIdx.x / AG_BK;
    const int bc = threadIdx.x % AG_BN, br = threadIdx.x / AG_BN;
    const bool a_in = k0 + ac < k, b_in = col0 + bc < n;
    const T* a = A + (row0 + ar) * k + k0 + ac;
    const T* b = W + (k0 + br) * n + col0 + bc;
    float* as = stage + ar * AG_LDA + ac;
    float* bs = stage + AG_A_FLOATS + br * AG_BN + bc;
#pragma unroll
    for (int i0 = 0; i0 < AG_A_PER; i0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u;
        v[u] = a_in && row0 + ar + i * A_STEP < m ? Op::to_f(__ldcg(a + i * A_STEP * k)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) as[(i0 + u) * A_STEP * AG_LDA] = v[u];
    }
#pragma unroll
    for (int i0 = 0; i0 < AG_B_PER; i0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u;
        v[u] = b_in && k0 + br + i * B_STEP < k ? Op::to_f(__ldcg(b + i * B_STEP * n)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) bs[(i0 + u) * B_STEP * AG_BN] = v[u];
    }
  }
};

// This group's share of one k tile: per 4 k steps, each of the thread's
// rows read once (LDS.128: 4 k values), then per step W's 8 columns
// (2 LDS.128) for 8 x 8 FFMA.
__device__ __forceinline__ void agmm_products(const float* stage, int grp, int ty, int tx,
                                              float (&acc)[AG_TM][8]) {
  const float* As = stage;
  const float* Bs = stage + AG_A_FLOATS;
#pragma unroll
  for (int kq = 0; kq < AG_BK / AG_KSPLIT; kq += 4) {
    const int kk = grp * (AG_BK / AG_KSPLIT) + kq;
    float4 a[AG_TM];
#pragma unroll
    for (int i = 0; i < AG_TM; ++i)
      a[i] = *(const float4*)(As + (ty + AG_ROW_STEP * i) * AG_LDA + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b0 = *(const float4*)(Bs + (kk + q) * AG_BN + tx * 4);
      const float4 b1 = *(const float4*)(Bs + (kk + q) * AG_BN + 32 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < AG_TM; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

template <class Op>
__device__ __forceinline__ void agmm_store(typename Op::T* C, long long m, long long n,
                                           long long row0, long long col0, int ty, int tx,
                                           const float (&acc)[AG_TM][8]) {
  using T = typename Op::T;
  const bool vec = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < AG_TM; ++i) {
    const long long gr = row0 + ty + AG_ROW_STEP * i;
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gc = col0 + h * 32 + tx * 4;
      T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = Op::from_f(acc[i][h * 4 + j]);
      T* p = C + gr * n + gc;
      if (vec && gc + 3 < n) {
        if (sizeof(T) == 4) {
          *(uint4*)p = make_uint4(*(unsigned*)&v[0], *(unsigned*)&v[1], *(unsigned*)&v[2],
                                  *(unsigned*)&v[3]);
        } else {
          *(uint2*)p = make_uint2((unsigned)v[0] | ((unsigned)v[1] << 16),
                                  (unsigned)v[2] | ((unsigned)v[3] << 16));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < n) p[j] = v[j];
      }
    }
  }
}

// out tile (bm, bn) of one (m, k) @ (k, n) product, f32 accumulation
template <class Op, bool ASYNC>
__device__ void agmm_tile(const typename Op::T* A, const typename Op::T* W, typename Op::T* C,
                          long long m, long long k, long long n, long long bm, long long bn,
                          float* smem) {
  const int grp = threadIdx.x / AG_GROUP, gt = threadIdx.x % AG_GROUP;
  const int ty = gt / 8, tx = gt % 8;
  const AgmmTile<Op> t(A, W, m, k, n, bm * AG_BM, bn * AG_BN);
  const int KT = (int)((k + AG_BK - 1) / AG_BK);
  float acc[AG_TM][8];
#pragma unroll
  for (int i = 0; i < AG_TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the ring's last readers (an earlier tile) are done
#pragma unroll
  for (int s = 0; s < AG_STAGES - 1; ++s) {
    if constexpr (ASYNC) {
      if (s < KT) t.issue(smem + s * AG_STAGE_FLOATS, (long long)s * AG_BK);
      cp_async_commit();
    } else if (s < KT) {
      t.fill(smem + s * AG_STAGE_FLOATS, (long long)s * AG_BK);
    }
  }
  for (int kt = 0; kt < KT; ++kt) {
    if constexpr (ASYNC) cp_async_wait<AG_STAGES - 2>();
    __syncthreads();  // tile kt landed for all; stage (kt-1) % STAGES is free
    const int nxt = kt + AG_STAGES - 1;
    float* refill = smem + (nxt % AG_STAGES) * AG_STAGE_FLOATS;
    if constexpr (ASYNC) {
      if (nxt < KT) t.issue(refill, (long long)nxt * AG_BK);
      cp_async_commit();
    }
    agmm_products(smem + (kt % AG_STAGES) * AG_STAGE_FLOATS, grp, ty, tx, acc);
    // the widening route refills after the products, whose operand
    // registers it then reuses; the next barrier orders its stores
    if constexpr (!ASYNC) {
      if (nxt < KT) t.fill(refill, (long long)nxt * AG_BK);
    }
  }
  if constexpr (ASYNC) cp_async_wait<0>();
  // the second group's partial sums meet the first's in the ring (a fixed
  // order: two calls give equal bits)
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < AG_TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) smem[(i * 8 + j) * AG_GROUP + gt] = acc[i][j];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < AG_TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += smem[(i * 8 + j) * AG_GROUP + gt];
    agmm_store<Op>(C, m, n, t.row0, t.col0, ty, tx, acc);
  }
}

template <class Op, bool ASYNC>
__global__ void __launch_bounds__(AG_THREADS, 1)
allgather_matmul_kernel(AgmmArgs a, Sync sync) {
  using T = typename Op::T;
  extern __shared__ __align__(16) float ag_smem[];
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
  const long long nbm = (a.m + AG_BM - 1) / AG_BM, nbn = (a.n + AG_BN - 1) / AG_BN;
  const unsigned want = (unsigned)a.G * sync.epoch;  // G arrivals per launch

  auto tiles = [&](const T* A, int j) {
    for (long long b = g; b < nbm * nbn; b += a.G)
      agmm_tile<Op, ASYNC>(A, w, out + (long long)j * a.m * a.n, a.m, a.k, a.n, b / nbn,
                           b % nbn, ag_smem);
  };

  // step 0: the local shard leaves for the right neighbour, then the local
  // tile computes while it travels
  copy_stripe(x, buf + ((long long)dst * S) * shard, shard_bytes, g, a.G);
  cta_count(a.counters + (long long)dst * S);
  tiles(x, pos);
  for (int s = 1; s < size; ++s) {
    if (!cta_wait(a.counters + (long long)f * S + s - 1, want, sync, 3u)) return;
    const T* in = buf + ((long long)f * S + s - 1) * shard;
    if (s < size - 1) {
      // forward the arrived shard first; its tile then overlaps the hop
      copy_stripe(in, buf + ((long long)dst * S + s) * shard, shard_bytes, g, a.G);
      cta_count(a.counters + (long long)dst * S + s);
    }
    tiles(in, (pos + size - s) % size);
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
  } else if (which == K_PERMUTE) {
    return (const void*)fused_permute_kernel;
  }
  return nullptr;
}

// The all-gather matmul's two routes: cp.async for f32 rows of whole
// 16-byte vectors, the widening register route otherwise. Both take
// AG_SMEM bytes of dynamic shared memory, which must be allowed before
// the occupancy query and the launch.
const void* agmm_kernel(int dtype, bool async) {
  const void* fn = nullptr;
  if (dtype == DT_F32)
    fn = async ? (const void*)allgather_matmul_kernel<F32, true>
               : (const void*)allgather_matmul_kernel<F32, false>;
  else if (dtype == DT_BF16)
    fn = (const void*)allgather_matmul_kernel<BF16, false>;
  else if (dtype == DT_I32)
    fn = (const void*)allgather_matmul_kernel<I32, false>;
  if (fn) cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, AG_SMEM);
  return fn;
}

Sync make_sync(void* abort_word, unsigned epoch, long long timeout_ns) {
  Sync s;
  s.abort = (unsigned*)abort_word;
  s.status = g_status_dev;
  s.epoch = epoch;
  s.timeout_ns = (unsigned long long)timeout_ns;
  return s;
}

int launch(int which, int dtype, int blocks, int threads, void* args, Sync* sync,
           void* stream) {
  const void* fn = kernel_for(which, dtype);
  if (!fn || !g_status_dev) return (int)cudaErrorInvalidValue;
  void* params[] = {args, sync};
  cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), params, 0,
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
// 1/2, 3 allgather_matmul, 4 permute, 5 an allreduce FIFO credit. Read
// without synchronizing.
extern "C" unsigned fused_ring_status() {
  return g_status_host ? *(volatile unsigned*)g_status_host : 0u;
}

extern "C" void fused_ring_clear_status() {
  if (g_status_host) *(volatile unsigned*)g_status_host = 0u;
}

// Co-resident CTAs of one kernel on the current device (blocks per SM
// from the occupancy query x SMs): the cooperative grid's ceiling.
extern "C" int fused_ring_capacity(int which, int dtype, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (which == K_AGMM) {
    // the smaller of the two routes' ceilings: the wrapper sizes the grid
    // before the route is known
    const void* fns[2] = {agmm_kernel(dtype, false), dtype == DT_F32 ? agmm_kernel(dtype, true)
                                                                     : nullptr};
    if (!fns[0]) return (int)cudaErrorInvalidValue;
    per_sm = 1 << 30;
    for (const void* fn : fns) {
      int b = 0;
      if (fn) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, AG_THREADS, AG_SMEM);
      if (fn && b < per_sm) per_sm = b;
    }
  } else {
    const void* fn = kernel_for(which, dtype);
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, which == K_ALLREDUCE ? AR_THREADS : THREADS, 0);
  }
  *out = per_sm * sms;
  return (int)cudaGetLastError();
}

// The all-gather matmul's launch shape: {tile rows, tile columns, threads
// a CTA, dynamic shared memory bytes} (the wrapper's plan holds the same).
extern "C" void allgather_matmul_config(int* out) {
  out[0] = AG_BM;
  out[1] = AG_BN;
  out[2] = AG_THREADS;
  out[3] = AG_SMEM;
}

// The allreduce's launch constants: its tile in 16-byte vectors, its
// receive slots a link, its threads a CTA and a counter's stride in u32
// words (the wrapper's plan sizes the scratch by them).
extern "C" void fused_allreduce_config(int* out) {
  out[0] = AR_TILE;
  out[1] = AR_SLOTS;
  out[2] = AR_THREADS;
  out[3] = FLAG_WORDS;
}

// The allreduce over `fifo` (total * G * AR_SLOTS * AR_TILE 16-byte
// vectors) and `flags` (total * G * 2 * FLAG_WORDS u32, zeros before the
// first launch; every launch on them leaves each link's counters equal, so
// launches that share them run in stream order with one geometry).
// ranks_launched < total only from the card test that proves a missing
// rank times out instead of hanging.
extern "C" int fused_allreduce_fifo(const void* x, const void* bias, void* out, void* fifo,
                                    void* flags, void* abort_word, unsigned epoch, int dtype,
                                    int size, int stride, int total, long long m,
                                    long long cn, long long n_pad, int G, int epilogue,
                                    long long timeout_ns, int ranks_launched, void* stream) {
  const int vec = dtype == DT_BF16 ? 8 : 4;
  if (cn % vec || n_pad % vec || m * (cn / vec) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  RingArgs a;
  a.x = (const uint4*)x;
  a.bias = (const uint4*)bias;
  a.out = (uint4*)out;
  a.fifo = (uint4*)fifo;
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
  return launch(K_ALLREDUCE, dtype, ranks_launched * G, AR_THREADS, &a, &s, stream);
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
  const bool async = dtype == DT_F32 && k % 4 == 0 && n % 4 == 0 &&
                     ((uintptr_t)x | (uintptr_t)w | (uintptr_t)buf) % 16 == 0;
  const void* fn = agmm_kernel(dtype, async);
  if (!fn || !g_status_dev) return (int)cudaErrorInvalidValue;
  Sync s = make_sync(abort_word, epoch, timeout_ns);
  void* params[] = {&a, &s};
  cudaLaunchCooperativeKernel(fn, dim3(total * G), dim3(AG_THREADS), params, AG_SMEM,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
  return launch(K_PERMUTE, 0, total * G, THREADS, &a, &s, stream);
}

HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(0, fused_allreduce_kernel<F32>),
                   HPCPAT_SMEM_ROW(0, fused_allreduce_kernel<BF16>),
                   HPCPAT_SMEM_ROW(0, fused_allreduce_kernel<I32>),
                   HPCPAT_SMEM_ROW(AG_SMEM, allgather_matmul_kernel<F32, true>),
                   HPCPAT_SMEM_ROW(AG_SMEM, allgather_matmul_kernel<F32, false>),
                   HPCPAT_SMEM_ROW(AG_SMEM, allgather_matmul_kernel<BF16, false>),
                   HPCPAT_SMEM_ROW(AG_SMEM, allgather_matmul_kernel<I32, false>),
                   HPCPAT_SMEM_ROW(0, fused_permute_kernel))
