// The serving plane's KV migration exchange (kernel 13 of the port), for
// Hopper (sm_90a).
//
// Replaces the paired remote-DMA kernel of
// hpc_patterns_tpu/comm/migration_dma.py:110 (built in _exchange_fn, its
// pallas_call at :131): an SPMD program over the pair [src, dst] in which
// the source remote-copies its (n_pages, row) payload slab into the
// destination's output buffer chunk by chunk, PAGE_CHUNK pages a chunk
// (the last one ragged), with a dedicated send/recv semaphore pair per
// chunk; every recv is awaited before the first send-wait, and every send
// is drained before the kernel returns.
//
// On one card the two replicas are two logical ranks in the same memory,
// and the pair is one ordinary launch of G sender CTAs, none of which
// waits on another:
//   - each sender copies its grid-strided share of chunk c into the
//     destination's landing slab (16-byte vectors where the row and both
//     base pointers allow it, bytes otherwise; every load of a thread's
//     share is issued before its first store), then __syncthreads() and
//     one arrival on chunk c's counter by thread 0: red.release.gpu for
//     every chunk but the last, atom.acq_rel.gpu on the last;
//   - the sender whose arrival completes the last chunk (its atom returns
//     G - 1) is the receiver. A sender arrives on chunk c + 1 only after
//     chunk c, so that arrival synchronizes with every sender's release of
//     every chunk — the wait_recv discipline, acquired by the last arriver
//     instead of a waiting CTA. It checks that every earlier chunk counted
//     G arrivals and adds one to the device's landed count.
// Nothing spins, so nothing needs co-residency: the launch is not
// cooperative and there is no timeout. A sender that never arrives leaves
// the landed count one short, which migration_dma.synchronize() reads
// after it synchronizes and raises on. Counters live in two sets used by
// alternate launches (the epoch's parity); each launch's CTAs zero the
// whole set of the next one, so a launch that missed an arrival poisons
// no later launch and no launch needs a memset. Launches that share the
// counters run in stream order.
//
// The TPU kernel's mirror-image back-copy (dst -> src, byte-inert: JAX
// keeps only the destination's shard) is skipped: the source keeps its
// payload and nothing reads a copy back.
//
// What bounds it on the H100: bytes. Each payload byte is read once and
// written once (2 x the slab at 3.35 TB/s: 0.63 us for one 1 MiB array
// of the plane's bundles). A copy this small is bound in practice by the
// launch and one round trip to memory: about one sender CTA an SM puts
// every vector of the chunk in flight at once, and the protocol adds one
// returning atomic to each CTA's path. On the H100 the earlier design's
// receiver CTA, acquiring every sender's flag, cost a third of its time
// and its cooperative launch almost nothing (PERF.md, PR 12).

#include <cuda_runtime.h>
#include <stdint.h>
#include "smem_rows.cuh"

namespace {

constexpr int THREADS = 256;
// 16-byte vectors a thread has in flight before its first store
constexpr int UNROLL = 4;

struct Args {
  const unsigned char* x;  // source slab, n_pages * row_bytes
  unsigned char* landing;  // destination's landing slab, the same size
  unsigned int* counters;  // this launch's set: (chunks,) arrivals
  unsigned int* next;      // the next launch's set, zeroed here
  int set_words;           // words a set holds (the most chunks a launch may have)
  unsigned int* landed;    // launches of this device that landed
  long long n_pages;
  long long row_bytes;
  int page_chunk;
  int chunks;
  int G;  // arrivals a chunk waits for: the sender CTAs of the plan
  int vec;  // 1: 16-byte vectors
};

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// UNROLL-strided elements of one pass: all loads, then all stores.
template <class V>
__device__ __forceinline__ void copy_strided(const V* __restrict__ src, V* __restrict__ dst,
                                             long long n, long long first, long long stride) {
  for (long long e = first; e < n; e += stride * UNROLL) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (e + u * stride < n) v[u] = src[e + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (e + u * stride < n) dst[e + u * stride] = v[u];
  }
}

// Sender CTA g's share of chunk c: a grid stride over the launched CTAs.
__device__ __forceinline__ void copy_chunk(const Args& a, int c, int g) {
  const long long lo = (long long)c * a.page_chunk;
  const long long span = a.n_pages - lo < a.page_chunk ? a.n_pages - lo : a.page_chunk;
  const long long off = lo * a.row_bytes;
  const long long bytes = span * a.row_bytes;
  const long long first = (long long)g * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (a.vec)
    copy_strided((const uint4*)(a.x + off), (uint4*)(a.landing + off), bytes / 16, first,
                 stride);
  else
    copy_strided(a.x + off, a.landing + off, bytes, first, stride);
}

__global__ void __launch_bounds__(THREADS) migration_exchange_kernel(Args a) {
  const int g = blockIdx.x;
  for (int i = g * THREADS + threadIdx.x; i < a.set_words; i += gridDim.x * THREADS)
    a.next[i] = 0u;
  for (int c = 0; c < a.chunks; ++c) {
    copy_chunk(a, c, g);
    // the CTA's stores of chunk c, then its arrival: the barrier orders
    // every thread's stores before thread 0's release, which is cumulative
    // at gpu scope; a __threadfence() (fence.sc) before it only adds a wait
    __syncthreads();
    if (threadIdx.x == 0) {
      if (c + 1 < a.chunks) {
        red_release(a.counters + c, 1u);
      } else if (atom_acq_rel(a.counters + c, 1u) == (unsigned)a.G - 1u) {
        // the last arrival: every chunk must have counted G
        bool all = true;
        for (int i = 0; i < c; ++i)
          all &= *(volatile unsigned*)(a.counters + i) == (unsigned)a.G;
        if (all) atomicAdd(a.landed, 1u);
      }
    }
  }
}

}  // namespace

// One exchange of an (n_pages, row_bytes) slab into `landing`: `senders`
// CTAs on `stream`, each chunk waiting for G arrivals. `counters` holds
// two sets of `max_chunks` words (zeros before the first launch) and
// `landed` one word. `senders` < G only from the card test that proves a
// missing sender is caught.
extern "C" int migration_exchange(const void* x, void* landing, void* counters, void* landed,
                                  unsigned epoch, long long n_pages, long long row_bytes,
                                  int page_chunk, int max_chunks, int G, int senders,
                                  void* stream) {
  const long long chunks = (n_pages + page_chunk - 1) / (page_chunk > 0 ? page_chunk : 1);
  if (n_pages < 1 || row_bytes < 1 || page_chunk < 1 || chunks > max_chunks || G < 1 ||
      senders < 1 || senders > G)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const unsigned char*)x;
  a.landing = (unsigned char*)landing;
  a.counters = (unsigned int*)counters + (long long)(epoch & 1u) * max_chunks;
  a.next = (unsigned int*)counters + (long long)((epoch + 1u) & 1u) * max_chunks;
  a.landed = (unsigned int*)landed;
  a.set_words = max_chunks;
  a.n_pages = n_pages;
  a.row_bytes = row_bytes;
  a.page_chunk = page_chunk;
  a.chunks = (int)chunks;
  a.G = G;
  a.vec = (row_bytes % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)landing % 16 == 0)
              ? 1 : 0;
  migration_exchange_kernel<<<senders, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(0, migration_exchange_kernel))
