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
// so the pair is one cooperative launch of two groups of CTAs:
//   senders  (blockIdx < senders): grid-strided over each chunk's bytes,
//            16-byte vectors where the row and both base pointers allow
//            it (bytes otherwise), into the destination's landing slab;
//            after its share of chunk c each sender CTA does
//            __syncthreads(), __threadfence() and st.release.gpu of its
//            own recv flag (c, g) = epoch;
//   receiver (the last CTA): ld.acquire.gpu of every (chunk, sender) flag
//            before the kernel returns — the wait_recv discipline. A
//            sender's own completion is its wait_send.
// Flags carry the launch's epoch (one buffer per device, a new epoch per
// launch), so no launch needs a memset. The launch is cooperative: it is
// refused, not hung, when the grid cannot be co-resident, and the wrapper
// sizes the senders from the occupancy query. Every spin is bounded on
// %globaltimer: one that runs out sets the launch's abort word (the other
// receiver threads give up too) and an error code in a word of mapped
// host memory that the Python wrapper reads and raises on
// (migration_dma_status) — the protocol of csrc/fused_ring.cu.
//
// The TPU kernel's mirror-image back-copy (dst -> src, byte-inert: JAX
// keeps only the destination's shard) is skipped: the source keeps its
// payload and nothing reads a copy back.
//
// What bounds it on the H100: bytes. Each payload byte is read once and
// written once (2 x the slab at 3.35 TB/s: 0.63 us for one 1 MiB array
// of the plane's bundles). A copy this small is launch-latency bound in
// practice; the design keeps every sender CTA on its own vectors (no
// shared memory, no barrier but the one before each flag) and the flag
// traffic at one word per (chunk, sender CTA).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

unsigned int* g_status_host = nullptr;
unsigned int* g_status_dev = nullptr;

struct Sync {
  unsigned int* abort;   // device word: == epoch once a spin of this launch ran out
  unsigned int* status;  // mapped host word: nonzero = error code
  unsigned int epoch;
  unsigned long long timeout_ns;
};

struct Args {
  const unsigned char* x;  // source slab, n_pages * row_bytes
  unsigned char* landing;  // destination's landing slab, the same size
  unsigned int* flags;     // (chunks, G) recv flags
  long long n_pages;
  long long row_bytes;
  int page_chunk;
  int chunks;
  int G;        // flags per chunk: the sender CTAs the receiver waits on
  int senders;  // sender CTAs launched (== G except in the timeout test)
  int vec;      // 1: 16-byte vectors
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Sender CTA g's share of chunk c: a grid stride over the sender CTAs.
__device__ __forceinline__ void copy_chunk(const Args& a, int c, int g) {
  const long long lo = (long long)c * a.page_chunk;
  const long long span = a.n_pages - lo < a.page_chunk ? a.n_pages - lo : a.page_chunk;
  const long long off = lo * a.row_bytes;
  const long long bytes = span * a.row_bytes;
  const long long stride = (long long)a.senders * THREADS;
  if (a.vec) {
    const uint4* src = (const uint4*)(a.x + off);
    uint4* dst = (uint4*)(a.landing + off);
    const long long n16 = bytes / 16;
    for (long long e = (long long)g * THREADS + threadIdx.x; e < n16; e += stride)
      dst[e] = src[e];
  } else {
    const unsigned char* src = a.x + off;
    unsigned char* dst = a.landing + off;
    for (long long e = (long long)g * THREADS + threadIdx.x; e < bytes; e += stride)
      dst[e] = src[e];
  }
}

__global__ void __launch_bounds__(THREADS) migration_exchange_kernel(Args a, Sync s) {
  if ((int)blockIdx.x < a.senders) {
    const int g = blockIdx.x;
    for (int c = 0; c < a.chunks; ++c) {
      copy_chunk(a, c, g);
      __syncthreads();  // the CTA's stores of chunk c, then its flag
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(a.flags + (long long)c * a.G + g, s.epoch);
      }
    }
    return;
  }
  // the receiver: every chunk's flags acquired before the kernel returns
  const long long nflags = (long long)a.chunks * a.G;
  bool gave_up = false;
  for (long long i = threadIdx.x; i < nflags && !gave_up; i += THREADS) {
    const unsigned long long t0 = globaltimer();
    for (unsigned it = 1; ld_acquire(a.flags + i) != s.epoch; ++it) {
      if ((it & 63u) == 0) {
        if (*(volatile unsigned*)s.abort == s.epoch) { gave_up = true; break; }
        if (globaltimer() - t0 > s.timeout_ns) {
          atomicExch(s.abort, s.epoch);
          *(volatile unsigned*)s.status = 1u;
          __threadfence_system();
          gave_up = true;
          break;
        }
      }
      __nanosleep(32);
    }
  }
}

}  // namespace

// Allocates the mapped host status word once per process (idempotent).
extern "C" int migration_dma_init() {
  if (g_status_host) return 0;
  cudaError_t e = cudaHostAlloc((void**)&g_status_host, sizeof(unsigned),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  *g_status_host = 0;
  e = cudaHostGetDevicePointer((void**)&g_status_dev, g_status_host, 0);
  return (int)e;
}

// The error code a timed-out spin wrote (0 = none; 1 = the receiver
// gave up on a flag). Read without synchronizing.
extern "C" unsigned migration_dma_status() {
  return g_status_host ? *(volatile unsigned*)g_status_host : 0u;
}

extern "C" void migration_dma_clear_status() {
  if (g_status_host) *(volatile unsigned*)g_status_host = 0u;
}

// Co-resident CTAs of the kernel on the current device (blocks per SM
// from the occupancy query x SMs): the cooperative grid's ceiling.
extern "C" int migration_dma_capacity(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)migration_exchange_kernel, THREADS, 0);
  *out = per_sm * sms;
  return (int)cudaGetLastError();
}

// One exchange of an (n_pages, row_bytes) slab into `landing`: `G` sender
// CTAs (plus the receiver) on `stream`. `senders` < G only from the card
// test that proves a missing sender times out instead of hanging.
extern "C" int migration_exchange(const void* x, void* landing, void* flags,
                                  void* abort_word, unsigned epoch, long long n_pages,
                                  long long row_bytes, int page_chunk, int G, int senders,
                                  long long timeout_ns, void* stream) {
  if (!g_status_dev || n_pages < 1 || row_bytes < 1 || page_chunk < 1 || G < 1 ||
      senders < 1 || senders > G)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const unsigned char*)x;
  a.landing = (unsigned char*)landing;
  a.flags = (unsigned int*)flags;
  a.n_pages = n_pages;
  a.row_bytes = row_bytes;
  a.page_chunk = page_chunk;
  a.chunks = (int)((n_pages + page_chunk - 1) / page_chunk);
  a.G = G;
  a.senders = senders;
  a.vec = (row_bytes % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)landing % 16 == 0)
              ? 1 : 0;
  Sync s;
  s.abort = (unsigned int*)abort_word;
  s.status = g_status_dev;
  s.epoch = epoch;
  s.timeout_ns = (unsigned long long)timeout_ns;
  void* params[] = {&a, &s};
  cudaLaunchCooperativeKernel((const void*)migration_exchange_kernel, dim3(senders + 1),
                              dim3(THREADS), params, 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
