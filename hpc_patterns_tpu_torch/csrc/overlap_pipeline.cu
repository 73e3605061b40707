// The on-card copy/compute overlap experiment, for Hopper (sm_90a).
//
// Replaces: hpc_patterns_tpu/concurrency/pipeline.py::_make_in_kernel,
// _make_out_kernel and _make_pair_kernel (the Pallas kernels behind
// overlap_run). It computes what _run computes: a walk over the chunks of
// x (C, R, 128) f32, `passes` times, in one of ten modes:
//   in   overlap | serial | dma | compute | compute2
//        (global -> shared copies against a dependent FMA chain)
//   out  overlap_out | serial_out | dma_out
//        (shared -> global writebacks of seeded slots against the chain)
//   pair pair_overlap | pair_serial
//        (a copy-through: global -> shared -> global, two copy streams)
// and returns the (8, 128) checksum: chain results of rows 0-7 of every
// chunk, summed pass by pass and chunk by chunk in f32 (pair modes sum the
// copied-in rows 0-7; dma and dma_out return zeros). Out and pair modes
// also write `written` (C, R, 128): 0.25 / 0.75 by chunk parity (the
// seeded slots), or the input itself.
//
// What bounds it on the H100, per pass: the copies move C * R * 512 bytes
// per direction (twice for the pair modes): bytes / 3.35 TB/s; the chain
// does C * R * 128 * 8 * trips FMAs: 2 * that / 67 TF/s, which needs every
// SM's four schedulers issuing an FFMA each cycle; serial is the sum of
// the two, overlap the larger. At the bench's 16 x 2048 x 128 (16 MiB) the
// working set stays in the 50 MB L2, so the copies read L2, not HBM.
//
// Design. On the TPU one core walks the whole chunk with two VMEM slots.
// Here the grid is shaped to the card (ops: pipeline.py::pipeline_plan):
// `blocks` blocks, one an SM, each owning an equal share of every chunk
// (contiguous, in units of 32 floats, shares differing by at most one
// unit), cut into `tiles` tiles when two slots of the whole share would
// not fit in shared memory (one tile at 16 x 2048, two at 16 x 32768).
// Each block walks passes, chunks and its tiles in that order, a step per
// (pass, chunk, tile), with two shared-memory slots and the Pallas
// kernel's start/wait schedule for its mode:
//   overlap       warm-up load of the pass's first step, then the load of
//                 step k+1 flies while the chain runs on step k;
//   serial / dma  load, wait, (compute);
//   overlap_out   start the writeback of step k; wait only for the one
//                 from two steps back; drain at the end of a pass;
//   serial_out /  writeback, wait, (compute);
//   dma_out
//   pair_overlap  the out-copy of step k-1 must land before the in-copy
//                 of step k+1 reuses its slot; drain at the end of a pass;
//   pair_serial   in-copy, wait, out-copy, wait.
// Copies are 1-D bulk copies on the TMA engine (cp.async.bulk), issued by
// thread 0: loads complete on a `full` mbarrier with expect_tx bytes,
// stores go through bulk groups (commit_group / wait_group). Each slot
// (by step parity) has a full/empty mbarrier pair: the consumers wait on
// full[k & 1] for step k (parity (k >> 1) & 1) and each warp arrives on
// empty[k & 1] when it is done with the step, so thread 0 issues the next
// copy into a slot as soon as its last reader is done, and no warp waits
// at a block-wide barrier. The chain: each thread runs CHAINS elements'
// chains side by side in registers (element e, e + THREADS, ...), so a
// warp keeps CHAINS independent FFMAs in flight; every element's FMA
// sequence is the same one, so each result keeps its bits. Block 0's
// first tile holds rows 0-7 of every chunk; its threads accumulate the
// checksum in the TPU's order in registers and store it once at the end,
// so the result is bit-identical to the plain version.
//
// Pitfalls, and what the code does about each:
// - a barrier's phase parity is the step's: full/empty[k & 1] complete
//   once per step that uses them, in step order, and nobody gets two
//   phases ahead of a waiter (a warp starts step k + 2 only after thread 0
//   saw step k's empty phase complete and issued step k + 2's copy or
//   signal), so parity (k >> 1) & 1 names the phase without any state;
// - the seeded modes (compute, compute2, out) keep chunk parity: step k
//   of chunk i reads slot i & 1 (0.25 or 0.75), whatever its tile; nothing
//   writes those slots after the seeding, so they need no handoff;
// - threads' writes to shared memory (the seeded slots) are fenced with
//   fence.proxy.async.shared::cta plus a block barrier before a bulk store
//   reads them; in the pair modes thread 0 fences again between the load's
//   completion and the store;
// - a chain result nobody stores is dead code to nvcc, which would delete
//   the compute leg of every element but block 0's: every thread folds all
//   its chain results into its `sink` slot, which it stores at the end;
// - compute / compute2 run on scratch that no copy fills (undefined on
//   the TPU); here those slots are seeded with 0.25 / 0.75 as the out
//   modes' are, so their checksums are defined and deterministic;
// - nothing may be in flight when the block exits: thread 0 waits for all
//   bulk groups before the end, and every load is waited on.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ledger.cuh"
#include "smem_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 128;
constexpr int FMA_UNROLL = 8;
constexpr int CHAINS = 8;  // elements a thread chains side by side
constexpr int UNIT = 32;   // floats of the share granule (128 bytes)
constexpr int CSUM = 8 * LANES;  // the (8, 128) checksum tile
constexpr int CSUM_PER_THREAD = CSUM / THREADS;
static_assert(CSUM % THREADS == 0, "each thread owns whole checksum slots");
static_assert(CSUM_PER_THREAD <= CHAINS,
              "the checksum elements lie in a thread's first group");
static_assert(LANES % UNIT == 0, "a row is whole units");

enum Mode {
  OVERLAP = 0, SERIAL, DMA, COMPUTE, COMPUTE2,
  OVERLAP_OUT, SERIAL_OUT, DMA_OUT,
  PAIR_OVERLAP, PAIR_SERIAL,
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  HPCPAT_LEDGER_BAR(smem_addr(bar), HPCPAT_L_INITS, 1);
  HPCPAT_LEDGER_BAR(smem_addr(bar), HPCPAT_L_COUNT, count);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  HPCPAT_LEDGER_BAR(smem_addr(bar), HPCPAT_L_ARRIVE, 1);
  HPCPAT_LEDGER_BAR(smem_addr(bar), HPCPAT_L_TX_EXPECT, bytes);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  HPCPAT_LEDGER_BAR(smem_addr(bar), HPCPAT_L_ARRIVE, 1);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
  HPCPAT_LEDGER_BAR(addr, HPCPAT_L_WAIT, 1);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// global -> shared, completing `bytes` of transactions on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  HPCPAT_LEDGER_BAR(smem_addr(bar), HPCPAT_L_TX_COPY, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global as one bulk group
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
pipeline_kernel(const float* __restrict__ x, float* __restrict__ written,
                float* __restrict__ csum, float* __restrict__ sink,
                int num_chunks, int chunk_rows, int tiles, int slot_elems,
                int trips, int passes) {
  constexpr bool SEEDED = MODE == COMPUTE || MODE == COMPUTE2 ||
                          MODE == OVERLAP_OUT || MODE == SERIAL_OUT ||
                          MODE == DMA_OUT;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[2], empty[2];

  const int tid = threadIdx.x, lane = tid % 32;
  const bool issuer = tid == 0;  // issues every copy
  const size_t chunk_elems = static_cast<size_t>(chunk_rows) * LANES;
  // this block's share of a chunk, in units of UNIT floats, and its tiles:
  // tile t is q units, one more for t < rem (all int: 4 units a row)
  const int units = chunk_rows * (LANES / UNIT);
  const int u0 = static_cast<int>(
      static_cast<long>(blockIdx.x) * units / gridDim.x);
  const int share = static_cast<int>(
      static_cast<long>(blockIdx.x + 1) * units / gridDim.x) - u0;
  const int q = share / tiles, rem = share % tiles;
  const bool owner = blockIdx.x == 0;  // its first tile holds rows 0-7
  const int steps_a_pass = num_chunks * tiles;
  auto slot = [&](int s) { return smem + s * slot_elems; };

  if (issuer) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (SEEDED) {
    for (int e = tid; e < slot_elems; e += THREADS) {
      slot(0)[e] = 0.25f;
      slot(1)[e] = 0.75f;
    }
    fence_proxy_async();  // visible to the bulk stores that read them
  }
  __syncthreads();

  float sink_acc = 0.f;
  // block 0: this thread's checksum elements tid + j * THREADS, held in
  // registers across chunks and passes and stored once at the end
  float part[CSUM_PER_THREAD] = {};

  // a step is (k, i, t): the k-th of the run, chunk i, tile t; its tile's
  // first element in the chunk and its length
  auto tile_off = [&](int t) {
    return static_cast<size_t>(u0 + t * q + min(t, rem)) * UNIT;
  };
  auto tile_len = [&](int t) { return (q + (t < rem)) * UNIT; };
  // the slot a step's data sits in: by step parity, or for the seeded
  // modes by chunk parity (the seed the chunk's chain starts from)
  auto data_slot = [&](int k, int i) { return SEEDED ? (i & 1) : (k & 1); };
  auto wait_full = [&](int k) { mbar_wait(&full[k & 1], (k >> 1) & 1); };
  auto wait_done = [&](int k) {  // every warp is done with step k
    if (k >= 0) mbar_wait(&empty[k & 1], (k >> 1) & 1);
  };
  auto arrive_done = [&](int k) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[k & 1]);
  };
  auto load = [&](int k, int i, int t) {  // issuer
    const uint32_t bytes = tile_len(t) * sizeof(float);
    mbar_expect_tx(&full[k & 1], bytes);
    bulk_load(slot(k & 1), x + i * chunk_elems + tile_off(t), bytes,
              &full[k & 1]);
  };
  auto store = [&](int k, int i, int t) {  // issuer
    bulk_store(written + i * chunk_elems + tile_off(t), slot(data_slot(k, i)),
               tile_len(t) * sizeof(float));
  };
  // the chain over tile t in slot s: CHAINS elements a thread side by
  // side; the first group of block 0's first tile feeds the checksum
  auto chain = [&](int t, int s, float add) {
    const int n = tile_len(t);
    const float* src = slot(s);
    const bool csum_tile = owner && t == 0;
    for (int e0 = tid; e0 < n; e0 += THREADS * CHAINS) {
      float a[CHAINS];
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        const int e = e0 + j * THREADS;
        a[j] = e < n ? src[e] : 0.f;
      }
      for (int r = 0; r < trips; ++r) {
#pragma unroll
        for (int u = 0; u < FMA_UNROLL; ++u)
#pragma unroll
          for (int j = 0; j < CHAINS; ++j) a[j] = fmaf(a[j], 0.9999999f, add);
      }
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) sink_acc += a[j];
      if (csum_tile && e0 == tid) {
#pragma unroll
        for (int j = 0; j < CSUM_PER_THREAD; ++j) part[j] += a[j];
      }
    }
  };
  auto sum_rows = [&](int k, int t) {  // pair modes: the copied-in rows 0-7
    if (owner && t == 0) {
#pragma unroll
      for (int j = 0; j < CSUM_PER_THREAD; ++j)
        part[j] += slot(k & 1)[tid + j * THREADS];
    }
  };

  for (int p = 0; p < passes; ++p) {
    const int k0 = p * steps_a_pass, kend = k0 + steps_a_pass;
    if ((MODE == OVERLAP || MODE == PAIR_OVERLAP) && issuer) {
      wait_done(k0 - 1);  // the previous pass is read: warm-up load
      load(k0, 0, 0);
    }
    int k = k0;
    for (int i = 0; i < num_chunks; ++i) {
      // the pass-derived salt keeps every pass's chain distinct
      const float salt =
          __fmul_rn(__int2float_rn(p * num_chunks + i), 1e-7f);
      const float add = __fadd_rn(0.5f, salt);
      for (int t = 0; t < tiles; ++t, ++k) {
        // the next step's chunk and tile
        const int ni = t + 1 < tiles ? i : i + 1;
        const int nt = t + 1 < tiles ? t + 1 : 0;
        if (MODE == OVERLAP) {
          if (issuer && k + 1 < kend) {
            wait_done(k - 1);  // step k + 1's slot is free
            load(k + 1, ni, nt);
          }
          wait_full(k);
          chain(t, k & 1, add);
          arrive_done(k);
        } else if (MODE == SERIAL) {
          if (issuer) {
            wait_done(k - 1);
            load(k, i, t);
          }
          wait_full(k);
          chain(t, k & 1, add);
          arrive_done(k);
        } else if (MODE == DMA) {
          if (issuer) {
            load(k, i, t);
            wait_full(k);
          }
        } else if (MODE == COMPUTE) {
          chain(t, i & 1, add);
        } else if (MODE == COMPUTE2) {
          chain(t, i & 1, add);
          chain(t, 1 - (i & 1), __fadd_rn(0.5f, __fadd_rn(salt, 0.5f)));
        } else if (MODE == OVERLAP_OUT) {
          if (issuer) {
            if (k - k0 >= 2) bulk_wait<1>();  // the writeback 2 steps back
            store(k, i, t);
          }
          chain(t, i & 1, add);
        } else if (MODE == SERIAL_OUT) {
          if (issuer) {
            wait_done(k - 1);
            store(k, i, t);
            bulk_wait<0>();
            mbar_arrive(&full[k & 1]);  // landed
          }
          wait_full(k);
          chain(t, i & 1, add);
          arrive_done(k);
        } else if (MODE == DMA_OUT) {
          if (issuer) {
            store(k, i, t);
            bulk_wait<0>();
          }
        } else if (MODE == PAIR_OVERLAP) {
          if (issuer) {
            if (k > k0) bulk_wait<0>();  // out-copy k - 1 left its slot
            if (k + 1 < kend) {
              wait_done(k - 1);
              load(k + 1, ni, nt);
            }
            wait_full(k);
            fence_proxy_async();
            store(k, i, t);
          }
          wait_full(k);
          sum_rows(k, t);
          arrive_done(k);
        } else {  // PAIR_SERIAL
          if (issuer) {
            wait_done(k - 1);
            load(k, i, t);
            wait_full(k);
            fence_proxy_async();
            store(k, i, t);
            bulk_wait<0>();
          }
          wait_full(k);
          sum_rows(k, t);
          arrive_done(k);
        }
      }
    }
    if ((MODE == OVERLAP_OUT || MODE == PAIR_OVERLAP) && issuer)
      bulk_wait<0>();  // drain the pass's last writebacks
  }
  if (issuer) bulk_wait<0>();
  sink[blockIdx.x * THREADS + tid] = sink_acc;
  if (owner)
#pragma unroll
    for (int j = 0; j < CSUM_PER_THREAD; ++j)
      csum[tid + j * THREADS] = part[j];
}

// the elements of one slot: the largest tile, the largest share over
// `tiles` rounded up; 0 when block 0's first tile cannot hold rows 0-7
// (the checksum)
int slot_elems_of(int chunk_rows, int blocks, int tiles) {
  const long units = static_cast<long>(chunk_rows) * (LANES / UNIT);
  const long share_max = (units + blocks - 1) / blocks;
  const long slot_units = (share_max + tiles - 1) / tiles;
  if (units / blocks / tiles * UNIT < CSUM) return 0;
  return static_cast<int>(slot_units * UNIT);
}

template <int MODE>
int launch(const float* x, float* written, float* csum, float* sink,
           int num_chunks, int chunk_rows, int blocks, int tiles, int trips,
           int passes, cudaStream_t stream) {
  // the step counts stay within int
  const int slot_elems = slot_elems_of(chunk_rows, blocks, tiles);
  if (slot_elems == 0 ||
      static_cast<long>(passes) * num_chunks * tiles >= (1L << 31))
    return -3;
  const int smem = 2 * slot_elems * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      pipeline_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_kernel<MODE><<<blocks, THREADS, smem, stream>>>(
      x, written, csum, sink, num_chunks, chunk_rows, tiles, slot_elems,
      trips, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: the index of the mode in pipeline.py's MODES; the grid: `blocks`
// blocks, each cutting its share of a chunk into `tiles` tiles
// (pipeline.py::pipeline_plan). `written` may be null for the modes that
// write nothing; `sink` holds one float per thread of the grid (blocks *
// 256). Returns cudaGetLastError() after the launch (0 = launched), -3 for
// a plan whose first tile cannot hold rows 0-7.
extern "C" int overlap_pipeline(const float* x, float* written, float* csum,
                                float* sink, int mode, int num_chunks,
                                int chunk_rows, int blocks, int tiles,
                                int trips, int passes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || tiles < 1) return -3;
#define HPCPAT_CASE(M)                                                      \
  case M:                                                                   \
    return launch<M>(x, written, csum, sink, num_chunks, chunk_rows,        \
                     blocks, tiles, trips, passes, st);
  switch (mode) {
    HPCPAT_CASE(OVERLAP)
    HPCPAT_CASE(SERIAL)
    HPCPAT_CASE(DMA)
    HPCPAT_CASE(COMPUTE)
    HPCPAT_CASE(COMPUTE2)
    HPCPAT_CASE(OVERLAP_OUT)
    HPCPAT_CASE(SERIAL_OUT)
    HPCPAT_CASE(DMA_OUT)
    HPCPAT_CASE(PAIR_OVERLAP)
    HPCPAT_CASE(PAIR_SERIAL)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HPCPAT_CASE
}

// the threads of one block, for the wrapper's sink size
extern "C" int overlap_pipeline_threads() { return THREADS; }

// the dynamic shared memory bytes the launcher requests for this plan
// (two slots; every mode the same), -3 as the launcher refuses the plan
extern "C" int overlap_pipeline_smem(int chunk_rows, int blocks, int tiles) {
  if (blocks < 1 || tiles < 1) return -3;
  const int slot_elems = slot_elems_of(chunk_rows, blocks, tiles);
  return slot_elems ? 2 * slot_elems * static_cast<int>(sizeof(float)) : -3;
}

// the shared memory of each mode's kernel (the dynamic bytes are the
// plan's two slots: set per call)
HPCPAT_SMEM_EXPORT(HPCPAT_SMEM_ROW(-1, pipeline_kernel<0>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<1>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<2>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<3>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<4>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<5>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<6>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<7>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<8>),
                   HPCPAT_SMEM_ROW(-1, pipeline_kernel<9>))
