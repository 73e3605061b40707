"""On-card copy/compute overlap benchmark — the counterpart of
``hpc_patterns_tpu/concurrency/pipeline.py``.

The reference's concurrency suite asks whether independent copy and
compute commands overlap on one device (sycl_con.cpp:84-115). This
module runs the whole experiment as ONE kernel (``csrc/
overlap_pipeline.cu``): global-memory <-> shared-memory bulk copies on
the TMA engine against the busy-wait FMA chain on the SMs, so the
overlap is measured inside the kernel, free of launch latency.

Modes, all walking the same chunks of ``x`` (num_chunks, rows, 128):

in-direction (global -> shared ≙ M2D) vs compute:
- ``overlap``  — double-buffered: the copy of chunk i+1 flies while the
  chain runs on chunk i (the out-of-order-queue analog)
- ``serial``   — copy chunk i, wait, compute chunk i (sycl_con.cpp:101-106)
- ``dma``      — copies only (per-command baseline for M2D)
- ``compute``  — chain only (per-command baseline for C)
- ``compute2`` — two chains per chunk (the C+C pair)

out-direction (shared -> global ≙ D2M) vs compute:
- ``overlap_out`` — write chunk i back while its chain runs; wait only for
  the slot's writeback from two chunks back
- ``serial_out``  — write back, wait, compute
- ``dma_out``     — writebacks only (per-command baseline for D2M)

copy vs copy (≙ M2D + D2M):
- ``pair_overlap`` / ``pair_serial`` — a copy-through of every chunk,
  pipelined across chunks or one copy at a time.

Each returns the (8, 128) checksum: the chain results of rows 0-7 of
every chunk (pair modes: the copied-in rows), summed pass by pass and
chunk by chunk. The compute, compute2 and out modes run the chain on
slots seeded with 0.25 / 0.75 (the JAX kernel seeds the out modes so,
and leaves compute/compute2 on undefined scratch). ``tripcount`` and
``passes`` are runtime arguments.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hpc_patterns_tpu_torch.concurrency.kernels import (
    FMA_UNROLL,
    MUL,
    fma_f32,
)
from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.topology import resolve_device

MODES = (
    "overlap", "serial", "dma", "compute", "compute2",
    "overlap_out", "serial_out", "dma_out",
    "pair_overlap", "pair_serial",
)
OUT_BUF_MODES = ("overlap_out", "serial_out", "dma_out",
                 "pair_overlap", "pair_serial")
#: the values the compute and out modes seed their two slots with
SEEDS = (0.25, 0.75)
#: the largest tile a block copies at once: two slots of 112 KiB fit in
#: the 227 KiB of shared memory one block may use
SLOT_BYTES_MAX = 112 * 1024
#: the granule of a block's share of a chunk: 32 floats (128 bytes)
UNIT_BYTES = 128

#: kernel launches in this process (the main-path witness)
launches = 0


def _add(p: int, num_chunks: int, i: int, extra: bool = False) -> float:
    """The chain's addend for pass ``p``, chunk ``i``: 0.5 + a salt that
    keeps every pass's chain distinct, in float32 with the kernel's
    roundings (``extra``: compute2's second chain, salt + 0.5)."""
    salt = np.float32(p * num_chunks + i) * np.float32(1e-7)
    if extra:
        salt = salt + np.float32(0.5)
    return float(np.float32(0.5) + salt)


def _chain(a: torch.Tensor, trips: int, add) -> torch.Tensor:
    for _ in range(trips * FMA_UNROLL):
        a = fma_f32(a, MUL, add)
    return a


def _check(x, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if x.ndim != 3 or x.shape[2] != 128 or x.shape[1] % 8:
        raise ValueError(
            f"want (num_chunks, 8k rows, 128) float32, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"want float32, got {x.dtype}")
    if x.shape[0] < 2 and mode == "overlap_out":
        raise ValueError("overlap_out needs >= 2 chunks")


def overlap_run_reference(x: torch.Tensor, *, mode: str, tripcount: int = 64,
                          passes: int = 1):
    """The plain version: ``(checksum, written)``, where ``written`` is
    the (num_chunks, rows, 128) array the out and pair modes write (None
    for the others). Only rows 0-7 of a chunk reach the checksum, and
    the chains are independent, so they run on those rows alone, all
    chunks of a pass at once; the checksum is then summed chunk by chunk
    in float32, the kernel's order."""
    _check(x, mode)
    C, R, _ = x.shape
    trips = int(tripcount)
    dev = x.device
    # (C, 8, 128): slot i % 2's seed for chunk i, and the other slot's
    parity = (torch.arange(C, device=dev) % 2).view(C, 1, 1)
    seeded = torch.where(parity == 0, SEEDS[0], SEEDS[1]).expand(C, 8, 128)
    other = torch.where(parity == 0, SEEDS[1], SEEDS[0]).expand(C, 8, 128)
    seeded, other = seeded.float(), other.float()

    def adds(p, extra=False):
        return torch.tensor([_add(p, C, i, extra) for i in range(C)],
                            dtype=torch.float64, device=dev).view(C, 1, 1)

    csum = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    for p in range(int(passes)):
        if mode in ("overlap", "serial"):
            parts = [_chain(x[:, :8], trips, adds(p))]
        elif mode in ("compute", "overlap_out", "serial_out"):
            parts = [_chain(seeded, trips, adds(p))]
        elif mode == "compute2":
            parts = [_chain(seeded, trips, adds(p)),
                     _chain(other, trips, adds(p, extra=True))]
        elif mode in ("pair_overlap", "pair_serial"):
            parts = [x[:, :8]]
        else:  # dma, dma_out: no chain, zeros
            break
        for i in range(C):
            for part in parts:
                csum = csum + part[i]
    written = None
    if mode in ("overlap_out", "serial_out", "dma_out"):
        written = torch.empty_like(x)
        written[0::2] = SEEDS[0]
        written[1::2] = SEEDS[1]
    elif mode in ("pair_overlap", "pair_serial"):
        written = x.clone()
    if written is not None and passes < 1:
        written = torch.zeros_like(x)
    return csum, written


def pipeline_plan(chunk_rows: int, sms: int = 132) -> tuple[int, int]:
    """``(blocks, tiles)`` of the kernel's grid for chunks of
    ``chunk_rows`` rows of 128 f32: one block an SM (fewer when a chunk
    has fewer than 8 rows a block), each owning an equal share of every
    chunk (in :data:`UNIT_BYTES` granules, shares differing by at most
    one), cut into ``tiles`` tiles so that a tile fits a slot of
    :data:`SLOT_BYTES_MAX`. Block 0's first tile always holds rows 0-7."""
    units = chunk_rows * 512 // UNIT_BYTES
    blocks = max(1, min(sms, chunk_rows // 8))
    share = -(-units // blocks)
    return blocks, -(-share * UNIT_BYTES // SLOT_BYTES_MAX)


def overlap_run(x: torch.Tensor, *, mode: str, tripcount: int = 64,
                passes: int = 1, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Run one mode over ``x`` (num_chunks, rows, 128) float32; returns
    the (8, 128) checksum. The out and pair modes write their array into
    ``out`` when it is given (else into scratch). CUDA: the Hopper kernel
    on the grid of :func:`pipeline_plan`; CPU:
    :func:`overlap_run_reference`."""
    global launches
    _check(x, mode)
    trips, passes = int(tripcount), int(passes)
    if trips < 0 or passes < 0:
        raise ValueError("tripcount and passes must be >= 0")
    C, R, _ = x.shape
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("out must match x in shape, dtype and device")
    if x.device.type == "cpu":
        csum, written = overlap_run_reference(x, mode=mode, tripcount=trips,
                                              passes=passes)
        if out is not None and written is not None:
            out.copy_(written)
        return csum
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("out", out)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    blocks, tiles = pipeline_plan(
        R, torch.cuda.get_device_properties(x.device).multi_processor_count)
    lib = _build.load("overlap_pipeline")
    fn = lib.overlap_pipeline
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    threads = lib.overlap_pipeline_threads()
    if mode in OUT_BUF_MODES and out is None:
        out = torch.empty_like(x)
    csum = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    sink = torch.empty(blocks * threads, dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr() if out is not None else None,
                csum.data_ptr(), sink.data_ptr(), MODES.index(mode), C, R,
                blocks, tiles, trips, passes, stream)
    _build.check(rc, f"overlap_pipeline[{mode}]")
    launches += 1
    return csum


def make_hbm_array(num_chunks: int = 64, chunk_rows: int = 512,
                   seed: int = 0, device=None) -> torch.Tensor:
    """The working set: (num_chunks, chunk_rows, 128) float32 in [0, 1)
    (so the chain stays bounded), drawn from a seeded generator on the
    device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((num_chunks, chunk_rows, 128), generator=gen,
                      dtype=torch.float32, device=dev)


def per_pass_seconds(x, mode: str, tripcount: int, *, cal_passes: int = 1000,
                     repetitions: int = 3, target_s: float = 1.0,
                     max_passes: int = 120_000) -> float:
    """Steady-state seconds per pass of ``mode``: a differenced
    calibration pair sizes the measurement to ~``target_s`` of device
    time, then :func:`~hpc_patterns_tpu_torch.harness.timing.
    amortized_seconds` differences two pass counts, so launch and
    readback latency divide out. Shared by the bench and the concurrency
    app's on-card engine."""
    from hpc_patterns_tpu_torch.harness.timing import (
        amortized_seconds,
        measure_forced,
    )

    def run(p):
        return overlap_run(x, mode=mode, tripcount=tripcount, passes=p)

    t_two = measure_forced(lambda: run(2 * cal_passes), repetitions=1).min_s
    t_one = measure_forced(lambda: run(cal_passes), repetitions=1).min_s
    est = (t_two - t_one) / cal_passes
    if est <= 0:
        # noise ate the difference; the latency-biased single-call
        # estimate only shrinks the pass count, never the reading
        est = max(t_two / (2 * cal_passes), 1e-7)
    hi = int(min(max(target_s / est, 2 * cal_passes), max_passes))
    return amortized_seconds(run, iters=hi, repetitions=repetitions,
                             base_iters=hi // 2)


def balance_tripcount(per_pass, copy_time_s, compute_mode, trips, *,
                      max_trips=4096, rounds=2):
    """Refine ``trips`` until the chain's per-pass time matches
    ``copy_time_s`` (the balance step of sycl_con.cpp:257-268, iterated
    because one probe's noise would leave the commands unbalanced).
    Returns ``(trips, t_compute)`` measured with ``per_pass(mode,
    trips)``."""
    t_comp = per_pass(compute_mode, trips)
    for _ in range(rounds):
        if t_comp <= 0 or copy_time_s <= 0:
            break
        new_trips = min(max(1, int(trips * copy_time_s / t_comp)), max_trips)
        if abs(new_trips - trips) <= max(2, trips // 10):
            break
        trips = new_trips
        t_comp = per_pass(compute_mode, trips)
    return trips, t_comp
