"""The comm kernels on one card: kernel 12, the all-gather matmul, and
kernels 10 and 11, the permute and the allreduce (``csrc/fused_ring.cu``),
and kernel 13, the migration exchange (``csrc/migration_dma.cu``), each
against the same C entry points built from another checkout.

    python -m hpc_patterns_tpu_torch.bench_comm [--other DIR]

Each timed with CUDA events over back-to-back calls on inputs cycled past
the 50 MB L2, beside one PyTorch call that computes the same function
(the yardstick only) and the bound (the larger of the bytes over 3.35
TB/s and the operations over 67 TF/s f32):

- kernel 12 at the bench's shape, 4 ranks x (256 x 1024) @ (1024 x
  1024) f32, beside a batched f32 ``matmul``; with this tree's launch
  plan (tile, CTAs a rank, waves), its error over
  ``fused.allgather_matmul_tolerance`` and two calls' equal bits;
- kernel 13 at one array of a plane bundle, 2 pages x 8 x 256 x 128 bf16
  (1 MiB), at ``page_chunk`` 4 and 1, beside ``landing.copy_(x)``;
- kernels 10 and 11 at 2^25 f32 x 4 ranks (permute r^1, allreduce),
  beside ``index_select`` and ``sum(0)`` + expand, with each side's
  allreduce scratch and peak memory over one call from fresh scratch;
- the bench's collective keys for kernel 12 (``bench.py``'s protocol: best
  of a few host-clock calls, each ending in a synchronize):
  ``agmm_fused_ms``, ``agmm_collective_ms`` and ``allreduce_overlap_frac``.

With ``--other`` the other checkout's ``fused_ring.cu`` and
``migration_dma.cu`` are compiled with this tree's nvcc flags and called
the way that checkout's wrappers call them (its all-gather matmul tiles
from its ``allgather_matmul_config``, 64 x 64 before it had one; its
allreduce through ``fused_allreduce_fifo`` on this tree's plan where it
has one, else through ``fused_allreduce`` with receive slots per (phase,
step), 2 (W - 1) x a chunk a rank; its exchange through its cooperative
entry with a receiver CTA when it has one). Each of its outputs is held against the plain version first. The
timings run in turns — other, this, this, other. Prints one JSON line per
kernel, one for the bench keys, and the card's name and power limit.
Needs a card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.bench_flash import _device_ms, _other_lib
from hpc_patterns_tpu_torch.comm import fused, ring
from hpc_patterns_tpu_torch.comm import migration_dma as md

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
WORLD = 4
AGMM_SHAPE = (256, 1024, 1024)  # m, k, n per rank: bench.py's AGMM_SHAPE
RING_ELEMENTS = 1 << 25
# one array of a plane bundle (chip_smoke.py's MIGRATION_TIMED_PAGES x
# MIGRATION_PAGE, bf16)
MIGRATION_PAGES, MIGRATION_ROW = 2, 8 * 256 * 128
PAGE_CHUNKS = (md.PAGE_CHUNK, 1)
DETAIL_REPS = 10  # bench.py's COMM_REPS
# the parent exchange's receiver spin gives up after this long
OTHER_SPIN_TIMEOUT_NS = 1_000_000_000
_V, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint


def _n_sets(nbytes: int) -> int:
    return max(2, min(32, math.ceil(150e6 / nbytes)))


def _bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


class _OtherRing:
    """Another checkout's fused_ring entries, with scratch as its wrapper
    allocates it (fresh epochs; one geometry each)."""

    def __init__(self, lib):
        self.lib = lib
        lib.fused_ring_init.restype = _I
        lib.fused_ring_status.restype = _U
        lib.fused_ring_capacity.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.allgather_matmul.argtypes = [_V, _V, _V, _V, _V, _V, _U, _I, _I,
                                         _I, _I, _LL, _LL, _LL, _I, _LL, _V]
        self.fifo = hasattr(lib, "fused_allreduce_fifo")
        if self.fifo:
            lib.fused_allreduce_fifo.argtypes = [
                _V, _V, _V, _V, _V, _V, _U, _I, _I, _I, _I, _LL, _LL, _LL,
                _I, _I, _LL, _I, _V]
        else:
            lib.fused_allreduce.argtypes = [_V, _V, _V, _V, _V, _V, _V, _U,
                                            _I, _I, _I, _I, _LL, _LL, _LL,
                                            _I, _I, _LL, _I, _V]
        lib.fused_permute.argtypes = [_V, _V, _V, _V, _V, _U, _I, _LL, _I,
                                      _LL, _V]
        fused._build.check(lib.fused_ring_init(), "other fused_ring_init")
        try:
            cfg = (_I * 4)()
            lib.allgather_matmul_config(cfg)
            self.tile = (cfg[0], cfg[1])
        except AttributeError:  # the first kernel's 64 x 64 blocks
            self.tile = (64, 64)
        self.scratch, self.capacity = {}, {}

    def _per_rank(self, which: int, code: int, ranks: int) -> int:
        if which not in self.capacity:
            c = _I(0)
            fused._build.check(self.lib.fused_ring_capacity(
                which, code, ctypes.byref(c)), "other fused_ring_capacity")
            self.capacity[which] = c.value
        return self.capacity[which] // ranks

    def _scratch(self, key, make):
        s = self.scratch.get(key)
        if s is None:
            s = self.scratch[key] = dict(make(), epoch=0)
        s["epoch"] += 1
        return s

    def _stream(self):
        return torch.cuda.current_stream().cuda_stream

    def agmm(self, x, w):
        W, m, k = x.shape
        n = w.shape[2]
        tiles = -(-m // self.tile[0]) * -(-n // self.tile[1])
        G = max(1, min(self._per_rank(1, 0, W), tiles))
        s = self._scratch(("agmm", x.shape, w.shape, G), lambda: {
            "buf": torch.empty(W * (W - 1) * m * k, device=x.device),
            "counters": torch.zeros(W * (W - 1), dtype=torch.int32,
                                    device=x.device),
            "abort": torch.zeros(1, dtype=torch.int32, device=x.device)})
        out = torch.empty(W, W * m, n, device=x.device)
        fused._build.check(self.lib.allgather_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), s["buf"].data_ptr(),
            s["counters"].data_ptr(), s["abort"].data_ptr(), s["epoch"], 0,
            W, 1, W, m, k, n, G, fused.SPIN_TIMEOUT_NS, self._stream()),
            "other allgather_matmul")
        return out

    def allreduce(self, x):
        W = x.shape[0]
        m, n, cn, n_pad = fused.ring_layout(x.shape[1:], W, fused.CARD_LANE)
        xp = fused._pad_rows(x, m, n, n_pad)
        out = torch.empty_like(xp)
        if self.fifo:
            plan = fused.allreduce_plan(W, m * cn // 4,
                                        W * self._per_rank(0, 0, W))
            s = self._scratch(("allreduce", x.shape, plan),
                              lambda: fused.allreduce_scratch(plan,
                                                              x.device))
            rc = self.lib.fused_allreduce_fifo(
                xp.data_ptr(), None, out.data_ptr(), s["fifo"].data_ptr(),
                s["flags"].data_ptr(), s["abort"].data_ptr(), s["epoch"], 0,
                W, 1, W, m, cn, n_pad, plan.ctas_a_rank, 0,
                fused.SPIN_TIMEOUT_NS, W, self._stream())
        else:
            G = max(1, min(self._per_rank(0, 0, W),
                           -(-(m * cn // 4) // (4 * 256))))
            S = W - 1
            s = self._scratch(("allreduce", x.shape, G), lambda: {
                "rs": torch.empty(W * S * m * cn, device=x.device),
                "ag": torch.empty(W * S * m * cn, device=x.device),
                "flags": torch.zeros(W * G * 2 * S, dtype=torch.int32,
                                     device=x.device),
                "abort": torch.zeros(1, dtype=torch.int32,
                                     device=x.device)})
            rc = self.lib.fused_allreduce(
                xp.data_ptr(), None, out.data_ptr(), s["rs"].data_ptr(),
                s["ag"].data_ptr(), s["flags"].data_ptr(),
                s["abort"].data_ptr(), s["epoch"], 0, W, 1, W, m, cn, n_pad,
                G, 0, fused.SPIN_TIMEOUT_NS, W, self._stream())
        fused._build.check(rc, "other fused_allreduce")
        return out[..., :n].reshape(x.shape)

    def scratch_bytes(self, kind: str) -> int:
        return sum(t.numel() * t.element_size()
                   for key, s in self.scratch.items() if key[0] == kind
                   for t in s.values() if torch.is_tensor(t))

    def permute(self, x, dst):
        W = x.shape[0]
        ring.check_permutation(list(enumerate(dst)), W)
        row_bytes = x[0].numel() * x.element_size()
        G = max(1, min(self._per_rank(2, 0, W),
                       -(-row_bytes // (16 * 4 * 256))))
        s = self._scratch(("permute", tuple(dst), G), lambda: {
            "dst": torch.tensor(dst, dtype=torch.int32, device=x.device),
            "counters": torch.zeros(W, dtype=torch.int32, device=x.device),
            "abort": torch.zeros(1, dtype=torch.int32, device=x.device)})
        out = torch.empty_like(x)
        fused._build.check(self.lib.fused_permute(
            x.data_ptr(), out.data_ptr(), s["dst"].data_ptr(),
            s["counters"].data_ptr(), s["abort"].data_ptr(), s["epoch"], W,
            row_bytes, G, fused.SPIN_TIMEOUT_NS, self._stream()),
            "other fused_permute")
        return out

    def synchronize(self):
        torch.cuda.synchronize()
        if self.lib.fused_ring_status():
            raise RuntimeError("other fused ring kernel: a spin timed out")


class _OtherExchange:
    """Another checkout's migration exchange: the cooperative entry with a
    spinning receiver CTA (a checkout that exports ``migration_dma_init``)
    or the counter entry that this tree's wrapper calls."""

    def __init__(self, lib):
        self.lib = lib
        self.coop = hasattr(lib, "migration_dma_init")
        lib.migration_exchange.restype = _I
        if self.coop:
            lib.migration_dma_init.restype = _I
            lib.migration_dma_status.restype = _U
            lib.migration_dma_capacity.argtypes = [ctypes.POINTER(_I)]
            lib.migration_exchange.argtypes = [_V, _V, _V, _V, _U, _LL, _LL,
                                               _I, _I, _I, _LL, _V]
            md._build.check(lib.migration_dma_init(), "other init")
            c = _I(0)
            md._build.check(lib.migration_dma_capacity(ctypes.byref(c)),
                            "other migration_dma_capacity")
            self.capacity = c.value
        else:
            lib.migration_exchange.argtypes = [_V, _V, _V, _V, _U, _LL, _LL,
                                               _I, _I, _I, _I, _V]
        self.words = 1 << 12  # flags (or two counter sets) of any case here
        self.flags = self.word = None  # the word: abort, or landed count
        self.epoch = self.launched = 0

    def __call__(self, x, page_chunk):
        n_pages = x.shape[0]
        row_bytes = x.shape[1] * x.element_size()
        chunk_bytes = min(page_chunk, n_pages) * row_bytes
        chunks = -(-n_pages // page_chunk)
        if self.flags is None:
            self.flags = torch.zeros(2 * self.words, dtype=torch.int32,
                                     device=x.device)
            self.word = torch.zeros(1, dtype=torch.int32, device=x.device)
        self.epoch += 1
        landing = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        if self.coop:  # the parent's rule: 2 vectors a thread
            G = max(1, min(self.capacity - 1,
                           math.ceil(chunk_bytes / (16 * 256 * 2))))
            assert chunks * G <= 2 * self.words
            rc = self.lib.migration_exchange(
                x.data_ptr(), landing.data_ptr(), self.flags.data_ptr(),
                self.word.data_ptr(), self.epoch, n_pages, row_bytes,
                page_chunk, G, G, OTHER_SPIN_TIMEOUT_NS, stream)
        else:
            G = md._senders(x.device, chunk_bytes)
            rc = self.lib.migration_exchange(
                x.data_ptr(), landing.data_ptr(), self.flags.data_ptr(),
                self.word.data_ptr(), self.epoch, n_pages, row_bytes,
                page_chunk, self.words, G, G, stream)
        md._build.check(rc, "other migration_exchange")
        self.launched += 1
        return landing

    def synchronize(self):
        torch.cuda.synchronize()
        bad = (self.lib.migration_dma_status() if self.coop
               else int(self.word.item()) != self.launched)
        if bad:
            raise RuntimeError("other migration exchange did not land")


def _turns(fns: dict, sets) -> dict:
    """Each side's time of its call, in turns: other, this, this, other."""
    order = [w for w in ("other", "this") if w in fns]
    order += order[::-1]
    times = {w: [] for w in fns}
    for w in order:
        times[w].append(_device_ms(fns[w], sets))
    return times


def agmm_row(other) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = AGMM_SHAPE
    per = WORLD * (m * k + k * n) * 4
    sets = [(torch.randn(WORLD, m, k, generator=gen, device="cuda"),
             torch.randn(WORLD, k, n, generator=gen, device="cuda"))
            for _ in range(_n_sets(per))]
    x, w = sets[0]
    want = fused.allgather_matmul_reference(x, w)
    tol = fused.allgather_matmul_tolerance(x, w, want)
    fns = {"this": fused.allgather_matmul}
    if other is not None:
        fns["other"] = other.agmm
    over, equal = {}, {}
    for side, fn in fns.items():
        got, again = fn(x, w), fn(x, w)
        (other if side == "other" else fused).synchronize()
        over[side] = ((got - want).abs() / tol).max().item()
        equal[side] = torch.equal(got, again)
        if over[side] > 1 or not equal[side]:
            raise RuntimeError(f"allgather_matmul {side}: max err / bound "
                               f"{over[side]}, equal bits {equal[side]}")
    times = _turns(fns, sets)
    fused.synchronize()
    lib = _device_ms(lambda a, b: torch.matmul(a.reshape(1, WORLD * m, k),
                                               b), sets)
    flops = 2.0 * WORLD * (WORLD * m) * k * n
    bm, bn, G, waves = fused.agmm_plan(WORLD, m, n, fused._capacity(
        "allgather_matmul", 0))
    row = {"kernel": 12, "name": "allgather_matmul",
           "shape": {"ranks": WORLD, "m": m, "k": k, "n": n,
                     "dtype": "float32"},
           "ms": times, "library_ms": lib,
           "library": "matmul (batched, fp32)",
           "bound_ms": _bound_ms(per + WORLD * WORLD * m * n * 4, flops),
           "tflops": {s: flops / (min(t) * 1e-3) / 1e12
                      for s, t in times.items()},
           "max_err_over_bound": over, "equal_bits": equal,
           "launch_plan": {"tile": [bm, bn], "ctas_a_rank": G,
                           "ctas": WORLD * G, "waves": waves},
           "other_tile": list(other.tile) if other is not None else None}
    print(json.dumps(row), flush=True)
    return row


def migration_rows(other) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    nbytes = MIGRATION_PAGES * MIGRATION_ROW * 2
    sets = [(torch.randn(MIGRATION_PAGES, MIGRATION_ROW, generator=gen,
                         device="cuda").bfloat16(),)
            for _ in range(math.ceil(150e6 / nbytes))]
    landing = torch.empty_like(sets[0][0])
    lib = _device_ms(landing.copy_, sets)
    rows = []
    for chunk in PAGE_CHUNKS:
        fns = {"this": lambda v, c=chunk: md.migration_exchange(v, c)}
        if other is not None:
            fns["other"] = lambda v, c=chunk: other(v, c)
        for side, fn in fns.items():
            got = fn(*sets[0])
            (other if side == "other" else md).synchronize()
            if not torch.equal(got.view(torch.uint8),
                               sets[0][0].view(torch.uint8)):
                raise RuntimeError(f"migration_exchange {side}: bytes differ")
        times = _turns(fns, sets)
        md.synchronize()
        if other is not None:
            other.synchronize()
        row = {"kernel": 13, "name": "migration_exchange",
               "shape": {"n_pages": MIGRATION_PAGES, "row": MIGRATION_ROW,
                         "dtype": "bfloat16", "bytes": nbytes,
                         "page_chunk": chunk},
               "ms": times, "library_ms": lib, "library": "landing.copy_(x)",
               "bound_ms": _bound_ms(2.0 * nbytes, 0.0),
               "senders": md._senders(torch.device("cuda", 0),
                                      min(chunk, MIGRATION_PAGES)
                                      * MIGRATION_ROW * 2),
               "other_cooperative": other.coop if other is not None
               else None}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def ring_rows(other) -> list:
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = RING_ELEMENTS
    sets = [(torch.randn(WORLD, n, generator=gen, device="cuda"),)
            for _ in range(_n_sets(WORLD * n * 4))]
    pairs = [(r, r ^ 1) for r in range(WORLD)]
    dst = [r ^ 1 for r in range(WORLD)]
    src = torch.tensor(dst, device="cuda")
    cases = {
        11: ("fused_allreduce", fused.fused_allreduce,
             other.allreduce if other is not None else None,
             lambda v: fused.fused_allreduce_reference(
                 v, lane=fused.CARD_LANE),
             lambda v: v.sum(0, keepdim=True).expand_as(v).contiguous(),
             "sum(0).expand_as.contiguous"),
        10: ("fused_permute", lambda v: fused.fused_permute(v, pairs),
             (lambda v: other.permute(v, dst)) if other is not None else None,
             lambda v: fused.fused_permute_reference(v, pairs),
             lambda v: v.index_select(0, src), "index_select")}
    rows = []
    for kernel, (name, this, theirs, plain, library, lib_name) in \
            cases.items():
        fns = {"this": this}
        if theirs is not None:
            fns["other"] = theirs
        want = plain(sets[0][0])
        memory = {}
        for side, fn in fns.items():
            if kernel == 11:  # one call from fresh scratch
                (other.scratch if side == "other" else fused._scratch
                 ).clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            got = fn(sets[0][0])
            (other if side == "other" else fused).synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} {side}: != plain bitwise")
            if kernel == 11:
                memory[side] = {
                    "peak_over_inputs_bytes":
                        torch.cuda.max_memory_allocated() - held,
                    "scratch_bytes": (other.scratch_bytes("allreduce")
                                      if side == "other" else sum(
                                          t.numel() * t.element_size()
                                          for t in fused._scratch[
                                              "allreduce"].values()
                                          if torch.is_tensor(t)))}
            del got
        times = _turns(fns, sets)
        fused.synchronize()
        row = {"kernel": kernel, "name": name,
               "shape": {"ranks": WORLD, "elements_per_rank": n,
                         "dtype": "float32"},
               "ms": times, "library_ms": _device_ms(library, sets),
               "library": lib_name,
               "bound_ms": _bound_ms(2.0 * WORLD * n * 4, 0.0)}
        if kernel == 11:
            row["memory"] = memory
            row["plan"] = dataclasses.asdict(fused._scratch["allreduce"][
                "key"][-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def bench_detail(other) -> dict:
    """bench.py's allgather_matmul keys (``fused_collective_detail``'s
    protocol, ones inputs) for each side, in turns."""
    from hpc_patterns_tpu_torch.comm.communicator import Communicator

    comm = Communicator({"x": WORLD}, "x", device="cuda")
    m, k, n = AGMM_SHAPE
    x = torch.ones(WORLD, m, k, device="cuda")
    w = torch.ones(WORLD, k, n, device="cuda")

    def best_ms(fn, sync):
        fn(x, w)
        sync()
        best = float("inf")
        for _ in range(DETAIL_REPS):
            t0 = time.perf_counter()
            fn(x, w)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    sides = {"this": (lambda a, b: comm.allgather_matmul(a, b, "fused"),
                      comm.synchronize)}
    if other is not None:
        sides["other"] = (other.agmm, other.synchronize)
    order = [s for s in ("other", "this") if s in sides]
    detail = {s: [] for s in sides}
    for side in order + order[::-1]:
        fused_ms = best_ms(*sides[side])
        coll_ms = best_ms(lambda a, b: comm.allgather_matmul(
            a, b, "collective"), comm.synchronize)
        detail[side].append({
            "agmm_fused_ms": fused_ms, "agmm_collective_ms": coll_ms,
            "allreduce_overlap_frac": max(0.0, 1.0 - fused_ms / coll_ms)})
    row = {"bench_detail": detail}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout of the repository to compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_comm: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ring = exchange = None
    if args.other is not None:
        ring = _OtherRing(_other_lib(args.other, "fused_ring"))
        exchange = _OtherExchange(_other_lib(args.other, "migration_dma"))
    agmm_row(ring)
    migration_rows(exchange)
    ring_rows(ring)
    bench_detail(ring)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
