"""The overlap pipeline (kernel 14, ``csrc/overlap_pipeline.cu``) on one
card, every mode, against the same C entry point built from another
checkout.

    python -m hpc_patterns_tpu_torch.bench_pipeline [--other DIR]

At the kernel table's shape (``chip_smoke.py``'s ``PIPE_TIMED``: 16 chunks
of 2048 x 128 f32, trips 8, one pass; L2-resident) and at the overlap
bench's second shape (16 x 32768 x 128, 256 MiB, past the L2), each mode
of :data:`~hpc_patterns_tpu_torch.concurrency.pipeline.MODES` is timed with
CUDA events over back-to-back calls on inputs cycled past the 50 MB L2:
this tree's ``overlap_run`` and, with ``--other``, the other checkout's
``overlap_pipeline`` on its own grid (its ``pipeline_plan`` where it has
one, else its one-block-a-stripe ``default_stripe_rows``), in turns
(other, this, this, other). Each checksum and written array is held
against the plain version bit for bit first. Beside each: the bound
(bytes over 3.35 TB/s, the chain's FMAs over 67 TF/s f32; serial modes
the sum of the two, the others the larger) and, for the pair modes,
``copy_`` of the same bytes. Prints one JSON line per (shape, mode) and
the card's name and power limit. Needs a card: without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.concurrency import pipeline as pl
from hpc_patterns_tpu_torch.ops import _build

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# (chunks, chunk rows, trips, passes)
SHAPES = ((16, 2048, 8, 1), (16, 32768, 8, 1))
# copies a mode makes of each chunk, and whether it runs the chain (and
# how many): the bound's two legs
COPIES = {"overlap": 1, "serial": 1, "dma": 1, "compute": 0, "compute2": 0,
          "overlap_out": 1, "serial_out": 1, "dma_out": 1,
          "pair_overlap": 2, "pair_serial": 2}
CHAIN_LEGS = {"overlap": 1, "serial": 1, "compute": 1, "compute2": 2,
              "overlap_out": 1, "serial_out": 1}
SERIAL_MODES = ("serial", "serial_out")


def _other_pipeline(other: Path):
    """The other checkout's ``overlap_pipeline`` C entry (built with this
    tree's nvcc flags) and a function giving its grid arguments for
    chunks of R rows: ``(blocks, tiles)`` from its ``pipeline_plan``, or
    ``(stripe_rows,)`` from its ``default_stripe_rows``; and its threads
    a block."""
    pkg = other / "hpc_patterns_tpu_torch"
    src = pkg / "csrc" / "overlap_pipeline.cu"
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = _build.BUILD_DIR / f"libother_overlap_pipeline-{tag}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    spec = importlib.util.spec_from_file_location(
        "other_pipeline", pkg / "concurrency" / "pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if hasattr(mod, "pipeline_plan"):
        def grid(R, sms):
            return mod.pipeline_plan(R, sms)
    else:
        def grid(R, sms):
            return (mod.default_stripe_rows(R, sms),)
    fn = lib.overlap_pipeline
    fn.restype = ctypes.c_int
    return fn, grid, lib.overlap_pipeline_threads()


def _device_ms(fn, sets, n=30):
    for a in sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host enqueues all n calls first
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _rows(C, R, trips, passes, other):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(7)
    nbytes = C * R * 512
    n_sets = max(2, min(32, math.ceil(150e6 / nbytes)))
    sets = [(torch.rand(C, R, 128, generator=gen, device="cuda"),
             torch.empty(C, R, 128, device="cuda")) for _ in range(n_sets)]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    fns = {}
    for mode in pl.MODES:
        def this(x, out, m=mode):
            return pl.overlap_run(x, mode=m, tripcount=trips, passes=passes,
                                  out=out if m in pl.OUT_BUF_MODES else None)

        fns[mode] = {"this": this}
        if other is not None:
            o_fn, o_grid, o_threads = other
            g = o_grid(R, sms)
            blocks = g[0] if len(g) == 2 else -(-R // g[0])
            o_fn.argtypes = ([ctypes.c_void_p] * 4
                             + [ctypes.c_int] * (5 + len(g))
                             + [ctypes.c_void_p])

            def theirs(x, out, m=mode, g=g, blocks=blocks):
                csum = torch.empty(8, 128, device="cuda")
                sink = torch.empty(blocks * o_threads, device="cuda")
                _build.check(o_fn(x.data_ptr(), out.data_ptr(),
                                  csum.data_ptr(), sink.data_ptr(),
                                  pl.MODES.index(m), C, R, *g, trips, passes,
                                  stream()), f"other overlap_pipeline[{m}]")
                return csum

            fns[mode]["other"] = theirs
    rows = []
    for mode in pl.MODES:
        want, written = pl.overlap_run_reference(
            sets[0][0], mode=mode, tripcount=trips, passes=passes)
        for who, fn in fns[mode].items():
            out = sets[0][1].fill_(-1.0)
            got = fn(*sets[0])
            torch.cuda.synchronize()
            if not torch.equal(got, want) or (
                    written is not None and not torch.equal(out, written)):
                raise RuntimeError(f"overlap_pipeline {mode} {C}x{R} {who}: "
                                   "not the plain version's bits")
        order = (["other"] if other is not None else []) + ["this"]
        times = {who: [] for who in order}
        for who in order + order[::-1]:
            times[who].append(_device_ms(fns[mode][who], sets))
        t_copy = passes * COPIES[mode] * nbytes / HBM_BYTES_PER_S
        flops = (passes * CHAIN_LEGS.get(mode, 0) * C * R * 128 * 8 * trips
                 * 2.0)
        t_comp = flops / F32_FLOPS_PER_S
        bound = t_copy + t_comp if mode in SERIAL_MODES else max(t_copy,
                                                                  t_comp)
        lib = (_device_ms(lambda x, out: out.copy_(x), sets)
               if mode.startswith("pair") else None)
        row = {"kernel": "overlap_pipeline", "mode": mode,
               "shape": [C, R, 128], "trips": trips, "passes": passes,
               "launch_plan": dict(zip(("blocks", "tiles"),
                                       pl.pipeline_plan(R, sms))),
               "ms": times, "bound_ms": bound * 1e3,
               "bound_by": "bytes" if t_copy >= t_comp else "operations",
               "library_ms": lib, "library": "copy_" if lib else None,
               "input_sets": n_sets}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout of the repository to compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_pipeline: needs an NVIDIA card", file=sys.stderr)
        return 1
    other = _other_pipeline(args.other) if args.other is not None else None
    for shape in SHAPES:
        _rows(*shape, other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
