"""Headline benchmark of the port: on-card copy/compute overlap speedup —
the counterpart of the repository's ``bench.py``.

The reference's headline claim is copy/kernel overlap on one device
(concurency/sycl_con.cpp). Measured here: the double-buffered pipeline
of ``concurrency/pipeline.py`` (the bulk copy of chunk i+1 in flight
while the FMA chain runs on chunk i) against the serialized
wait-then-compute walk of the same work, in one kernel each.

Protocol, as ``bench.py``'s:
- per-pass times by completion-forced differencing
  (``pipeline.per_pass_seconds``), so launch and readback latency cancel;
- the tripcount balanced so compute per pass ≈ copy per pass
  (sycl_con.cpp:257-268's balance step);
- five (serial, overlap) pairs measured back to back; the median ratio
  is the value;
- the reference's rule: PASS iff speedup > theoretical / 1.3
  (sycl_con.cpp:279-296); ``vs_baseline`` = speedup / (theoretical/1.3).

Prints ONE JSON line:
  {"metric": "onchip_overlap_speedup", "value": <speedup>, "unit": "x",
   "vs_baseline": <...>, "detail": {...}}

The detail also carries the collective keys of the JAX bench's
``_fused_collective_detail`` (:func:`fused_collective_detail`), measured
over ``COMM_WORLD`` logical ranks on the card.

    python -m hpc_patterns_tpu_torch.bench                 # 16 x 2048 x 128
    python -m hpc_patterns_tpu_torch.bench --chunk-rows 32768   # past L2
    python -m hpc_patterns_tpu_torch.bench --device cpu    # 4 x 8 x 128
    python -m hpc_patterns_tpu_torch.bench --gate build/bench_rounds
    python -m hpc_patterns_tpu_torch.bench --target-s 0.1 --cal-passes 200

``--target-s``/``--cal-passes`` shorten each per-pass measurement and
its calibration (recorded in the line's detail).

``--gate [DIR]`` (the JAX bench's ``--gate``): capture as usual, write
the line as the next round ``BENCH_rNN.json`` under DIR (default
``build/bench_rounds``; never the repository root, whose
``BENCH_r*.json`` are the JAX package's) in the round schema ``{"n",
"cmd", "rc", "tail", "parsed"}``, then run the regression gate
(``harness/regress.py``) over DIR's rounds and exit with its status.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.concurrency import pipeline
from hpc_patterns_tpu_torch.harness.verdict import TOLERANCE, concurrency_verdict
from hpc_patterns_tpu_torch.topology import resolve_device

# the JAX bench's shape: 16 x (2048, 128) f32 = 16 MiB
NUM_CHUNKS = 16
CHUNK_ROWS = 2048
# the plain version on the CPU walks the chain in float64 tensor ops:
# the CPU run keeps the JAX bench's interpreter shape and only rehearses
# the protocol, with a short calibration and measurement
CPU_CHUNKS, CPU_CHUNK_ROWS, CPU_CAL_PASSES, CPU_TARGET_S = 4, 8, 2, 1e-3
# the CPU rehearsal's floor on a per-pass reading: the plain ``dma`` mode
# costs almost nothing per pass there, so its differenced time can clamp
# to 0 and leave the protocol with no pairs; a reading below the floor
# counts as the floor. The card has none: a zero there stays degenerate.
CPU_MIN_PASS_S = 1e-7
PROBE_TRIPS = 64
MAX_TRIPS = 4096
CAL_PASSES = 1000
TARGET_S = 1.0
PAIRS = 5
# the collective keys: 4 logical ranks (the reference CTest's -np 4),
# 2^20 f32 per rank, allgather_matmul at the JAX chip shape per rank; the
# CPU rehearsal keeps the JAX CPU smoke's sizes
COMM_WORLD = 4
COMM_ELEMENTS, CPU_COMM_ELEMENTS = 1 << 20, 1 << 11
AGMM_SHAPE, CPU_AGMM_SHAPE = (256, 1024, 1024), (4, 32, 16)
COMM_REPS, CPU_COMM_REPS = 10, 3


def overlap_headline(x: torch.Tensor, *, cal_passes: int = CAL_PASSES,
                     target_s: float = TARGET_S) -> dict:
    """The protocol over ``x``: the copy and compute probes, the balanced
    tripcount, :data:`PAIRS` (serial, overlap) pairs and the median ratio.
    Returns the headline record (see the module docstring)."""

    floor = CPU_MIN_PASS_S if x.device.type == "cpu" else 0.0

    def per_pass(mode, trips):
        return max(floor, pipeline.per_pass_seconds(x, mode, trips,
                                                    cal_passes=cal_passes,
                                                    target_s=target_s))

    t_dma = per_pass("dma", PROBE_TRIPS)
    t_probe = per_pass("compute", PROBE_TRIPS)
    trips, t_comp, raw = 0, 0.0, []
    t_serial = t_overlap = 0.0
    if t_dma > 0 and t_probe > 0:
        trips = min(max(1, int(PROBE_TRIPS * t_dma / t_probe)), MAX_TRIPS)
        trips, t_comp = pipeline.balance_tripcount(
            per_pass, t_dma, "compute", trips, max_trips=MAX_TRIPS)
        # the two legs of a ratio are measured back to back; the median
        # ratio cannot be inflated by one lucky draw
        raw = [(per_pass("serial", trips), per_pass("overlap", trips))
               for _ in range(PAIRS)]
        good = sorted((p for p in raw if min(p) > 0),
                      key=lambda p: p[0] / p[1])
        if good:
            t_serial, t_overlap = good[len(good) // 2]
    degenerate = min(t_overlap, t_serial, t_dma, t_comp) <= 0
    if degenerate:  # report "measured nothing", never a pass
        speedup = theoretical = vs_baseline = 0.0
        verdict = None
    else:
        speedup = t_serial / t_overlap
        theoretical = (t_dma + t_comp) / max(t_dma, t_comp)
        vs_baseline = speedup / (theoretical / TOLERANCE)
        # the reference's rule over its "best serial" (the per-command
        # sum, sycl_con.cpp:117-119), as the concurrency app applies it
        verdict = concurrency_verdict([t_dma, t_comp], t_overlap,
                                      rule="sycl",
                                      resources=["hbm", "core"])
    nbytes = x.numel() * x.element_size()
    detail = {
        "t_dma_us": t_dma * 1e6,
        "t_compute_us": t_comp * 1e6,
        "t_serial_us": t_serial * 1e6,
        "t_overlap_us": t_overlap * 1e6,
        "dma_gbps": nbytes / t_dma / 1e9 if t_dma > 0 else None,
        "theoretical_max_speedup": theoretical,
        "tripcount": trips,
        "degenerate": degenerate,
        "verdict": verdict.summary_line() if verdict else "FAILURE",
        "backend": x.device.type,
        "shape": list(x.shape),
        "working_set_bytes": nbytes,
        "pairs_us": [[s * 1e6, o * 1e6] for s, o in raw],
        "cal_passes": cal_passes,
        "target_s": target_s,
    }
    if x.device.type == "cuda":
        props = torch.cuda.get_device_properties(x.device)
        l2 = getattr(props, "L2_cache_size", 50 * 10**6)
        detail.update(device=torch.cuda.get_device_name(x.device),
                      l2_bytes=l2, fits_in_l2=nbytes <= l2)
    return {"metric": "onchip_overlap_speedup", "value": speedup,
            "unit": "x", "vs_baseline": vs_baseline, "detail": detail}


def fused_collective_detail(device) -> dict:
    """The JAX bench's collective keys (bench.py:84-157) over
    :data:`COMM_WORLD` logical ranks:

    - ``fused_allreduce_gbps``: ring-normalized bus bandwidth of
      ``Communicator.allreduce(algorithm="fused")`` — the ring inside one
      kernel;
    - ``allreduce_busbw_gbps``: the same on ``algorithm="collective"``
      (one PyTorch reduction over the ranks);
    - ``allreduce_gbps_by_algorithm``: fused, collective, ring_chunked;
    - ``allreduce_overlap_frac``: 1 - t(fused allgather_matmul) /
      t(collective gather-then-matmul), clamped at 0.

    Each time is the best of a few calls, each ending in a synchronize.
    On one card the ring's "wire" is device memory."""
    from hpc_patterns_tpu_torch.comm.communicator import Communicator

    cpu = device.type == "cpu"
    n = CPU_COMM_ELEMENTS if cpu else COMM_ELEMENTS
    reps = CPU_COMM_REPS if cpu else COMM_REPS
    comm = Communicator({"x": COMM_WORLD}, "x", device=device)

    def best_seconds(fn, *args):
        fn(*args)  # build and warm outside the timing
        comm.synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            comm.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    x = comm.shard(torch.ones(comm.size, n, device=device))
    nbytes = n * x.element_size()
    gbps = {}
    for alg in ("fused", "collective", "ring_chunked"):
        t = best_seconds(comm.jit_allreduce(x, alg), x)
        gbps[alg] = 2 * nbytes * (comm.size - 1) / comm.size / t / 1e9
    m, k, n_w = CPU_AGMM_SHAPE if cpu else AGMM_SHAPE
    xa = torch.ones(comm.size, m, k, device=device)
    w = torch.ones(comm.size, k, n_w, device=device)
    t_fused = best_seconds(lambda a, b: comm.allgather_matmul(a, b, "fused"),
                           xa, w)
    t_host = best_seconds(
        lambda a, b: comm.allgather_matmul(a, b, "collective"), xa, w)
    return {
        "fused_allreduce_gbps": gbps["fused"],
        "allreduce_busbw_gbps": gbps["collective"],
        "allreduce_overlap_frac": max(0.0, 1.0 - t_fused / t_host),
        "allreduce_gbps_by_algorithm": gbps,
        "comm_world": comm.size,
        "comm_elements_per_rank": n,
        "agmm_shape_per_rank": [m, k, n_w],
        "agmm_fused_ms": t_fused * 1e3,
        "agmm_collective_ms": t_host * 1e3,
    }


#: the repository root (the JAX package's checked-in rounds live here)
REPO_ROOT = Path(__file__).resolve().parent.parent
DEFAULT_GATE_DIR = REPO_ROOT / "build" / "bench_rounds"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--chunks", type=int, default=None,
                   help=f"chunks (default {NUM_CHUNKS}; {CPU_CHUNKS} on cpu)")
    p.add_argument("--chunk-rows", type=int, default=None,
                   help=f"rows of 128 f32 per chunk (default {CHUNK_ROWS}; "
                        f"{CPU_CHUNK_ROWS} on cpu)")
    p.add_argument("--target-s", type=float, default=None,
                   help=f"seconds a per-pass measurement aims at (default "
                        f"{TARGET_S}; {CPU_TARGET_S} on cpu)")
    p.add_argument("--cal-passes", type=int, default=None,
                   help=f"calibration passes (default {CAL_PASSES}; "
                        f"{CPU_CAL_PASSES} on cpu)")
    p.add_argument("--gate", nargs="?", const=str(DEFAULT_GATE_DIR),
                   default=None, metavar="DIR",
                   help="write the line as the next round under DIR "
                        "(default build/bench_rounds), then gate DIR's "
                        "rounds with harness/regress.py and exit with its "
                        "status")
    return p


def gate(line: str, rounds_dir, *, argv=()) -> int:
    """Write ``line`` (the bench's JSON line, or an error text) as the
    next ``BENCH_rNN.json`` round under ``rounds_dir``, then run the
    regression gate over every round there. Returns the gate's exit
    status (1 as well when the capture parsed to nothing)."""
    from hpc_patterns_tpu_torch.harness import regress

    d = Path(rounds_dir).resolve()
    if d == REPO_ROOT:
        raise SystemExit("--gate: the repository root holds the JAX "
                         "package's BENCH_r*.json rounds; name another "
                         "directory")
    d.mkdir(parents=True, exist_ok=True)
    prior = sorted(d.glob("BENCH_r*.json"))
    n = 0
    for path in prior:
        try:
            n = max(n, int(json.loads(path.read_text()).get("n", 0)))
        except (OSError, ValueError, AttributeError):
            continue
    n += 1
    try:
        parsed = json.loads(line)
    except ValueError:
        parsed = None
    out = d / f"BENCH_r{n:02d}.json"
    out.write_text(json.dumps(
        {"n": n, "cmd": " ".join(["python -m hpc_patterns_tpu_torch.bench",
                                  *argv]),
         "rc": 0 if parsed is not None else 1, "tail": line + "\n",
         "parsed": parsed}, indent=2))
    print(f"wrote round {n} -> {out}", flush=True)
    rc = regress.main([*map(str, prior), str(out)])
    return rc if parsed is not None else max(rc, 1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
        cpu = dev.type == "cpu"
        chunks = args.chunks or (CPU_CHUNKS if cpu else NUM_CHUNKS)
        rows = args.chunk_rows or (CPU_CHUNK_ROWS if cpu else CHUNK_ROWS)
        x = pipeline.make_hbm_array(chunks, rows, device=dev)
        rec = overlap_headline(
            x, cal_passes=args.cal_passes or (CPU_CAL_PASSES if cpu
                                              else CAL_PASSES),
            target_s=args.target_s or (CPU_TARGET_S if cpu else TARGET_S))
        rec["detail"].update(fused_collective_detail(dev))
        line = json.dumps(rec)
    except Exception as e:
        if args.gate is None:
            raise
        # a failed capture is a round that measured nothing: recorded
        # and skipped by the gate, and the exit status says it failed
        traceback.print_exc()
        line = f"{type(e).__name__}: {e}"
    print(line, flush=True)
    if args.gate is not None:
        return gate(line, args.gate, argv=argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
