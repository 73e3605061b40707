"""Shared app scaffolding — the counterpart of
``hpc_patterns_tpu/apps/common.py``: the instrumented session every app
runs through, the communicator an app runs over and its reporting
units.

The port runs every rank of a communicator in one process on one card
(logical ranks, see :mod:`hpc_patterns_tpu_torch.comm`), so the
cross-process reductions of the JAX module are the identity here.
"""

from __future__ import annotations

import os
from typing import Callable

from hpc_patterns_tpu_torch.comm.communicator import Communicator

def run_instrumented(run_fn: Callable[[object], int], args) -> int:
    """The shared ``--metrics``/``--trace`` session every app ``main()``
    runs through: install a fresh process-wide metrics registry AND
    flight recorder from the flags (both no-ops without their flag), run
    the app, and on ANY exit path append the closing snapshot records to
    ``--log``: one ``kind=metrics`` (``python -m hpc_patterns_tpu_torch.
    harness.report``) and one ``kind=trace`` (``python -m
    hpc_patterns_tpu_torch.harness.trace``). Appending keeps the app's
    own records. With ``HPCPAT_TRACE_DIR`` set, a traced run also writes
    its recorder snapshot there as ``rank<id>.trace.json`` — the same
    snapshot as the log record."""
    from hpc_patterns_tpu_torch.harness import metrics, trace
    from hpc_patterns_tpu_torch.harness.runlog import RunLog

    m = metrics.configure(enabled=getattr(args, "metrics", False))
    trace_kw = {}
    if getattr(args, "trace_capacity", None):
        trace_kw["capacity"] = args.trace_capacity
    rec = trace.configure(enabled=getattr(args, "trace", False),
                          **trace_kw)
    try:
        return run_fn(args)
    finally:
        trace_dir = os.environ.get(trace.ENV_TRACE_DIR)
        rec_snap = (rec.snapshot()
                    if rec.enabled and (getattr(args, "log", None)
                                        or trace_dir) else None)
        if getattr(args, "log", None) and (m.enabled or rec.enabled):
            log = RunLog(args.log, truncate=False)
            if m.enabled:
                log.emit(kind="metrics", **m.snapshot())
            if rec.enabled:
                log.emit(kind="trace", **rec_snap)
        if rec.enabled and trace_dir:
            trace.write_rank_snapshot(rec, trace_dir, snapshot=rec_snap)


#: ranks when the app is not told (``--world -1``): the reference CTest's
#: ``mpirun -np 4``
DEFAULT_WORLD = 4


def make_communicator(device, world: int = -1, *, even: bool = False,
                      axis: str = "x") -> Communicator:
    """The app's communicator: ``world`` logical ranks on a 1-D mesh
    (``-1``: :data:`DEFAULT_WORLD`) on ``device`` (``cuda`` unless
    ``"cpu"``). ``even=True`` reproduces the reference's even-rank-count
    precondition (allreduce-mpi-sycl.cpp:95-97) by dropping one rank from
    an odd world."""
    if world == -1:
        world = DEFAULT_WORLD
    if world < 1:
        raise ValueError(f"world must be >= 1 or -1, got {world}")
    if even and world % 2 and world > 1:
        world -= 1
    return Communicator({axis: world}, axis, device=device)


def allreduce_bus_bandwidth_gbps(nbytes: int, seconds: float,
                                 world: int) -> float:
    """Bus bandwidth for an allreduce: algbw · 2(size−1)/size, the
    ring-limit normalization that makes world sizes comparable (the
    BASELINE.json "allreduce GB/s" metric); 0 for world=1."""
    if seconds <= 0:
        return float("inf")
    return (nbytes / seconds / 1e9) * (2 * (world - 1) / world)


def local_rows(global_tensor) -> list:
    """``(rank, row)`` pairs this process can address: every row, since
    all ranks live in this process."""
    return list(enumerate(global_tensor))


def supports_memory_kind(kind: str) -> bool:
    """Whether the device advertises the given memory kind. Delegates to
    the single probe home (``memory/kinds.py``)."""
    from hpc_patterns_tpu_torch.memory import kinds as kindslib

    return kindslib.supports_memory_kind(kind)


def all_processes_agree(ok: bool) -> bool:
    """Cross-process AND of a local verdict: the identity in one
    process."""
    return bool(ok)
