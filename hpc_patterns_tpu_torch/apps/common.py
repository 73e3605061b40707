"""Shared app scaffolding — the counterpart of
``hpc_patterns_tpu/apps/common.py``: the instrumented session every app
runs through, the communicator an app runs over and its reporting
units.

A communicator's ranks are logical (:mod:`hpc_patterns_tpu_torch.comm`).
Run alone, an app holds every rank in its process; under the launcher
(``apps/launch.py``, the ``mpirun -np`` analog) each process joins a gloo
process group and holds a block of consecutive ranks, and the
cross-process reductions below run through that group (the identity in
one process). torch loads with the communicator's functions, not with
this module: the serving plane's stub replicas run without it.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Callable

from hpc_patterns_tpu_torch import topology

if TYPE_CHECKING:
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
    """The app's communicator: ``world`` logical ranks on a 1-D mesh on
    ``device`` (``cuda`` unless ``"cpu"``). ``even=True`` reproduces the
    reference's even-rank-count precondition (allreduce-mpi-sycl.cpp:
    95-97) by dropping one rank from an odd world.

    Joins a launcher rendezvous first when one is in the environment
    (:func:`topology.init_distributed_from_env`, the MPI_Init analog).
    Under the launcher ``world=-1`` is processes x the ranks each holds
    (``HPCPAT_LOCAL_RANKS``), an explicit world divides over the
    processes, and this process holds its block of consecutive ranks; a
    traced run then takes a barrier and records a sync anchor after it
    (:func:`trace.mark_rendezvous`) for the cross-rank merge. Alone,
    ``world=-1`` is :data:`DEFAULT_WORLD`."""
    from hpc_patterns_tpu_torch.comm import processes
    from hpc_patterns_tpu_torch.comm.communicator import Communicator
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    topology.init_distributed_from_env()
    nprocs = topology.process_env_info()[1] if topology.is_multihost() \
        else 1
    if world == -1:
        world = (nprocs * topology.local_ranks_from_env() if nprocs > 1
                 else DEFAULT_WORLD)
    if world < 1:
        raise ValueError(f"world must be >= 1 or -1, got {world}")
    if even and world % 2 and world > 1:
        if nprocs > 1:
            raise ValueError(
                f"world {world} across {nprocs} processes is odd: an "
                "even rank count cannot drop a rank of another process")
        world -= 1
    tracelib.mark_rendezvous("make_communicator")
    return Communicator({axis: world}, axis, device=device,
                        block=processes.current_block(world))


def wire_line(comm: Communicator) -> str | None:
    """The line an app prints when its collectives cross processes:
    which backend and which memory carry them. None in one process."""
    from hpc_patterns_tpu_torch.comm import processes

    b = comm.block
    if b is None:
        return None
    return (f"collectives: {b.num_processes} processes x {b.local} "
            f"logical rank(s) (this process: ranks {b.start}.."
            f"{b.start + b.local - 1}), across processes over "
            f"{processes.wire(comm.device)}")


def allreduce_bus_bandwidth_gbps(nbytes: int, seconds: float,
                                 world: int) -> float:
    """Bus bandwidth for an allreduce: algbw · 2(size−1)/size, the
    ring-limit normalization that makes world sizes comparable (the
    BASELINE.json "allreduce GB/s" metric); 0 for world=1."""
    if seconds <= 0:
        return float("inf")
    return (nbytes / seconds / 1e9) * (2 * (world - 1) / world)


def local_rows(tensor, comm: Communicator | None = None) -> list:
    """``(rank, row)`` pairs this process holds: ``tensor`` is a
    communicator's ``(local_size, ...)`` result and each row is paired
    with its global rank (``comm``'s block; every row in one process).
    Each process validates only its own ranks' buffers, as the
    reference's per-rank asserts do (allreduce-mpi-sycl.cpp:192-206)."""
    start = comm.rank_offset if comm is not None else 0
    return [(start + i, row) for i, row in enumerate(tensor)]


def supports_memory_kind(kind: str) -> bool:
    """Whether the device advertises the given memory kind. Delegates to
    the single probe home (``memory/kinds.py``)."""
    from hpc_patterns_tpu_torch.memory import kinds as kindslib

    return kindslib.supports_memory_kind(kind)


def reduce_across_processes(value: float, op=None) -> float:
    """Reduce a host scalar across the launched processes (default max —
    the reference's MPI_Allreduce(MAX) timing convention) through the
    gloo group; the identity in one process."""
    from hpc_patterns_tpu_torch.comm import processes

    values = processes.host_values(value)
    return float((op or max)(values))


def all_processes_agree(ok: bool) -> bool:
    """Cross-process AND of a local verdict (a distributed SUCCESS needs
    every rank's assert to hold); the identity in one process."""
    return reduce_across_processes(0.0 if ok else 1.0) == 0.0
