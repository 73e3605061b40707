"""Device resolution and the launcher's process protocol — the
counterpart of device discovery and the multi-process half of
``hpc_patterns_tpu/topology.py``.

The port runs on the card. A caller that wants the CPU (the tests, the
plain reference paths) says so explicitly; without a GPU and without
that request every entry point raises instead of silently running on
the host, so no CPU number can pass for a device one.

A run may span several OS processes (``apps/launch.py``, the ``mpirun
-np`` analog): each child learns the rendezvous from the ``HPCPAT_*``
variables and joins it through ``torch.distributed`` on **gloo**
(:func:`init_distributed_from_env`), and holds a block of
``HPCPAT_LOCAL_RANKS`` consecutive logical ranks. NCCL refuses two
ranks on one device, and one card is what the port has. torch is
imported lazily here: the launcher is host code and imports this module
without it.

Meshes (:func:`make_mesh`, :func:`make_hybrid_mesh`) are ``{axis: size}``
dicts over logical ranks, laid out row-major (later axes vary fastest).
A slice (:func:`group_by_slice`) is the JAX package's multi-slice unit:
in one process every rank is slice 0; across launched processes the
process-keyed :data:`ENV_SLICE_GROUPING` (``launch.py --slices``) gives
each process's block of ranks its slice.
"""

from __future__ import annotations

import math
import os
import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import TYPE_CHECKING, Mapping

if TYPE_CHECKING:
    import torch

# the env rendezvous protocol set by apps/launch.py (the JAX package's
# names): the coordinator's host:port, the process count and this
# process's id
ENV_COORDINATOR = "HPCPAT_COORDINATOR"
ENV_NUM_PROCESSES = "HPCPAT_NUM_PROCESSES"
ENV_PROCESS_ID = "HPCPAT_PROCESS_ID"
#: per-rank flight-recorder handoff directory (harness/trace.py)
ENV_TRACE_DIR = "HPCPAT_TRACE_DIR"
#: process-keyed slice grouping (``process:0,0,1,1``), which
#: :func:`process_env_info` applies to the trace stamp
ENV_SLICE_GROUPING = "HPCPAT_SLICE_GROUPING"
#: logical ranks a launched process holds (launch
#: ``--cpu-devices-per-proc``): the port's stand-in for the virtual
#: devices a JAX worker gets
ENV_LOCAL_RANKS = "HPCPAT_LOCAL_RANKS"
#: seconds a gloo collective waits for its peers before it raises
DIST_TIMEOUT_S = 600


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); ``"cpu"``/``"cuda"``/
    ``"cuda:N"``/``torch.device`` -> that device, a CUDA one checked
    for availability."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


@dataclass(frozen=True)
class LogicalDevice:
    """One logical endpoint on a physical device: the serving plane's
    replica placement. JAX places replicas on distinct chips; the port
    has one card, so two replicas there are two *ranks* on the same
    ``device`` (the stand-in the ring kernels also use), and a pair of
    endpoints that differ in rank is a real source/destination pair for
    the migration exchange (``comm/migration_dma.py``). ``device`` is
    resolved like every entry point's (``cuda`` raises without a GPU)."""

    device: torch.device
    rank: int = 0

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.rank < 0:
            raise ValueError(f"rank must be >= 0, got {self.rank}")

    @property
    def type(self) -> str:
        return self.device.type

    def __str__(self) -> str:
        return f"{self.device}/rank{self.rank}"


def _dist():
    """``torch.distributed`` when a process group is up, else None —
    without importing torch into a process that never did."""
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return None
    return dist


def process_env_info(environ=None) -> tuple[int, int, int]:
    """``(process_id, num_processes, slice_id)`` for THIS process, from
    the launcher env protocol when present, else from an initialized
    process group, else ``(0, 1, 0)``. ``slice_id`` applies a
    process-keyed :data:`ENV_SLICE_GROUPING` override. What stamps
    flight-recorder snapshots with their rank (harness/trace.py)."""
    env = os.environ if environ is None else environ
    pid_s = env.get(ENV_PROCESS_ID)
    if pid_s is not None:
        pid = int(pid_s)
        nprocs = int(env.get(ENV_NUM_PROCESSES, 1))
    else:
        dist = _dist()
        pid, nprocs = ((dist.get_rank(), dist.get_world_size())
                       if dist is not None else (0, 1))
    slice_id = 0
    spec = env.get(ENV_SLICE_GROUPING)
    if spec:
        kind, _, arg = spec.partition(":")
        if kind == "process":
            if not arg:
                slice_id = pid
            else:
                try:
                    mapping = [int(x) for x in arg.split(",")]
                    if pid < len(mapping):
                        slice_id = mapping[pid]
                except ValueError:
                    pass  # a telemetry stamp falls back to slice 0
    return pid, nprocs, slice_id


def init_distributed_from_env(environ=None) -> bool:
    """Join the rendezvous in ``HPCPAT_COORDINATOR`` /
    ``HPCPAT_NUM_PROCESSES`` / ``HPCPAT_PROCESS_ID`` (exported by
    ``apps/launch.py``) as one process of a gloo process group
    (``init_method="tcp://" + HPCPAT_COORDINATOR``). No-op (False)
    without the variables or when a group is already up; True when this
    call joined. Every app's communicator calls it, so each app runs
    alone and under the launcher alike."""
    env = os.environ if environ is None else environ
    coord = env.get(ENV_COORDINATOR)
    if not coord:
        return False
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    dist.init_process_group(
        "gloo", init_method="tcp://" + coord,
        world_size=int(env[ENV_NUM_PROCESSES]),
        rank=int(env[ENV_PROCESS_ID]),
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return True


def is_multihost() -> bool:
    """True in a process group of more than one process."""
    dist = _dist()
    return dist is not None and dist.get_world_size() > 1


def local_ranks_from_env() -> int:
    """The logical ranks this process holds (:data:`ENV_LOCAL_RANKS`, 1
    when unset)."""
    n = int(os.environ.get(ENV_LOCAL_RANKS) or 1)
    if n < 1:
        raise ValueError(f"{ENV_LOCAL_RANKS} must be >= 1, got {n}")
    return n


def worker_env(base: Mapping[str, str], local_ranks: int,
               num_processes: int = 1) -> dict:
    """Environment for a launched child that holds ``local_ranks``
    logical ranks (the port's ``cpu_worker_env``): exports
    :data:`ENV_LOCAL_RANKS`, and caps each child's intra-op threads at
    its share of the host's cores unless the caller set
    ``OMP_NUM_THREADS`` (children on one host otherwise spin their
    thread pools on each other's cores)."""
    env = dict(base)
    env[ENV_LOCAL_RANKS] = str(int(local_ranks))
    cores = os.cpu_count() or 1
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, cores // max(1, num_processes))))
    return env


def pump_lines(prefix: str, stream, sink) -> None:
    """Echo ``stream`` to ``sink`` line by line (with ``prefix``) until
    EOF, flushing each line — the launcher's output pump for its
    children."""
    for line in iter(stream.readline, ""):
        sink.write(f"{prefix}{line}")
        sink.flush()
    stream.close()


class TopologyError(ValueError):
    """A mesh the ranks cannot hold (JAX ``topology.TopologyError``)."""


def factor_axes(n_ranks: int, axes: Mapping[str, int]) -> dict:
    """Resolve -1 ("auto") axis sizes so the product equals ``n_ranks``:
    the remainder to the first auto axis, 1 to the others (JAX
    ``_factor_axes``)."""
    sizes = dict(axes)
    for k, v in sizes.items():
        if v != -1 and v < 1:
            raise TopologyError(
                f"axis {k!r} has invalid size {v} (use -1 for auto)")
    auto = [k for k, v in sizes.items() if v == -1]
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if n_ranks % fixed:
        raise TopologyError(
            f"mesh axes {dict(axes)} do not divide {n_ranks} devices")
    if not auto:
        if fixed != n_ranks:
            raise TopologyError(f"mesh axes {dict(axes)} use {fixed} "
                                f"devices but {n_ranks} exist")
        return sizes
    for k in auto[1:]:
        sizes[k] = 1
    sizes[auto[0]] = n_ranks // fixed
    return sizes


def make_mesh(axes: Mapping[str, int], n_ranks: int | None = None) -> dict:
    """A named-axis mesh over ``n_ranks`` logical ranks (default: the
    product of the fixed sizes, no auto axis allowed then), row-major:
    later axes vary fastest, so put the most communication-heavy (tp,
    then sp) last, as JAX's ``make_mesh`` advises."""
    if n_ranks is None:
        if any(v == -1 for v in axes.values()):
            raise TopologyError("an auto (-1) axis needs n_ranks")
        n_ranks = math.prod(axes.values())
    return factor_axes(n_ranks, axes)


def group_by_slice(n_local: int | None = None, environ=None) -> dict:
    """``{slice_id: [global logical ranks]}``. One process: its
    ``n_local`` ranks (default :func:`local_ranks_from_env`) form slice
    0. Launched processes: process ``p`` holds ranks ``[p·L, (p+1)·L)``
    and its slice comes from the process-keyed
    :data:`ENV_SLICE_GROUPING` (every process slice 0 without it)."""
    env = os.environ if environ is None else environ
    local = n_local or local_ranks_from_env()
    _, nprocs, _ = process_env_info(env)
    groups: dict = defaultdict(list)
    for p in range(nprocs):
        probe = dict(env)
        probe[ENV_PROCESS_ID] = str(p)
        probe[ENV_NUM_PROCESSES] = str(nprocs)
        groups[process_env_info(probe)[2]] += range(p * local,
                                                    (p + 1) * local)
    return dict(groups)


def make_hybrid_mesh(dcn_axes: Mapping[str, int],
                     ici_axes: Mapping[str, int], groups: dict) -> dict:
    """A multi-slice mesh (JAX ``hybrid_device_layout`` /
    ``make_hybrid_mesh``): the DCN axes across the slices of ``groups``
    (:func:`group_by_slice`), the ICI axes within one, DCN axes leading.
    Slices must be equal-sized; -1 sizes auto-fill; on one slice the DCN
    axes are 1."""
    per_slice = {s: len(r) for s, r in groups.items()}
    if len(set(per_slice.values())) != 1:
        raise TopologyError(f"slices are unequal ({per_slice}); a hybrid "
                            "mesh needs equal-sized slices")
    dcn = factor_axes(len(groups), dcn_axes)
    ici = factor_axes(next(iter(per_slice.values())), ici_axes)
    overlap = set(dcn) & set(ici)
    if overlap:
        raise TopologyError(f"axes {sorted(overlap)} appear in both "
                            "dcn_axes and ici_axes")
    return {**dcn, **ici}
