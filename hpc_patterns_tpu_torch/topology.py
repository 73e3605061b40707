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
"""

from __future__ import annotations

import os
import sys
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
