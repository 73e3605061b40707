"""Logical ranks across OS processes: the block of ranks a process holds
and the wire between processes.

A launched run (``apps/launch.py``) spans several processes joined in a
gloo process group (:func:`hpc_patterns_tpu_torch.topology.
init_distributed_from_env`). Process ``p`` of ``P`` holds the ``L``
consecutive logical ranks ``[p·L, (p+1)·L)`` of a world of ``P·L``, and a
communicator's tensors there are its rows only: ``(L, ...)``, row ``i``
= global rank ``p·L + i`` (:class:`RankBlock`). One process
(``block=None``) holds every rank, as before.

The wire is gloo over host memory. A card tensor goes device → pinned
host (a copy on the current stream, waited for) → gloo → pinned host →
device (a copy enqueued on the current stream), so each exchange sits in
the compute stream's order. Rows travel as their bytes (a ``uint8``
view), so every dtype crosses bit for bit. NCCL would refuse two ranks
on one device; the port has one card.

Two primitives carry every collective across processes:

- :func:`exchange_rows` — a permutation of rows: rows a process keeps
  move locally, the rest go point to point (``isend``/``irecv``) to the
  process that holds their destination. The ring engine's hops use it,
  so a ring keeps its arithmetic order and its result is bit-equal to
  the one-process run;
- :func:`gather_rows` — every process's block, gathered (gloo
  ``all_gather``). The library collectives reduce the gathered rows with
  the one-process function and keep their own rows, so they too equal
  the one-process result bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

#: why the device-initiated ring kernels do not cross processes
FUSED_ACROSS_PROCESSES = (
    "the fused routes run every rank's CTAs in one cooperative launch "
    "that spins on flags the other ranks' CTAs set; kernels of two "
    "processes on one card are time-sliced, not co-resident (no MPS), so "
    "a launch spanning processes cannot exist: run them in one process")

#: the wire as the apps print it
WIRE = {"cuda": "gloo over pinned host memory (device -> pinned host -> "
                "gloo -> device, on the compute stream's order)",
        "cpu": "gloo over host memory"}


@dataclass(frozen=True)
class RankBlock:
    """The ``local`` consecutive logical ranks process ``process_id`` of
    ``num_processes`` holds, out of ``world = num_processes · local``."""

    world: int
    local: int
    process_id: int
    num_processes: int

    def __post_init__(self):
        if self.world != self.local * self.num_processes:
            raise ValueError(
                f"world {self.world} != {self.num_processes} processes x "
                f"{self.local} ranks")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f"process {self.process_id} not in "
                             f"[0, {self.num_processes})")

    @property
    def start(self) -> int:
        return self.process_id * self.local

    def owner(self, rank: int) -> int:
        """The process holding global rank ``rank``."""
        return rank // self.local

    def ranks(self, device=None) -> torch.Tensor:
        """This process's global ranks, in row order."""
        return torch.arange(self.start, self.start + self.local,
                            device=device)


def spans(block: RankBlock | None) -> bool:
    """Whether ``block`` reaches past this process."""
    return block is not None and block.num_processes > 1


def current_block(world: int) -> RankBlock | None:
    """The block this process holds of a ``world``-rank communicator in
    the process group, or None when no group of more than one process is
    up (every rank in this process)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n < 2:
        return None
    if world % n:
        raise ValueError(
            f"world {world} does not divide over {n} processes")
    return RankBlock(world, world // n, dist.get_rank(), n)


def wire(device) -> str:
    """What carries the collectives across processes for ``device``."""
    return WIRE["cuda" if torch.device(device).type == "cuda" else "cpu"]


def _as_bytes(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (n, ...) as a contiguous (n, bytes) uint8 view."""
    return rows.contiguous().reshape(rows.shape[0], -1).view(torch.uint8)


def _to_host(rows: torch.Tensor) -> torch.Tensor:
    """The rows' bytes where gloo reads them: the tensor itself on the
    CPU; on a card a pinned host copy enqueued on the current stream and
    waited for (the stream's work before it is included)."""
    b = _as_bytes(rows)
    if b.device.type != "cuda":
        return b
    h = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
    h.copy_(b, non_blocking=True)
    torch.cuda.current_stream(b.device).synchronize()
    return h


def _host_buffer(shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


def _from_bytes(h: torch.Tensor, like: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` rows shaped and typed like ``like``'s from their bytes ``h``,
    on ``like``'s device (a copy enqueued on the current stream)."""
    rows = h.to(like.device, non_blocking=True) if like.is_cuda else h
    return rows.view(like.dtype).reshape(n, *like.shape[1:])


def exchange_rows(x: torch.Tensor, src: list[int],
                  block: RankBlock) -> torch.Tensor:
    """Row ``d`` of the global result is global row ``src[d]``; returns
    this process's rows. ``x``: this process's ``(local, ...)`` rows.
    Each process sends a peer the rows that peer needs in the order of
    their destinations and receives in the same order, so both sides
    agree on the layout without a header."""
    L, start = block.local, block.start
    mine = range(start, start + L)
    out_rows: list = [None] * L
    # what I receive: my destinations grouped by the source's process
    recv_from: dict[int, list[int]] = {}
    for d in mine:
        s = src[d]
        if block.owner(s) == block.process_id:
            out_rows[d - start] = x[s - start]
        else:
            recv_from.setdefault(block.owner(s), []).append(d)
    # what I send: my rows other processes need, by destination
    send_to: dict[int, list[int]] = {}
    for d, s in enumerate(src):
        q = block.owner(d)
        if q != block.process_id and block.owner(s) == block.process_id:
            send_to.setdefault(q, []).append(s)
    reqs, held = [], []
    for q, rows in sorted(send_to.items()):
        h = _to_host(x[torch.tensor([r - start for r in rows],
                                    device=x.device)])
        held.append(h)
        reqs.append(dist.isend(h, q))
    width = _as_bytes(x[:1]).shape[1]
    bufs = {}
    for q, dests in sorted(recv_from.items()):
        bufs[q] = _host_buffer((len(dests), width), x.device)
        reqs.append(dist.irecv(bufs[q], q))
    for r in reqs:
        r.wait()
    for q, dests in recv_from.items():
        got = _from_bytes(bufs[q], x, len(dests))
        for i, d in enumerate(dests):
            out_rows[d - start] = got[i]
    return torch.stack(out_rows)


def gather_rows(x: torch.Tensor, block: RankBlock) -> torch.Tensor:
    """Every process's ``(local, ...)`` rows stacked in rank order:
    the global ``(world, ...)`` tensor on ``x``'s device."""
    h = _to_host(x)
    buf = _host_buffer((block.num_processes, *h.shape), x.device)
    dist.all_gather(list(buf.unbind(0)), h)
    return _from_bytes(buf.reshape(block.world, -1), x, block.world)


def allreduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` (f32) over every process of the group, in one
    gloo ``all_reduce``: a card tensor goes through a pinned host copy
    and back (on the compute stream's order); ``x`` itself with no
    group."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() < 2:
        return x
    n = dist.get_world_size()
    if x.device.type == "cuda":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
    else:
        h = x.clone()
    dist.all_reduce(h)
    h /= n
    return h.to(x.device, non_blocking=True) if x.is_cuda else h


def host_values(value: float) -> list[float]:
    """``value`` from every process of the group, in process order; just
    ``[value]`` with no group."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() < 2:
        return [float(value)]
    parts = [torch.zeros(1, dtype=torch.float64)
             for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.tensor([float(value)], dtype=torch.float64))
    return [float(p.item()) for p in parts]
