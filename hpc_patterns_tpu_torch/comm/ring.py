"""Ring engine: neighbour-exchange collectives over logical ranks — the
counterpart of ``hpc_patterns_tpu/comm/ring.py``.

The JAX functions are rank-local (they run inside ``shard_map`` and see
one shard). The port runs every logical rank in one process, so each
function here takes the **global** tensor: a ``(size, ...)`` tensor
whose row ``r`` is rank ``r``'s buffer — the JAX ``Communicator``'s
global-array view. A ``ppermute`` becomes an index over dim 0
(``torch.roll`` for a ring hop), and each step's combine is the same
``mine + incoming`` in the same chunk order, so the results equal the JAX
ring's bit for bit.

The reference's even/odd blocking send/recv order
(allreduce-mpi-sycl.cpp:43-59) only avoids MPI deadlock; a permutation of
rows cannot deadlock, so the *schedule* is what is reproduced.

Across processes (``block``, a :class:`~.processes.RankBlock`), ``x``
holds this process's rows only and the size is the block's world: a hop
rolls the local rows and swaps the edge rows with the neighbouring
processes (:func:`.processes.exchange_rows`), and every combine runs on
the same rows in the same order, so a launched ring equals the
one-process ring bit for bit.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import torch

from hpc_patterns_tpu_torch.comm import processes


def _ring_perm(size: int, shift: int) -> list[tuple[int, int]]:
    """Static source->dest pairs sending each rank's data ``shift`` to the
    right (shift may be negative)."""
    return [(i, (i + shift) % size) for i in range(size)]


def check_permutation(pairs, size: int, *, allow_partial: bool = False) -> None:
    """Deadlock/race sanitizer for permutation schedules: indices in
    range, no rank twice as source or destination, and — unless
    ``allow_partial`` — every rank exactly once as both (a true
    permutation; a partial one would leave buffers unfilled). Raises
    ValueError. O(n)."""
    srcs, dsts = [], []
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"pair ({s}, {d}) out of range for size {size}")
        srcs.append(s)
        dsts.append(d)
    by_name = (("sources", srcs), ("destinations", dsts))
    for name, idxs in by_name:
        dups = sorted(x for x, c in Counter(idxs).items() if c > 1)
        if dups:
            raise ValueError(
                f"malformed permutation: duplicate {name} {dups} — data "
                "would be dropped/duplicated")
    if not allow_partial:
        for name, idxs in by_name:
            missing = sorted(set(range(size)) - set(idxs))
            if missing:
                raise ValueError(
                    f"partial permutation: ranks {missing} missing from "
                    f"{name} — their buffers would be left unfilled "
                    "(pass allow_partial=True if intended)")


def _size(x: torch.Tensor, block) -> int:
    """The ring's size: the block's world, else ``x``'s rows."""
    return block.world if block is not None else x.shape[0]


def _ranks(x: torch.Tensor, block) -> torch.Tensor:
    """The global rank of each of ``x``'s rows."""
    if block is not None:
        return block.ranks(x.device)
    return torch.arange(x.shape[0], device=x.device)


def _move(x: torch.Tensor, src: list[int], block) -> torch.Tensor:
    """Global row ``d`` of the result is global row ``src[d]``."""
    if processes.spans(block):
        return processes.exchange_rows(x, src, block)
    return x[torch.tensor(src, device=x.device)]


def permute(x: torch.Tensor, pairs, *, block=None) -> torch.Tensor:
    """Row ``s`` of ``x`` lands on row ``d`` for every ``(s, d)`` (a full
    permutation, checked)."""
    size = _size(x, block)
    pairs = [(int(s), int(d)) for s, d in pairs]
    check_permutation(pairs, size)
    src = [0] * size
    for s, d in pairs:
        src[d] = s
    return _move(x, src, block)


def ring_shift(x: torch.Tensor, shift: int = 1, *, block=None
               ) -> torch.Tensor:
    """Rank r's buffer lands on rank ``(r + shift) % size`` — one
    ``SendRecvRing`` step (allreduce-mpi-sycl.cpp:43-59)."""
    size = _size(x, block)
    check_permutation(_ring_perm(size, shift), size)
    if not processes.spans(block):
        return torch.roll(x, shifts=shift, dims=0)
    return _move(x, [(d - shift) % size for d in range(size)], block)


def pairwise_exchange(x: torch.Tensor, *, block=None) -> torch.Tensor:
    """Even/odd partner swap: rank r exchanges with rank ``r ^ 1`` (the
    ping-pong pattern). Requires an even rank count
    (allreduce-mpi-sycl.cpp:95-97)."""
    size = _size(x, block)
    if size % 2:
        raise ValueError(f"pairwise_exchange needs an even axis size, got {size}")
    return permute(x, [(i, i ^ 1) for i in range(size)], block=block)


def ring_schedule(x: torch.Tensor, step_fn: Callable, *,
                  steps: int | None = None, shift: int = 1, carry=None,
                  block=None):
    """``steps`` rounds of (shift the buffer one neighbour over, combine
    locally): ``step_fn(carry, incoming, step)`` -> new carry, where
    ``incoming`` at step ``s`` holds on row r the buffer of rank
    ``(r - s*shift) % size`` (allreduce-mpi-sycl.cpp:177-181)."""
    if steps is None:
        steps = _size(x, block) - 1
    buf = x
    if carry is None:
        carry = x
    for s in range(1, steps + 1):
        buf = ring_shift(buf, shift, block=block)
        carry = step_fn(carry, buf, s)
    return carry


def ring_allreduce(x: torch.Tensor, *, block=None) -> torch.Tensor:
    """Allreduce(SUM) as a (size-1)-step ring of full-buffer exchanges —
    the reference's hand-rolled algorithm (allreduce-mpi-sycl.cpp:
    173-182)."""
    return ring_schedule(x, lambda acc, incoming, _s: acc + incoming,
                         block=block)


def ring_reduce_scatter(x: torch.Tensor, *, scatter_axis: int = 0,
                        block=None) -> torch.Tensor:
    """Reduce-scatter as a (size-1)-step chunked ring. Each rank's shard
    is split into ``size`` chunks along ``scatter_axis`` (an axis of the
    shard, i.e. dim ``scatter_axis + 1`` of ``x``); at step s rank r adds
    its chunk ``(r - 1 - s) % size`` to the partial arriving from the
    left. Returns ``(size, *chunk)``: row r holds chunk r fully reduced."""
    size = _size(x, block)
    ax = scatter_axis % (x.dim() - 1) + 1
    if x.shape[ax] % size:
        raise ValueError(
            f"scatter axis length {x.shape[ax]} not divisible by {size}")
    # (rank, chunk, ...) with the chunk's own axis kept in place
    stacked = torch.stack(torch.chunk(x, size, dim=ax), dim=1)
    rows = torch.arange(x.shape[0], device=x.device)
    ranks = _ranks(x, block)
    send = stacked[rows, (ranks + size - 1) % size]
    for s in range(1, size):
        incoming = ring_shift(send, 1, block=block)
        mine = stacked[rows, (ranks + size - 1 - s) % size]
        send = mine + incoming
    return send


def ring_all_gather(x: torch.Tensor, *, gather_axis: int = 0,
                    tiled: bool = False, block=None) -> torch.Tensor:
    """All-gather as a (size-1)-step ring: each step forwards what arrived
    the step before. ``tiled=False`` gives ``(size, size, *shard)`` (row
    r holds every rank's shard in rank order); ``tiled=True``
    concatenates them along ``gather_axis`` of the shard."""
    size = _size(x, block)
    pieces = [x]
    buf = x
    for _ in range(size - 1):
        buf = ring_shift(buf, 1, block=block)
        pieces.append(buf)
    # pieces[s] on row r came from rank (r - s): put position j = rank j
    stacked = torch.stack(pieces, dim=1)  # (row, s, ...)
    rows = torch.arange(x.shape[0], device=x.device)
    src_step = ((_ranks(x, block)[:, None]
                 - torch.arange(size, device=x.device)[None, :]) % size)
    ordered = stacked[rows[:, None], src_step]  # [r, j] -> step s
    if not tiled:
        return ordered
    return torch.cat(torch.unbind(ordered, dim=1),
                     dim=gather_axis % (x.dim() - 1) + 1)


def ring_allreduce_chunked(x: torch.Tensor, *, scatter_axis: int = 0,
                           block=None) -> torch.Tensor:
    """Bandwidth-optimal allreduce: ring reduce-scatter, then ring
    all-gather — 2·n·(size-1)/size elements per rank on the wire."""
    reduced = ring_reduce_scatter(x, scatter_axis=scatter_axis, block=block)
    return ring_all_gather(reduced, gather_axis=scatter_axis, tiled=True,
                           block=block)
