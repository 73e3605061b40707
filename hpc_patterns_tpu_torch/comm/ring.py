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
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import torch


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


def permute(x: torch.Tensor, pairs) -> torch.Tensor:
    """Row ``s`` of ``x`` lands on row ``d`` for every ``(s, d)`` (a full
    permutation, checked)."""
    size = x.shape[0]
    pairs = [(int(s), int(d)) for s, d in pairs]
    check_permutation(pairs, size)
    src = [0] * size
    for s, d in pairs:
        src[d] = s
    return x[torch.tensor(src, device=x.device)]


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rank r's buffer lands on rank ``(r + shift) % size`` — one
    ``SendRecvRing`` step (allreduce-mpi-sycl.cpp:43-59)."""
    size = x.shape[0]
    check_permutation(_ring_perm(size, shift), size)
    return torch.roll(x, shifts=shift, dims=0)


def pairwise_exchange(x: torch.Tensor) -> torch.Tensor:
    """Even/odd partner swap: rank r exchanges with rank ``r ^ 1`` (the
    ping-pong pattern). Requires an even rank count
    (allreduce-mpi-sycl.cpp:95-97)."""
    size = x.shape[0]
    if size % 2:
        raise ValueError(f"pairwise_exchange needs an even axis size, got {size}")
    return permute(x, [(i, i ^ 1) for i in range(size)])


def ring_schedule(x: torch.Tensor, step_fn: Callable, *,
                  steps: int | None = None, shift: int = 1, carry=None):
    """``steps`` rounds of (shift the buffer one neighbour over, combine
    locally): ``step_fn(carry, incoming, step)`` -> new carry, where
    ``incoming`` at step ``s`` holds on row r the buffer of rank
    ``(r - s*shift) % size`` (allreduce-mpi-sycl.cpp:177-181)."""
    if steps is None:
        steps = x.shape[0] - 1
    buf = x
    if carry is None:
        carry = x
    for s in range(1, steps + 1):
        buf = ring_shift(buf, shift)
        carry = step_fn(carry, buf, s)
    return carry


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Allreduce(SUM) as a (size-1)-step ring of full-buffer exchanges —
    the reference's hand-rolled algorithm (allreduce-mpi-sycl.cpp:
    173-182)."""
    return ring_schedule(x, lambda acc, incoming, _s: acc + incoming)


def _chunk_index(size: int, offset: int, device) -> torch.Tensor:
    """Per-rank chunk ``(r + offset) % size`` for every rank r."""
    return (torch.arange(size, device=device) + offset) % size


def ring_reduce_scatter(x: torch.Tensor, *, scatter_axis: int = 0
                        ) -> torch.Tensor:
    """Reduce-scatter as a (size-1)-step chunked ring. Each rank's shard
    is split into ``size`` chunks along ``scatter_axis`` (an axis of the
    shard, i.e. dim ``scatter_axis + 1`` of ``x``); at step s rank r adds
    its chunk ``(r - 1 - s) % size`` to the partial arriving from the
    left. Returns ``(size, *chunk)``: row r holds chunk r fully reduced."""
    size = x.shape[0]
    ax = scatter_axis % (x.dim() - 1) + 1
    if x.shape[ax] % size:
        raise ValueError(
            f"scatter axis length {x.shape[ax]} not divisible by {size}")
    # (rank, chunk, ...) with the chunk's own axis kept in place
    stacked = torch.stack(torch.chunk(x, size, dim=ax), dim=1)
    ranks = torch.arange(size, device=x.device)
    send = stacked[ranks, _chunk_index(size, size - 1, x.device)]
    for s in range(1, size):
        incoming = ring_shift(send, 1)
        mine = stacked[ranks, _chunk_index(size, size - 1 - s, x.device)]
        send = mine + incoming
    return send


def ring_all_gather(x: torch.Tensor, *, gather_axis: int = 0,
                    tiled: bool = False) -> torch.Tensor:
    """All-gather as a (size-1)-step ring: each step forwards what arrived
    the step before. ``tiled=False`` gives ``(size, size, *shard)`` (row
    r holds every rank's shard in rank order); ``tiled=True``
    concatenates them along ``gather_axis`` of the shard."""
    size = x.shape[0]
    pieces = [x]
    buf = x
    for _ in range(size - 1):
        buf = ring_shift(buf, 1)
        pieces.append(buf)
    # pieces[s] on row r came from rank (r - s): put position j = rank j
    stacked = torch.stack(pieces, dim=1)  # (rank, s, ...)
    ranks = torch.arange(size, device=x.device)
    src_step = (ranks[:, None] - ranks[None, :]) % size  # [r, j] -> s
    ordered = stacked[ranks[:, None], src_step]
    if not tiled:
        return ordered
    return torch.cat(torch.unbind(ordered, dim=1),
                     dim=gather_axis % (x.dim() - 1) + 1)


def ring_allreduce_chunked(x: torch.Tensor, *, scatter_axis: int = 0
                           ) -> torch.Tensor:
    """Bandwidth-optimal allreduce: ring reduce-scatter, then ring
    all-gather — 2·n·(size-1)/size elements per rank on the wire."""
    reduced = ring_reduce_scatter(x, scatter_axis=scatter_axis)
    return ring_all_gather(reduced, gather_axis=scatter_axis, tiled=True)
