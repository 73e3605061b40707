"""Halo exchange: ghost-cell neighbour transfer on the ring — the
counterpart of ``hpc_patterns_tpu/comm/halo.py``.

The interop suite's shared-USM role in BASELINE.json is the
stencil/halo-exchange config ("SYCL+OMP shared-USM stencil with halo
exchange"). A halo exchange is two simultaneous one-hop ring transfers:
each rank sends its boundary strip left and right and receives its
neighbours' strips — two :func:`.ring.ring_shift` calls, the
deadlock-free form of the reference's even/odd ordered Send/Recv pairs
(allreduce-mpi-sycl.cpp:50-58).

The JAX functions are rank-local inside ``shard_map``; these take the
rank-stacked tensor ``(ranks, n_local, ...)`` (row r = rank r's shard;
the domain axis is dim 1, rank order = global domain order, periodic by
construction). ``block`` (a :class:`~.processes.RankBlock`) names the
ranks this process holds when the ring spans processes: the shifts then
cross the process boundary and nothing else changes.
"""

from __future__ import annotations

import torch

from hpc_patterns_tpu_torch.comm import ring


def halo_exchange(x: torch.Tensor, *, halo: int = 1,
                  block=None) -> torch.Tensor:
    """Return ``x`` padded with ``halo`` ghost rows from each ring
    neighbour: (ranks, n_local, ...) -> (ranks, n_local + 2·halo, ...).

    Row layout of each rank: ``[left neighbour's last halo rows | x |
    right neighbour's first halo rows]`` with periodic wrap-around.
    """
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    if x.shape[1] < halo:
        raise ValueError(
            f"local shard ({x.shape[1]} rows) smaller than halo {halo}")
    # +1 shift: my strip lands on my right neighbour => what *I* receive
    # came from my left neighbour, and vice versa
    from_left = ring.ring_shift(x[:, -halo:], +1, block=block)
    from_right = ring.ring_shift(x[:, :halo], -1, block=block)
    return torch.cat([from_left, x, from_right], dim=1)


def jacobi_step(u: torch.Tensor, *, alpha: float = 0.25,
                block=None) -> torch.Tensor:
    """One periodic 1-D diffusion (3-point Jacobi) step with halo
    exchange: u' = (1-2α)·u + α·(left + right). The canonical stencil
    the halo pattern exists for."""
    g = halo_exchange(u, halo=1, block=block)
    return (1.0 - 2.0 * alpha) * g[:, 1:-1] + alpha * (g[:, :-2] + g[:, 2:])
