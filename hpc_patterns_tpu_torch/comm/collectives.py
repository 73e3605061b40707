"""Library collectives over logical ranks — the counterpart of
``hpc_patterns_tpu/comm/collectives.py`` (the ``MPI_Allreduce`` side of
the reference's ring-vs-library comparison, allreduce-mpi-sycl.cpp:
61-67).

Every function takes the global ``(size, ...)`` tensor (row r = rank r's
buffer, see :mod:`.ring`) and returns the global result, each rank's row
holding what that rank would receive. These are plain PyTorch reductions
over dim 0: the library route the hand-built rings are raced against.
"""

from __future__ import annotations

import torch


def _pprod(x: torch.Tensor) -> torch.Tensor:
    """``prod`` as gather-then-product: a fundamentally different data
    pattern from a ring reduction, which is why the fused route refuses
    ``prod`` (:data:`.fused.FUSED_REDUCE_OPS`)."""
    return x.prod(dim=0, keepdim=True)


def _pmean(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=0, keepdim=True) / x.shape[0]


_REDUCE_OPS = {
    "sum": lambda x: x.sum(dim=0, keepdim=True),
    "max": lambda x: x.amax(dim=0, keepdim=True),
    "min": lambda x: x.amin(dim=0, keepdim=True),
    "mean": _pmean,
    "prod": _pprod,
}


def _everywhere(reduced: torch.Tensor, size: int) -> torch.Tensor:
    """One reduced row -> every rank's row (its own buffer each)."""
    return reduced.expand(size, *reduced.shape[1:]).contiguous()


def allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``MPI_Allreduce``: every rank gets the elementwise reduction."""
    try:
        fn = _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(
            f"unknown reduce op {op!r}; have {sorted(_REDUCE_OPS)}") from None
    return _everywhere(fn(x), x.shape[0])


def all_gather(x: torch.Tensor, *, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """``MPI_Allgather``: ``tiled`` concatenates the shards along
    ``gather_axis`` of the shard, else stacks them: ``(size, size,
    *shard)``."""
    size = x.shape[0]
    if tiled:
        one = torch.cat(torch.unbind(x, dim=0),
                        dim=gather_axis % (x.dim() - 1))[None]
    else:
        one = x[None]
    return _everywhere(one, size)


def reduce_scatter(x: torch.Tensor, *, scatter_axis: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """``MPI_Reduce_scatter``: rank r gets chunk r of the sum along
    ``scatter_axis`` of the shard."""
    if op != "sum":
        raise ValueError("reduce_scatter supports op='sum'")
    size = x.shape[0]
    ax = scatter_axis % (x.dim() - 1) + 1
    if x.shape[ax] % size:
        raise ValueError(
            f"scatter axis length {x.shape[ax]} not divisible by {size}")
    total = x.sum(dim=0, keepdim=True)
    return torch.cat(torch.chunk(total, size, dim=ax), dim=0)


def all_to_all(x: torch.Tensor, *, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``MPI_Alltoall``: rank r's chunk c lands on rank c at position r
    (the Ulysses sequence-parallel primitive)."""
    size = x.shape[0]
    nd = x.dim() - 1
    chunks = torch.chunk(x, size, dim=split_axis % nd + 1)  # [c](size, ..)
    return torch.stack(
        [torch.cat(torch.unbind(chunks[c], dim=0), dim=concat_axis % nd)
         for c in range(size)])


def broadcast(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """``MPI_Bcast``: every rank gets root's shard."""
    return _everywhere(x[root:root + 1], x.shape[0])
