"""Library collectives over logical ranks — the counterpart of
``hpc_patterns_tpu/comm/collectives.py`` (the ``MPI_Allreduce`` side of
the reference's ring-vs-library comparison, allreduce-mpi-sycl.cpp:
61-67).

Every function takes the global ``(size, ...)`` tensor (row r = rank r's
buffer, see :mod:`.ring`) and returns the global result, each rank's row
holding what that rank would receive. These are plain PyTorch reductions
over dim 0: the library route the hand-built rings are raced against.

Across processes (``block``, a :class:`~.processes.RankBlock`), ``x``
holds this process's rows only: the rows of every process are gathered
through gloo (:func:`.processes.gather_rows`), reduced by the same
one-process function, and this process keeps its own rows, so each
result equals the one-process one bit for bit.
"""

from __future__ import annotations

import torch

from hpc_patterns_tpu_torch.comm import processes


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


def _across(fn, x: torch.Tensor, block) -> torch.Tensor:
    """``fn`` over the global rows; this process's rows of its result."""
    if not processes.spans(block):
        return fn(x)
    out = fn(processes.gather_rows(x, block))
    return out[block.start:block.start + block.local].contiguous()


def allreduce(x: torch.Tensor, op: str = "sum", *, block=None
              ) -> torch.Tensor:
    """``MPI_Allreduce``: every rank gets the elementwise reduction."""
    try:
        fn = _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(
            f"unknown reduce op {op!r}; have {sorted(_REDUCE_OPS)}") from None
    return _across(lambda v: _everywhere(fn(v), v.shape[0]), x, block)


def all_gather(x: torch.Tensor, *, tiled: bool = True,
               gather_axis: int = 0, block=None) -> torch.Tensor:
    """``MPI_Allgather``: ``tiled`` concatenates the shards along
    ``gather_axis`` of the shard, else stacks them: ``(size, size,
    *shard)``."""
    def fn(v):
        if tiled:
            one = torch.cat(torch.unbind(v, dim=0),
                            dim=gather_axis % (v.dim() - 1))[None]
        else:
            one = v[None]
        return _everywhere(one, v.shape[0])
    return _across(fn, x, block)


def reduce_scatter(x: torch.Tensor, *, scatter_axis: int = 0,
                   op: str = "sum", block=None) -> torch.Tensor:
    """``MPI_Reduce_scatter``: rank r gets chunk r of the sum along
    ``scatter_axis`` of the shard."""
    if op != "sum":
        raise ValueError("reduce_scatter supports op='sum'")
    size = block.world if block is not None else x.shape[0]
    ax = scatter_axis % (x.dim() - 1) + 1
    if x.shape[ax] % size:
        raise ValueError(
            f"scatter axis length {x.shape[ax]} not divisible by {size}")
    return _across(lambda v: torch.cat(torch.chunk(
        v.sum(dim=0, keepdim=True), size, dim=ax), dim=0), x, block)


def all_to_all(x: torch.Tensor, *, split_axis: int = 0,
               concat_axis: int = 0, block=None) -> torch.Tensor:
    """``MPI_Alltoall``: rank r's chunk c lands on rank c at position r
    (the Ulysses sequence-parallel primitive)."""
    def fn(v):
        size = v.shape[0]
        nd = v.dim() - 1
        chunks = torch.chunk(v, size, dim=split_axis % nd + 1)  # [c](size,)
        return torch.stack(
            [torch.cat(torch.unbind(chunks[c], dim=0), dim=concat_axis % nd)
             for c in range(size)])
    return _across(fn, x, block)


def broadcast(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """``MPI_Bcast``: every rank gets root's shard."""
    return _everywhere(x[root:root + 1], x.shape[0])
