"""Tensor parallelism: column/row sharded matmuls over logical ranks — the
counterpart of ``hpc_patterns_tpu/parallel/tensor.py``.

Megatron-style TP with the comm layer: the row-parallel reduction is the
reference's allreduce, the library collective or the hand-built ring
(allreduce-mpi-sycl.cpp:61-67 vs :173-182). Every tensor is rank-stacked
(row r of the leading dim is rank r's shard or replica), as in ``comm/``.

The trunk's forms (:func:`column_parallel_in`, :func:`row_parallel_out`)
take a replicated input as the one tensor it is on every rank and give
the row-parallel sum once (every rank's replica is that tensor), with the
tp rank dim at any place among other rank dims: a replica is never a
copy on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpc_patterns_tpu_torch.comm import collectives, ring

ROW_ALGORITHMS = ("collective", "ring")


def _local_matmul(x, w):
    """Each rank's ``x_r @ w_r`` as ONE batched product over the rank
    dim: x (P, ..., d) (a stride-0 broadcast is read in place), w (P, d,
    f) -> (P, ..., f)."""
    P, lead = w.shape[0], x.shape[1:-1]
    y = torch.matmul(x.reshape(P, -1, x.shape[-1]), w)
    return y.reshape(P, *lead, w.shape[-1])


def column_parallel(x, w_local, b_local=None):
    """``Y_r = x_r @ W_r``: weights column-sharded ``(P, d, f/P)``,
    activations replicated in, feature-sharded out. No communication."""
    y = _local_matmul(x, w_local)
    if b_local is not None:
        y = y + b_local.reshape(b_local.shape[0], *([1] * (y.dim() - 2)),
                                b_local.shape[-1])
    return y


def row_parallel(x_local, w_local, b=None, *, algorithm: str = "collective"):
    """``Y = sum_r x_r @ W_r`` on every rank: weights row-sharded, inputs
    feature-sharded, the sum by allreduce — ``"collective"``
    (``collectives.allreduce``) or ``"ring"`` (``ring.ring_allreduce``),
    the miniapp's ``-a`` switch."""
    if algorithm not in ROW_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    partial = _local_matmul(x_local, w_local)
    if algorithm == "collective":
        y = collectives.allreduce(partial, "sum")
    else:
        y = ring.ring_allreduce(partial)
    return y if b is None else y + b


def row_parallel_scatter(x_local, w_local, *, scatter_axis: int = -1):
    """Row-parallel matmul ending in reduce-scatter: rank r keeps chunk r
    of the sum along ``scatter_axis`` of the shard (the
    sequence-parallel-Megatron fusion)."""
    partial = _local_matmul(x_local, w_local)
    return collectives.reduce_scatter(
        partial, scatter_axis=scatter_axis % (partial.dim() - 1))


def tp_mlp(x, w_in_local, w_out_local, *, activation=None,
           algorithm: str = "collective"):
    """The TP block: column-parallel in-projection, the activation on the
    shard (tanh gelu, as ``jax.nn.gelu``), row-parallel out-projection —
    one allreduce a block."""
    h = column_parallel(x, w_in_local)
    h = (activation or (lambda t: F.gelu(t, approximate="tanh")))(h)
    return row_parallel(h, w_out_local, algorithm=algorithm)


def column_parallel_in(x, w_local):
    """Column-parallel ``Y_r = x @ W_r`` with ``x`` replicated, given
    once (no rank dim): w (P, d, f/P) -> (P, ..., f/P), one launch over
    the ranks. Its backward sums the ranks' input gradients (the
    allreduce Megatron's column-parallel input takes in the backward)."""
    return column_parallel(x.expand(w_local.shape[0], *x.shape), w_local)


def row_parallel_out(x_local, w_local, *, dim: int = 0):
    """Row-parallel ``Y = sum_r x_r @ W_r``: the ranks' partial products
    (one launch over the ranks), then the allreduce's sum over the rank
    dim ``dim`` of ``x_local``'s leading rank dims, held once. x (...P...,
    n, f/P) with the tp ranks at ``dim``, w (P, f/P, d)."""
    return _local_matmul(torch.movedim(x_local, dim, 0), w_local).sum(0)
