"""JAX params tree -> the port's params: the same keys, the same stacked
(L, ...) layer layout, every leaf a torch tensor. The caller hands the
tree over as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module needs no JAX."""

from __future__ import annotations

import numpy as np
import torch

from hpc_patterns_tpu_torch.topology import resolve_device


def params_from_jax(tree, *, device=None, dtype: torch.dtype | None = None):
    """Map a (nested dict of) numpy array tree onto torch tensors on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). Floating leaves take ``dtype`` when given (else
    keep theirs); integer leaves keep theirs."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        # a copy: the caller's arrays (often read-only views of JAX
        # buffers) are never aliased by tensors the port may write
        t = torch.from_numpy(np.array(x, copy=True, order="C"))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)
