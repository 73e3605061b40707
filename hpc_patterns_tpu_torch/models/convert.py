"""JAX tree -> the port's tree: the same keys, the same stacked (L, ...)
layer layout, every leaf a torch tensor. The caller hands the tree over
as numpy arrays (``jax.tree.map(np.asarray, tree)``), so this module
needs no JAX. Params trees (int8-quantized ones included) and KV caches
(linear or paged, quantized or not: dicts of per-layer tuples) both
carry across."""

from __future__ import annotations

import numpy as np
import torch

from hpc_patterns_tpu_torch.models.transformer import QUANT_SCALE_SUFFIX
from hpc_patterns_tpu_torch.topology import resolve_device

#: numpy has no bfloat16 or float8: JAX hands them over as ml_dtypes
#: arrays, which cross through an integer view of the same width
_VIA_INT = {"bfloat16": (np.uint16, torch.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn)}
#: leaves that stay float32 whatever ``dtype`` is asked: int8 weights'
#: per-channel scales and the KV caches' per-row dequant scales
_SCALE_KEYS = ("k_scale", "v_scale")
#: the float dtypes ``dtype`` applies to (one-byte storage keeps its own)
_CASTABLE = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _is_scale(key) -> bool:
    return isinstance(key, str) and (key.endswith(QUANT_SCALE_SUFFIX)
                                     or key in _SCALE_KEYS)


def _leaf(x) -> torch.Tensor:
    # a copy: the caller's arrays (often read-only views of JAX buffers)
    # are never aliased by tensors the port may write
    a = np.array(x, copy=True, order="C")
    via = _VIA_INT.get(a.dtype.name)
    if via is None:
        return torch.from_numpy(a)
    np_int, torch_int, torch_dt = via
    return torch.from_numpy(a.view(np_int)).view(torch_int).view(torch_dt)


def params_from_jax(tree, *, device=None, dtype: torch.dtype | None = None):
    """Map a tree of numpy arrays (nested dicts, tuples and lists) onto
    torch tensors on ``device`` (default ``cuda``; raises without a GPU
    unless ``device="cpu"``), bytes unchanged. ``dtype``, when given,
    applies to f16/bf16/f32/f64 leaves except the scale leaves
    (``*_qscale``, ``k_scale``, ``v_scale``), which stay float32;
    integer and one-byte (int8, float8) leaves keep theirs."""
    dev = resolve_device(device)

    def conv(x, key=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v, key) for v in x)
        t = _leaf(x)
        if dtype is not None and t.dtype in _CASTABLE and not _is_scale(key):
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def _find_adam(state):
    """The first node of an optax state tree with ``mu``, ``nu`` and
    ``count`` (``ScaleByAdamState``), depth first."""
    if all(hasattr(state, a) for a in ("mu", "nu", "count")):
        return state
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, *, device=None):
    """optax's ``chain(clip_by_global_norm, adamw)`` state (handed over as
    numpy leaves, e.g. ``jax.tree.map(np.asarray, opt_state)``) -> the
    port's AdamW state ``{"mu", "nu", "count"}`` on ``device``: the adam
    moments tree for tree, the update count as an int (the schedule's
    count, where there is one, moves in step with it)."""
    adam = _find_adam(state)
    if adam is None:
        raise ValueError("no optax adam state (mu, nu, count) in the tree")
    return {"mu": params_from_jax(adam.mu, device=device),
            "nu": params_from_jax(adam.nu, device=device),
            "count": int(np.asarray(adam.count))}
