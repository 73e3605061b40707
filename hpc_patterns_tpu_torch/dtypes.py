"""Config dtype names -> torch dtypes (the counterpart of
``hpc_patterns_tpu/dtypes.py`` for the names this slice uses)."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype; anything else
    raises (fp8/int8 storage belongs to a later slice)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype {name!r} not in {tuple(_DTYPES)}") from None
