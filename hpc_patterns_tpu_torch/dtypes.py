"""Dtype traits — the counterpart of ``hpc_patterns_tpu/dtypes.py``.

Two tables:

- :func:`torch_dtype`: the model compute dtypes a config may name
  (``float32``, ``bfloat16``) and the one-byte KV storage dtypes
  (``int8``, ``float8_e4m3fn``), with :func:`supports_fp8` for the
  latter;
- :data:`REGISTRY`: the collectives' dtype traits, the analog of the
  reference's ``mpi_datatype.hpp`` trait template (10 specializations and
  an ``MPI_BYTE`` default, mpi_datatype.hpp:24-51). Same ten entries,
  exactness and validation tolerances as the JAX registry; an unlisted
  dtype gets the byte default (exact, bytewise compare).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    # KV storage only (models/decode.py::_kv_storage_dtype)
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: str) -> torch.dtype:
    """A dtype name of :data:`_DTYPES` -> the torch dtype; anything else
    raises."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype {name!r} not in {tuple(_DTYPES)}") from None


_FP8_SUPPORT: dict[str, bool] = {}


def supports_fp8(device=None) -> bool:
    """Can ``device`` (default: ``cuda`` when a card is present, else
    the CPU) run the fp8 KV pipeline: store ``float8_e4m3fn``, widen it
    to f32 and matmul the result? Probed once per device type by running
    that op sequence; any error reads as "no". A card also needs compute
    capability >= 8.9 (fp8 arrived with Ada and Hopper). The counterpart
    of ``hpc_patterns_tpu/dtypes.py::supports_fp8``: the ``--kv-dtype``
    resolver (``harness/cli.py``) degrades fp8 to int8 with a note when
    this fails."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type not in _FP8_SUPPORT:
        ok = True
        try:
            if dev.type == "cuda":
                ok = torch.cuda.get_device_capability(dev) >= (8, 9)
            if ok:
                x = torch.linspace(-1.0, 1.0, 16, device=dev)
                q = (x * 448.0).to(torch.float8_e4m3fn)
                a = q.float().reshape(4, 4)
                ok = bool(torch.isfinite(a @ a).all())
        except Exception:  # noqa: BLE001 - any failure means "no fp8"
            ok = False
        _FP8_SUPPORT[dev.type] = ok
    return _FP8_SUPPORT[dev.type]


@dataclasses.dataclass(frozen=True)
class DtypeTraits:
    dtype: torch.dtype
    itemsize: int
    exact_sum: bool  # integer/exact accumulate: validation uses ==
    tensor_core_native: bool  # a Hopper tensor-core input type
    tolerance: float  # allreduce validation tolerance (reference: 1e-6,
    # allreduce-mpi-sycl.cpp:197)

    @property
    def name(self) -> str:
        return str(self.dtype).removeprefix("torch.")


def _t(dt: torch.dtype, exact: bool, tc: bool, tol: float) -> DtypeTraits:
    return DtypeTraits(dt, torch.tensor([], dtype=dt).element_size(), exact,
                       tc, tol)


# the 10 scalar specializations of mpi_datatype.hpp:28-51
REGISTRY: dict[str, DtypeTraits] = {
    "float32": _t(torch.float32, False, False, 1e-6),
    "float16": _t(torch.float16, False, True, 1e-2),
    "bfloat16": _t(torch.bfloat16, False, True, 1e-2),
    "float64": _t(torch.float64, False, False, 1e-12),
    "int8": _t(torch.int8, True, False, 0.0),
    "int16": _t(torch.int16, True, False, 0.0),
    "int32": _t(torch.int32, True, False, 0.0),
    "int64": _t(torch.int64, True, False, 0.0),
    "uint8": _t(torch.uint8, True, False, 0.0),
    "uint32": _t(torch.uint32, True, False, 0.0),
}


def get_traits(dtype) -> DtypeTraits:
    """Traits for ``dtype`` (a registry name or a ``torch.dtype``);
    unlisted dtypes get the byte default (exact, bytewise), as the
    reference's MPI_BYTE fallback (mpi_datatype.hpp:24-26)."""
    if isinstance(dtype, str):
        if dtype in REGISTRY:
            return REGISTRY[dtype]
        raise ValueError(f"unknown dtype name {dtype!r}; have "
                         f"{sorted(REGISTRY)}")
    name = str(dtype).removeprefix("torch.")
    if name in REGISTRY:
        return REGISTRY[name]
    return _t(dtype, True, False, 0.0)


def validate_allreduce(result, expected_scalar, dtype) -> bool:
    """The analytic-oracle check: every element equals the closed-form
    expected value (allreduce-mpi-sycl.cpp:192-204). ``result`` is a
    numpy array or a CPU tensor."""
    traits = get_traits(dtype)
    if torch.is_tensor(result):
        result = (result.float() if result.dtype == torch.bfloat16
                  else result).numpy()
    if traits.exact_sum:
        # compare in the integer dtype: a float64 cast would lose
        # precision past 2**53 and false-PASS wrong int64 results
        arr = np.asarray(result)
        return bool(np.all(arr == arr.dtype.type(expected_scalar)))
    arr = np.asarray(result, dtype=np.float64)
    expected = float(expected_scalar)
    bound = traits.tolerance + 1e-6 * abs(expected)  # atol + rtol form
    return bool(np.all(np.abs(arr - expected) <= bound))
