"""ctypes bindings for the native support library (native/hpcpat.cpp) —
a copy of ``hpc_patterns_tpu/interop/native.py`` (which imports no JAX),
kept here because the port imports nothing of the JAX package.

The binding is plain ctypes over an
``extern "C"`` surface — the same spirit as the reference's C MPI API
use (mpi_datatype.hpp). The library is built by ``make -C native`` (or
:func:`build` — loading never compiles as a side effect); when the .so
is absent the module degrades gracefully (``available()`` → False,
Python fallbacks take over), the reference's whole-GPU-fallback
philosophy (devices.hpp:33-38).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "libhpcpat.so"

_lib = None
_load_failed = False


def build() -> bool:
    """Explicitly build the native library (``make -C native``). The
    only place a compiler run happens — loading never builds as a side
    effect, so a fresh checkout's first timing call stays cheap."""
    global _load_failed
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True, capture_output=True, timeout=120,
        )
        _load_failed = False
        return _load() is not None
    except Exception:
        return False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not _SO.exists():
            raise FileNotFoundError(f"{_SO} not built (run native.build())")
        lib = ctypes.CDLL(str(_SO))
        lib.hp_stats.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.hp_roundtrip.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.hp_aligned_alloc.restype = ctypes.c_void_p
        lib.hp_aligned_alloc.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.hp_free.argtypes = [ctypes.c_void_p]
        lib.hp_fill.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ]
        lib.hp_iota.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.hp_validate.restype = ctypes.c_int64
        lib.hp_validate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.hp_ring_plan.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.hp_ring_phase.restype = ctypes.c_int32
        lib.hp_ring_phase.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except Exception:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _require_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library unavailable (run hpc_patterns_tpu_torch.interop."
            "native.build() or `make -C native`)"
        )
    return lib


class _OwnedView(np.ndarray):
    """ndarray subclass that holds a strong reference to the owning
    AlignedBuffer, so views (and dlpack consumers of them, which keep
    the exporting array alive) can never outlive the C allocation."""

    _owner = None


def stats(samples) -> dict:
    """min/max/mean/std computed in C (≙ the per-app chrono reductions)."""
    lib = _require_lib()
    xs = np.ascontiguousarray(samples, np.float64)
    out = np.zeros(4, np.float64)
    lib.hp_stats(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), xs.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return {"min": out[0], "max": out[1], "mean": out[2], "std": out[3]}


def stats_roundtrip(samples):
    """Samples through native memory and back (binding health check used
    by harness.timing)."""
    lib = _require_lib()
    xs = np.ascontiguousarray(samples, np.float64)
    out = np.empty_like(xs)
    lib.hp_roundtrip(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), xs.size,
    )
    return out.tolist()


class AlignedBuffer:
    """float32 buffer from the native aligned allocator, exposed to
    numpy zero-copy (≙ the reference's USM allocations crossing
    runtimes). Frees the C memory when garbage collected."""

    def __init__(self, n_elements: int, alignment: int = 128):
        self._lib = _require_lib()
        self.n_elements = int(n_elements)
        self.alignment = int(alignment)
        self._ptr = self._lib.hp_aligned_alloc(self.n_elements * 4, self.alignment)
        if not self._ptr:
            raise MemoryError(
                f"hp_aligned_alloc({n_elements * 4}, {alignment}) failed"
            )

    @property
    def address(self) -> int:
        return int(self._ptr)

    def as_numpy(self) -> np.ndarray:
        """Zero-copy numpy view of the native memory. The view keeps this
        buffer alive (no use-after-free when the AlignedBuffer goes out
        of scope while views — or dlpack importers of them — remain)."""
        buf = (ctypes.c_float * self.n_elements).from_address(self._ptr)
        view = np.ctypeslib.as_array(buf).view(_OwnedView)
        view._owner = self
        return view

    def fill(self, value: float) -> None:
        self._lib.hp_fill(
            ctypes.cast(self._ptr, ctypes.POINTER(ctypes.c_float)),
            self.n_elements, ctypes.c_float(value),
        )

    def iota(self, base: float = 0.0, step: float = 1.0) -> None:
        self._lib.hp_iota(
            ctypes.cast(self._ptr, ctypes.POINTER(ctypes.c_float)),
            self.n_elements, ctypes.c_float(base), ctypes.c_float(step),
        )

    def validate(self, expected: float, tol: float = 1e-6) -> int:
        """Index of first mismatching element, or -1 (all good) — the C
        version of the analytic-oracle check (allreduce-mpi-sycl.cpp:
        192-204)."""
        return int(
            self._lib.hp_validate(
                ctypes.cast(self._ptr, ctypes.POINTER(ctypes.c_float)),
                self.n_elements, ctypes.c_float(expected), ctypes.c_float(tol),
            )
        )

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.hp_free(ptr)


def ring_plan(size: int, shift: int = 1) -> list[tuple[int, int]]:
    """(src, dst) pairs for one ring step, computed natively — must match
    comm.ring._ring_perm exactly (cross-language cross-check)."""
    lib = _require_lib()
    src = np.zeros(size, np.int32)
    dst = np.zeros(size, np.int32)
    lib.hp_ring_plan(
        size, shift,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return list(zip(src.tolist(), dst.tolist()))


def ring_phase_senders(size: int, phase: int) -> list[int]:
    """The even/odd deadlock-freedom ordering (allreduce-mpi-sycl.cpp:
    50-58): phase 0 = even ranks send, phase 1 = odd."""
    lib = _require_lib()
    out = np.zeros(size, np.int32)
    n = lib.hp_ring_phase(size, phase,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out[:n].tolist()
