"""Zero-copy buffer sharing between runtimes — the counterpart of
``hpc_patterns_tpu/interop/zero_copy.py``.

The reference proves OMP<->SYCL zero-copy by writing through one runtime
and reading through the other (interop_omp_ze_sycl.cpp:81-101). The port
has no JAX, so its runtime pairs are its own: the native C++ allocator
(hpcpat.cpp) <-> numpy <-> PyTorch on the host, and PyTorch CUDA <->
DLPack <-> PyTorch CUDA on the card. Every bridge returns the shared view
AND the proof — *pointer identity* between producer and consumer, which a
copy could not pass (a value check could).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.dlpack


def numpy_to_torch(x: np.ndarray) -> tuple[torch.Tensor, bool]:
    """Host memory into PyTorch, zero-copy: ``(tensor, zero_copy)``."""
    t = torch.from_numpy(x)
    return t, t.data_ptr() == x.ctypes.data


def torch_to_numpy(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """A CPU tensor out to numpy, zero-copy: ``(array, zero_copy)``."""
    out = t.numpy()
    return out, out.ctypes.data == t.data_ptr()


def native_to_torch(buf) -> tuple[torch.Tensor, bool]:
    """The reference chain: native-allocator memory -> numpy view ->
    PyTorch tensor, all aliasing one allocation (≙ omp_target_alloc memory
    read by a SYCL queue, interop_omp_ze_sycl.cpp:81-91)."""
    view = buf.as_numpy()
    if view.ctypes.data != buf.address:
        raise RuntimeError("numpy view must alias the native buffer")
    t, zc = numpy_to_torch(view)
    return t, zc and t.data_ptr() == buf.address


def torch_dlpack_roundtrip(t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """A tensor (CUDA or CPU) exported as a DLPack capsule and imported
    back: ``(tensor, zero_copy)`` by pointer identity."""
    back = torch.utils.dlpack.from_dlpack(torch.utils.dlpack.to_dlpack(t))
    return back, back.data_ptr() == t.data_ptr()
