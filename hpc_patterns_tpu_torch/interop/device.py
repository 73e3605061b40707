"""In-place proofs on the device — the counterpart of
``hpc_patterns_tpu/interop/device.py``.

The reference proves its device-context leg with OpenMP and SYCL kernels
sharing one Level-Zero context (interop_omp_ze_sycl.cpp:81-101). Here:

- :func:`donation_alias_proof` — PyTorch's own in-place ops (``mul_``,
  ``add_``) write into the input's storage (the counterpart of jit
  donation);
- :func:`kernel_alias_proof` — the counterpart of ``pallas_alias_proof``:
  the separately compiled CUDA library (``csrc/alias_inplace.cu``) writes
  ``x * 2 + 1`` into a buffer PyTorch allocated, in place.

Both prove aliasing by ``data_ptr`` identity before and after, and check
the values (the reference's assert style). On the CPU the plain version
runs and the evidence says so (``interpret=True``).
"""

from __future__ import annotations

import ctypes

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.topology import resolve_device

#: kernel launches in this process (the main-path witness)
launches = 0


def alias_inplace_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x = x * 2 + 1`` in place; returns ``x``."""
    return x.mul_(2.0).add_(1.0)


def alias_inplace(x: torch.Tensor) -> torch.Tensor:
    """``x = x * 2 + 1`` written into ``x``'s own buffer; returns ``x``
    (same ``data_ptr``). CUDA: the kernel (contiguous float32 only).
    CPU: :func:`alias_inplace_reference`."""
    global launches
    if x.dtype != torch.float32:
        raise ValueError(f"alias_inplace takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return alias_inplace_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("alias_inplace takes a contiguous tensor")
    fn = _build.load("alias_inplace").alias_inplace
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = x.data_ptr()
    with torch.cuda.device(x.device):
        rc = fn(ptr, x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "alias_inplace")
    launches += 1
    if x.data_ptr() != ptr:
        raise RuntimeError("alias_inplace: the tensor moved")
    return x


def kernel_alias_proof(rows: int = 8, cols: int = 128, device=None):
    """The in-place kernel on a PyTorch-allocated ``(rows, cols)`` float32
    buffer. Returns ``(ok, evidence)``: ``pointer_ok`` (``data_ptr``
    before == after), ``values_ok``, and ``interpret`` (True when the
    plain version ran on the CPU)."""
    dev = resolve_device(device)
    x = torch.arange(rows * cols, dtype=torch.float32,
                     device=dev).reshape(rows, cols)
    want = x.cpu() * 2.0 + 1.0
    ptr_in = x.data_ptr()
    out = alias_inplace(x)
    ptr_out = out.data_ptr()
    values_ok = bool(torch.equal(out.cpu(), want))
    ev = {"pointer_ok": ptr_in == ptr_out, "values_ok": values_ok,
          "interpret": dev.type == "cpu", "ptr": ptr_in}
    return bool(ev["pointer_ok"] and values_ok), ev


def donation_alias_proof(n: int = 1 << 14, device=None):
    """PyTorch in-place ops writing into the input's storage: ``x = x * 3
    + 1`` via ``mul_``/``add_``. Returns ``(ok, evidence)``."""
    dev = resolve_device(device)
    x = torch.full((n,), 2.0, dtype=torch.float32, device=dev)
    ptr_in = x.data_ptr()
    out = x.mul_(3.0).add_(1.0)
    values_ok = bool((out == 7.0).all())
    ev = {"pointer_ok": out.data_ptr() == ptr_in, "values_ok": values_ok}
    return bool(ev["pointer_ok"] and values_ok), ev
