"""Exact-softmax paged-attention decode (``decode_attn="paged_flash"``):
the counterpart of ``hpc_patterns_tpu/ops/paged_attention.py``.

On CUDA tensors :func:`paged_attention_decode` launches the hand-written
Hopper kernel ``csrc/paged_attention.cu`` (replacing
``_paged_attention_kernel``) or raises; on CPU tensors it computes its
plain version, the gather route (``models/decode.py::
_paged_attend_gather``: dequantize, scores, mask -1e30, softmax, p.v),
which is :func:`~hpc_patterns_tpu_torch.ops.flash_decode.
flash_decode_paged_reference`.

The JAX kernel stages the whole allocated K/V span in VMEM. The card's
kernel does not: it keeps the (g, pages * P) f32 score row in shared
memory and streams K once and V once. A score row past the card's
shared-memory budget raises ``ValueError`` naming the limit; long
contexts belong on the online-softmax ``flash`` route.
"""

from __future__ import annotations

import ctypes

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.ops.flash_decode import (
    _check_paged,
    _ptr,
    check_kernel_operands,
    check_scales,
    flash_decode_paged_reference,
    kernel_pos,
)

#: the mask constant; equal to the flash routes' (a test pins it)
_NEG_INF = -1e30

#: kernel launches in this process (the main-path witness)
launches = 0

#: dynamic shared memory one block of the H100 may use (232,448 bytes)
SMEM_LIMIT = 227 * 1024
_THREADS = 128


def smem_bytes(H: int, Hkv: int, D: int, P: int, pages: int,
               dtype: torch.dtype) -> int:
    """Bytes of shared memory one launch needs (``csrc/paged_attention.cu``
    ``smem_bytes``): the (g, D) queries, the (g, pages * P) score row and
    the (RG, g, D) partial accumulators, all f32."""
    g = H // Hkv
    n = 16 // torch.empty((), dtype=dtype).element_size()  # values per load
    rg = _THREADS // (D // n)
    return 4 * (g * D + g * pages * P + rg * g * D)


def paged_attention_decode(q, k_pool, v_pool, table, pos, *,
                           k_scale_pool=None, v_scale_pool=None,
                           scale: float | None = None):
    """Single-query attention against a paged KV pool, exact-softmax form.

    ``q`` (B, H, D); ``k_pool``/``v_pool`` (n_pool, Hkv, P, D) in the
    compute dtype, int8 or float8_e4m3fn; ``table`` (B, pages) int32;
    ``pos``: a shared int or (B,) per-sequence positions.
    ``k_scale_pool``/``v_scale_pool`` (n_pool, Hkv, 1, P) f32 per-row
    dequant scales: required for one-byte pools, refused for
    compute-dtype ones. Returns (B, H, D) f32, the gather route's
    numbers. CUDA: the Hopper kernel (f32/bf16 q; pools of q's dtype or
    one-byte; D in (16, 32, 64, 128); H / Hkv <= 8; a score row within
    :data:`SMEM_LIMIT`); anything else raises. CPU: the gather route."""
    global launches
    _check_paged(q, k_pool, v_pool, table, pos)
    quantized = check_scales(k_pool, k_scale_pool, v_scale_pool)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(
            q, k_pool, v_pool, table, pos, scale,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    n_pool, Hkv, P, _ = k_pool.shape
    pages = table.shape[1]
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    scales = ((("k_scale_pool", k_scale_pool),
               ("v_scale_pool", v_scale_pool)) if quantized else ())
    qc, kc = check_kernel_operands(
        q, (("k_pool", k_pool), ("v_pool", v_pool)), scales,
        (("table", table),))
    need = smem_bytes(H, Hkv, D, P, pages, k_pool.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"paged_flash keeps the (g={H // Hkv}, pages*P={pages * P}) f32 "
            f"score row in shared memory: {need} bytes > the {SMEM_LIMIT}-"
            "byte limit of one block; serve this context on the online-"
            "softmax route (decode_attn='flash')")
    pos_ptr, pos_scalar = kernel_pos(pos, q)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    fn = _build.load("paged_attention").paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                _ptr(k_scale_pool), _ptr(v_scale_pool), table.data_ptr(),
                pos_ptr, pos_scalar, out.data_ptr(), B, H, Hkv, D, P, pages,
                n_pool, float(scale), qc, kc, stream)
    _build.check(rc, "paged_attention")
    launches += 1
    return out
