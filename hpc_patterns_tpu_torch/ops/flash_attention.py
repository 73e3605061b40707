"""Causal flash-attention forward: the counterpart of
``hpc_patterns_tpu/ops/flash_attention.py::flash_attention``.

On a CUDA tensor :func:`flash_attention` launches the hand-written
Hopper kernel ``csrc/flash_prefill.cu`` (or raises); on a CPU tensor it
computes :func:`flash_attention_reference`, the dense masked softmax.
Forward only — the serving path needs neither the backward nor the
logsumexp (``need_lse=False`` on inference).
"""

from __future__ import annotations

import ctypes

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.parallel.ring_attention import full_attention

#: kernel launches in this process (the main-path witness)
launches = 0

#: the kernel's query/key tile; T must be a multiple of it
BLOCK = 64

_HEAD_DIMS = (16, 32, 64, 128)


def _check_gqa(q, k, v) -> None:
    if q.ndim != 4:
        raise ValueError(f"want (batch, seq, heads, head_dim), got "
                         f"{tuple(q.shape)}")
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != T
            or k.shape[3] != D or H % max(Hkv, 1)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (kv heads must divide n_heads)")


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: float | None = None):
    """The kernel's plain version: dense grouped-query softmax in f32
    (q head h reads kv head h // (H / Hkv)), returned in ``q.dtype`` —
    ``_dense_forward``'s math in the JAX module, which for causal
    self-attention (no fully masked row) is ``full_attention``'s."""
    _check_gqa(q, k, v)
    return full_attention(q, k, v, causal=causal, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Softmax attention over (B, T, H, D) queries and (B, T, Hkv, D)
    keys/values (the JAX layout). CUDA: the Hopper kernel, bf16 only,
    T a multiple of :data:`BLOCK`, D in (16, 32, 64, 128); anything else
    raises. CPU: :func:`flash_attention_reference`."""
    global launches
    _check_gqa(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                             "bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if T % BLOCK or D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes T % {BLOCK} == 0 and D in "
                         f"{_HEAD_DIMS}; got T={T}, D={D}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.load("flash_prefill")
    fn = lib.flash_prefill_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, T, H, Hkv, D, float(scale), int(bool(causal)), stream)
    _build.check(rc, "flash_prefill_fwd")
    launches += 1
    return out
