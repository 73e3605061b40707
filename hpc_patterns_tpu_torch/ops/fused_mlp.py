"""Fused transformer MLP (matmul -> gelu -> matmul): the counterpart of
``hpc_patterns_tpu/ops/fused_mlp.py``.

``y = gelu(x W1) W2`` with the (tokens, d_ff) activation never written
to device memory in the forward. Kernels (``csrc/fused_mlp.cu``), each
with its plain PyTorch version beside it:

- the forward (the TPU ``_fwd_kernel``): a cluster of CTAs shares each
  128-token tile, each CTA owning a slice of y's columns in registers; the
  d_ff axis streams through in panels: a = x W1f (f32), g = gelu(a)
  rounded to x's dtype and exchanged between the cluster's CTAs in shared
  memory, y += g W2f in f32, y rounded once at the end;
- the save-a forward (``_fwd_kernel_save_a``): the same, also writing the
  pre-gelu ``a`` (N, F) in x's dtype for the ``xla_a`` backward;
- the backward (the TPU ``_bwd_kernel``). The TPU kernel holds (D, bf)
  f32 dW accumulators in VMEM and writes an (F/bf, N, D) partial-dx slab;
  an SM holds neither at a width that fills it. So ``bwd_dx`` recomputes
  a and dh = dy W2fᵀ tile by tile and writes g and da = dh gelu'(a)
  (rounded to x's dtype), then forms dx = da W1fᵀ in f32 (two launches);
  ``bwd_dw`` then forms dW1 = xᵀ da and dW2 = gᵀ dy, each output tile
  owned by one CTA over the whole token axis. Five block products in all,
  as on the TPU; deterministic (no float atomics).

On a CUDA tensor each wrapper launches its kernel (bf16, contiguous,
16-byte aligned, d_model a multiple of 128 up to 1024, d_ff a multiple of
8) or raises; on a CPU tensor it computes its plain version. The autograd
function, the backward modes and the residuals are the same code on both,
so the CPU tests cover them.

Rounding: g and da are rounded to x's dtype before the products that read
them, and dW accumulates in f32 and is cast to w's dtype, as on the TPU.
The TPU kernel rounds each d_ff panel's dx partial to x's dtype (its slab
lives in device memory) and sums the partials in f32; here dx stays in an
f32 accumulator over all of d_ff and is rounded once.

The backward strategy is the JAX module's env knob, read once per forward
and kept with the residuals (:data:`BWD_MODES`).
"""

from __future__ import annotations

import ctypes
import os

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.ops.tiling import fit_block_divisor

#: kernel launches in this process (the main-path witness)
launches = {"fwd": 0, "fwd_save_a": 0, "bwd_dx": 0, "bwd_dw": 0}
#: forward passes of :func:`fused_mlp` in this process, on any device
#: (where activation checkpointing reruns the forward, this counts it)
calls = {"forward": 0}

#: ``HPCPAT_FUSED_MLP_BWD``: "kernel" (the backward kernels, residuals
#: x, w1, w2), "xla" (the same five products in torch ops), "xla_a" (the
#: save-a forward kernel, then four products from the saved a)
BWD_MODES = ("kernel", "xla", "xla_a")

#: the kernels' width contract: d_model a multiple of D_MULTIPLE up to
#: MAX_D (the forward's y lives in the registers of a cluster of at most
#: MAX_D / D_MULTIPLE CTAs), d_ff a multiple of F_MULTIPLE (16-byte rows)
D_MULTIPLE = 128
MAX_D = 1024
F_MULTIPLE = 8

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def _gelu(a):
    """tanh-approximation gelu in f32 (``F.gelu(approximate="tanh")``)."""
    u = _SQRT_2_OVER_PI * (a + _GELU_C * a * a * a)
    return 0.5 * a * (1.0 + torch.tanh(u))


def _dgelu(a):
    """d/da of the tanh-approximation gelu, analytic."""
    u = _SQRT_2_OVER_PI * (a + _GELU_C * a * a * a)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * a * a)
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * du


def _bwd_mode() -> str:
    mode = os.environ.get("HPCPAT_FUSED_MLP_BWD", "kernel")
    if mode not in BWD_MODES:
        raise ValueError(f"HPCPAT_FUSED_MLP_BWD={mode!r} not in {BWD_MODES}")
    return mode


# ---------------------------------------------------------------- checks


def _check_shapes(x2, w1, w2) -> None:
    D = x2.shape[-1]
    if (x2.ndim != 2 or w1.ndim != 2 or w2.ndim != 2 or w1.shape[0] != D
            or w2.shape[1] != D or w1.shape[1] != w2.shape[0]):
        raise ValueError(f"shape mismatch: x (..., {D}), w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")


def _on_card(t) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the
    plain versions); anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _check_kernel_operands(named, D, F) -> None:
    """The kernels' contract: one card, bf16, contiguous and 16-byte
    aligned; D a multiple of :data:`D_MULTIPLE` up to :data:`MAX_D`, F a
    multiple of :data:`F_MULTIPLE`."""
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernels take "
                             "torch.bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if D % D_MULTIPLE or not D_MULTIPLE <= D <= MAX_D or F % F_MULTIPLE:
        raise ValueError(
            f"the kernels take d_model a multiple of {D_MULTIPLE} in "
            f"[{D_MULTIPLE}, {MAX_D}] and d_ff a multiple of {F_MULTIPLE}; "
            f"got d_model={D}, d_ff={F}")


def _fn(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- plain


def _blocks(n, cap):
    b = fit_block_divisor(n, cap)
    return [(lo, lo + b) for lo in range(0, n, b)]


def fused_mlp_forward_reference(x2, w1, w2, save_a: bool = False, *,
                                block_t: int = 512, block_f: int = 512):
    """Kernel 8's plain version: y (N, D) in x's dtype, and with
    ``save_a`` also a = x W1 (N, F) rounded to x's dtype. Walks the TPU
    kernel's grid — token blocks of ``block_t``, d_ff panels of
    ``block_f``, both fitted to divisors — with y accumulating over the
    panels in f32, so no (N, F) f32 intermediate exists."""
    N, F = x2.shape[0], w1.shape[1]
    y = torch.empty_like(x2)
    a_out = torch.empty(N, F, dtype=x2.dtype, device=x2.device) \
        if save_a else None
    w1f, w2f = w1.float(), w2.float()
    for t0, t1 in _blocks(N, block_t):
        xb = x2[t0:t1].float()
        acc = None
        for f0, f1 in _blocks(F, block_f):
            a = xb @ w1f[:, f0:f1]
            if save_a:
                a_out[t0:t1, f0:f1] = a
            part = _gelu(a).to(x2.dtype).float() @ w2f[f0:f1]
            acc = part if acc is None else acc + part
        y[t0:t1] = acc
    return (y, a_out) if save_a else y


def fused_mlp_bwd_dx_reference(x2, w1, w2, dy2, *, block_t: int = 512,
                               block_f: int = 512):
    """The dx kernel's plain version: (dx (N, D), g (N, F), da (N, F)),
    all in x's dtype: a = x W1 and dh = dy W2ᵀ in f32, g = gelu(a) and
    da = dh gelu'(a) rounded, dx = da W1ᵀ summed in f32 over the d_ff
    panels and rounded once. The grid as in
    :func:`fused_mlp_forward_reference`."""
    N, F = x2.shape[0], w1.shape[1]
    dx = torch.empty_like(x2)
    g = torch.empty(N, F, dtype=x2.dtype, device=x2.device)
    da = torch.empty_like(g)
    w1f, w2f = w1.float(), w2.float()
    for t0, t1 in _blocks(N, block_t):
        xb, dyb = x2[t0:t1].float(), dy2[t0:t1].float()
        acc = None
        for f0, f1 in _blocks(F, block_f):
            a = xb @ w1f[:, f0:f1]
            g[t0:t1, f0:f1] = _gelu(a)
            dab = (dyb @ w2f[f0:f1].T * _dgelu(a)).to(x2.dtype)
            da[t0:t1, f0:f1] = dab
            part = dab.float() @ w1f[:, f0:f1].T
            acc = part if acc is None else acc + part
        dx[t0:t1] = acc
    return dx, g, da


def fused_mlp_bwd_dw_reference(x2, g, da, dy2, *, block_t: int = 512):
    """The dW kernel's plain version: (dW1 = xᵀ da (D, F), dW2 = gᵀ dy
    (F, D)), both f32, accumulated over token blocks of ``block_t``."""
    dw1 = dw2 = None
    for t0, t1 in _blocks(x2.shape[0], block_t):
        p1 = x2[t0:t1].float().T @ da[t0:t1].float()
        p2 = g[t0:t1].float().T @ dy2[t0:t1].float()
        dw1 = p1 if dw1 is None else dw1 + p1
        dw2 = p2 if dw2 is None else dw2 + p2
    return dw1, dw2


def fused_mlp_backward_reference(x2, w1, w2, dy2, *, block_t: int = 512,
                                 block_f: int = 512):
    """Kernel 9's plain version: (dx, dW1, dW2) in the dtypes of x, w1,
    w2 (the two backward kernels' plain versions in turn)."""
    dx, g, da = fused_mlp_bwd_dx_reference(x2, w1, w2, dy2, block_t=block_t,
                                           block_f=block_f)
    dw1, dw2 = fused_mlp_bwd_dw_reference(x2, g, da, dy2, block_t=block_t)
    return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


# ---------------------------------------------------------------- kernels


def fused_mlp_forward(x2, w1, w2, save_a: bool = False, *,
                      block_t: int = 512, block_f: int = 512):
    """Kernel 8: y (N, D), with ``save_a`` also a (N, F). CUDA: the
    kernel (or raises); CPU: :func:`fused_mlp_forward_reference` on the
    ``block_t`` x ``block_f`` grid (the kernel tiles by the SM)."""
    _check_shapes(x2, w1, w2)
    if not _on_card(x2):
        return fused_mlp_forward_reference(x2, w1, w2, save_a,
                                           block_t=block_t, block_f=block_f)
    N, D = x2.shape
    F = w1.shape[1]
    _check_kernel_operands((("x", x2), ("w1", w1), ("w2", w2)), D, F)
    y = torch.empty_like(x2)
    a = torch.empty(N, F, dtype=x2.dtype, device=x2.device) \
        if save_a else None
    lib = _build.load("fused_mlp")
    with torch.cuda.device(x2.device):
        rc = _fn(lib, "fused_mlp_fwd", 5, 3)(
            x2.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
            a.data_ptr() if save_a else None, N, D, F, _stream(x2))
    _build.check(rc, "fused_mlp_fwd")
    launches["fwd_save_a" if save_a else "fwd"] += 1
    return (y, a) if save_a else y


def fused_mlp_bwd_dx(x2, w1, w2, dy2, *, block_t: int = 512,
                     block_f: int = 512):
    """The backward's dx kernels: (dx, g, da) as
    :func:`fused_mlp_bwd_dx_reference`. CUDA: g and da, then dx (one
    entry point, two launches; or raises); CPU: the plain version."""
    _check_shapes(x2, w1, w2)
    if dy2.shape != x2.shape:
        raise ValueError(f"dy {tuple(dy2.shape)} must match x "
                         f"{tuple(x2.shape)}")
    if not _on_card(x2):
        return fused_mlp_bwd_dx_reference(x2, w1, w2, dy2, block_t=block_t,
                                          block_f=block_f)
    N, D = x2.shape
    F = w1.shape[1]
    _check_kernel_operands((("x", x2), ("w1", w1), ("w2", w2), ("dy", dy2)),
                           D, F)
    dx = torch.empty_like(x2)
    g = torch.empty(N, F, dtype=x2.dtype, device=x2.device)
    da = torch.empty_like(g)
    lib = _build.load("fused_mlp")
    with torch.cuda.device(x2.device):
        rc = _fn(lib, "fused_mlp_bwd_dx", 7, 3)(
            x2.data_ptr(), w1.data_ptr(), w2.data_ptr(), dy2.data_ptr(),
            dx.data_ptr(), g.data_ptr(), da.data_ptr(), N, D, F,
            _stream(x2))
    _build.check(rc, "fused_mlp_bwd_dx")
    launches["bwd_dx"] += 1
    return dx, g, da


def fused_mlp_bwd_dw(x2, g, da, dy2, *, block_t: int = 512):
    """The backward's dW kernel: (dW1 (D, F), dW2 (F, D)) in f32 as
    :func:`fused_mlp_bwd_dw_reference`. CUDA: the kernel (or raises);
    CPU: the plain version."""
    if (x2.shape != dy2.shape or g.shape != da.shape
            or g.shape[0] != x2.shape[0] or x2.ndim != 2 or g.ndim != 2):
        raise ValueError(f"want x, dy (N, D) and g, da (N, F); got x "
                         f"{tuple(x2.shape)}, dy {tuple(dy2.shape)}, g "
                         f"{tuple(g.shape)}, da {tuple(da.shape)}")
    if not _on_card(x2):
        return fused_mlp_bwd_dw_reference(x2, g, da, dy2, block_t=block_t)
    N, D = x2.shape
    F = g.shape[1]
    _check_kernel_operands((("x", x2), ("g", g), ("da", da), ("dy", dy2)),
                           D, F)
    dw1 = torch.empty(D, F, dtype=torch.float32, device=x2.device)
    dw2 = torch.empty(F, D, dtype=torch.float32, device=x2.device)
    lib = _build.load("fused_mlp")
    with torch.cuda.device(x2.device):
        rc = _fn(lib, "fused_mlp_bwd_dw", 6, 3)(
            x2.data_ptr(), g.data_ptr(), da.data_ptr(), dy2.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(), N, D, F, _stream(x2))
    _build.check(rc, "fused_mlp_bwd_dw")
    launches["bwd_dw"] += 1
    return dw1, dw2


# ---------------------------------------------------------------- backward


def _backward_kernel(x2, w1, w2, dy2, blocks):
    """Kernel 9 (both kernels): (dx, dW1, dW2) in the input dtypes."""
    dx, g, da = fused_mlp_bwd_dx(x2, w1, w2, dy2, **blocks)
    dw1, dw2 = fused_mlp_bwd_dw(x2, g, da, dy2, block_t=blocks["block_t"])
    return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


def _products_from_a(x2, a, w1, w2, dy2):
    """The four products after a: g, da, then dW2, dW1 and dx in torch
    ops (f32 accumulation, the rounding points of the kernels)."""
    g = _gelu(a).to(x2.dtype)
    dh = dy2.float() @ w2.float().T
    da = (dh * _dgelu(a)).to(x2.dtype)
    dw2 = g.float().T @ dy2.float()
    dw1 = x2.float().T @ da.float()
    dx = da.float() @ w1.float().T
    return dx.to(x2.dtype), dw1.to(w1.dtype), dw2.to(w2.dtype)


def _backward_xla(x2, w1, w2, dy2):
    """The ``xla`` mode (JAX ``_backward_xla``): recompute a from x, then
    the same products in torch ops — the diagnostic that separates the
    forward kernel's effect from the backward kernels'."""
    return _products_from_a(x2, x2.float() @ w1.float(), w1, w2, dy2)


def _backward_xla_from_a(x2, a, w1, w2, dy2):
    """The ``xla_a`` mode (JAX ``_backward_xla_from_a``): gelu recomputed
    elementwise from the saved pre-activation, no recompute product."""
    return _products_from_a(x2, a.float(), w1, w2, dy2)


def _forward(x2, w1, w2, save_a, blocks):
    calls["forward"] += 1
    return fused_mlp_forward(x2, w1, w2, save_a, **blocks)


class _FusedMLP(torch.autograd.Function):
    """:func:`fused_mlp`'s custom VJP: residuals (x, w1, w2), plus a under
    ``xla_a``; the mode is read once here, so residuals and backward
    always agree."""

    @staticmethod
    def forward(ctx, x2, w1, w2, block_t, block_f):
        mode = _bwd_mode()
        blocks = dict(block_t=block_t, block_f=block_f)
        if mode == "xla_a":
            y, a = _forward(x2, w1, w2, True, blocks)
            ctx.save_for_backward(x2, a, w1, w2)
        else:
            y = _forward(x2, w1, w2, False, blocks)
            ctx.save_for_backward(x2, w1, w2)
        ctx.mode, ctx.blocks = mode, blocks
        return y

    @staticmethod
    def backward(ctx, dy2):
        saved = ctx.saved_tensors
        x2 = saved[0]
        dy2 = dy2.to(x2.dtype).contiguous()
        if ctx.mode == "xla_a":
            grads = _backward_xla_from_a(*saved, dy2)
        elif ctx.mode == "xla":
            grads = _backward_xla(*saved, dy2)
        else:
            grads = _backward_kernel(*saved, dy2, ctx.blocks)
        return (*grads, None, None)


def fused_mlp(x, w1, w2, *, block_t: int = 512, block_f: int = 512):
    """gelu MLP ``x @ w1 -> gelu -> @ w2`` with the (tokens, d_ff)
    activation never in device memory (the forward kernel).

    ``x``: (..., D) in the compute dtype, leading dims flattened to the
    token axis; ``w1`` (D, F) and ``w2`` (F, D) already in the compute
    dtype. Differentiable in all three (the backward per
    :data:`BWD_MODES`). ``block_t``/``block_f`` are the TPU grid's
    request, fitted to divisors of the token count and F (an off-size
    shape never errors); the plain route walks that grid, the kernels
    tile by the SM's budget. CUDA: the Hopper kernels, bf16 only;
    anything else raises. CPU: the plain versions."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    if block_t < 1 or block_f < 1:
        raise ValueError(f"blocks must be >= 1, got block_t={block_t}, "
                         f"block_f={block_f}")
    x2 = x.reshape(-1, D)
    _check_shapes(x2, w1, w2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w2)):
        y2 = _FusedMLP.apply(x2, w1, w2, block_t, block_f)
    else:
        y2 = _forward(x2, w1, w2, False,
                      dict(block_t=block_t, block_f=block_f))
    return y2.reshape(*lead, D)
