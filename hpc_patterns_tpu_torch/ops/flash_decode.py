"""Single-query attention against a paged KV cache: the counterpart of
``hpc_patterns_tpu/ops/flash_decode.py::flash_decode_paged``.

On CUDA tensors :func:`flash_decode_paged` launches the hand-written
Hopper kernel ``csrc/paged_decode.cu`` (or raises); on CPU tensors it
computes :func:`flash_decode_paged_reference`, the gather-through-the-
table masked softmax of ``models/decode.py::_paged_attend_gather``.
Compute-dtype pools only; scale (int8/fp8) pools raise
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from hpc_patterns_tpu_torch.ops import _build

_NEG_INF = -1e30

#: kernel launches in this process (the main-path witness)
launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: query rows per kv head the kernel takes (its G_MAX)
G_MAX = 8


def _check(q, k_pool, v_pool, table, pos):
    B, H, D = q.shape
    n_pool, Hkv, P, Dp = k_pool.shape
    if H % Hkv or v_pool.shape != k_pool.shape or Dp != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if table.ndim != 2 or table.shape[0] != B:
        raise ValueError(f"table {tuple(table.shape)} must be (batch={B}, "
                         "pages)")
    if torch.is_tensor(pos) and pos.ndim == 1 and pos.shape[0] != B:
        raise ValueError(f"ragged pos has {pos.shape[0]} entries for "
                         f"batch {B}")


def flash_decode_paged_reference(q, k_pool, v_pool, table, pos,
                                 scale: float | None = None):
    """Gather each row's pages through the table into a contiguous
    (B, Hkv, pages*P, D) f32 view and take the masked softmax of the one
    query per head — ``_paged_attend_gather``'s math. ``pos``: int,
    0-d or (B,) int tensor. Returns (B, H, D) f32."""
    _check(q, k_pool, v_pool, table, pos)
    B, H, D = q.shape
    _, Hkv, P, _ = k_pool.shape
    pages = table.shape[1]
    g = H // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    tbl = table.long()

    def view(pool):  # (n_pool, Hkv, P, D) -> (B, Hkv, pages*P, D)
        return pool[tbl].permute(0, 2, 1, 3, 4).reshape(
            B, Hkv, pages * P, D).float()

    kd, vd = view(k_pool), view(v_pool)
    qg = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, kd) * scale
    idx = torch.arange(pages * P, device=q.device)
    p_ = torch.as_tensor(pos, device=q.device)
    visible = idx <= (p_.reshape(-1, 1, 1, 1) if p_.ndim else p_)
    s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, vd).reshape(B, H, D)


def flash_decode_paged(q, k_pool, v_pool, table, pos, *,
                       k_scale_pool=None, v_scale_pool=None,
                       scale: float | None = None):
    """Attention of one new token per sequence against the paged cache.

    ``q`` (B, H, D); pools (n_pool, Hkv, P, D) in the compute dtype;
    ``table`` (B, pages) int32 page ids; ``pos``: a shared position
    (int or 0-d tensor) or a (B,) int32 tensor of per-sequence
    positions — the row at ``pos`` must already hold this token's K/V.
    Returns (B, H, D) f32. CUDA: the Hopper kernel (f32 or bf16 pools,
    D in (16, 32, 64, 128), H / Hkv <= :data:`G_MAX`); anything else raises.
    CPU: :func:`flash_decode_paged_reference`."""
    global launches
    if k_scale_pool is not None or v_scale_pool is not None:
        raise NotImplementedError(
            "quantized (int8/fp8) KV pools: the scale branch of "
            "hpc_patterns_tpu/ops/flash_decode.py::_decode_kernel_paged "
            "is not ported yet")
    _check(q, k_pool, v_pool, table, pos)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k_pool, v_pool, table, pos,
                                            scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    n_pool, Hkv, P, _ = k_pool.shape
    pages = table.shape[1]
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"kernel takes matching f32/bf16 q and pools, got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    if D not in _HEAD_DIMS or H // Hkv > G_MAX:
        raise ValueError(f"kernel takes D in {_HEAD_DIMS} and "
                         f"H/Hkv <= {G_MAX}; got D={D}, H/Hkv={H // Hkv}")
    if torch.is_tensor(pos) and pos.ndim == 1:
        if pos.device != q.device or pos.dtype != torch.int32 \
                or not pos.is_contiguous():
            raise ValueError("ragged pos must be a contiguous int32 tensor "
                             "on q's device")
        pos_ptr, pos_scalar = pos.data_ptr(), 0
    elif torch.is_tensor(pos) and pos.ndim == 0 and pos.device.type == "cuda":
        raise ValueError("a shared position must be a host int (a 0-d "
                         "CUDA tensor would force a sync); pass int(pos) "
                         "or a (B,) tensor")
    else:
        pos_ptr, pos_scalar = None, int(pos)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.load("paged_decode")
    fn = lib.paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), pos_ptr, pos_scalar, out.data_ptr(),
                B, H, Hkv, D, P, pages, n_pool, float(scale),
                _DTYPE_CODE[q.dtype], stream)
    _build.check(rc, "paged_decode")
    launches += 1
    return out
