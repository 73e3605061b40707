"""Flash attention, forward and backward: the counterpart of
``hpc_patterns_tpu/ops/flash_attention.py`` (``flash_attention`` and
``flash_attention_block``).

Four kernels, each with its plain PyTorch version beside it:

- the forward (``csrc/flash_prefill.cu``; the TPU ``_kernel``): online
  softmax with the causal mask in global (q_offset, k_offset) positions,
  GQA, Tq != Tk, and the per-row logsumexp the backward reads;
- the fused backward (``csrc/flash_attention_bwd.cu``; ``_fused_bwd_kernel``):
  dK, dV and a partial-dQ slab (n_kv, B*H, Tq, D), one slot per 128-key
  tile, summed here;
- the dQ pass and the dK/dV pass (same file; ``_dq_kernel``,
  ``_dkv_kernel``): the split backward, a card's "auto" route.

On a CUDA tensor each wrapper launches its kernel (bf16, sequence lengths
multiples of 64, head_dim in (16, 32, 64, 128)) or raises; on a CPU tensor
it computes its plain version. The autograd functions and the backward's
routing (fused or split, q-chunking past the slab budget, the slab's
masked sum) are the same code on both, so the CPU tests cover them; only
"auto" differs: split on a card, the JAX slab rule on the CPU
(:func:`plan_backward`).

Layouts: user tensors are (B, T, heads, D), as in JAX; lse and Delta are
(B, H, Tq) f32 inside (the kernels' (B*H, Tq) rows) and lse is (B, Tq, H)
where :func:`flash_attention_block` returns it.
"""

from __future__ import annotations

import ctypes
import os

import torch

from hpc_patterns_tpu_torch.ops import _build

#: kernel launches in this process (the main-path witness): the forward
#: without lse (inference) and with it (training), and the three backward
#: kernels
launches = {"fwd": 0, "fwd_lse": 0, "fused_bwd": 0, "dq": 0, "dkv": 0}
#: forward passes in this process, on any device (where activation
#: checkpointing reruns the forward, this counts it)
calls = {"forward": 0}

#: the kernels' sequence granule: Tq and Tk must be multiples of it (the
#: forward's CTAs take 64 or 128 query rows, one warpgroup per 64, and mask
#: a ragged edge of their 128-key tiles)
BLOCK = 64
#: the fused backward's q and kv tiles: a CTA owns 128 keys and walks
#: 64-query tiles, so the slab has ceil(Tk / BWD_BLOCK_K) slots per row
#: (the last one half when Tk % 128 == 64)
BWD_BLOCK_Q = 64
BWD_BLOCK_K = 128

#: the values of ``bwd``: None/"auto" (on a card the split route; on the
#: CPU fused while the slab fits the budget), "fused" (one pass, 5
#: products per visible tile pair, the slab), "split" (dQ pass + dK/dV
#: pass, 7 products, no slab)
BWD_ROUTES = (None, "auto", "fused", "split")

# The fused backward materializes a (n_kv, B*H, Tq, D) partial-dQ slab;
# above this byte budget the CPU's "auto" chunks the queries, then falls
# back to the split route (a card's "auto" is always split). The JAX
# module's variable and default (1.5 GiB), read the same way; 0 forces the
# split route. The slab here is sized on this port's 128-row kv tile.
_FUSED_SLAB_LIMIT = int(
    os.environ.get("HPCPAT_FLASH_BWD_SLAB_LIMIT", 3 << 29))

_HEAD_DIMS = (16, 32, 64, 128)
_NEG_INF = -1e30


# ---------------------------------------------------------------- checks


def _check_shapes(q, k, v, *, square: bool) -> None:
    if q.ndim != 4:
        raise ValueError(f"want (batch, seq, heads, head_dim), got "
                         f"{tuple(q.shape)}")
    B, Tq, H, D = q.shape
    Hkv = k.shape[2] if k.ndim == 4 else 0
    if (k.ndim != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != D or Hkv == 0 or H % Hkv
            or (square and k.shape[1] != Tq)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (kv heads must divide n_heads)")


def _on_card(*tensors) -> bool:
    """True for CUDA tensors (which the kernels must take), False for CPU
    ones (the plain versions); anything else raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _check_kernel_operands(named, Tq, Tk, D, f32=()) -> None:
    """The kernels' contract: one card, bf16 (``f32`` names: float32),
    contiguous and 16-byte aligned; Tq, Tk multiples of 64; D in
    :data:`_HEAD_DIMS`."""
    dev = named[0][1].device
    for name, t in named:
        want = torch.float32 if name in f32 else torch.bfloat16
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes {want}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if Tq % BLOCK or Tk % BLOCK or D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes T % {BLOCK} == 0 (Tq and Tk) and "
                         f"D in {_HEAD_DIMS}; got Tq={Tq}, Tk={Tk}, D={D}")


def _scale(scale, D) -> float:
    return float(1.0 / (D ** 0.5) if scale is None else scale)


def _fn(lib, name, n_ptr, n_int_before, n_int_after):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int_before
                   + [ctypes.c_float] + [ctypes.c_int] * n_int_after
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------- forward


def _expand(x, H):
    """(B, T, Hkv, D) -> (B, H, T, D) f32, q head h reading kv head
    h // (H / Hkv) (plain versions only; the kernels read the narrow
    array)."""
    return x.float().permute(0, 2, 1, 3).repeat_interleave(
        H // x.shape[2], dim=1)


def _masked_scores(q, k, q_offset, k_offset, scale, causal):
    """(B, H, Tq, Tk) f32 scaled scores with the global causal mask."""
    s = q.float().permute(0, 2, 1, 3) @ _expand(k, q.shape[2]).transpose(
        -1, -2) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], _NEG_INF)
    return s


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: float | None = None, *,
                              q_offset: int = 0, k_offset: int = 0,
                              with_lse: bool = False):
    """The forward kernel's plain version — the JAX module's
    ``_dense_forward``: dense masked softmax in f32, rows with nothing
    visible output 0 with lse = -1e30 + log(1e-30), out in ``q.dtype``.
    Returns ``out`` (B, Tq, H, D), and with ``with_lse`` also lse
    (B, H, Tq) f32."""
    _check_shapes(q, k, v, square=False)
    scale = _scale(scale, q.shape[3])
    s = _masked_scores(q, k, q_offset, k_offset, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * (s > _NEG_INF / 2)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = ((p @ _expand(v, q.shape[2])) / l).to(q.dtype).permute(0, 2, 1, 3)
    if not with_lse:
        return out
    return out, (m + torch.log(l))[..., 0]


def _forward(q, k, v, q_offset, k_offset, causal, scale, with_lse):
    """Kernel 1 on a card (counted), its plain version on the CPU.
    Returns (out, lse or None)."""
    calls["forward"] += 1
    if not _on_card(q):
        r = flash_attention_reference(q, k, v, causal, scale,
                                      q_offset=q_offset, k_offset=k_offset,
                                      with_lse=with_lse)
        return r if with_lse else (r, None)
    out, lse = _launch_forward(q, k, v, q_offset, k_offset, causal, scale,
                               with_lse)
    launches["fwd_lse" if with_lse else "fwd"] += 1
    return out, lse


def _launch_forward(q, k, v, q_offset, k_offset, causal, scale, with_lse,
                    rows: int = 0):
    """One launch of kernel 1 on card tensors, uncounted. ``rows`` is the
    CTA's query rows (64 or 128); 0 lets the kernel's shape rule choose,
    as every caller but the tile tests and timings does."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    _check_kernel_operands((("q", q), ("k", k), ("v", v)), Tq, Tk, D)
    lib = _build.load("flash_prefill")
    out = torch.empty_like(q)
    # the serving launch passes no lse: the kernel then skips writing it
    lse = torch.empty(B, H, Tq, dtype=torch.float32,
                      device=q.device) if with_lse else None
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, B, Tq, Tk, H, Hkv, D,
            _scale(scale, D), int(bool(causal)), int(q_offset),
            int(k_offset)]
    if rows:
        fn = _fn(lib, "flash_attention_fwd_rows", 5, 6, 4)
        args.append(int(rows))
    else:
        fn = _fn(lib, "flash_attention_fwd", 5, 6, 3)
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    return out, lse


# ---------------------------------------------------------------- backward


def _softmax_grads(q, k, v, do, lse, delta, q_offset, k_offset, causal,
                   scale):
    """Dense (B, H, Tq, Tk) P and dS in f32, each rounded to the input
    dtype where the kernels round it (before the products that read
    them), and K, Q expanded to f32 — the shared body of the three
    backward plain versions."""
    H = q.shape[2]
    s = _masked_scores(q, k, q_offset, k_offset, scale, causal)
    p = torch.exp(s - lse[..., None]) * (s > _NEG_INF / 2)
    dp = do.float().permute(0, 2, 1, 3) @ _expand(v, H).transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dt = q.dtype
    return p.to(dt).float(), ds.to(dt).float()


def _narrow(x, Hkv):
    """(B, H, T, D) per-q-head f32 -> (B, T, Hkv, D): the GQA group sum."""
    B, H, T, D = x.shape
    return x.reshape(B, Hkv, H // Hkv, T, D).sum(2).permute(0, 2, 1, 3)


def _dkv_plain(q, k, v, do, lse, delta, q_offset, k_offset, causal, scale):
    p, ds = _softmax_grads(q, k, v, do, lse, delta, q_offset, k_offset,
                           causal, scale)
    Hkv = k.shape[2]
    dv = p.transpose(-1, -2) @ do.float().permute(0, 2, 1, 3)
    dk = ds.transpose(-1, -2) @ q.float().permute(0, 2, 1, 3)
    return ((_narrow(dk, Hkv) * scale).to(k.dtype),
            _narrow(dv, Hkv).to(v.dtype), ds)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, *, q_offset=0,
                                  k_offset=0, causal=True, scale=None):
    """The dK/dV kernel's plain version (``_dkv_kernel``): (dk, dv) in
    the narrow (B, Tk, Hkv, D) layout and input dtype, dk scaled."""
    dk, dv, _ = _dkv_plain(q, k, v, do, lse, delta, q_offset, k_offset,
                           causal, _scale(scale, q.shape[3]))
    return dk, dv


def flash_attention_dq_reference(q, k, v, do, lse, delta, *, q_offset=0,
                                 k_offset=0, causal=True, scale=None):
    """The dQ kernel's plain version (``_dq_kernel``): dq (B, Tq, H, D)
    = scale * dS K in the input dtype."""
    scale = _scale(scale, q.shape[3])
    _, ds = _softmax_grads(q, k, v, do, lse, delta, q_offset, k_offset,
                           causal, scale)
    dq = ds @ _expand(k, q.shape[2]) * scale
    return dq.to(q.dtype).permute(0, 2, 1, 3)


def _n_kv(Tk, block_k=BWD_BLOCK_K) -> int:
    """The slab's slots per row: kv tiles of ``block_k`` keys, the last
    one ragged."""
    return -(-Tk // block_k)


def _unwritten_rows(Tq, Tk, q_offset, k_offset, causal,
                    block_k=BWD_BLOCK_K) -> list:
    """Per kv tile j (of ``block_k`` keys: the kernel's, unless a timing
    masks another build's slab), how many leading query rows of its slab
    slots the fused kernel never writes: the rows of the q tiles that
    cannot see kv tile j (causal: their last global position precedes its
    first)."""
    n_kv, n_q = _n_kv(Tk, block_k), Tq // BWD_BLOCK_Q
    if not causal:
        return [0] * n_kv
    rows = []
    for j in range(n_kv):
        k_start = k_offset + j * block_k
        # first q tile qi with q_offset + (qi + 1) * BQ - 1 >= k_start
        first = -(-(k_start - q_offset + 1 - BWD_BLOCK_Q) // BWD_BLOCK_Q)
        rows.append(min(max(first, 0), n_q) * BWD_BLOCK_Q)
    return rows


def _written(Tq, Tk, q_offset, k_offset, causal, device):
    """(n_kv, Tq) bool: slab slot (kv tile j, ., row t, .) is written iff
    the q tile holding row t can see kv tile j."""
    rows = torch.tensor(_unwritten_rows(Tq, Tk, q_offset, k_offset, causal),
                        device=device)
    return torch.arange(Tq, device=device)[None, :] >= rows[:, None]


def flash_attention_fused_bwd_reference(q, k, v, do, lse, delta, *,
                                        q_offset=0, k_offset=0, causal=True,
                                        scale=None):
    """The fused kernel's plain version (``_fused_bwd_kernel``): (dk, dv,
    slab) with slab (n_kv, B*H, Tq, D) in the input dtype, n_kv =
    ceil(Tk / BWD_BLOCK_K), slot j holding scale * dS[:, kv tile j] K[kv
    tile j] (a ragged last tile's missing keys count 0) where the (q tile,
    kv tile j) pair is visible and NaN where the kernel never writes (what
    device memory may hold there): the caller must mask by select."""
    scale = _scale(scale, q.shape[3])
    dk, dv, ds = _dkv_plain(q, k, v, do, lse, delta, q_offset, k_offset,
                            causal, scale)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    n_kv = _n_kv(Tk)
    pad = n_kv * BWD_BLOCK_K - Tk
    kf = torch.nn.functional.pad(_expand(k, H), (0, 0, 0, pad))
    kf = kf.reshape(B, H, n_kv, BWD_BLOCK_K, D)
    dsj = torch.nn.functional.pad(ds, (0, pad))
    dsj = dsj.reshape(B, H, Tq, n_kv, BWD_BLOCK_K).permute(0, 1, 3, 2, 4)
    slab = ((dsj @ kf) * scale).to(q.dtype)            # (B, H, n_kv, Tq, D)
    slab = slab.permute(2, 0, 1, 3, 4).reshape(n_kv, B * H, Tq, D)
    seen = _written(Tq, Tk, q_offset, k_offset, causal, q.device)
    return dk, dv, slab.masked_fill(~seen[:, None, :, None], float("nan"))


def _bwd_operands(q, k, v, do, lse, delta):
    B, Tq, H, D = q.shape
    _check_kernel_operands((("q", q), ("k", k), ("v", v), ("do", do),
                            ("lse", lse), ("delta", delta)),
                           Tq, k.shape[1], D, f32=("lse", "delta"))
    if (do.shape != q.shape or lse.shape != (B, H, Tq)
            or delta.shape != (B, H, Tq)):
        raise ValueError(
            f"do {tuple(do.shape)} must match q {tuple(q.shape)}; lse "
            f"{tuple(lse.shape)} and delta {tuple(delta.shape)} must be "
            f"(B, H, Tq) = {(B, H, Tq)}")


def flash_attention_fused_bwd(q, k, v, do, lse, delta, *, q_offset=0,
                              k_offset=0, causal=True, scale=None):
    """Kernel 2 (``_fused_bwd_kernel``): (dk, dv, slab) as
    :func:`flash_attention_fused_bwd_reference`, whose never-written slots
    hold whatever the allocator held. CUDA: the kernel (or raises); CPU:
    the plain version."""
    _check_shapes(q, k, v, square=False)
    if not _on_card(q):
        return flash_attention_fused_bwd_reference(
            q, k, v, do, lse, delta, q_offset=q_offset, k_offset=k_offset,
            causal=causal, scale=scale)
    _bwd_operands(q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    slab = torch.empty(_n_kv(Tk), B * H, Tq, D, dtype=q.dtype,
                       device=q.device)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = _fn(lib, "flash_attention_fused_bwd", 9, 6, 3)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            slab.data_ptr(), B, Tq, Tk, H, Hkv, D, _scale(scale, D),
            int(bool(causal)), int(q_offset), int(k_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_fused_bwd")
    launches["fused_bwd"] += 1
    return dk, dv, slab


def flash_attention_dq(q, k, v, do, lse, delta, *, q_offset=0, k_offset=0,
                       causal=True, scale=None):
    """Kernel 3 (``_dq_kernel``): dq (B, Tq, H, D). CUDA: the kernel (or
    raises); CPU: :func:`flash_attention_dq_reference`."""
    _check_shapes(q, k, v, square=False)
    if not _on_card(q):
        return flash_attention_dq_reference(
            q, k, v, do, lse, delta, q_offset=q_offset, k_offset=k_offset,
            causal=causal, scale=scale)
    _bwd_operands(q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = _fn(lib, "flash_attention_dq", 7, 6, 3)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Tq, Tk, H,
            Hkv, D, _scale(scale, D), int(bool(causal)), int(q_offset),
            int(k_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_dq")
    launches["dq"] += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, q_offset=0, k_offset=0,
                        causal=True, scale=None):
    """Kernel 4 (``_dkv_kernel``): (dk, dv) narrow. CUDA: the kernel (or
    raises); CPU: :func:`flash_attention_dkv_reference`."""
    _check_shapes(q, k, v, square=False)
    if not _on_card(q):
        return flash_attention_dkv_reference(
            q, k, v, do, lse, delta, q_offset=q_offset, k_offset=k_offset,
            causal=causal, scale=scale)
    _bwd_operands(q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = _fn(lib, "flash_attention_dkv", 8, 6, 3)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Tq, Tk, H, Hkv, D, _scale(scale, D), int(bool(causal)),
            int(q_offset), int(k_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_dkv")
    launches["dkv"] += 1
    return dk, dv


def _check_bwd(bwd) -> None:
    if bwd not in BWD_ROUTES:
        raise ValueError(f"bwd {bwd!r} not in {BWD_ROUTES}")


def plan_backward(B, Tq, Tk, H, D, itemsize, bwd=None, *,
                  on_card: bool = False) -> dict:
    """The backward's route at these shapes: the slab's bytes, the
    q-chunk count and whether the fused kernel runs. On the CPU
    (``on_card`` False) "auto" is the JAX rule on this port's tiles: fused
    while the slab fits :data:`_FUSED_SLAB_LIMIT`, chunking the queries
    past it, then split. On a card "auto" is the split route, a departure
    from the JAX rule: with the wgmma dQ pass, Delta + dq + dkv (0.597 ms)
    beat the fused route with its slab zeroing and f32 sum (0.971 ms) at
    the training shape on an H100 (PERF.md), and need no slab."""
    _check_bwd(bwd)
    slab_bytes = _n_kv(Tk) * B * H * Tq * D * itemsize
    n_chunks = 1
    if on_card and bwd in (None, "auto"):
        return {"slab_bytes": slab_bytes, "n_chunks": 1, "fused": False,
                "limit": _FUSED_SLAB_LIMIT}
    if bwd in (None, "auto", "fused") and slab_bytes > _FUSED_SLAB_LIMIT:
        while (slab_bytes // n_chunks > _FUSED_SLAB_LIMIT
               and n_chunks < 16
               and Tq % (2 * n_chunks) == 0
               and (Tq // (2 * n_chunks)) % BWD_BLOCK_Q == 0):
            n_chunks *= 2
    fused = bwd == "fused" or (
        bwd in (None, "auto") and slab_bytes // n_chunks <= _FUSED_SLAB_LIMIT)
    return {"slab_bytes": slab_bytes, "n_chunks": n_chunks, "fused": fused,
            "limit": _FUSED_SLAB_LIMIT}


def _backward(q, k, v, o, lse, q_offset, k_offset, g, g_lse, *, causal,
              scale, bwd):
    """(dq, dk, dv) for the out-cotangent ``g`` (B, Tq, H, D) and the lse
    cotangent ``g_lse`` (B, Tq, H) or None: Delta = rowsum(g * o) in f32,
    shifted by the lse cotangent (d lse / d s = P), then the route of
    :func:`plan_backward` (whose "auto" is split on a card). The same code
    on a card and on the CPU."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    plan = plan_backward(B, Tq, Tk, H, D, q.element_size(), bwd,
                         on_card=_on_card(q))
    g = g.contiguous()
    delta = (g.float() * o).sum(-1)  # f32 products of the bf16 values
    if g_lse is not None:
        delta = delta - g_lse
    delta = delta.permute(0, 2, 1).contiguous()
    kw = dict(k_offset=k_offset, causal=causal, scale=scale)
    if not plan["fused"]:
        dq = flash_attention_dq(q, k, v, g, lse, delta, q_offset=q_offset,
                                **kw)
        dk, dv = flash_attention_dkv(q, k, v, g, lse, delta,
                                     q_offset=q_offset, **kw)
        return dq, dk, dv
    n = plan["n_chunks"]
    Tq_c = Tq // n
    parts, dk_acc, dv_acc = [], None, None
    for i in range(n):
        lo = i * Tq_c

        def rows(x, ax):  # this chunk's queries
            return x if n == 1 else x.narrow(ax, lo, Tq_c).contiguous()

        dk_i, dv_i, slab = flash_attention_fused_bwd(
            rows(q, 1), k, v, rows(g, 1), rows(lse, 2), rows(delta, 2),
            q_offset=q_offset + lo, **kw)
        # a never-written slot holds whatever memory held (NaN in the
        # plain version): select, never multiply — the slots a kv tile's
        # kernel skipped are its leading rows, zeroed in place
        for j, r in enumerate(_unwritten_rows(Tq_c, Tk, q_offset + lo,
                                              k_offset, causal)):
            if r:
                slab[j, :, :r] = 0
        parts.append(slab.sum(0, dtype=torch.float32).to(q.dtype))
        if n == 1:  # the kernel's dk/dv as they are
            dk_acc, dv_acc = dk_i, dv_i
        elif dk_acc is None:
            dk_acc, dv_acc = dk_i.float(), dv_i.float()
        else:
            dk_acc += dk_i.float()
            dv_acc += dv_i.float()
    dq = parts[0] if n == 1 else torch.cat(parts, dim=1)  # (B*H, Tq, D)
    dq = dq.reshape(B, H, Tq, D).permute(0, 2, 1, 3)
    return dq, dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _Flash(torch.autograd.Function):
    """:func:`flash_attention`'s custom VJP: residuals (q, k, v, out,
    lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bwd):
        out, lse = _forward(q, k, v, 0, 0, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, scale=scale, bwd=bwd)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, 0, 0, g, None, **ctx.opts)
        return dq, dk, dv, None, None, None


class _FlashBlock(torch.autograd.Function):
    """:func:`flash_attention_block`'s custom VJP: residuals (q, k, v,
    out, lse, offsets); the lse cotangent shifts Delta."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, scale, bwd):
        out, lse = _forward(q, k, v, q_offset, k_offset, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.offsets = (q_offset, k_offset)
        ctx.opts = dict(causal=causal, scale=scale, bwd=bwd)
        return out, lse.permute(0, 2, 1).contiguous()

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, *ctx.offsets, g_out,
                               g_lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, bwd: str | None = None):
    """Softmax attention over (B, T, H, D) queries and (B, T, Hkv, D)
    keys/values (the JAX layout), differentiable in q, k, v. With no
    gradient wanted it runs the forward alone (no lse: the serving
    launch); otherwise the custom VJP, whose backward takes the route
    ``bwd`` names (:data:`BWD_ROUTES`; see :func:`plan_backward`). CUDA:
    the Hopper kernels, bf16 only, T a multiple of :data:`BLOCK`, D in
    (16, 32, 64, 128); anything else raises. CPU: the plain versions."""
    _check_bwd(bwd)
    _check_shapes(q, k, v, square=True)
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, scale, bwd)
    return _forward(q, k, v, 0, 0, causal, scale, False)[0]


def flash_attention_block(q, k, v, q_offset, k_offset, *,
                          causal: bool = True, scale: float | None = None,
                          bwd: str | None = None):
    """One partial attention: queries ``q`` (B, Tq, H, D) at global
    position ``q_offset`` against one K/V block (B, Tk, Hkv, D) at
    ``k_offset``; Tq and Tk may differ. Returns ``(out, lse)`` with lse
    (B, Tq, H) f32, so partials over disjoint blocks merge by logsumexp.
    A fully-future block returns out 0 and lse ~ -1e30. Differentiable in
    q, k, v, including through lse."""
    _check_bwd(bwd)
    _check_shapes(q, k, v, square=False)
    q_offset, k_offset = int(q_offset), int(k_offset)
    if _needs_grad(q, k, v):
        return _FlashBlock.apply(q, k, v, q_offset, k_offset, causal, scale,
                                 bwd)
    out, lse = _forward(q, k, v, q_offset, k_offset, causal, scale, True)
    return out, lse.permute(0, 2, 1)
