"""Ring attention: context parallelism on the ring engine — the
counterpart of ``hpc_patterns_tpu/parallel/ring_attention.py``.

The reference's ring dataflow (per step: neighbour hop, local combine,
buffer rotation; allreduce-mpi-sycl.cpp:173-182) with the combine
generalized to blockwise online-softmax attention. Rank r holds the r-th
sequence block of Q, K and V; K/V blocks travel the ring and each step
folds the visiting block into a running (max, sum, output), with the
causal mask in global positions, so the result is the attention of the
gathered sequence.

The JAX functions are rank-local (inside ``shard_map``). The port runs
every logical rank in one process, as ``comm/`` does: each function takes
the rank-stacked tensors — ``(ranks, batch, seq_local, heads, head_dim)``,
row r rank r's block — and returns the rank-stacked output. A hop is
``comm.ring.ring_shift`` (``"ppermute"``) or kernel 10 through
``comm.fused.fused_ring_shift`` (``"fused"``); both move the same bytes.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # finite mask value: avoids inf-inf=nan in the rescale


def _check_gqa(q, k, v) -> int:
    """Validate head counts (dim -2); return the GQA group factor
    H // Hkv (1 = MHA): q head h attends kv head h // group."""
    H, Hkv = q.shape[-2], k.shape[-2]
    if H % max(Hkv, 1) or v.shape[-2] != Hkv:
        raise ValueError(
            f"kv heads {Hkv}/{v.shape[-2]} must match and divide "
            f"n_heads {H} (GQA attends the narrow K/V)")
    return H // Hkv


def _grouped_scores(q, k, scale):
    """(..., H, T, S) f32 scores of q (..., T, H, D) against possibly
    narrow k (..., S, Hkv, D), with no expanded K copy."""
    *lead, T, H, D = q.shape
    Hkv = k.shape[-2]
    qg = q.reshape(*lead, T, Hkv, H // Hkv, D).float()
    s = torch.einsum("...tkgd,...skd->...kgts", qg, k.float()) * scale
    return s.reshape(*lead, H, T, k.shape[-3])


def _grouped_pv(p, v):
    """(..., H, T, D) f32 = P @ V with possibly narrow V."""
    *lead, H, T, S = p.shape
    Hkv = v.shape[-2]
    pg = p.reshape(*lead, Hkv, H // Hkv, T, S)
    out = torch.einsum("...kgts,...skd->...kgtd", pg, v.float())
    return out.reshape(*lead, H, T, v.shape[-1])


def _block_step(q, k, v, acc, m, l, *, scale, q_offset, k_offset, causal):
    """Fold one visiting K/V block into every rank's running accumulator.

    q: (P, B, T, H, D); k/v: (P, B, S, Hkv, D); acc: (P, B, H, T, D) f32;
    m, l: (P, B, H, T) f32; q_offset, k_offset: (P,) global positions of
    each rank's query block and visiting key block."""
    s = _grouped_scores(q, k, scale)
    if causal:
        T, S = q.shape[2], k.shape[2]
        t_idx = q_offset[:, None] + torch.arange(T, device=q.device)
        s_idx = k_offset[:, None] + torch.arange(S, device=q.device)
        visible = s_idx[:, None, :] <= t_idx[:, :, None]  # (P, T, S)
        s = torch.where(visible[:, None, None], s,
                        torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    # exp(_NEG_INF - m_new) underflows to 0: masked keys stay masked
    p = torch.exp(s - m_new[..., None])
    rescale = torch.exp(m - m_new)
    l_new = l * rescale + p.sum(-1)
    acc_new = acc * rescale[..., None] + _grouped_pv(p, v)
    return acc_new, m_new, l_new


class _FusedShift(torch.autograd.Function):
    """Kernel 10's ring hop. Like JAX's device-initiated shift it has no
    VJP: a backward that reaches it raises (train with ``ppermute``)."""

    @staticmethod
    def forward(ctx, x):
        from hpc_patterns_tpu_torch.comm import fused

        return fused.fused_ring_shift(x, 1)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "ring_attention(shift_impl='fused') has no backward (the "
            "device-initiated shift has no VJP, as in JAX); use "
            "shift_impl='ppermute' to train through the ring")


def _kv_rotate(shift_impl: str):
    """The per-step K/V neighbour hop on the rank-stacked blocks: the
    library permute (``"ppermute"``: ``ring.ring_shift``) or the
    device-initiated one (``"fused"``: kernel 10, one launch for K and one
    for V). Both produce the same bytes (a shift is a permutation)."""
    if shift_impl == "ppermute":
        from hpc_patterns_tpu_torch.comm import ring

        return lambda kv: tuple(ring.ring_shift(t, 1) for t in kv)
    if shift_impl == "fused":
        return lambda kv: tuple(_FusedShift.apply(t) for t in kv)
    raise ValueError(
        f"shift_impl {shift_impl!r} not in ('ppermute', 'fused')")


def ring_attention(q, k, v, *, causal: bool = False,
                   scale: float | None = None, impl: str = "dense",
                   shift_impl: str = "ppermute"):
    """Attention over a sequence sharded on the ranks' leading dim.

    ``q``, ``k``, ``v``: ``(ranks, batch, seq_local, heads, head_dim)``;
    the global sequence is the blocks in rank order. K/V may be GQA-narrow
    (kv_heads dividing q's heads): the narrow blocks are what circulate.
    Returns the rank-stacked output, shape and dtype of ``q``, equal to
    attending the gathered sequence.

    ``impl``: each step's local compute. ``"dense"`` materializes the
    (T_local, S) score blocks of every rank at once; ``"flash"`` calls
    ``ops.flash_attention_block`` (kernel 1 on a card) once for each rank
    and step at ``q_offset = r * T_local``, ``k_offset = src * T_local``
    and merges the partials by logsumexp. Under ``causal`` a fully-future
    block (``src > r``) is not launched: it would add out 0 at lse -1e30,
    which leaves the merge unchanged bit for bit, so a call launches
    ``ranks * (ranks + 1) / 2`` blocks, not ``ranks ** 2``.

    ``shift_impl``: who moves the K/V blocks each step — ``"ppermute"``
    or ``"fused"`` (kernel 10; no backward)."""
    if q.ndim != 5:
        raise ValueError(f"want (ranks, batch, seq, heads, head_dim), got "
                         f"{tuple(q.shape)}")
    if impl not in ("dense", "flash"):
        raise ValueError(f"impl {impl!r} not in ('dense', 'flash')")
    rotate = _kv_rotate(shift_impl)
    _check_gqa(q, k, v)
    P, B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if impl == "flash":
        return _ring_attention_flash(q, k, v, causal=causal, scale=scale,
                                     rotate=rotate)

    S = k.shape[2]
    ranks = torch.arange(P, device=q.device)
    acc = torch.zeros((P, B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((P, B, H, T), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((P, B, H, T), dtype=torch.float32, device=q.device)
    kv = (k, v)
    for step in range(P):
        k_blk, v_blk = kv
        # the block visiting rank r at step s started at rank (r - s) % P
        src = (ranks - step) % P
        acc, m, l = _block_step(q, k_blk, v_blk, acc, m, l, scale=scale,
                                q_offset=ranks * T, k_offset=src * S,
                                causal=causal)
        if step + 1 < P:
            kv = rotate(kv)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def _merge(out, lse, o_b, lse_b):
    """Fold one partial (out (B, T, H, D), lse (B, T, H)) into the running
    pair by logsumexp; the first partial is the running pair (the merge
    from (0, -1e30) would return it bit for bit)."""
    o_b = o_b.float()
    if out is None:
        return o_b, lse_b
    m = torch.maximum(lse, lse_b)
    e_run = torch.exp(lse - m)
    e_b = torch.exp(lse_b - m)
    denom = e_run + e_b
    out = (out * e_run[..., None] + o_b * e_b[..., None]) / denom[..., None]
    return out, m + torch.log(denom)


def _ring_attention_flash(q, k, v, *, causal, scale, rotate):
    """The flash ring: each visiting K/V block is one partial attention
    (normalized within the block, with its logsumexp) per rank, merged
    into that rank's running result."""
    from hpc_patterns_tpu_torch.ops.flash_attention import (
        flash_attention_block,
    )

    P, B, T = q.shape[:3]
    q = q.contiguous()
    outs, lses = [None] * P, [None] * P
    kv = (k.contiguous(), v.contiguous())
    for step in range(P):
        k_blk, v_blk = kv
        S = k_blk.shape[2]
        for r in range(P):
            src = (r - step) % P
            if causal and src > r:  # fully future: nothing visible
                continue
            o_b, lse_b = flash_attention_block(
                q[r], k_blk[r], v_blk[r], r * T, src * S, causal=causal,
                scale=scale)
            outs[r], lses[r] = _merge(outs[r], lses[r], o_b, lse_b)
        if step + 1 < P:
            kv = rotate(kv)
    return torch.stack(outs).to(q.dtype)


def full_attention(q, k, v, *, causal: bool = False,
                   scale: float | None = None, q_offset: int = 0):
    """Plain softmax attention, f32 scores, grouped-query: q (B, T, H, D)
    against possibly-narrow k/v (B, S, Hkv, D); q head h reads kv head
    h // (H / Hkv) with no expanded K/V copy. Returns ``q.dtype``.
    ``q_offset``: the position of q's first row in k's sequence (a tail
    prefill's rows start past a cached prefix); the causal mask keeps
    key s for query t where s <= t + q_offset."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if H % max(Hkv, 1) or v.shape[2] != Hkv:
        raise ValueError(f"kv heads {Hkv}/{v.shape[2]} must match and "
                         f"divide n_heads {H}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    S = k.shape[1]
    qg = q.reshape(B, T, Hkv, H // Hkv, D).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool,
                          device=q.device).tril(q_offset)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)
