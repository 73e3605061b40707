"""``full_attention`` only — the counterpart of
``hpc_patterns_tpu/parallel/ring_attention.py::full_attention``. Prefill
uses it for padded prompt lengths that are not multiples of 128 (the
ring itself is a later slice)."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


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
