"""Ulysses-style sequence parallelism: all-to-all around local attention —
the counterpart of ``hpc_patterns_tpu/parallel/ulysses.py``.

Instead of circulating K/V (the ring), one ``MPI_Alltoall``-shaped
exchange (``comm.collectives.all_to_all``) re-shards from sequence-sharded
to head-sharded, every rank runs full-sequence attention on its head
slice, and a second all-to-all restores sequence sharding. As in
``parallel/ring_attention.py`` the tensors are rank-stacked: ``(ranks,
batch, seq_local, heads, head_dim)``.
"""

from __future__ import annotations

import warnings

from hpc_patterns_tpu_torch.comm import collectives
from hpc_patterns_tpu_torch.parallel.ring_attention import (
    _check_gqa,
    full_attention,
)


def ulysses_attention(q, k, v, *, causal: bool = False,
                      scale: float | None = None, impl: str = "dense"):
    """Attention over a sequence sharded on the ranks' leading dim, by
    head scattering. ``heads`` must divide by the rank count. GQA-narrow
    K/V ride the all-to-alls narrow when kv_heads divides by the rank
    count too; otherwise they are expanded to full heads first, with a
    warning. Returns the rank-stacked output, shape of ``q``.

    ``impl``: the full-sequence attention of every rank's head slice —
    ``"dense"`` (``full_attention``) or ``"flash"``
    (``ops.flash_attention``: kernel 1 forward, kernels 3 and 4 backward
    on a card). The ranks' slices have one shape, so they run as one call
    with the ranks folded into the batch."""
    if q.ndim != 5:
        raise ValueError(f"want (ranks, batch, seq, heads, head_dim), got "
                         f"{tuple(q.shape)}")
    if impl not in ("dense", "flash"):
        raise ValueError(f"impl {impl!r} not in ('dense', 'flash')")
    size = q.shape[0]
    H, Hkv = q.shape[3], k.shape[3]
    if H % size:
        raise ValueError(f"heads {H} not divisible by axis size {size}")
    _check_gqa(q, k, v)
    if Hkv != H and Hkv % size:
        # can't scatter partial kv heads: expand, loudly (the narrow-K/V
        # exchange saving is lost)
        warnings.warn(
            f"ulysses: axis size {size} does not divide kv_heads={Hkv}; "
            f"expanding K/V to {H} heads for the all-to-all (narrow-K/V "
            "exchange saving lost) — make kv_heads a multiple of the "
            "sp axis size to keep the narrow path",
            stacklevel=2)
        k = k.repeat_interleave(H // Hkv, dim=3)
        v = v.repeat_interleave(H // Hkv, dim=3)

    # (B, T/P, H, D) -> (B, T, H/P, D): gather sequence, scatter heads
    def seq_to_heads(x):
        return collectives.all_to_all(x, split_axis=2, concat_axis=1)

    def heads_to_seq(x):
        return collectives.all_to_all(x, split_axis=1, concat_axis=2)

    qh, kh, vh = (seq_to_heads(t).flatten(0, 1) for t in (q, k, v))
    if impl == "flash":
        from hpc_patterns_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        out = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        out = full_attention(qh, kh, vh, causal=causal, scale=scale)
    return heads_to_seq(out.unflatten(0, (size, -1)))
