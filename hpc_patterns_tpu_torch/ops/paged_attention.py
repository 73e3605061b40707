"""Exact-softmax paged-attention decode (``decode_attn="paged_flash"``):
the counterpart of ``hpc_patterns_tpu/ops/paged_attention.py``.

On CUDA tensors :func:`paged_attention_decode` launches the hand-written
Hopper kernel ``csrc/paged_attention.cu`` (replacing
``_paged_attention_kernel``) or raises; on CPU tensors it computes its
plain version, the gather route (``models/decode.py::
_paged_attend_gather``: dequantize, scores, mask -1e30, softmax, p.v),
which is :func:`~hpc_patterns_tpu_torch.ops.flash_decode.
flash_decode_paged_reference`.

The JAX kernel stages the whole allocated K/V span in VMEM and takes one
softmax over it. The card's kernel splits each sequence's rows into the
fixed chunks of :func:`~hpc_patterns_tpu_torch.ops.flash_decode.
paged_decode_plan` (set by the page size alone), a CTA each: inside a
chunk the JAX kernel's form (rows dequantized before the dot, the chunk's
scores in shared memory, their exact max, then the exponentials and
their sum, then p.v), the chunks merged by lse in a dependent launch.
Any context the table holds launches.
"""

from __future__ import annotations

from hpc_patterns_tpu_torch.ops.flash_decode import (
    _check_paged,
    check_scales,
    flash_decode_paged_reference,
    launch_paged,
)

#: the mask constant; equal to the flash routes' (a test pins it)
_NEG_INF = -1e30

#: kernel launches in this process (the main-path witness)
launches = 0


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
    one-byte; D in (16, 32, 64, 128); H / Hkv <= 8), with an f32
    workspace of B * H * n_chunks * (D + 2) values when the table holds
    more than one chunk; the host never reads ``pos``; anything else
    raises. CPU: the gather route."""
    global launches
    _check_paged(q, k_pool, v_pool, table, pos)
    quantized = check_scales(k_pool, k_scale_pool, v_scale_pool)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(
            q, k_pool, v_pool, table, pos, scale,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    out = launch_paged("paged_attention", "paged_attention", q, k_pool,
                       v_pool, table, pos, k_scale_pool, v_scale_pool,
                       quantized, scale)
    launches += 1
    return out
