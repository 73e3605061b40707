"""PyTorch + CUDA port of ``hpc_patterns_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; module names mirror
it one for one so each part of the port has an obvious counterpart.
This package imports ``torch`` only — never ``jax`` and never anything
from ``hpc_patterns_tpu``.

Ported so far: the greedy paged serving path — ``models/serving.py``
(``ContinuousBatcher``) over ``models/decode.py`` (paged prefill and
decode), with two kernels written by hand for ``sm_90a``:
``csrc/flash_prefill.cu`` (causal flash attention forward) and
``csrc/paged_decode.cu`` (single-query attention through a page table).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise
(:func:`hpc_patterns_tpu_torch.topology.resolve_device`).
"""
