"""Block fitting for the port's kernels: the counterpart of
``hpc_patterns_tpu/ops/tiling.py``, of which only
:func:`fit_block_divisor` comes over (that module imports ``jax`` at its
top, so the port keeps its own copy).

The rest of the JAX module has no CUDA meaning: its collective-id
registry numbers the TPU's cross-chip semaphores, and its compiler
parameters and interpret default configure Mosaic. A CUDA kernel takes
its tiles from the SM's budget and masks its ragged edges itself.
"""

from __future__ import annotations


def fit_block_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap``: an off-size length
    gets a smaller even tile instead of an error. Always succeeds (1
    divides everything). The fused-MLP fitting rule."""
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1
