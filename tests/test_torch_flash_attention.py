"""The port's flash prefill wrapper (``hpc_patterns_tpu_torch.ops.
flash_attention``) against the JAX Pallas forward, run in interpret mode
on the CPU. On CPU tensors the wrapper computes its plain version (the
dense masked softmax), so this pins that the plain version — what the
CUDA kernel is held against on the card — computes the TPU kernel's
function.

Tolerance: f32 on both sides, atol = rtol = 1e-5 — only the summation
order differs (online softmax over key blocks vs one dense softmax).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from hpc_patterns_tpu_torch.ops import flash_attention as fa  # noqa: E402

ATOL = RTOL = 1e-5


def _inputs(seed, B, T, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_matches_jax_causal(T, H, Hkv):
    q, k, v = _inputs(T + H + Hkv, 2, T, H, Hkv, 16)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_matches_jax_non_causal_and_explicit_scale():
    q, k, v = _inputs(3, 1, 128, 4, 2, 16)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        scale=0.3, interpret=True))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False, scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 64, 2, 2, 8))
    before = fa.launches
    got = fa.flash_attention(q, k, v)
    assert fa.launches == before
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v),
                               atol=0, rtol=0)


def test_shape_and_device_checks_raise():
    q = torch.zeros(1, 64, 4, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, torch.zeros(1, 64, 3, 8),
                           torch.zeros(1, 64, 3, 8))
    with pytest.raises(ValueError, match="want"):
        fa.flash_attention(torch.zeros(64, 4, 8), q, q)
    meta = torch.zeros(1, 64, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)
