"""The port's paged decode wrapper (``hpc_patterns_tpu_torch.ops.
flash_decode``) against the JAX Pallas ``flash_decode_paged``, run in
interpret mode on the CPU: a permuted page table, ragged positions
(0, a page's last row, the next page's first, the top of the table) and
a shared scalar position, MHA and GQA. On CPU tensors the wrapper
computes its plain version (the gather-through-the-table softmax).

Tolerance: f32 on both sides, atol = rtol = 1e-5 — only the summation
order differs (online softmax page by page vs one softmax).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.ops.flash_decode import (  # noqa: E402
    flash_decode_paged as jax_flash_decode_paged,
)
from hpc_patterns_tpu_torch.ops import flash_decode as fd  # noqa: E402

ATOL = RTOL = 1e-5
P, PAGES = 16, 4


def _inputs(seed, B, H, Hkv, D, n_pool=None):
    rng = np.random.default_rng(seed)
    n_pool = n_pool or B * PAGES + 3
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((n_pool, Hkv, P, D), dtype=np.float32)
    vp = rng.standard_normal((n_pool, Hkv, P, D), dtype=np.float32)
    table = rng.permutation(n_pool)[:B * PAGES].astype(np.int32)
    return q, kp, vp, table.reshape(B, PAGES)


def _both(q, kp, vp, table, pos):
    want = np.asarray(jax_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), interpret=True))
    t = torch.from_numpy
    p = t(np.asarray(pos, np.int32)) if np.ndim(pos) else int(pos)
    got = fd.flash_decode_paged(t(q), t(kp), t(vp), t(table), p)
    return got, want


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_ragged_pos_permuted_table_matches_jax(H, Hkv):
    q, kp, vp, table = _inputs(H * 10 + Hkv, 5, H, Hkv, 16)
    pos = np.array([0, P - 1, P, PAGES * P - 1, 37], np.int32)
    got, want = _both(q, kp, vp, table, pos)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pos", [0, P - 1, P, 2 * P + 5])
def test_scalar_pos_matches_jax(pos):
    q, kp, vp, table = _inputs(pos, 3, 4, 2, 16)
    got, want = _both(q, kp, vp, table, pos)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_pages_past_the_fill_are_not_read():
    # garbage in every page past each row's fill must not leak in (the
    # trash-page / stale-row invariant serving relies on)
    q, kp, vp, table = _inputs(9, 2, 4, 4, 16)
    pos = np.array([P - 1, 2 * P], np.int32)
    clean = _both(q, kp, vp, table, pos)[0]
    for b, p in enumerate(pos):
        for j in range(p // P + 1, PAGES):
            kp[table[b, j]] = 1e4
            vp[table[b, j]] = 1e4
    dirty = fd.flash_decode_paged(*(torch.from_numpy(a) for a in
                                    (q, kp, vp, table)),
                                  torch.from_numpy(pos))
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


def test_quantized_pools_and_bad_shapes_raise():
    q, kp, vp, table = (torch.from_numpy(a) for a in _inputs(1, 2, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="_decode_kernel_paged"):
        fd.flash_decode_paged(q, kp, vp, table, 3, k_scale_pool=kp[:, :, :1],
                              v_scale_pool=vp[:, :, :1])
    with pytest.raises(ValueError, match="ragged pos"):
        fd.flash_decode_paged(q, kp, vp, table,
                              torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="table"):
        fd.flash_decode_paged(q, kp, vp, table[:1], 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        fd.flash_decode_paged(q, kp, vp[..., :4], table, 3)
