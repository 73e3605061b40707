"""The port's decode wrappers (``hpc_patterns_tpu_torch.ops.
flash_decode``) against the JAX Pallas kernels, run in interpret mode on
the CPU: ``flash_decode_paged`` over a permuted page table, ragged
positions (0, a page's last row, the next page's first, the top of the
table) and a shared scalar position, MHA, GQA and MQA, on compute-dtype
pools and on int8/fp8 pools with scale pools; ``flash_decode_attention``
on the linear cache in the compute dtype, int8 and fp8. On CPU tensors
the wrappers compute their plain versions (the masked softmax over the
dequantized cache). One-byte caches are quantized once, by JAX's
``_quantize_rows``, and carried across byte for byte.

Tolerance: f32 on both sides, atol = rtol = 1e-5 — only the summation
order differs (online softmax block by block vs one softmax), and where
the JAX kernel folds the scales into scores and probabilities the plain
version dequantizes first (one more f32 rounding per term).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models.decode import (  # noqa: E402
    _quantize_rows as jax_quantize_rows,
)
from hpc_patterns_tpu.ops.flash_decode import (  # noqa: E402
    flash_decode_attention as jax_flash_decode_attention,
)
from hpc_patterns_tpu.ops.flash_decode import (  # noqa: E402
    flash_decode_paged as jax_flash_decode_paged,
)
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
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
    # scale pools on compute-dtype pools, and one-byte pools without them
    with pytest.raises(ValueError, match="refuses"):
        fd.flash_decode_paged(q, kp, vp, table, 3, k_scale_pool=kp[:, :, :1],
                              v_scale_pool=vp[:, :, :1])
    with pytest.raises(ValueError, match="needs"):
        fd.flash_decode_paged(q, kp.to(torch.int8), vp.to(torch.int8),
                              table, 3)
    with pytest.raises(ValueError, match="ragged pos"):
        fd.flash_decode_paged(q, kp, vp, table,
                              torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="table"):
        fd.flash_decode_paged(q, kp, vp, table[:1], 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        fd.flash_decode_paged(q, kp, vp[..., :4], table, 3)


def _carry(a):
    """A JAX array as a CPU tensor, bytes unchanged (fp8 included)."""
    return params_from_jax(np.asarray(a), device="cpu")


def _quantized(x, kv):
    """(values, scales) of f32 rows ``x`` in ``kv`` storage, quantized by
    JAX: the JAX arrays and their port twins."""
    if kv == "compute":
        return (jnp.asarray(x), None), (torch.from_numpy(x), None)
    q, sc = jax_quantize_rows(jnp.asarray(x), kv)
    return (q, sc), (_carry(q), _carry(sc))


KV = ["compute", "int8", "fp8"]
GROUPS = pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)],
                                 ids=["mha", "gqa", "mqa"])


@GROUPS
@pytest.mark.parametrize("kv", KV)
def test_linear_flash_decode_attention_matches_jax(kv, H, Hkv):
    rng = np.random.default_rng(H * 10 + Hkv)
    B, S, D = 2, 40, 16
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    (jk, jks), (tk, tks) = _quantized(
        rng.standard_normal((B, Hkv, S, D), dtype=np.float32), kv)
    (jv, jvs), (tv, tvs) = _quantized(
        rng.standard_normal((B, Hkv, S, D), dtype=np.float32), kv)
    for pos in (0, 17, S - 1):
        want = np.asarray(jax_flash_decode_attention(
            jnp.asarray(q), jk, jv, jnp.int32(pos), k_scale=jks,
            v_scale=jvs, interpret=True))
        got = fd.flash_decode_attention(torch.from_numpy(q), tk, tv, pos,
                                        k_scale=tks, v_scale=tvs)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _quantized_pools(seed, B, H, Hkv, D, kv):
    q, kp, vp, table = _inputs(seed, B, H, Hkv, D)
    n_pool = kp.shape[0]
    out = []
    for pool in (kp, vp):
        (jq, js), (tq, ts) = _quantized(pool, kv)
        out.append((jq, js.reshape(n_pool, Hkv, 1, P),
                    tq, ts.reshape(n_pool, Hkv, 1, P)))
    return q, table, out


@GROUPS
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_paged_scale_branch_matches_jax(kv, H, Hkv):
    q, table, ((jk, jks, tk, tks), (jv, jvs, tv, tvs)) = _quantized_pools(
        H + Hkv, 5, H, Hkv, 16, kv)
    ragged = np.array([0, P - 1, P, PAGES * P - 1, 37], np.int32)
    for pos in (ragged, 2 * P + 5):
        want = np.asarray(jax_flash_decode_paged(
            jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
            k_scale_pool=jks, v_scale_pool=jvs, interpret=True))
        p = torch.from_numpy(pos) if np.ndim(pos) else int(pos)
        got = fd.flash_decode_paged(torch.from_numpy(q), tk, tv,
                                    torch.from_numpy(table), p,
                                    k_scale_pool=tks, v_scale_pool=tvs,
                                    pages_per_step=2)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
