"""The port's exact-softmax paged decode (``hpc_patterns_tpu_torch.ops.
paged_attention.paged_attention_decode``) against the JAX Pallas
``paged_attention_decode`` in interpret mode on the CPU — the battery of
the JAX package's own ``test_quantization.py``: f32, bf16, int8 and fp8
pools, one partial page, a partial last live page, the grid edges (first
position, exactly full table, a live prefix far short of the
allocation), ragged positions over a permuted table; the scale guards;
and the mask constant equal to the flash routes'. On CPU tensors the
wrapper computes its plain version, the gather route.

Tolerance: atol = rtol = 1e-5 with f32 queries on both sides (bf16 pools
are widened to f32 on both): the sums run in another order, and one-byte
pools are dequantized by the same ``k.float() * scale`` on both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models.decode import (  # noqa: E402
    _quantize_rows as jax_quantize_rows,
)
from hpc_patterns_tpu.ops import paged_attention as jpa  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.ops import flash_decode as fd  # noqa: E402
from hpc_patterns_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from hpc_patterns_tpu_torch.parallel import ring_attention  # noqa: E402

ATOL = RTOL = 1e-5
B, H, HKV, D, P = 2, 4, 2, 8, 16


def _carry(a):
    return None if a is None else params_from_jax(np.asarray(a),
                                                  device="cpu")


def _pools(seed, pages, kv_dtype):
    """q, pools and scale pools in ``kv_dtype`` (JAX arrays), quantized
    by JAX's ``_quantize_rows`` as the JAX battery makes them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    n_pool = B * pages
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((n_pool, HKV, P, D),
                                            dtype=np.float32))
        if kv_dtype in ("float32", "bfloat16"):
            out.append((x.astype(kv_dtype), None))
        else:
            qv, s = jax_quantize_rows(x.reshape(-1, D), kv_dtype)
            out.append((qv.reshape(n_pool, HKV, P, D),
                        s.reshape(n_pool, HKV, 1, P)))
    return q, out


def _battery(kv_dtype, pages, pos, permute=False):
    q, ((kp, ks), (vp, vs)) = _pools(pages * 7 + len(kv_dtype), pages,
                                     kv_dtype)
    ids = np.arange(B * pages, dtype=np.int32)
    if permute:
        ids = np.random.default_rng(3).permutation(ids)
    table = ids.reshape(B, pages)
    want = np.asarray(jpa.paged_attention_decode(
        jnp.asarray(q), kp, vp, jnp.asarray(table), jnp.asarray(pos),
        k_scale_pool=ks, v_scale_pool=vs, interpret=True))
    p = torch.from_numpy(pos) if np.ndim(pos) else int(pos)
    got = tpa.paged_attention_decode(
        torch.from_numpy(q), _carry(kp), _carry(vp), torch.from_numpy(table),
        p, k_scale_pool=_carry(ks), v_scale_pool=_carry(vs))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("pages,pos", [(1, 9), (4, 37)],
                         ids=["one-partial-page", "partial-last-page"])
def test_matches_jax_scalar_pos(kv_dtype, pages, pos):
    _battery(kv_dtype, pages, np.int32(pos))


@pytest.mark.parametrize("pages,pos", [(1, 0), (4, 63), (7, 40)],
                         ids=["first-position", "full-table", "short-prefix"])
def test_matches_jax_grid_edges(pages, pos):
    _battery("float32", pages, np.int32(pos))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "fp8"])
def test_matches_jax_ragged_and_permuted(kv_dtype):
    _battery(kv_dtype, 4, np.array([5, 50], np.int32), permute=True)


def test_guards():
    q = torch.zeros(2, 4, 8)
    kp = torch.zeros(8, 2, 16, 8)
    table = torch.zeros(2, 4, dtype=torch.int32)
    sc = torch.zeros(8, 2, 1, 16)
    k8 = kp.to(torch.int8)
    with pytest.raises(ValueError, match="refuses"):
        tpa.paged_attention_decode(q, kp, kp, table, 0, k_scale_pool=sc,
                                   v_scale_pool=sc)
    with pytest.raises(ValueError, match="needs"):
        tpa.paged_attention_decode(q, k8, k8, table, 0)
    with pytest.raises(ValueError, match="come together"):
        tpa.paged_attention_decode(q, k8, k8, table, 0, k_scale_pool=sc)
    with pytest.raises(ValueError, match="table rows"):
        tpa.paged_attention_decode(q, kp, kp, table[:1], 0)
    with pytest.raises(ValueError, match="ragged pos"):
        tpa.paged_attention_decode(q, kp, kp, table,
                                   torch.zeros(3, dtype=torch.int32))


def test_mask_constant_matches_flash_routes():
    assert tpa._NEG_INF == fd._NEG_INF == ring_attention._NEG_INF \
        == jpa._NEG_INF


@pytest.mark.parametrize("P", [16, 64, 192, 256, 300, 1024])
def test_exact_softmax_chunk_plan_follows_the_page_size_alone(P):
    # kernel 7 splits each sequence's rows on kernel 6's plan (both launch
    # through flash_decode.launch_paged): the chunk is set by the page size
    # alone (never by the batch, the kv heads or the table width), so a
    # sequence's bits do not depend on its batch; the chunks cover the
    # table's pages * P rows, the last one partial at most; a chunk stays
    # within the kernels' PAGED_CHUNK_MAX (256) rows and, for pages of a
    # multiple of 64 rows, never straddles a page
    chunk = fd.paged_decode_chunk(P)
    assert 0 < chunk <= 256
    if P % 64 == 0:
        assert P % chunk == 0 or chunk % P == 0
    for pages in (1, 3, 4, 7, 64):
        n_chunks, c = fd.paged_decode_plan(pages, P)
        assert c == chunk
        assert (n_chunks - 1) * chunk < pages * P <= n_chunks * chunk
