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


def _chunk_positions(S_max, rows, sms):
    """0, the smallest chunks' edges, S_max - 1, and every edge (and its
    neighbours) of the split S_max - 1 gets."""
    n, chunk = fd.decode_chunks(S_max - 1, rows, sms)
    edges = {chunk * i + d for i in range(1, n) for d in (-1, 0, 1)}
    small = {fd.CHUNK_ROWS - 1, fd.CHUNK_ROWS, fd.CHUNK_ROWS + 1}
    return sorted(p for p in {0, 1, S_max - 2, S_max - 1} | edges | small
                  if 0 <= p < S_max)


@pytest.mark.parametrize("S_max,rows,sms", [(520, 32, 132), (520, 8, 132),
                                            (4096, 4, 132), (4096, 2, 132),
                                            (600, 24, 132), (600, 1000, 132),
                                            (200, 2, 16), (40, 2, 16)])
def test_decode_chunks_cover_the_live_rows_once(S_max, rows, sms):
    for pos in _chunk_positions(S_max, rows, sms):
        n, chunk = fd.decode_chunks(pos, rows, sms)
        spans = [(i * chunk, min((i + 1) * chunk, pos + 1)) for i in range(n)]
        # every live row in exactly one chunk, in order, none empty
        assert [r for lo, hi in spans for r in range(lo, hi)] == \
            list(range(pos + 1)), (pos, n, chunk)
        assert all(lo < hi for lo, hi in spans), (pos, n, chunk)
        assert chunk % fd.CHUNK_ROWS == 0
        # no more chunks than the CTAs the split aims at need
        assert n == 1 or (n - 1) * rows < fd.CTAS_PER_SM * sms


def test_decode_chunks_at_the_precision_law_shape():
    # B 4 x Hkv 8 (Hkv 2) cache rows at pos 519 on a 132-SM card: 9 chunks
    # of 64 rows, 288 (72) CTAs; a card-filling batch or a short fill is
    # one chunk; nothing to split raises
    assert fd.decode_chunks(519, 32, 132) == (9, 64)
    assert fd.decode_chunks(519, 8, 132) == (9, 64)
    assert fd.decode_chunks(519, 264, 132) == (1, 576)
    assert fd.decode_chunks(63, 32, 132) == (1, 64)
    assert fd.decode_chunks(64, 32, 132) == (2, 64)
    assert fd.decode_chunks(0, 32, 132) == (1, 64)
    with pytest.raises(ValueError, match="no rows"):
        fd.decode_chunks(-1, 32, 132)


def _split_model(q, k, v, pos, n, chunk, scale):
    """The split kernel's algebra in plain torch (f32): each chunk's
    unnormalised softmax (m, l, acc) over its rows, then the merge by lse
    in chunk order, out = sum acc_i e^(m_i - m*) / max(sum l_i e^(m_i -
    m*), 1e-30)."""
    B, H, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    parts = []
    for i in range(n):
        lo, hi = i * chunk, min((i + 1) * chunk, pos + 1)
        s = torch.einsum("bkgd,bksd->bkgs", qg, k[:, :, lo:hi]) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgs,bksd->bkgd", p, v[:, :, lo:hi])))
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(li * torch.exp(mi - m_star) for mi, li, _ in parts)
    acc = sum(ai * torch.exp(mi - m_star)[..., None] for mi, _, ai in parts)
    return (acc / l.clamp_min(1e-30)[..., None]).reshape(B, H, D)


@GROUPS
def test_lse_merge_of_the_split_matches_jax_at_chunk_edges(H, Hkv):
    # the chunking algebra on the planner's splits, not the kernel (which
    # the cuda-marked tests hold against its plain version): a 16-SM
    # card's split of a 200-row cache, up to 4 chunks of 64 rows
    rng = np.random.default_rng(70 + H + Hkv)
    B, S, D, sms = 2, 200, 16, 16
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    splits = set()
    for pos in _chunk_positions(S, B * Hkv, sms):
        n, chunk = fd.decode_chunks(pos, B * Hkv, sms)
        splits.add(n)
        want = np.asarray(jax_flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
            interpret=True))
        got = _split_model(*map(torch.from_numpy, (q, k, v)), pos, n, chunk,
                           1.0 / D ** 0.5)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert {1, 2, 3, 4} <= splits


# the paged kernel's split: pages of 64 rows, 8 a sequence, so the planned
# 128-row chunk cuts the table into 4 and a chunk spans two pages
SPLIT_P, SPLIT_PAGES = 64, 8


def _paged_split_model(q, kp, vp, table, pos, chunk, scale, ks=None,
                       vs=None):
    """The paged kernel's algebra in plain torch (f32): every sequence's
    rows in the fixed chunks ``[c * chunk, (c + 1) * chunk)`` of its
    table, read through the table; a chunk that starts past ``pos[b]``
    does nothing; a sequence whose live rows all lie in chunk 0 is
    normalised there; otherwise each live chunk's (m, l, acc), the scores
    times the k scales and the probabilities times the v scales, merges
    by lse in chunk order."""
    B, H, D = q.shape
    _, Hkv, P, _ = kp.shape
    pages = table.shape[1]
    tbl = table.long()
    kd = fd._gather_pages(kp, tbl).float()
    vd = fd._gather_pages(vp, tbl).float()
    ones = torch.ones(kd.shape[:3])
    ksd = ones if ks is None else fd._gather_pages(ks.transpose(2, 3),
                                                   tbl)[..., 0]
    vsd = ones if vs is None else fd._gather_pages(vs.transpose(2, 3),
                                                   tbl)[..., 0]
    n_chunks = -(-pages * P // chunk)
    out = torch.empty(B, H, D)
    for b in range(B):
        p = min(max(int(pos[b]), 0), pages * P - 1)
        qb = q[b].float().reshape(Hkv, H // Hkv, D)
        parts = []
        for c in range(n_chunks):
            lo = c * chunk
            if lo > p:
                continue  # past the fill: no work, nothing written
            hi = min(lo + chunk, p + 1)
            s = (torch.einsum("kgd,ksd->kgs", qb, kd[b, :, lo:hi]) * scale
                 * ksd[b, :, None, lo:hi])
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum(
                "kgs,ksd->kgd", e * vsd[b, :, None, lo:hi], vd[b, :, lo:hi])))
        if len(parts) == 1:  # chunk 0 normalises in place
            m, l, acc = parts[0]
        else:
            m_star = torch.stack([m for m, _, _ in parts]).amax(0)
            l = sum(li * torch.exp(mi - m_star) for mi, li, _ in parts)
            acc = sum(ai * torch.exp(mi - m_star)[..., None]
                      for mi, _, ai in parts)
        out[b] = (acc / l.clamp_min(1e-30)[..., None]).reshape(H, D)
    return out


def _split_pools(seed, B, H, Hkv, D, kv):
    """q, a permuted table of SPLIT_PAGES pages, and K/V pools (with
    scale pools for int8) of SPLIT_P-row pages: the JAX arrays and their
    port twins."""
    rng = np.random.default_rng(seed)
    n_pool = B * SPLIT_PAGES + 3
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    table = rng.permutation(n_pool)[:B * SPLIT_PAGES].astype(np.int32)
    pools = []
    for _ in range(2):
        x = rng.standard_normal((n_pool, Hkv, SPLIT_P, D), dtype=np.float32)
        if kv == "bfloat16":
            j = jnp.asarray(x).astype(jnp.bfloat16)
            pools.append((j, None, _carry(j), None))
        else:
            (jq, js), (tq, ts) = _quantized(x, kv)
            shape = (n_pool, Hkv, 1, SPLIT_P)
            pools.append((jq, js.reshape(shape), tq, ts.reshape(shape)))
    return q, table.reshape(B, SPLIT_PAGES), pools


@GROUPS
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_paged_split_model_matches_jax_at_chunk_and_page_edges(kv, H, Hkv):
    # the split algebra on the kernel's fixed plan, not the kernel (which
    # the cuda-marked tests hold against its plain version): ragged fills
    # on and next to every chunk and page edge, chunks past each fill,
    # the one-chunk case normalised in place
    B, D = 5, 16
    q, table, ((jk, jks, tk, tks), (jv, jvs, tv, tvs)) = _split_pools(
        90 + H + Hkv, B, H, Hkv, D, kv)
    n_chunks, chunk = fd.paged_decode_plan(SPLIT_PAGES, SPLIT_P)
    assert (n_chunks, chunk) == (4, 128)
    rows = SPLIT_PAGES * SPLIT_P
    edges = sorted({e + d for e in range(SPLIT_P, rows, SPLIT_P)
                    for d in (-1, 0, 1)} | {0, 1, rows - 1})
    live = set()
    for i in range(0, len(edges), B):
        pos = np.array((edges[i:i + B] + edges[:B])[:B], np.int32)
        want = np.asarray(jax_flash_decode_paged(
            jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
            k_scale_pool=jks, v_scale_pool=jvs, interpret=True))
        got = _paged_split_model(torch.from_numpy(q), tk, tv,
                                 torch.from_numpy(table), pos, chunk,
                                 1.0 / D ** 0.5, tks, tvs)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        live |= {int(p) // chunk + 1 for p in pos}
    assert live == {1, 2, 3, 4}


def test_paged_decode_plan_depends_on_the_page_size_only():
    # the chunk is a function of the page size: no batch, kv heads, head
    # dim, pool dtype, fill or SM count enters the plan (a sequence's bits
    # then do not depend on what it is batched with), unlike decode_chunks
    import inspect

    assert list(inspect.signature(fd.paged_decode_plan).parameters) == [
        "pages", "P"]
    assert list(inspect.signature(fd.paged_decode_chunk).parameters) == [
        "P"]
    for P in (16, 32, 64, 128, 192, 256, 300, 320, 512):
        chunk = fd.paged_decode_chunk(P)
        assert chunk % 64 == 0 and chunk <= fd.PAGED_CHUNK_ROWS
        # no chunk straddles a page of whole 64-row multiples
        assert P % 64 or P % chunk == 0 or chunk % P == 0
        for pages in (1, 3, 4, 9):
            n, c = fd.paged_decode_plan(pages, P)
            assert c == chunk  # the table's width moves only n
            assert (n - 1) * c < pages * P <= n * c
    # the linear cache's planner does look at the batch and the card
    assert fd.decode_chunks(519, 8, 132) != fd.decode_chunks(519, 264, 132)
