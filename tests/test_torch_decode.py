"""The port's paged serving path (``hpc_patterns_tpu_torch.models.decode``)
against the JAX one, slice as a whole: prefill logits and K/V,
``paged_prefill`` logits and pool contents through a permuted table,
ragged ``paged_decode_step`` logits over several steps, and greedy
``paged_generate`` tokens. The JAX side takes ``decode_attn="gather"``,
the route its own serving takes off the TPU; the port runs both its
routes — "flash" (the kernels' wrappers, which compute their plain
versions on CPU tensors) and "gather".

Tolerances: logits and cache contents atol = rtol = 1e-4 in f32 (matmul
summation order differs between XLA:CPU and torch); greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)

ATOL = RTOL = 1e-4
P = 16
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=256,
             max_seq=256, dtype="float32")
ROUTES = ["flash", "gather"]


def _setup(route="flash", seed=0, **kw):
    fields = {**SMALL, **kw}
    jcfg = jtf.TransformerConfig(**fields, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**fields, decode_attn=route)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompt(B, T, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T), np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("T", [20, 128])
def test_prefill_logits_and_kv_match_jax(route, T):
    jcfg, tcfg, jp, tp = _setup(route, n_kv_heads=2)
    prompt = _prompt(2, T)
    last = np.array([T - 1, T // 2], np.int32)
    jl, jc = jdec.prefill(jp, jnp.asarray(prompt), jcfg, T + 8,
                          last_pos=jnp.asarray(last))
    tl, tc = tdec.prefill(tp, torch.from_numpy(prompt), tcfg, T + 8,
                          last_pos=torch.from_numpy(last))
    _close(tl, jl)
    for name in ("k", "v"):
        for l in range(tcfg.n_layers):
            assert tuple(tc[name][l].shape) == jc[name][l].shape
            _close(tc[name][l], jc[name][l])


def _permuted_table(B, pages, pool, seed=3):
    perm = np.random.default_rng(seed).permutation(pool)[:B * pages]
    return perm.astype(np.int32).reshape(B, pages)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kw", [{}, {"pos_embed": "rope",
                                     "n_kv_heads": 2}],
                         ids=["learned", "rope-gqa"])
def test_paged_prefill_then_ragged_decode_steps_match_jax(route, kw):
    jcfg, tcfg, jp, tp = _setup(route, **kw)
    B, T, pages, pool = 3, 30, 4, 15
    table = _permuted_table(B, pages, pool)
    prompt = _prompt(B, T)
    jcache = jdec.init_paged_cache(jcfg, B, pages, P, pool_pages=pool,
                                   table=jnp.asarray(table))
    tcache = tdec.init_paged_cache(tcfg, B, pages, P, pool_pages=pool,
                                   table=table, device="cpu")
    jl, jcache = jdec.paged_prefill(jp, jnp.asarray(prompt), jcfg, jcache,
                                    P)
    tl, tcache = tdec.paged_prefill(tp, torch.from_numpy(prompt), tcfg,
                                    tcache, P)
    _close(tl, jl)
    used = table[:, :-(-T // P)].reshape(-1)
    for name in ("k", "v"):
        for l in range(tcfg.n_layers):
            _close(tcache[name][l][used], np.asarray(jcache[name][l])[used])
    # ragged steps: each row at its own position, crossing page 2's
    # boundary (31 -> 32) on row 0; tokens follow JAX's greedy picks
    pos = np.array([T, T - 3, T - 10], np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(4):
        jl, jcache = jdec.paged_decode_step(jp, jcache, jnp.asarray(pos),
                                            jnp.asarray(tok), jcfg)
        tl = tdec.paged_decode_step(tp, tcache, torch.from_numpy(pos),
                                    torch.from_numpy(tok), tcfg)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    for name in ("k", "v"):
        for l in range(tcfg.n_layers):
            _close(tcache[name][l], jcache[name][l])


@pytest.mark.parametrize("route", ROUTES)
def test_scalar_pos_decode_step_matches_jax(route):
    jcfg, tcfg, jp, tp = _setup(route, n_kv_heads=1)
    prompt = _prompt(2, 16)
    jcache = jdec.init_paged_cache(jcfg, 2, 3, P)
    tcache = tdec.init_paged_cache(tcfg, 2, 3, P, device="cpu")
    jl, jcache = jdec.paged_prefill(jp, jnp.asarray(prompt), jcfg, jcache,
                                    P)
    tdec.paged_prefill(tp, torch.from_numpy(prompt), tcfg, tcache, P)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, _ = jdec.paged_decode_step(jp, jcache, 16, jnp.asarray(tok), jcfg)
    tl = tdec.paged_decode_step(tp, tcache, 16, torch.from_numpy(tok),
                                tcfg)
    _close(tl, jl)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kw,T", [
    ({}, 20), ({"pos_embed": "rope"}, 33), ({"n_kv_heads": 2}, 128),
], ids=["learned", "rope", "gqa-flash-prefill"])
def test_paged_generate_greedy_tokens_equal_jax(route, kw, T):
    jcfg, tcfg, jp, tp = _setup(route, **kw)
    prompt = _prompt(2, T, seed=T)
    want = np.asarray(jdec.paged_generate(jp, jnp.asarray(prompt), jcfg, 12,
                                          page_size=P))
    got = tdec.paged_generate(tp, torch.from_numpy(prompt), tcfg, 12,
                              page_size=P, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_generate_matches_jax_kernel_route():
    # the JAX side on its own Pallas kernels (interpret mode) this time
    jcfg, tcfg, jp, tp = _setup("flash", n_kv_heads=2)
    jcfg = dataclasses.replace(jcfg, decode_attn="flash")
    prompt = _prompt(1, 128, seed=7)
    want = np.asarray(jdec.paged_generate(jp, jnp.asarray(prompt), jcfg, 4,
                                          page_size=P))
    got, margins = tdec.paged_generate(tp, torch.from_numpy(prompt), tcfg,
                                       4, page_size=P, device="cpu",
                                       with_margins=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert margins.shape == (1, 4) and bool((margins >= 0).all())


def test_unported_routes_and_capacity_raise():
    _, tcfg, _, tp = _setup("paged_flash")
    cache = tdec.init_paged_cache(tcfg, 1, 2, P, device="cpu")
    tok = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="_paged_attention_kernel"):
        tdec.paged_decode_step(tp, cache, 3, tok, tcfg)
    _, gcfg, _, _ = _setup("gather")
    with pytest.raises(ValueError, match="capacity"):
        tdec.paged_decode_step(tp, cache, 2 * P, tok, gcfg)
    qcfg = dataclasses.replace(gcfg, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="quantized"):
        tdec.init_paged_cache(qcfg, 1, 2, P, device="cpu")
    with pytest.raises(ValueError, match="identity table"):
        tdec.init_paged_cache(gcfg, 2, 2, P, pool_pages=3, device="cpu")
