"""The port's paged serving path (``hpc_patterns_tpu_torch.models.decode``)
against the JAX one, slice as a whole: prefill logits and K/V,
``paged_prefill`` logits and pool contents through a permuted table,
ragged ``paged_decode_step`` logits over several steps, and greedy
``paged_generate`` tokens. The JAX side takes ``decode_attn="gather"``,
the route its own serving takes off the TPU; the port runs both its
routes — "flash" (the kernels' wrappers, which compute their plain
versions on CPU tensors) and "gather".

The quantized half (int8/fp8 KV, per-row scales): ``_quantize_rows``
bit-equal to JAX's on the same rows; ``prefill`` caches and
``decode_step`` logits on the linear cache against JAX for compute, int8
and fp8 on both routes; greedy ``generate`` against JAX; and, in-port,
``extend_step`` against sequential steps, quantized ``paged_generate``
against quantized linear ``generate``, and sampling.

Tolerances: logits and cache contents atol = rtol = 1e-4 in f32 (matmul
summation order differs between XLA:CPU and torch); greedy tokens equal,
or tie-aware (a first divergence only where the top-1/top-2 gap is below
1e-4). With one-byte KV, K/V that differ in the last ULP may round to the
neighbouring quantization step: quantized bytes may differ in at most 1%
of values, each dequantized value stays within one step (its row's
scale), and logits hold to atol = rtol = 2e-3 (one flipped step moves a
score by about scale * |q| / sqrt(D); measured here: the bytes equal and
logits within 3e-6).
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
from hpc_patterns_tpu_torch.models.serving import (  # noqa: E402
    tie_aware_compare,
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
    # the paged_flash route and quantized pools are ported: they run (on
    # the CPU through the gather view); capacity and the identity table
    # still raise
    _, tcfg, _, tp = _setup("paged_flash")
    cache = tdec.init_paged_cache(tcfg, 1, 2, P, device="cpu")
    tok = torch.zeros(1, dtype=torch.int32)
    got = tdec.paged_decode_step(tp, cache, 3, tok, tcfg)
    assert got.shape == (1, tcfg.vocab) and bool(torch.isfinite(got).all())
    _, gcfg, _, _ = _setup("gather")
    with pytest.raises(ValueError, match="capacity"):
        tdec.paged_decode_step(tp, cache, 2 * P, tok, gcfg)
    qcfg = dataclasses.replace(gcfg, kv_cache_dtype="int8")
    qcache = tdec.init_paged_cache(qcfg, 1, 2, P, device="cpu")
    assert qcache["k"][0].dtype == torch.int8
    assert tuple(qcache["k_scale"][0].shape) == (2, tcfg.kv_heads, 1, P)
    with pytest.raises(ValueError, match="identity table"):
        tdec.init_paged_cache(gcfg, 2, 2, P, pool_pages=3, device="cpu")


KV = ["compute", "int8", "fp8"]
Q_ATOL = Q_RTOL = 2e-3
TIE_TOL = 1e-4


def _qsetup(route, kv, seed=0, **kw):
    jcfg, tcfg, jp, tp = _setup(route, seed=seed, **kw)
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv,
                               decode_attn=route if route != "paged_flash"
                               else "gather")
    return jcfg, dataclasses.replace(tcfg, kv_cache_dtype=kv), jp, tp


def _bytes(t):
    t = torch.as_tensor(t) if not torch.is_tensor(t) else t
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _close_cache(tc, jc, kv):
    """Port cache vs JAX cache: values and scales (see the tolerances
    above)."""
    jt = params_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert sorted(tc) == sorted(jt)
    for name in ("k", "v"):
        for l, (got, want) in enumerate(zip(tc[name], jt[name])):
            assert got.dtype == want.dtype and got.shape == want.shape
            if kv == "compute":
                _close(got, want)
                continue
            differ = (_bytes(got) != _bytes(want)).float().mean().item()
            assert differ <= 0.01, (name, l, differ)
            gs, ws = tc[name + "_scale"][l], jt[name + "_scale"][l]
            _close(gs, ws)
            step = ws[..., None]
            assert bool(((got.float() * gs[..., None]
                          - want.float() * ws[..., None]).abs()
                         <= step * 1.001 + 1e-6).all())


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantize_rows_bit_equal_to_jax(kv):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 3, 16), dtype=np.float32) * 3
    # pin each row's amax element: it must land on the grid's top (+-127
    # or +-448) on both sides, the edge where fp8 casts could disagree
    x[..., 5] = np.sign(x[..., 5] + 0.5) * (np.abs(x).max(-1) + 1.0)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor scale
    jq, js = jdec._quantize_rows(jnp.asarray(x), kv)
    tq, ts = tdec._quantize_rows(torch.from_numpy(x), kv)
    want_q = params_from_jax(np.asarray(jq), device="cpu")
    assert tq.dtype == want_q.dtype
    assert torch.equal(_bytes(tq), _bytes(want_q))
    assert torch.equal(ts, params_from_jax(np.asarray(js), device="cpu"))
    top = 127.0 if kv == "int8" else tdec.FP8_MAX
    amax = tq.float()[1:, :, 5].abs()
    assert bool((amax == top).all())
    assert float(ts[0, 0]) == pytest.approx(1e-8)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kv", KV)
def test_linear_prefill_and_decode_steps_match_jax(route, kv):
    jcfg, tcfg, jp, tp = _qsetup(route, kv, n_kv_heads=2)
    prompt = _prompt(2, 20)
    jl, jc = jdec.prefill(jp, jnp.asarray(prompt), jcfg, 28)
    tl, tc = tdec.prefill(tp, torch.from_numpy(prompt), tcfg, 28)
    atol = ATOL if kv == "compute" else Q_ATOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                               rtol=atol)
    _close_cache(tc, jc, kv)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(4):
        jl, jc = jdec.decode_step(jp, jc, jnp.int32(20 + i),
                                  jnp.asarray(tok), jcfg)
        tl = tdec.decode_step(tp, tc, 20 + i, torch.from_numpy(tok), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=atol)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _close_cache(tc, jc, kv)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("kw", [{}, {"pos_embed": "rope", "n_kv_heads": 1}],
                         ids=["learned", "rope-mqa"])
def test_greedy_generate_matches_jax(kv, kw):
    jcfg, tcfg, jp, tp = _qsetup("flash", kv, **kw)
    prompt = _prompt(2, 24, seed=5)
    want = np.asarray(jdec.generate(jp, jnp.asarray(prompt), jcfg, 10))
    got, margins = tdec.generate(tp, torch.from_numpy(prompt), tcfg, 10,
                                 device="cpu", with_margins=True)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    for b in range(2):
        assert tie_aware_compare(got[b].numpy(), want[b],
                                 margins[b].numpy(), TIE_TOL) != "mismatch"
    greedy = tdec.greedy_generate(tp, torch.from_numpy(prompt), tcfg, 10,
                                  device="cpu")
    assert torch.equal(greedy, got)


def test_extend_step_equals_sequential_steps():
    _, tcfg, _, tp = _setup("gather", n_kv_heads=2, pos_embed="rope")
    prompt = torch.from_numpy(_prompt(2, 12))
    chunk = torch.from_numpy(_prompt(2, 5, seed=9))
    _, ca = tdec.prefill(tp, prompt, tcfg, 20)
    _, cb = tdec.prefill(tp, prompt, tcfg, 20)
    got = tdec.extend_step(tp, ca, 12, chunk, tcfg)
    assert got.shape == (2, 5, tcfg.vocab)
    for i in range(5):
        want = tdec.decode_step(tp, cb, 12 + i, chunk[:, i], tcfg)
        _close(got[:, i], want)
    for name in ("k", "v"):
        for l in range(tcfg.n_layers):
            _close(ca[name][l], cb[name][l])
    qcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="compute-dtype"):
        tdec.extend_step(tp, ca, 12, chunk, qcfg)
    with pytest.raises(ValueError, match="outside"):
        tdec.extend_step(tp, ca, 17, chunk, tcfg)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("route", ["flash", "paged_flash", "gather"])
def test_quantized_paged_generate_equals_linear_generate(kv, route):
    _, tcfg, _, tp = _qsetup(route, kv, n_kv_heads=2)
    prompt = torch.from_numpy(_prompt(2, 21, seed=4))
    want, margins = tdec.generate(tp, prompt, tcfg, 12, device="cpu",
                                  with_margins=True)
    got = tdec.paged_generate(tp, prompt, tcfg, 12, page_size=P,
                              device="cpu")
    for b in range(2):
        assert tie_aware_compare(got[b].numpy(), want[b].numpy(),
                                 margins[b].numpy(), TIE_TOL) != "mismatch"


def test_sampling_top1_valid_draws_and_generator():
    _, tcfg, _, tp = _setup("flash", n_kv_heads=2)
    prompt = torch.from_numpy(_prompt(2, 10, seed=2))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    greedy = tdec.generate(tp, prompt, tcfg, 8, device="cpu")
    top1 = tdec.generate(tp, prompt, tcfg, 8, device="cpu", temperature=0.9,
                         top_k=1, generator=gen(0))
    assert torch.equal(top1, greedy)
    a = tdec.paged_generate(tp, prompt, tcfg, 12, page_size=P, device="cpu",
                            temperature=2.0, generator=gen(1))
    b = tdec.paged_generate(tp, prompt, tcfg, 12, page_size=P, device="cpu",
                            temperature=2.0, generator=gen(1))
    c = tdec.paged_generate(tp, prompt, tcfg, 12, page_size=P, device="cpu",
                            temperature=2.0, generator=gen(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 \
        and int(a.max()) < tcfg.vocab
    k4 = tdec.generate(tp, prompt, tcfg, 6, device="cpu", temperature=1.0,
                       top_k=4, generator=gen(3))
    assert k4.shape == (2, 6)
    with pytest.raises(ValueError, match="Generator"):
        tdec.generate(tp, prompt, tcfg, 4, device="cpu", temperature=0.5)
    with pytest.raises(ValueError, match="top_k"):
        tdec.paged_generate(tp, prompt, tcfg, 4, device="cpu", top_k=-1)


def test_topk_mask_keeps_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 2.0]])
    got = tdec._topk_mask(logits, 2)
    want = jdec._topk_mask(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
