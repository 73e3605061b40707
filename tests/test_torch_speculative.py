"""The port's speculative decoding (``hpc_patterns_tpu_torch.models.
speculative``) and ragged paged extend (``decode.paged_extend_step``)
held against the JAX package on the CPU, on the JAX tests' small model
carried across by ``models/convert.py`` (f32):

- the extend against JAX's on the same pools (ragged positions, a chunk
  that crosses a page): logits within 1e-5, the written pools equal
  within 1e-6 (compute), one LSB (int8 and fp8 bytes) and 1e-6 relative
  (scales); past capacity it raises;
- the extend against sequential ``paged_decode_step`` s (JAX
  ``TestPagedExtend``): logits within 2e-5, pools within 1e-5;
- greedy ``speculative_generate`` and both ``speculative_generate_
  batched`` impls, random and self drafts, int8 pools: token for token
  JAX's speculative tokens and the target's own greedy tokens;
- the guards; ``_accept_resample``'s first-token law against the target
  row analytically (TV < 0.02 over 20000 rows), and its bonus position
  (decided by the same rule: with q = p every proposal is accepted and
  the last one's law is p's);
- the sampled impls equal each other (a row draws from its key and
  positions only) and top-k 1 equals greedy; every sampled token is its
  position's rule replayed alone over teacher-forced logits.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import speculative as jspec  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import speculative as tspec  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its models are small,
    and under a parallel test run a thread pool that a worker spins
    across cores the other workers hold slows every worker, the timing
    verdicts of test_torch_bench_serving among them (its own fixture
    takes one thread for the same reason)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32, dtype="float32")
DRAFT = dict(d_model=16, d_ff=32, n_layers=1, n_heads=2)
P = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(over=None, draft_over=None, seed=0):
    """(jcfg, tcfg, jparams, tparams) of one model: the JAX config on the
    gather route, the port's on the flash route (its CPU plain version)."""
    kw = {**BASE, **(over or {}), **(draft_over or {})}
    jcfg = jtf.TransformerConfig(**kw, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**kw, decode_attn="flash")
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), device="cpu")


def _prompts(batch, seed=1, length=8):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (batch, length)).astype(np.int32)


def _port_cache(jcache):
    return params_from_jax(_np(jcache), device="cpu")


# -- the extend against JAX's ------------------------------------------------

@pytest.mark.parametrize("kv", ["compute", "int8", "fp8"])
def test_paged_extend_equals_jax(kv):
    jcfg, tcfg, jp, tp = _pair({"pos_embed": "rope", "n_kv_heads": 2,
                                "kv_cache_dtype": kv})
    prompt = _prompts(2, length=10)
    jc = jdec.init_paged_cache(jcfg, 2, pages_per_seq=3, page_size=P)
    _, jc = jdec.paged_prefill(jp, jnp.asarray(prompt), jcfg, jc, P)
    tc = _port_cache(jc)
    # row 0 re-enters at 6 (its chunk crosses the page edge at 8), row 1
    # continues at 9
    pos = np.array([6, 9], np.int32)
    chunk = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jl, jc2 = jdec.paged_extend_step(jp, jc, jnp.asarray(pos),
                                     jnp.asarray(chunk), jcfg)
    tl = tdec.paged_extend_step(tp, tc, torch.from_numpy(pos),
                                torch.from_numpy(chunk), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    want = _port_cache(jc2)
    for name in ("k", "v"):
        for a, b in zip(tc[name], want[name]):
            if kv == "compute":
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
            else:
                # one LSB: int8 steps, or adjacent float8 codes (same sign)
                ai = a.view(torch.int8 if kv == "int8" else torch.uint8)
                bi = b.view(ai.dtype)
                assert (ai.int() - bi.int()).abs().max() <= 1
    for name in ("k_scale", "v_scale") if kv != "compute" else ():
        for a, b in zip(tc[name], want[name]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_paged_extend_guards():
    _, tcfg, _, tp = _pair()
    cache = tdec.init_paged_cache(tcfg, 2, pages_per_seq=2, page_size=P,
                                  device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tdec.paged_extend_step(tp, cache, torch.tensor([14, 3],
                                                       dtype=torch.int32),
                               torch.zeros((2, 3), dtype=torch.int32), tcfg)
    with pytest.raises(ValueError, match="per-row"):
        tdec.paged_extend_step(tp, cache, 3,
                               torch.zeros((2, 3), dtype=torch.int32), tcfg)


# -- the extend against single steps (JAX TestPagedExtend) -------------------

@pytest.mark.parametrize("over", [{}, {"pos_embed": "rope"},
                                  {"n_kv_heads": 2},
                                  {"kv_cache_dtype": "int8"}])
def test_paged_extend_equals_sequential_steps(over):
    _, tcfg, _, tp = _pair(over)
    prompt = torch.from_numpy(_prompts(2))
    caches = []
    for _ in range(2):
        c = tdec.init_paged_cache(tcfg, 2, pages_per_seq=3, page_size=P,
                                  device="cpu")
        tdec.paged_prefill(tp, prompt, tcfg, c, P)
        # row 1 needs its position-8 row before it starts at 9
        tdec.paged_decode_step(tp, c, torch.tensor([12, 8],
                                                   dtype=torch.int32),
                               torch.tensor([0, 9], dtype=torch.int32), tcfg)
        caches.append(c)
    ca, cb = caches
    pos = torch.tensor([8, 9], dtype=torch.int32)
    chunk = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    le = tdec.paged_extend_step(tp, ca, pos, chunk, tcfg)
    for j in range(3):
        lj = tdec.paged_decode_step(tp, cb, pos + j, chunk[:, j], tcfg)
        np.testing.assert_allclose(le[:, j].numpy(), lj.numpy(), atol=2e-5,
                                   err_msg=f"chunk position {j}")
    for name in ca:
        for a, b in zip(ca[name] if name != "table" else [ca[name]],
                        cb[name] if name != "table" else [cb[name]]):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=1e-5)


# -- greedy generation -------------------------------------------------------

@pytest.mark.parametrize("over", [{}, {"pos_embed": "rope",
                                       "n_kv_heads": 2}])
@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_speculative_generate_greedy_equals_jax_and_target(gamma, over):
    jcfg, tcfg, jp, tp = _pair(over)
    djcfg, dtcfg, djp, dtp = _pair(
        over, {**DRAFT, "n_kv_heads": min(2, over.get("n_kv_heads", 0))},
        seed=42)
    prompt = _prompts(1)
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompt), jcfg, 10))
    got = tspec.speculative_generate(tp, tcfg, dtp, dtcfg,
                                     torch.from_numpy(prompt), 10,
                                     gamma=gamma, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tdec.greedy_generate(
        tp, torch.from_numpy(prompt), tcfg, 10, device="cpu").numpy())
    if gamma == 3:
        jgot = np.asarray(jspec.speculative_generate(
            jp, jcfg, djp, djcfg, jnp.asarray(prompt), 10, gamma=gamma))
        np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("impl", ["ragged", "vmap"])
@pytest.mark.parametrize("draft", ["random", "self"])
def test_batched_greedy_equals_jax_and_target(impl, draft):
    jcfg, tcfg, jp, tp = _pair()
    djcfg, dtcfg, djp, dtp = ((jcfg, tcfg, jp, tp) if draft == "self"
                              else _pair(None, DRAFT, seed=42))
    # rows whose acceptance differs: random, constant, adversarial
    prompts = np.stack([_prompts(1, seed=9)[0], np.full(8, 3, np.int32),
                        (np.arange(8) * 7 % BASE["vocab"]).astype(np.int32)])
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompts), jcfg,
                                           12))
    got = tspec.speculative_generate_batched(
        tp, tcfg, dtp, dtcfg, torch.from_numpy(prompts), 12, gamma=4,
        impl=impl, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(jspec.speculative_generate_batched(
        jp, jcfg, djp, djcfg, jnp.asarray(prompts), 12, gamma=4, impl=impl))
    np.testing.assert_array_equal(got, jgot)


def test_batched_ragged_int8_equals_int8_target():
    jcfg, tcfg, jp, tp = _pair({"kv_cache_dtype": "int8"})
    _, dtcfg, _, dtp = _pair({"kv_cache_dtype": "int8"}, DRAFT, seed=42)
    prompt = _prompts(2)
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompt), jcfg, 8))
    got = tspec.speculative_generate_batched(
        tp, tcfg, dtp, dtcfg, torch.from_numpy(prompt), 8, gamma=2,
        device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tdec.greedy_generate(
        tp, torch.from_numpy(prompt), tcfg, 8, device="cpu").numpy())


def test_generator_guards():
    _, tcfg, _, tp = _pair()
    two = torch.from_numpy(_prompts(2))
    one = two[:1]
    with pytest.raises(ValueError, match="batch 1"):
        tspec.speculative_generate(tp, tcfg, tp, tcfg, two, 4, device="cpu")
    bad = ttf.TransformerConfig(**{**BASE, "vocab": 32})
    bad_p = ttf.init_params(bad, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tspec.speculative_generate(tp, tcfg, bad_p, bad, one, 4,
                                   device="cpu")
    with pytest.raises(ValueError, match="PRNG key"):
        tspec.speculative_generate(tp, tcfg, tp, tcfg, one, 4,
                                   temperature=0.8, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        tspec.speculative_generate(tp, tcfg, tp, tcfg, one, 4, gamma=0,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tspec.speculative_generate(tp, tcfg, tp, tcfg, one, 20, gamma=4,
                                   device="cpu")
    # a mesh runs on the ragged route (tests/test_torch_tp_serving.py);
    # the vmap route refuses it, as JAX's does
    with pytest.raises(ValueError, match="impl='vmap' is single-device"):
        tspec.speculative_generate_batched(tp, tcfg, tp, tcfg, two, 4,
                                           impl="vmap", mesh={"tp": 2},
                                           device="cpu")
    with pytest.raises(ValueError, match="impl"):
        tspec.speculative_generate_batched(tp, tcfg, tp, tcfg, two, 4,
                                           impl="scan", device="cpu")


# -- the accept/resample rule ------------------------------------------------

def _law_rows(M, gamma, q, p, seed):
    """M rows of one synthetic round: proposals drawn from q (numpy), the
    port's streams from M distinct keys."""
    rng = np.random.default_rng(seed)
    props = np.stack([rng.choice(len(row), size=M, p=row) for row in q], 1)
    keys = torch.from_numpy(np.stack(
        [tdec.sample_key(seed, i) for i in range(M)]).astype(np.int64))
    qt = torch.from_numpy(q).float().expand(M, *q.shape)
    pt = torch.from_numpy(p).float().expand(M, *p.shape)
    return tspec._accept_resample(tspec.spec_streams(keys),
                                  torch.zeros(M, dtype=torch.int32),
                                  torch.from_numpy(props.astype(np.int64)),
                                  qt, pt)[:2], props


def test_accept_resample_first_token_law_is_the_target_row():
    V, gamma, M = 6, 2, 20000
    rng = np.random.default_rng(0)
    q = rng.dirichlet(np.ones(V), size=gamma + 1)
    p = rng.dirichlet(np.ones(V), size=gamma + 1)
    (a, nxt), props = _law_rows(M, gamma, q, p, seed=1)
    first = np.where(a.numpy() >= 1, props[:, 0], nxt.numpy())
    emp = np.bincount(first, minlength=V) / M
    tv = 0.5 * np.abs(emp - p[0]).sum()
    assert tv < 0.02, (tv, emp, p[0])


def test_accept_resample_bonus_position_when_draft_matches():
    V, gamma, M = 6, 2, 20000
    p = np.random.default_rng(2).dirichlet(np.ones(V), size=gamma + 1)
    (a, nxt), props = _law_rows(M, gamma, p, p, seed=3)
    assert int(a.min()) == gamma  # every proposal accepted, always
    np.testing.assert_array_equal(nxt.numpy(), props[:, gamma])
    emp = np.bincount(nxt.numpy(), minlength=V) / M
    assert 0.5 * np.abs(emp - p[gamma]).sum() < 0.02


def test_accept_resample_bonus_position_law_is_the_target_row():
    # the first gamma proposals always accepted (q = p there), the bonus
    # position's draft law independent of p: the closing token's law is
    # still p_gamma, by accept or residual
    V, gamma, M = 6, 2, 20000
    rng = np.random.default_rng(4)
    p = rng.dirichlet(np.ones(V), size=gamma + 1)
    q = np.concatenate([p[:gamma], rng.dirichlet(np.ones(V), size=1)])
    (a, nxt), _ = _law_rows(M, gamma, q, p, seed=5)
    assert int(a.min()) == gamma
    emp = np.bincount(nxt.numpy(), minlength=V) / M
    assert 0.5 * np.abs(emp - p[gamma]).sum() < 0.02


def test_streams_fold_apart():
    keys = torch.from_numpy(np.stack([tdec.sample_key(0, i)
                                      for i in range(64)]).astype(np.int64))
    folded = [keys] + list(tspec.spec_streams(keys).values())
    words = {tuple(k) for f in folded for k in f.tolist()}
    assert len(words) == 64 * 4  # no stream shares a key with another
    assert all(((f >= 0) & (f < 1 << 32)).all() for f in folded)


# -- sampled rows ------------------------------------------------------------

def test_sampled_impls_equal_and_top_k_1_is_greedy():
    _, tcfg, _, tp = _pair()
    _, dtcfg, _, dtp = _pair(None, DRAFT, seed=42)
    prompts = torch.from_numpy(_prompts(3, seed=5))
    keys = np.stack([tdec.sample_key(7, i) for i in range(3)])
    kw = dict(gamma=2, key=keys, temperature=0.8, top_k=8, device="cpu")
    ragged = tspec.speculative_generate_batched(tp, tcfg, dtp, dtcfg,
                                                prompts, 10, **kw)
    vmap = tspec.speculative_generate_batched(tp, tcfg, dtp, dtcfg, prompts,
                                              10, impl="vmap", **kw)
    np.testing.assert_array_equal(ragged.numpy(), vmap.numpy())
    assert ragged.min() >= 0 and ragged.max() < tcfg.vocab
    one = tspec.speculative_generate(tp, tcfg, dtp, dtcfg, prompts[1:2], 10,
                                     **{**kw, "key": keys[1]})
    np.testing.assert_array_equal(one.numpy(), ragged[1:2].numpy())
    want = tdec.greedy_generate(tp, prompts, tcfg, 10, device="cpu")
    got = tspec.speculative_generate_batched(
        tp, tcfg, dtp, dtcfg, prompts, 10, gamma=3, key=keys,
        temperature=0.9, top_k=1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("impl", ["ragged", "vmap"])
@pytest.mark.parametrize("temperature,top_k", [(0.8, 8), (1.3, 0)])
def test_each_sampled_token_is_its_positions_rule(impl, temperature, top_k):
    # a sampled token depends only on its row's key, its prefix and its
    # position, never on where a round began or ended: replayed one
    # position at a time over teacher-forced logits (the first token the
    # plain draw, each later one the draft's pick on its position's draft
    # draw and _accept_resample at gamma 0 on its position's accept and
    # residual draws), the rule gives back every token the rounds emitted
    _, tcfg, _, tp = _pair()
    _, dtcfg, _, dtp = _pair(None, DRAFT, seed=42)
    B, n = 3, 9
    prompts = torch.from_numpy(_prompts(B, seed=6))
    keys = np.stack([tdec.sample_key(9, i) for i in range(B)])
    toks = tspec.speculative_generate_batched(
        tp, tcfg, dtp, dtcfg, prompts, n, gamma=3, impl=impl, key=keys,
        temperature=temperature, top_k=top_k, device="cpu")
    T = prompts.shape[1]
    seq = torch.cat([prompts, toks], dim=1)
    tl = ttf.forward(tp, seq, tcfg)[:, T - 1:-1]  # the law at T + i
    dl = ttf.forward(dtp, seq, dtcfg)[:, T - 1:-1]
    kt = tdec._as_keys(keys, B, "cpu")
    streams = tspec.spec_streams(kt)
    got = [tdec._pick(tl[:, 0], temperature, top_k, kt, T)]
    for i in range(1, n):
        at = torch.full((B,), T + i, dtype=torch.int32)
        masked = tdec._topk_mask(dl[:, i], top_k) / temperature
        x = torch.argmax(masked + tdec.gumbel_noise(
            streams["draft"], at.long(), tcfg.vocab), dim=-1)
        _, nxt, _ = tspec._accept_resample(
            streams, at, x[:, None].to(torch.int32),
            torch.softmax(masked, dim=-1)[:, None],
            tspec._warp(tl[:, i], temperature, top_k)[:, None])
        got.append(nxt)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), toks.numpy())
