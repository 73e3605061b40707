"""The port's prefix-sharing arena against the JAX package: the radix
index (``memory/prefix_cache.py``) runs JAX's own ``TestRadixPrefixCache``
bodies (``tests/_torch_parity.py``) and answers a seeded match / insert /
evict / release sequence exactly as JAX's index does;
``decode.paged_tail_prefill`` equals JAX's on converted weights (f32,
atol = rtol = 1e-4, the decode tests' tolerance) and equals the port's
own monolithic ``paged_prefill`` BIT FOR BIT at the same rung; the
sharing engine (``ContinuousBatcher(prefix_cache=True)``) is token-
identical to the private-pages engine and the standalone ``paged_generate``
— greedy and sampled, at a page boundary and mid-page, under preemption
and migration (JAX's ``TestSharingOracle`` and ``TestCowComposition``
shapes) — and admits with the same matched spans as JAX's engine on the
same stream. CPU, f32, the JAX tests' small model carried across by
``models/convert.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.memory.prefix_cache import (  # noqa: E402
    RadixPrefixCache as JaxRadix,
)
from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.memory import (  # noqa: E402
    ColdAfterNPolicy,
    ResidencyManager,
)
from hpc_patterns_tpu_torch.memory.prefix_cache import (  # noqa: E402
    RadixPrefixCache,
)
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.serving_plane.migration import (  # noqa: E402
    bundle_from_wire,
    bundle_to_wire,
)

import _torch_parity as parity  # noqa: E402

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
BUCKETS = (16, 24, 32)
P = 8
ATOL = RTOL = 1e-4

JAX_BODIES = parity.load("test_prefix_cache")
RADIX_CASES = parity.cases(JAX_BODIES, ["TestRadixPrefixCache"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (its models are small; a
    worker's thread pool spinning on cores other workers hold slows them
    all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**BASE, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**BASE, decode_attn="gather")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.mark.parametrize("cls,method", RADIX_CASES,
                         ids=[m for _, m in RADIX_CASES])
def test_jax_radix_body_on_the_port(cls, method, request):
    assert JAX_BODIES.RadixPrefixCache is RadixPrefixCache
    parity.call(JAX_BODIES, cls, method, request)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_op_sequence_equals_jax_index(seed):
    rng = np.random.RandomState(seed)
    page = 4
    ours, theirs = RadixPrefixCache(page), JaxRadix(page)
    stems = [rng.randint(0, 8, size=16).astype(np.int32) for _ in range(3)]
    next_page = 0
    for step in range(120):
        op = rng.choice(["insert", "match", "evict", "release", "count"])
        stem = stems[rng.randint(len(stems))]
        toks = np.concatenate([stem[:rng.randint(0, 17)],
                               rng.randint(0, 8, size=rng.randint(0, 9))
                               .astype(np.int32)])
        rung = int(rng.choice([16, 24]))
        if op == "insert":
            n = len(toks) // page
            pages = list(range(next_page, next_page + n))
            next_page += n
            got = (ours.insert(toks, rung, pages),
                   theirs.insert(toks, rung, pages))
        elif op == "match":
            cap = None if rng.uniform() < 0.5 else int(rng.randint(0, 5))
            touch = bool(rng.uniform() < 0.5)
            got = (ours.match(toks, rung, max_pages=cap, touch=touch),
                   theirs.match(toks, rung, max_pages=cap, touch=touch))
        elif op == "evict":
            banned = {int(p) for p in rng.randint(0, next_page + 1, 3)}
            need = int(rng.randint(1, 4))
            got = (ours.evict(need, lambda p: p not in banned),
                   theirs.evict(need, lambda p: p not in banned))
        elif op == "release":
            pages = [int(p) for p in rng.randint(0, next_page + 1, 3)]
            got = (sorted(ours.release_pages(pages)),
                   sorted(theirs.release_pages(pages)))
        else:
            n = int(rng.randint(0, 3))
            ours.count_match(n)
            theirs.count_match(n)
            got = ((ours.hits, ours.misses), (theirs.hits, theirs.misses))
        assert got[0] == got[1], f"step {step} {op}"
        assert ours.pages() == theirs.pages() and len(ours) == len(theirs)
    assert ours.clear() == theirs.clear()


# ------------------------------------------------------------ tail prefill

def _prefix_then_tail(dec, params, cfg, prompt_a, prompt_b, m, as_array):
    """Prefill ``prompt_a`` monolithically into pages 0..; then prefill
    only the tail of ``prompt_b`` (sharing ``prompt_a``'s first ``m``
    pages) into pages 8... Returns (tail logits, tail K pages, tail V
    pages) of layer 0 and 1, and the cache."""
    rung = prompt_a.size
    n = rung // P
    table_a = np.arange(n, dtype=np.int32)[None]
    table_b = np.array([list(range(m)) + list(range(8, 8 + n - m))],
                       np.int32)
    kw = dict(pool_pages=16, table=as_array(table_a))
    if dec is tdec:
        kw["device"] = "cpu"
    cache = dec.init_paged_cache(cfg, 1, n, P, **kw)
    _, cache = dec.paged_prefill(params, as_array(prompt_a[None]), cfg,
                                 cache, P, last_pos=rung - 2)
    cache = dict(cache, table=as_array(table_b))
    logits, cache = dec.paged_tail_prefill(
        params, as_array(prompt_b[None, m * P:]), cfg, cache, P, m,
        last_pos=rung - 2 - m * P)
    tail = slice(8, 8 + n - m)
    return (np.asarray(logits),
            [np.asarray(cache["k"][l][tail]) for l in range(cfg.n_layers)],
            [np.asarray(cache["v"][l][tail]) for l in range(cfg.n_layers)])


@pytest.mark.parametrize("rung,m", [(24, 2), (32, 1), (32, 3)])
def test_tail_prefill_matches_jax_and_monolithic_bitwise(model, rung, m):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(rung + m)
    a = rng.randint(0, 64, size=rung).astype(np.int32)
    b = a.copy()
    b[m * P:] = rng.randint(0, 64, size=rung - m * P)
    jl, jk, jv = _prefix_then_tail(jdec, jp, jcfg, a, b, m, jnp.asarray)
    tl, tk, tv = _prefix_then_tail(tdec, tp, tcfg, a, b, m,
                                   torch.from_numpy)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL)
    for x, y in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL)
    # bitwise against the port's own monolithic prefill of b at the rung
    n = rung // P
    cache = tdec.init_paged_cache(
        tcfg, 1, n, P, pool_pages=16,
        table=np.arange(8, 8 + n, dtype=np.int32)[None], device="cpu")
    ml, cache = tdec.paged_prefill(tp, torch.from_numpy(b[None]), tcfg,
                                   cache, P, last_pos=rung - 2)
    assert torch.equal(torch.from_numpy(tl), ml)
    for l in range(tcfg.n_layers):
        assert np.array_equal(tk[l], cache["k"][l][8 + m:8 + n].numpy())
        assert np.array_equal(tv[l], cache["v"][l][8 + m:8 + n].numpy())


def test_tail_prefill_keeps_jax_refusals(model):
    _, tcfg, _, tp = model
    cache = tdec.init_paged_cache(tcfg, 2, 4, P, pool_pages=9,
                                  device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="single-row"):
        tdec.paged_tail_prefill(tp, toks, tcfg, cache, P, 1)
    one = dict(cache, table=cache["table"][:1])
    with pytest.raises(ValueError, match="aligned"):
        tdec.paged_tail_prefill(tp, toks[:1, :5], tcfg, one, P, 1)
    with pytest.raises(ValueError, match="aligned"):
        tdec.paged_tail_prefill(tp, toks[:1], tcfg, one, 4, 1)
    q = ttf.TransformerConfig(**BASE, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        tdec.paged_tail_prefill(tp, toks[:1], q, one, P, 1)
    assert tdec.PREFIX_ALIGN == jdec.PREFIX_ALIGN


# ------------------------------------------------------------ the engine

def _standalone(tp, tcfg, prompt, max_new, **kw):
    return tdec.paged_generate(tp, torch.from_numpy(prompt)[None], tcfg,
                               max_new, page_size=P, device="cpu",
                               **kw)[0].numpy()


def _engine(tp, tcfg, share=True, **over):
    kw = dict(slots=2, pool_pages=12, pages_per_seq=4, page_size=P,
              chunk=2, prompt_buckets=BUCKETS, prefix_cache=share,
              device="cpu")
    kw.update(over)
    return tsrv.ContinuousBatcher(tp, tcfg, **kw)


def _template_requests(template, n, seed=0, tails=(3, 5, 8)):
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        tail = rng.randint(0, 64, size=int(rng.choice(tails)))
        reqs.append((np.concatenate([template, tail]).astype(np.int32),
                     int(rng.choice([3, 5]))))
    return reqs


def _sample_kw(eng, sid, temp):
    return {} if temp == 0 else dict(temperature=temp, top_k=8,
                                     key=eng.request_key(sid))


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_shared_equals_private_and_standalone(model, temp):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(1)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    reqs = _template_requests(template, 6, seed=2)
    reqs.append((template.copy(), 4))  # a full-identical prompt
    skw = dict(temperature=temp, top_k=0 if temp == 0 else 8)
    priv = _engine(tp, tcfg, share=False, **skw)
    ids_p = [priv.submit(p, b) for p, b in reqs]
    got_p = priv.run()
    shr = _engine(tp, tcfg, **skw)
    ids_s = [shr.submit(p, b) for p, b in reqs]
    got_s = shr.run()
    for i, (p, b) in enumerate(reqs):
        want = _standalone(tp, tcfg, p, b, **_sample_kw(shr, ids_s[i],
                                                          temp))
        np.testing.assert_array_equal(got_p[ids_p[i]], want)
        np.testing.assert_array_equal(got_s[ids_s[i]], want)
    assert shr._prefix.hits > 0 and shr.prefill_skip_frac > 0.3
    # drained: rows released, the index still holds chains; clearing it
    # returns every page
    shr.release_prefix_cache()
    assert sorted(shr.free_pages) == list(range(12))
    assert sorted(priv.free_pages) == list(range(12))


def test_matched_spans_equal_the_jax_engine(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(1)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    reqs = _template_requests(template, 5, seed=3)
    kw = dict(slots=2, pool_pages=12, pages_per_seq=4, page_size=P,
              chunk=2, prompt_buckets=BUCKETS, prefix_cache=True)
    runs = []
    for srv, params, cfg, extra in ((jsrv, jp, jcfg, {}),
                                    (tsrv, tp, tcfg, {"device": "cpu"})):
        events = []
        eng = srv.ContinuousBatcher(params, cfg, **kw, **extra,
                                    emit=lambda **r: events.append(r))
        ids = [eng.submit(p, b) for p, b in reqs]
        got = eng.run()
        admits = [(e["seq_id"], e["slot"], e["pages"], e["matched_tokens"],
                   e["shared_pages"]) for e in events
                  if e["kind"] == "serve_admit"]
        runs.append(([np.asarray(got[s]) for s in ids], admits,
                     eng.prefill_skip_frac,
                     (eng._prefix.hits, eng._prefix.misses)))
    (jt, ja, js, jh), (tt, ta, ts, th) = runs
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    assert ta == ja and th == jh and ts == js
    assert any(a[3] for a in ta)


def test_divergence_at_page_boundary_vs_mid_page(model):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(3)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    events = []
    eng = _engine(tp, tcfg, emit=lambda **kw: events.append(kw))
    # all three prompts are 21 tokens: the SAME rung (24)
    seeder = np.concatenate([template, rng.randint(0, 64, size=5)]) \
        .astype(np.int32)
    seed = eng.submit(seeder, 3)
    eng.run()
    boundary = np.concatenate([template, rng.randint(0, 64, size=5)]) \
        .astype(np.int32)
    midpage = np.concatenate([template[:12], rng.randint(0, 64, size=9)]) \
        .astype(np.int32)
    b = eng.submit(boundary, 4)
    m = eng.submit(midpage, 4)
    got = eng.run()
    admits = {e["seq_id"]: e for e in events if e["kind"] == "serve_admit"}
    assert admits[b]["matched_tokens"] == 16
    # the boundary page is private from admission (copy-on-write there)
    assert admits[m]["matched_tokens"] == 8
    for sid, prompt, n in ((seed, seeder, 3), (b, boundary, 4),
                           (m, midpage, 4)):
        np.testing.assert_array_equal(got[sid],
                                      _standalone(tp, tcfg, prompt, n))


def test_match_is_rung_keyed(model):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(4)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    events = []
    eng = _engine(tp, tcfg, emit=lambda **kw: events.append(kw))
    eng.submit(np.concatenate([template, rng.randint(0, 64, size=5)])
               .astype(np.int32), 3)  # rung 24
    eng.run()
    b = eng.submit(np.concatenate([template, rng.randint(0, 64, size=13)])
                   .astype(np.int32), 3)  # rung 32: no rung-24 match
    eng.run()
    c = eng.submit(np.concatenate([template, rng.randint(0, 64, size=7)])
                   .astype(np.int32), 3)  # rung 24 again: shares
    eng.run()
    admits = {e["seq_id"]: e for e in events if e["kind"] == "serve_admit"}
    assert admits[b]["matched_tokens"] == 0
    assert admits[c]["matched_tokens"] == 16


def test_sharing_admits_where_private_pages_cannot(model):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(5)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    pa = np.concatenate([template, rng.randint(0, 64, size=3)]) \
        .astype(np.int32)
    pb = np.concatenate([template, rng.randint(0, 64, size=3)]) \
        .astype(np.int32)
    # each needs 3 private pages; a pool of 4 holds both only shared
    shr = _engine(tp, tcfg, pool_pages=4, pages_per_seq=3, chunk=1)
    a = shr.submit(pa, 4)
    shr.run(max_rounds=1)
    b = shr.submit(pb, 4)
    shr.run(max_rounds=1)
    assert shr.active_count == 2
    got = shr.run()
    np.testing.assert_array_equal(got[a], _standalone(tp, tcfg, pa, 4))
    np.testing.assert_array_equal(got[b], _standalone(tp, tcfg, pb, 4))


def test_reclaim_frees_cache_only_pages_for_admission(model):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(6)
    eng = _engine(tp, tcfg, pool_pages=6, pages_per_seq=3)
    for _ in range(3):  # fill the index with disjoint chains
        eng.submit(rng.randint(0, 64, size=16).astype(np.int32), 3)
        eng.run()
    assert len(eng.free_pages) < 6
    fresh = rng.randint(0, 64, size=20).astype(np.int32)
    sid = eng.submit(fresh, 4)
    np.testing.assert_array_equal(eng.run()[sid],
                                  _standalone(tp, tcfg, fresh, 4))


def test_constructor_refuses_unshareable_configs(model):
    _, tcfg, _, tp = model
    kw = dict(slots=1, pool_pages=4, pages_per_seq=4, page_size=P, chunk=2,
              device="cpu", prefix_cache=True)
    with pytest.raises(ValueError, match="RUNG-KEYED"):
        tsrv.ContinuousBatcher(tp, tcfg, **kw)
    with pytest.raises(ValueError, match="aligned"):
        tsrv.ContinuousBatcher(tp, tcfg, prompt_buckets=(12, 20), **kw)
    q = ttf.TransformerConfig(**BASE, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        tsrv.ContinuousBatcher(tp, q, prompt_buckets=BUCKETS, **kw)
    flash = ttf.TransformerConfig(**{**BASE, "max_seq": 256},
                                  decode_attn="flash")
    with pytest.raises(ValueError, match="128-multiple"):
        tsrv.ContinuousBatcher(tp, flash, prompt_buckets=(16, 128), **kw)
    # off-multiple rungs serve on the flash route
    tsrv.ContinuousBatcher(tp, flash, prompt_buckets=BUCKETS, **kw)
    with pytest.raises(ValueError, match="draft"):
        tsrv.ContinuousBatcher(tp, tcfg, prompt_buckets=BUCKETS,
                               draft_params=tp, draft_cfg=tcfg, **kw)


# ------------------------------------------------------------ composition

@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_preempt_resume_of_sharing_row(model, temp):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(7)
    template = rng.randint(0, 64, size=8).astype(np.int32)
    pv = np.concatenate([template, rng.randint(0, 64, size=1)]) \
        .astype(np.int32)
    events = []
    skw = dict(temperature=temp, top_k=0 if temp == 0 else 8)
    eng = _engine(tp, tcfg, pool_pages=4, preempt=True,
                  emit=lambda **kw: events.append(kw), **skw)
    v = eng.submit(pv, 18, priority=1)  # 9 + 18 -> all 4 pages
    eng.run(max_rounds=3)
    h = eng.submit(template.copy(), 4, priority=0)  # must evict v
    got = eng.run()
    assert [e["seq_id"] for e in events
            if e["kind"] == "serve_preempt"] == [v]
    np.testing.assert_array_equal(
        got[v], _standalone(tp, tcfg, pv, 18, **_sample_kw(eng, v, temp)))
    np.testing.assert_array_equal(
        got[h], _standalone(tp, tcfg, template, 4,
                            **_sample_kw(eng, h, temp)))
    # the resumed admission re-matched the surviving chain
    resumed = [e for e in events if e["kind"] == "serve_admit"
               and e["resumed"]]
    assert resumed and resumed[0]["matched_tokens"] >= 8
    eng.release_prefix_cache()
    assert sorted(eng.free_pages) == list(range(4))


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_migration_materialized_vs_resolved(model, temp):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(8)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    prompt = np.concatenate([template, rng.randint(0, 64, size=5)]) \
        .astype(np.int32)
    skw = dict(temperature=temp, top_k=0 if temp == 0 else 8, seed=0)
    kw = dict(pool_pages=8, **skw)
    src = _engine(tp, tcfg, **kw)
    sid = src.submit(prompt, 6, seq_id=7)
    src.service_round(decode=False)
    bundle = src.export_migration(src.exportable_slots()[0])
    assert bundle.rung == 24 and bundle.prefix_len == 16
    wire = bundle_from_wire(bundle_to_wire(bundle))
    assert (wire.rung, wire.prefix_len) == (24, 16)
    want = _standalone(tp, tcfg, prompt, 6, **_sample_kw(src, sid, temp))
    cold = _engine(tp, tcfg, **kw)
    s_cold = cold.install_migration(wire)
    assert cold._slots[s_cold].shared_pages == 0  # materialized
    np.testing.assert_array_equal(cold.run()[sid], want)
    warm = _engine(tp, tcfg, **kw)
    w = warm.submit(np.concatenate([template, rng.randint(0, 64, size=7)])
                    .astype(np.int32), 3)  # seeds the rung-24 chain
    warm.run()
    s_warm = warm.install_migration(bundle)
    assert warm._slots[s_warm].shared_pages == 2  # refs resolved
    np.testing.assert_array_equal(warm.run()[sid], want)
    assert w in warm.finished


def test_migration_seeds_the_destination_index(model):
    _, tcfg, _, tp = model
    rng = np.random.RandomState(8)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    prompt = np.concatenate([template, rng.randint(0, 64, size=5)]) \
        .astype(np.int32)
    src = _engine(tp, tcfg)
    sid = src.submit(prompt, 4, seq_id=7)
    src.service_round(decode=False)
    bundle = src.export_migration(src.exportable_slots()[0])
    cold = _engine(tp, tcfg)
    assert cold._slots[cold.install_migration(bundle)].shared_pages == 0
    p2 = np.concatenate([template, rng.randint(0, 64, size=7)]) \
        .astype(np.int32)
    w = cold.submit(p2, 3)
    got = cold.run()
    assert cold._prefix.hits >= 1 and cold._prefill_skip_tokens >= 16
    np.testing.assert_array_equal(got[w], _standalone(tp, tcfg, p2, 3))
    np.testing.assert_array_equal(got[sid],
                                  _standalone(tp, tcfg, prompt, 4))


def test_pin_while_shared_blocks_residency_paging(model):
    # refcount >= 2 net of the index's own reference pins a row against
    # paging while the second reader runs; a lone reader is swappable.
    # The CPU chunk step runs only the active rows and the pages they
    # reach: shared pages read by two rows and a frozen row's own last
    # slot keep the tokens exact
    _, tcfg, _, tp = model
    rng = np.random.RandomState(9)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    pa = np.concatenate([template, rng.randint(0, 64, size=3)]) \
        .astype(np.int32)
    pb = np.concatenate([template, rng.randint(0, 64, size=5)]) \
        .astype(np.int32)
    mgr = ResidencyManager(host_blocks=16, policy=ColdAfterNPolicy(1))
    eng = _engine(tp, tcfg, pool_pages=10, residency=mgr)
    a = eng.submit(pa, 8)
    b = eng.submit(pb, 8)
    eng.run(max_rounds=2)
    slots = {s.seq_id: i for i, s in enumerate(eng._slots) if s.active}
    assert not eng._row_swappable(slots[a])
    assert not eng._row_swappable(slots[b])
    assert all(g.pinned for g in mgr.groups("hbm"))
    got = eng.run()
    np.testing.assert_array_equal(got[a], _standalone(tp, tcfg, pa, 8))
    np.testing.assert_array_equal(got[b], _standalone(tp, tcfg, pb, 8))
    c = eng.submit(np.concatenate([template, rng.randint(0, 64, size=4)])
                   .astype(np.int32), 8)
    eng.run(max_rounds=1)
    sc = next(i for i, s in enumerate(eng._slots)
              if s.active and s.seq_id == c)
    assert eng._row_swappable(sc)
    eng.run()


def test_swapped_sharing_rows_page_back_exactly(model):
    # sharing and residency together under real paging: rows swap out
    # (their cache-held pages stay resident and shareable), come back
    # through the prefix resolution of their own bundle, and every
    # sequence equals its standalone
    _, tcfg, _, tp = model
    rng = np.random.RandomState(10)
    templates = [rng.randint(0, 64, size=8).astype(np.int32)
                 for _ in range(4)]
    reqs = [(np.concatenate([t, rng.randint(0, 64, size=6)])
             .astype(np.int32), 10) for t in templates]
    mgr = ResidencyManager(host_blocks=32, policy=ColdAfterNPolicy(1))
    eng = _engine(tp, tcfg, slots=4, pool_pages=7, pages_per_seq=4,
                  residency=mgr)
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    assert mgr.swap_outs > 0 and mgr.swap_ins > 0
    for sid, (p, b) in zip(ids, reqs):
        np.testing.assert_array_equal(got[sid], _standalone(tp, tcfg, p, b))
    eng.release_prefix_cache()
    assert sorted(eng.free_pages) == list(range(7))
