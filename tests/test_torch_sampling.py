"""Sampled serving in the port (``hpc_patterns_tpu_torch.models.decode``'s
Gumbel-max sampler and the engine's per-row keys): every sampled sequence
equals the port's standalone ``paged_generate`` with the request's key,
byte for byte, with and without a bucket ladder and with per-request
overrides; a sampled migration bundle continues exactly in a second
engine; a row draws the same alone or in a batch; greedy engines run no
noise op; and the sampled law equals the JAX engine's (a TV-distance
battery against the exact law, since threefry and the port's hash draw
different streams). CPU, f32, the JAX tests' small model carried across
by ``models/convert.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.apps import serve_app  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
P = 8


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**BASE, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**BASE, decode_attn="flash")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _requests(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, size=int(rng.choice([5, 8, 11])))
             .astype(np.int32), int(rng.choice([3, 6, 9])))
            for _ in range(n)]


def _standalone(tp, tcfg, prompt, max_new, **kw):
    return tdec.paged_generate(tp, torch.from_numpy(prompt)[None], tcfg,
                               max_new, page_size=P, device="cpu",
                               **kw)[0].numpy()


@pytest.mark.parametrize("case", [
    # (slots, pool, pages_per_seq, chunk, temperature, top_k, seed,
    #  buckets, request seed): JAX tests/test_serving.py:368 and :388
    (2, 6, 3, 3, 0.8, 8, 3, None, 23),
    (2, 8, 4, 4, 1.1, 0, 5, (4, 8, 12), 29),
], ids=["no_buckets", "buckets"])
def test_sampled_engine_equals_standalone(model, case):
    _, tcfg, _, tp = model
    slots, pool, pps, chunk, temp, top_k, seed, buckets, rseed = case
    eng = tsrv.ContinuousBatcher(
        tp, tcfg, slots=slots, pool_pages=pool, pages_per_seq=pps,
        page_size=P, chunk=chunk, temperature=temp, top_k=top_k,
        seed=seed, prompt_buckets=buckets, device="cpu")
    reqs = _requests(6 if buckets is None else 5, seed=rseed)
    ids = [eng.submit(p, m) for p, m in reqs]
    got = eng.run()
    for sid, (p, m) in zip(ids, reqs):
        want = _standalone(tp, tcfg, p, m, key=eng.request_key(sid),
                           temperature=temp, top_k=top_k)
        np.testing.assert_array_equal(got[sid], want, err_msg=f"seq {sid}")
    assert sorted(eng.free_pages) == list(range(pool))
    # sampling actually happened: not the greedy continuation throughout
    greedy = [_standalone(tp, tcfg, p, m) for p, m in reqs]
    assert any(not np.array_equal(got[s], g) for s, g in zip(ids, greedy))


def test_per_request_overrides(model):
    _, tcfg, _, tp = model
    eng = tsrv.ContinuousBatcher(tp, tcfg, slots=2, pool_pages=6,
                                 pages_per_seq=3, page_size=P,
                                 temperature=0.7, seed=9, device="cpu")
    prompt = np.arange(6, dtype=np.int32)
    mine = tdec.sample_key(777)
    a = eng.submit(prompt, 7)
    b = eng.submit(prompt, 7, temperature=1.5, key=mine)
    got = eng.run()
    np.testing.assert_array_equal(
        got[a], _standalone(tp, tcfg, prompt, 7, key=eng.request_key(a),
                            temperature=0.7))
    np.testing.assert_array_equal(
        got[b], _standalone(tp, tcfg, prompt, 7, key=mine,
                            temperature=1.5))
    with pytest.raises(ValueError, match="must be > 0"):
        eng.submit(prompt, 3, temperature=0.0)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        eng.submit(prompt, 3, key=np.zeros(3, np.uint32))


def test_row_draws_the_same_alone_and_in_a_batch(model):
    _, tcfg, _, tp = model
    reqs = _requests(4, seed=31)
    prompt = np.stack([p[:5] for p, _ in reqs])
    keys = np.stack([tdec.sample_key(5, i) for i in range(4)])
    batch = tdec.paged_generate(tp, torch.from_numpy(prompt), tcfg, 8,
                                page_size=P, key=keys, temperature=0.9,
                                top_k=6, device="cpu").numpy()
    for i in range(4):
        alone = _standalone(tp, tcfg, prompt[i], 8, key=keys[i],
                            temperature=0.9, top_k=6)
        np.testing.assert_array_equal(batch[i], alone)
    # the linear cache's generate draws the same stream
    lin = tdec.generate(tp, torch.from_numpy(prompt), tcfg, 8, key=keys,
                        temperature=0.9, top_k=6, device="cpu").numpy()
    np.testing.assert_array_equal(lin, batch)


def test_sample_key_and_noise_are_pure_functions():
    k = tdec.sample_key(3, 7)
    assert k.dtype == np.uint32 and k.shape == (2,)
    np.testing.assert_array_equal(k, tdec.sample_key(3, 7))
    assert not np.array_equal(k, tdec.sample_key(3, 8))
    assert not np.array_equal(k, tdec.sample_key(4, 7))
    keys = tdec._as_keys(np.stack([k, tdec.sample_key(1)]), 2, "cpu")
    g = tdec.gumbel_noise(keys, torch.tensor([4, 9]), 1000)
    # row 0 alone, at its own position, draws the same noise
    g0 = tdec.gumbel_noise(keys[:1], 4, 1000)
    assert torch.equal(g[:1], g0)
    assert torch.isfinite(g).all()
    assert not torch.equal(g0, tdec.gumbel_noise(keys[:1], 5, 1000))
    # S positions a row in one pass (the engine's chunk) stack the
    # one-position draws
    gs = tdec.gumbel_noise(keys, torch.tensor([[4, 9], [5, 10]]), 1000)
    assert torch.equal(gs[0], g)
    assert torch.equal(gs[1], tdec.gumbel_noise(keys, torch.tensor([5, 10]),
                                                1000))


@pytest.mark.parametrize("temp,top_k", [(0.5, 0), (2.0, 0), (1.0, 2),
                                         (1.0, 3), (0.7, 4)])
def test_sampler_draws_the_warped_law(temp, top_k):
    # the sampler alone, on one skewed row with three logits tied at the
    # 3rd-5th place (top_k 3 and 4 cut inside the tie, which survives
    # whole), over 20k request keys: the draws' law is softmax(top-k
    # (logits) / T). At n = 20k over 12 outcomes the sampling floor is
    # about 0.01; a temperature dropped or applied twice reads 0.25-0.3
    logits = torch.tensor([2.0, 1.5, 1.0, 1.0, 1.0, 0.5, 0.0, -0.5, -1.0,
                           -2.0, -3.0, -4.0])
    n = 20000
    keys = tdec._as_keys(np.stack([tdec.sample_key(5, i)
                                   for i in range(n)]), n, "cpu")
    tok = tdec._pick(logits.expand(n, -1), temp, top_k, keys, 7).numpy()
    want = torch.softmax(tdec._topk_mask(logits, top_k) / temp, -1)
    emp = np.bincount(tok, minlength=len(logits)) / n
    tv = 0.5 * np.abs(emp - want.numpy()).sum()
    assert tv < 0.02, (temp, top_k, tv)
    if top_k:
        assert set(np.unique(tok)) <= set(np.flatnonzero(want.numpy()))


def test_greedy_engine_runs_no_noise_op(model, monkeypatch):
    _, tcfg, _, tp = model

    def boom(*a, **k):
        raise AssertionError("a greedy engine drew noise")

    monkeypatch.setattr(tdec, "gumbel_noise", boom)
    monkeypatch.setattr(tsrv, "gumbel_noise", boom)
    eng = tsrv.ContinuousBatcher(tp, tcfg, slots=2, pool_pages=6,
                                 pages_per_seq=3, page_size=P, chunk=2,
                                 device="cpu")
    reqs = _requests(3, seed=4)
    ids = [eng.submit(p, m) for p, m in reqs]
    got = eng.run()
    for sid, (p, m) in zip(ids, reqs):
        np.testing.assert_array_equal(got[sid],
                                      _standalone(tp, tcfg, p, m))
    assert eng.greedy and int(eng.keys.abs().sum()) == 0


def test_sampled_bundle_continues_exactly_in_a_second_engine(model):
    _, tcfg, _, tp = model

    def eng(seed):
        return tsrv.EngineCore(tp, tcfg, slots=2, pool_pages=8,
                               pages_per_seq=4, page_size=P, chunk=2,
                               temperature=0.9, top_k=5, seed=seed,
                               device="cpu")

    a, b = eng(3), eng(99)
    reqs = _requests(2, seed=41)
    ids = [a.submit(p, m) for p, m in reqs]
    a.service_round(decode=False)  # prefill and first token only
    bundles = [a.export_migration(s) for s in a.exportable_slots()]
    assert all(bd.key.dtype == np.uint32 and bd.key.any()
               and bd.temp == pytest.approx(0.9) for bd in bundles)
    for bd in bundles:
        b.install_migration(bd)
    got = {}
    while b.has_work():
        b.service_round()
    got = b.finished
    for sid, (p, m) in zip(ids, reqs):
        np.testing.assert_array_equal(
            got[sid], _standalone(tp, tcfg, p, m, key=a.request_key(sid),
                                  temperature=0.9, top_k=5))
    assert b.free_page_count == b.pool_pages


def test_generator_key_fallback_and_errors(model):
    _, tcfg, _, tp = model
    prompt = torch.from_numpy(np.stack([np.arange(6, dtype=np.int32)] * 2))
    a = tdec.paged_generate(tp, prompt, tcfg, 6, page_size=P, device="cpu",
                            temperature=1.0,
                            generator=torch.Generator().manual_seed(0))
    b = tdec.paged_generate(tp, prompt, tcfg, 6, page_size=P, device="cpu",
                            temperature=1.0,
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        tdec.paged_generate(tp, prompt, tcfg, 3, page_size=P, device="cpu",
                            temperature=1.0, key=np.zeros((3, 2), np.uint32))


def _law_battery(cfg_t, tp, jcfg, jp, temp, top_k, n_req):
    """token[0] and token[1] of ``n_req`` same-prompt requests through the
    port engine and the JAX engine, beside the exact laws: token[0]'s is
    softmax(top-k(logits) / T) at the prompt; token[1]'s the mixture over
    the port's own first tokens."""
    prompt = np.arange(5, dtype=np.int32)
    pps = 1
    teng = tsrv.ContinuousBatcher(tp, cfg_t, slots=8, pool_pages=8 * pps,
                                  pages_per_seq=pps, page_size=P, chunk=1,
                                  temperature=temp, top_k=top_k, seed=11,
                                  device="cpu")
    jeng = jsrv.ContinuousBatcher(jp, jcfg, slots=8, pool_pages=8 * pps,
                                  pages_per_seq=pps, page_size=P, chunk=1,
                                  temperature=temp, top_k=top_k, seed=11)
    tids = [teng.submit(prompt, 2) for _ in range(n_req)]
    jids = [jeng.submit(prompt, 2) for _ in range(n_req)]
    tgot, jgot = teng.run(), jeng.run()
    tok = {"port": np.array([tgot[s] for s in tids]),
           "jax": np.array([np.asarray(jgot[s]) for s in jids])}

    def warped(seq):
        lg = ttf.forward(tp, torch.from_numpy(seq)[None].long(), cfg_t)
        lg = tdec._topk_mask(lg[0, -1].float(), top_k) / temp
        return torch.softmax(lg, -1).numpy().astype(np.float64)

    q0 = warped(prompt)
    law, q1 = {}, np.zeros(cfg_t.vocab)
    for t0 in tok["port"][:, 0]:
        if int(t0) not in law:
            law[int(t0)] = warped(np.append(prompt, t0).astype(np.int32))
        q1 += law[int(t0)]
    q1 /= n_req

    def tv(sample, q):
        emp = np.bincount(sample, minlength=cfg_t.vocab) / len(sample)
        return 0.5 * np.abs(emp - q).sum()

    return {who: (tv(t[:, 0], q0), tv(t[:, 1], q1))
            for who, t in tok.items()}, q0


@pytest.mark.parametrize("temp,top_k", [(1.0, 4), (0.7, 0)])
def test_sampled_law_holds_against_the_jax_engine(model, temp, top_k):
    jcfg, tcfg, jp, tp = model
    tvs, q0 = _law_battery(tcfg, tp, jcfg, jp, temp, top_k, 240)
    for who, (tv0, tv1) in tvs.items():
        # the sampling-noise floor at n = 240 over <= 64 outcomes is
        # well under 0.2 (the JAX draft-law test's bound)
        assert tv0 < 0.2 and tv1 < 0.25, (who, tv0, tv1)
    # and the two engines agree with each other within the same floor
    assert abs(tvs["port"][0] - tvs["jax"][0]) < 0.15
    if top_k:
        assert np.count_nonzero(q0) <= top_k + 1


def test_serve_app_sampled_cpu_succeeds(capsys):
    rc = serve_app.main(["--device", "cpu", "--dtype", "float32",
                         "--prompt-mix", "--requests", "5", "--slots", "2",
                         "--temperature", "0.8", "--top-k", "8",
                         "--seed", "3"])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("SUCCESS"), out
    assert "sampled" in out and "mismatch 0" in out


def test_greedy_bundle_keeps_jax_fields(model):
    # a greedy engine's bundle: key zeros, temp 0.0 (what the wire codec
    # and the cross-package bundle tests read)
    _, tcfg, _, tp = model
    eng = tsrv.EngineCore(tp, tcfg, slots=1, pool_pages=4, pages_per_seq=4,
                          page_size=P, device="cpu")
    eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.service_round(decode=False)
    (slot,) = eng.exportable_slots()
    bd = eng.export_migration(slot)
    assert bd.key.tolist() == [0, 0] and bd.temp == 0.0
    assert bd.temp_override is None
    assert isinstance(jnp.asarray(bd.key), jax.Array)


def test_pick_margin_sees_the_top_k_edge():
    # a sampled pick flips on a top-1/top-2 near-tie of the perturbed
    # scores and also where a token enters or leaves the top-k support;
    # decode.pick_margin is the smaller of the two (the tie-aware oracle of
    # a sampled divergence), and without top-k it is the top-2 gap
    logits = torch.tensor([[3.0, 2.0, 1.0, 1.0, 0.5, 0.0]])
    g = torch.tensor([[0.0, 0.0, 0.0, 5.0, 0.0, 0.0]])  # token 3 wins
    keys = torch.zeros((1, 2), dtype=torch.int64)
    t = 1.0
    scores = tdec.sample_scores(logits, keys, 0, t, 3, g)
    assert int(scores.argmax()) == 3
    gap = float((lambda v: v[0, 0] - v[0, 1])(torch.topk(scores, 2).values))
    inside, member = tdec.support_edges(logits, 3, t)
    assert inside[0].tolist() == [True, True, True, True, False, False]
    m = float(tdec.pick_margin(scores, logits / t + g, inside, member)[0])
    assert gap == pytest.approx(3.0) and m == 0.0  # token 3 sits on the edge
    # an outside token whose raw score would win counts by the larger of
    # its distance to the edge and its raw deficit
    g2 = torch.tensor([[0.0, 0.0, 0.0, 0.0, 4.0, 0.0]])
    s2 = tdec.sample_scores(logits, keys, 0, t, 2, g2)
    in2, mem2 = tdec.support_edges(logits, 2, t)
    m2 = float(tdec.pick_margin(s2, logits / t + g2, in2, mem2)[0])
    assert int(s2.argmax()) == 0 and m2 == pytest.approx(1.0)
    # no top-k: the top-1/top-2 gap of the perturbed scores
    s0 = tdec.sample_scores(logits, keys, 0, t, 0, g)
    in0, mem0 = tdec.support_edges(logits, 0, t)
    gap0 = torch.topk(s0, 2).values
    assert float(tdec.pick_margin(s0, logits / t + g, in0, mem0)[0]) \
        == pytest.approx(float(gap0[0, 0] - gap0[0, 1]))


def test_sampled_standalone_margins_are_whole_decision_margins(model):
    # paged_generate's sampled margins are each pick's whole margin
    # (pick_margin: the top-2 gap and the top-k edge), so one tie-aware
    # judge covers greedy and sampled rows; the tokens are those of the run
    # without margins
    _, tcfg, _, tp = model
    prompt = np.arange(7, dtype=np.int32)
    key = tdec.sample_key(5, 1)
    law = dict(temperature=0.8, top_k=8, key=key)
    toks, margins = tdec.paged_generate(
        tp, torch.from_numpy(prompt)[None], tcfg, 9, page_size=P,
        device="cpu", with_margins=True, **law)
    np.testing.assert_array_equal(
        toks[0].numpy(), _standalone(tp, tcfg, prompt, 9, **law))
    keys = torch.as_tensor(np.asarray(key, np.int64)[None])
    seq = np.concatenate([prompt, toks[0].numpy()])
    with torch.no_grad():
        logits = ttf.forward(tp, torch.from_numpy(seq)[None], tcfg)[0]
    for j in range(9):
        pos = len(prompt) + j
        lg = logits[pos - 1:pos]
        g = tdec.gumbel_noise(keys, pos, tcfg.vocab)
        sc = tdec.sample_scores(lg, keys, pos, 0.8, 8, g)
        assert int(sc.argmax()) == int(toks[0, j])
        inside, member = tdec.support_edges(lg, 8, 0.8)
        want = float(tdec.pick_margin(sc, lg / 0.8 + g, inside, member)[0])
        top = torch.topk(sc, 2).values[0]
        assert float(margins[0, j]) == pytest.approx(want, abs=1e-4)
        assert float(margins[0, j]) <= float(top[0] - top[1]) + 1e-6
