"""The port's draft-assisted serving engine, serve_app ``--draft-pair``
and ``make_draft_pair`` held against the JAX package on the CPU, on the
JAX serving tests' small model carried across by ``models/convert.py``
(f32, where greedy tokens must be equal, no tolerance):

- the greedy engine at gamma 2 and 4 (a random draft), with a self
  draft, with EOS, on int8 pools and with a bucket ladder: every
  sequence equal to the port's standalone ``paged_generate`` and to the
  JAX engine's tokens, every page back;
- the sampled engine: its second tokens' law within TV 0.2 of the
  target's warped law from JAX's ``forward`` (JAX's distribution
  oracle), and byte for byte ``speculative_generate_batched`` with each
  request's key; a preempted-then-resumed draft row byte for byte its
  uninterrupted run (greedy and sampled);
- the refusals: a draft engine takes no migration role, exports and
  installs nothing;
- ``serve_app --draft-pair`` on a CPU-width pair (SUCCESS, greedy and
  sampled); ``markov_corpus`` bit for bit the JAX script's (loaded with
  ``importlib``, unedited); a small pair beats the random draft.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu.models.decode import _topk_mask  # noqa: E402
from hpc_patterns_tpu_torch import make_draft_pair as mdp  # noqa: E402
from hpc_patterns_tpu_torch.apps import serve_app  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.models.speculative import (  # noqa: E402
    speculative_generate_batched,
)
from hpc_patterns_tpu_torch.serving_plane.router import (  # noqa: E402
    Replica,
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


ROOT = Path(__file__).resolve().parents[1]
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
DRAFT = dict(d_model=16, d_ff=32, n_layers=1, n_heads=2)
P = 8


def _model(over=None, seed=0):
    kw = {**BASE, **(over or {})}
    jcfg = jtf.TransformerConfig(**kw, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**kw, decode_attn="flash")
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.fixture(scope="module")
def target():
    return _model()


@pytest.fixture(scope="module")
def draft():
    return _model(DRAFT, seed=42)


def _requests(n, seed):
    """JAX's tests/test_serving.py:_requests."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, size=int(rng.choice([5, 8, 11])))
             .astype(np.int32), int(rng.choice([3, 6, 9])))
            for _ in range(n)]


def _standalone(tp, tcfg, prompt, max_new):
    return tdec.paged_generate(tp, torch.from_numpy(prompt)[None], tcfg,
                               max_new, page_size=P, device="cpu")[0].numpy()


def _serve(tp, tcfg, reqs, **kw):
    eng = tsrv.ContinuousBatcher(tp, tcfg, page_size=P, device="cpu", **kw)
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    return eng, ids, [got[sid] for sid in ids]


# -- the greedy engine -------------------------------------------------------

@pytest.mark.parametrize("gamma", [2, 4])
def test_draft_engine_equals_standalone_and_jax(target, draft, gamma):
    jcfg, tcfg, jp, tp = target
    djcfg, dtcfg, djp, dtp = draft
    reqs = _requests(5, seed=11)
    geom = dict(slots=2, pool_pages=8, pages_per_seq=4)
    eng, _, got = _serve(tp, tcfg, reqs, draft_params=dtp, draft_cfg=dtcfg,
                         gamma=gamma, **geom)
    jeng = jsrv.ContinuousBatcher(jp, jcfg, page_size=P, draft_params=djp,
                                  draft_cfg=djcfg, gamma=gamma, **geom)
    jids = [jeng.submit(p, b) for p, b in reqs]
    jgot = jeng.run()
    for (p, b), g, jid in zip(reqs, got, jids):
        np.testing.assert_array_equal(g, _standalone(tp, tcfg, p, b))
        np.testing.assert_array_equal(g, jgot[jid])
    assert eng.free_page_count == eng.pool_pages
    assert eng.spec_rounds > 0 and eng.decode_steps == 0
    assert eng.spec_stats["tokens"] == sum(b - 1 for _, b in reqs)


@pytest.mark.parametrize("case", ["self_draft", "eos", "int8", "bucketed",
                                  "max_seq_edge"])
def test_draft_engine_variants_equal_standalone(target, draft, case):
    _, tcfg, _, tp = target
    _, dtcfg, _, dtp = draft
    kw = dict(slots=2, pool_pages=8, pages_per_seq=4, draft_params=dtp,
              draft_cfg=dtcfg, gamma=2)
    reqs = _requests(4, seed=13)
    if case == "self_draft":
        kw.update(draft_params=tp, draft_cfg=tcfg, gamma=3)
        reqs = [(np.arange(5, dtype=np.int32), 9)]
    elif case == "eos":
        prompt = np.arange(5, dtype=np.int32)
        full = _standalone(tp, tcfg, prompt, 9)
        kw.update(draft_params=tp, draft_cfg=tcfg, eos_id=int(full[3]))
        reqs = [(prompt, 9)]
    elif case == "int8":
        _, tcfg, _, tp = _model({"kv_cache_dtype": "int8"})
        _, dq, _, dp = _model({**DRAFT, "kv_cache_dtype": "int8"}, seed=42)
        kw.update(draft_params=dp, draft_cfg=dq)
    elif case == "bucketed":
        kw.update(pool_pages=10, pages_per_seq=5, prompt_buckets=(4, 8, 12))
        reqs = _requests(4, seed=19)
    else:
        # learned positions and max_seq = prompt + budget: a round's
        # overshoot past the budget reaches past the position table (JAX's
        # gather clamps it; so does the port's)
        _, tcfg, _, tp = _model({"max_seq": 14})
        _, dq, _, dp = _model({**DRAFT, "max_seq": 14}, seed=42)
        kw.update(draft_params=dp, draft_cfg=dq, gamma=4)
        reqs = [(np.arange(5, dtype=np.int32), 9)]
    eng, _, got = _serve(tp, tcfg, reqs, **kw)
    for (p, b), g in zip(reqs, got):
        want = _standalone(tp, tcfg, p, b)
        if case == "eos":
            want = want[:int(np.argmax(want == kw["eos_id"])) + 1]
            assert len(want) < b
        np.testing.assert_array_equal(g, want)
    assert eng.free_page_count == eng.pool_pages


def test_draft_sizing_equals_jax():
    for n, budget, gamma, pad in ((5, 9, 2, None), (8, 3, 4, 16),
                                  (31, 64, 8, 32)):
        assert (tsrv.EngineCore.pages_needed(n, budget, P, gamma=gamma,
                                             padded_len=pad)
                == jsrv.ContinuousBatcher.pages_needed(
                    n, budget, P, gamma=gamma, padded_len=pad))


# -- the sampled engine ------------------------------------------------------

def test_draft_sampled_law_equals_the_targets(target):
    # JAX's distribution oracle (tests/test_serving.py:736): 160 requests
    # of one prompt, budget 2; token 1 comes from a live rejection-
    # sampling round against an independent draft, and its empirical law
    # must match the mixture of the target's warped next-token laws
    jcfg, tcfg, jp, tp = target
    _, dtcfg, _, dtp = _model(DRAFT, seed=1234)
    temp, top_k, n_req = 1.0, 4, 160
    prompt = np.arange(5, dtype=np.int32)
    pps = tsrv.EngineCore.pages_needed(5, 2, P, gamma=2)
    _, _, got = _serve(tp, tcfg, [(prompt, 2)] * n_req, slots=4,
                       pool_pages=4 * pps, pages_per_seq=pps, chunk=2,
                       draft_params=dtp, draft_cfg=dtcfg, gamma=2,
                       temperature=temp, top_k=top_k, seed=11)
    firsts = np.array([g[0] for g in got])
    seconds = np.array([g[1] for g in got])

    def warped_next(seq):
        logits = np.asarray(jtf.forward(
            jp, jnp.asarray(seq, jnp.int32)[None, :], jcfg))[0, -1]
        masked = np.asarray(_topk_mask(jnp.asarray(logits), top_k))
        z = masked / temp - masked.max()
        p = np.exp(z)
        p[~np.isfinite(p)] = 0.0
        return p / p.sum()

    law, q = {}, np.zeros(tcfg.vocab)
    for t0 in firsts:
        if int(t0) not in law:
            law[int(t0)] = warped_next(np.append(prompt, t0))
        q += law[int(t0)]
    q /= n_req
    emp = np.bincount(seconds, minlength=tcfg.vocab) / n_req
    tv = 0.5 * np.abs(emp - q).sum()
    assert tv < 0.2, tv


def test_draft_sampled_engine_equals_batched_standalone(target, draft):
    _, tcfg, _, tp = target
    _, dtcfg, _, dtp = draft
    reqs = _requests(5, seed=11)
    samp = dict(temperature=0.8, top_k=8)
    eng, ids, got = _serve(tp, tcfg, reqs, slots=2, pool_pages=8,
                           pages_per_seq=4, draft_params=dtp,
                           draft_cfg=dtcfg, gamma=2, seed=3, **samp)
    for sid, (p, b), g in zip(ids, reqs, got):
        want = speculative_generate_batched(
            tp, tcfg, dtp, dtcfg, torch.from_numpy(p)[None], b, gamma=2,
            key=eng.request_key(sid), device="cpu", **samp)[0].numpy()
        np.testing.assert_array_equal(g, want)
    assert eng.spec_stats["accepted"] > 0


@pytest.mark.parametrize("sampled", [False, True])
def test_preempted_draft_row_equals_uninterrupted(target, draft, sampled):
    # the low-priority victim holds every page; a high-priority arrival
    # evicts it after two dispatches, and its resume re-prefills both
    # caches and continues from its last token
    _, tcfg, _, tp = target
    _, dtcfg, _, dtp = draft
    samp = dict(temperature=0.8, top_k=8, seed=5) if sampled else {}
    victim = (np.arange(1, 9, dtype=np.int32), 16)  # 8 + 16 + 3: 4 pages
    head = (np.arange(20, 28, dtype=np.int32), 4)   # 8 + 4 + 3: 2 pages
    eng = tsrv.ContinuousBatcher(
        tp, tcfg, slots=2, pool_pages=4, pages_per_seq=4, page_size=P,
        chunk=1, preempt=True, draft_params=dtp, draft_cfg=dtcfg, gamma=2,
        device="cpu", **samp)
    vid = eng.submit(*victim, priority=1)
    eng.run(max_rounds=2)
    hid = eng.submit(*head, priority=0)
    got = eng.run()
    assert eng.stats[vid]["preemptions"] >= 1
    for sid, (p, b) in ((vid, victim), (hid, head)):
        want = speculative_generate_batched(
            tp, tcfg, dtp, dtcfg, torch.from_numpy(p)[None], b, gamma=2,
            key=eng.request_key(sid) if sampled else None, device="cpu",
            **({"temperature": 0.8, "top_k": 8} if sampled else {}))
        np.testing.assert_array_equal(got[sid], want[0].numpy())
    assert len(eng.stats[vid]["token_ts"]) == victim[1]
    assert eng.free_page_count == eng.pool_pages


# -- refusals ----------------------------------------------------------------

def test_draft_engine_does_not_migrate(target, draft):
    _, tcfg, _, tp = target
    _, dtcfg, _, dtp = draft
    eng = tsrv.ContinuousBatcher(tp, tcfg, slots=2, pool_pages=8,
                                 pages_per_seq=4, page_size=P,
                                 draft_params=dtp, draft_cfg=dtcfg,
                                 device="cpu")
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="migration role"):
            Replica(eng, role=role)
    assert Replica(eng, role="both").role == "both"
    eng.submit(np.arange(5, dtype=np.int32), 6)
    eng.service_round(decode=False)
    with pytest.raises(ValueError, match="do not migrate"):
        eng.export_migration(eng.exportable_slots()[0])
    plain = tsrv.ContinuousBatcher(tp, tcfg, slots=2, pool_pages=8,
                                   pages_per_seq=4, page_size=P,
                                   device="cpu")
    plain.submit(np.arange(5, dtype=np.int32), 6)
    plain.service_round(decode=False)
    bundle = plain.export_migration(plain.exportable_slots()[0])
    with pytest.raises(ValueError, match="do not migrate"):
        eng.install_migration(bundle)


# -- the pair and the app ----------------------------------------------------

@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("pair") / "pair"
    assert mdp.main(["--out", str(out), "--device", "cpu", "--steps", "25",
                     "--distill-steps", "25"]) == 0
    return out


def test_pair_beats_the_random_draft(pair_dir):
    meta = json.loads((pair_dir / "META.json").read_text())
    acc = meta["acceptance"]
    assert acc["aligned_greedy"] > acc["random_greedy"] + 0.05
    assert acc["aligned_minpq"] > acc["random_minpq"] + 0.05
    assert set(meta) == {"target_cfg", "draft_cfg", "steps",
                         "distill_steps", "acceptance", "corpus"}
    assert meta["draft_cfg"]["n_layers"] == 1
    assert meta["target_cfg"]["n_layers"] == 2


def test_markov_corpus_bit_equal_to_the_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_make_draft_pair", ROOT / "benchmarks" / "make_draft_pair.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for kw in ({}, {"draw_seed": 777}, {"seed": 3, "branching": 4}):
        np.testing.assert_array_equal(mdp.markov_corpus(256, 5000, **kw),
                                      ref.markov_corpus(256, 5000, **kw))


@pytest.mark.parametrize("extra", [[], ["--temperature", "0.8", "--top-k",
                                        "8", "--eos-id", "5"]])
def test_serve_app_serves_the_pair(pair_dir, capsys, extra):
    rc = serve_app.main(["--device", "cpu", "--draft-pair", str(pair_dir),
                         "--gamma", "3", "--prompt-mix", "--requests", "6",
                         *extra])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("SUCCESS"), out
    assert f"aligned pair from {pair_dir} (gamma=3)" in out
    assert ("draft+sampled law" if extra else "draft greedy") in out
    assert "mismatch 0" in out and "pages leaked 0" in out
