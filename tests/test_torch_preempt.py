"""Preemption, resume and the admission high-water mark in the port's
engine, and the engine's ``emit=`` records and request timing, held
against the JAX engine on the same staged schedules: a row evicted under
structural page starvation and resumed emits exactly its uninterrupted
standalone tokens (greedy in f32, and sampled with its key); equal
priority never preempts; the high-water mark defers fresh admissions;
an infeasible head evicts nothing; the victims, the order of the
``serve_preempt`` records and every record's kind, seq_id and slot equal
the JAX engine's; the request trace's ``preempted`` segment and the
``token_ts`` stamps match JAX's. CPU, f32, the JAX tests' small model
carried across by ``models/convert.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.harness import reqtrace as jrq  # noqa: E402
from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.harness import reqtrace as trq  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
P = 8
#: the JAX tests' starved geometry (tests/test_serving.py:_starved): the
#: low-priority victim takes all 4 pages, an 8-token high-priority
#: arrival needs 2
STARVED = dict(slots=2, pool_pages=4, pages_per_seq=4, page_size=P,
               chunk=2, preempt=True, prompt_buckets=(8, 16, 24, 32))


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**BASE, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**BASE, decode_attn="flash")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.fixture(autouse=True)
def _clean_reqtrace():
    trq.reset()
    jrq.reset()
    yield
    trq.reset()
    jrq.reset()


def _standalone(tp, tcfg, prompt, max_new, **kw):
    return tdec.paged_generate(tp, torch.from_numpy(prompt)[None], tcfg,
                               max_new, page_size=P, device="cpu",
                               **kw)[0].numpy()


def _port(tp, tcfg, events=None, **kw):
    return tsrv.ContinuousBatcher(
        tp, tcfg, device="cpu",
        emit=(lambda **r: events.append(r)) if events is not None else None,
        **{**STARVED, **kw})


def _jax(jp, jcfg, events=None, **kw):
    return jsrv.ContinuousBatcher(
        jp, jcfg,
        emit=(lambda **r: events.append(r)) if events is not None else None,
        **{**STARVED, **kw})


PA = np.arange(5, dtype=np.int32)
PB = np.arange(8, dtype=np.int32) + 7


def _starve(eng, budget_a=20):
    a = eng.submit(PA, budget_a, priority=1)  # takes all 4 pages
    eng.run(max_rounds=3)                     # A mid-generation
    b = eng.submit(PB, 4, priority=0)         # starved: must evict A
    return a, b, eng.run()


def test_preempted_and_resumed_greedy_exact(model):
    _, tcfg, _, tp = model
    events = []
    eng = _port(tp, tcfg, events)
    a, b, got = _starve(eng)
    pre = [e for e in events if e["kind"] == "serve_preempt"]
    assert [e["seq_id"] for e in pre] == [a]
    assert pre[0]["for_seq_id"] == b
    assert eng.stats[a]["preemptions"] == 1
    np.testing.assert_array_equal(got[a], _standalone(tp, tcfg, PA, 20))
    np.testing.assert_array_equal(got[b], _standalone(tp, tcfg, PB, 4))
    assert sorted(eng.free_pages) == list(range(4))
    resumed = [e for e in events
               if e["kind"] == "serve_admit" and e["resumed"]]
    assert [e["seq_id"] for e in resumed] == [a]
    # the resume re-prefilled prompt + emitted tokens: one extra
    # admission, and nothing was prepended twice
    assert eng.admissions == 3 and len(got[a]) == 20


def test_preempted_and_resumed_sampled_stream_exact(model):
    _, tcfg, _, tp = model
    eng = _port(tp, tcfg, temperature=0.8, top_k=8, seed=3)
    a, b, got = _starve(eng)
    assert eng.stats[a]["preemptions"] == 1
    for sid, (p, m) in ((a, (PA, 20)), (b, (PB, 4))):
        np.testing.assert_array_equal(
            got[sid], _standalone(tp, tcfg, p, m, key=eng.request_key(sid),
                                  temperature=0.8, top_k=8))


def test_equal_priority_never_preempts(model):
    _, tcfg, _, tp = model
    events = []
    eng = _port(tp, tcfg, events)
    a = eng.submit(PA, 12, priority=1)
    eng.run(max_rounds=2)
    eng.submit(np.arange(8, dtype=np.int32), 4, priority=1)
    got = eng.run()
    assert not [e for e in events if e["kind"] == "serve_preempt"]
    assert eng.stats[a]["preemptions"] == 0
    np.testing.assert_array_equal(got[a], _standalone(tp, tcfg, PA, 12))


def test_highwater_defers_fresh_admissions(model):
    _, tcfg, _, tp = model
    events = []
    eng = tsrv.ContinuousBatcher(tp, tcfg, slots=2, pool_pages=6,
                                 pages_per_seq=3, page_size=P, chunk=2,
                                 admit_highwater=0.5, device="cpu",
                                 emit=lambda **r: events.append(r))
    a = eng.submit(PA, 9)  # 2 pages
    b = eng.submit(PA, 9)  # would make 4 > 3 of 6
    got = eng.run()
    admits = [e for e in events if e["kind"] == "serve_admit"]
    assert admits[1]["free_pages"] >= 4  # b only after a freed its pages
    for sid in (a, b):
        np.testing.assert_array_equal(got[sid], _standalone(tp, tcfg, PA, 9))


def test_infeasible_head_never_evicts(model):
    # a fresh high-priority head whose need exceeds the high-water cap can
    # never admit: evicting for it would thrash the victims through
    # re-prefills and still end stuck, so none is evicted and the run
    # fails loudly once the victims finish
    _, tcfg, _, tp = model
    events = []
    eng = tsrv.ContinuousBatcher(tp, tcfg, slots=2, pool_pages=6,
                                 pages_per_seq=6, page_size=P, chunk=2,
                                 preempt=True, admit_highwater=0.5,
                                 device="cpu",
                                 emit=lambda **r: events.append(r))
    a = eng.submit(PA, 9, priority=1)
    eng.run(max_rounds=2)
    eng.submit(np.arange(20, dtype=np.int32), 20, priority=0)  # 5 > 3
    with pytest.raises(RuntimeError, match="admit_highwater"):
        eng.run()
    assert not [e for e in events if e["kind"] == "serve_preempt"]
    np.testing.assert_array_equal(eng.finished[a],
                                  _standalone(tp, tcfg, PA, 9))


def _staged(eng):
    """Two long batch rows at t=0, then an interactive wave that must
    evict them, one more batch row, and a request that sheds at once."""
    ids = [eng.submit(PA, 18, priority=1),
           eng.submit(PA + 3, 18, priority=1)]
    eng.run(max_rounds=2)
    ids += [eng.submit(PB, 4, priority=0), eng.submit(PB + 1, 6, priority=0),
            eng.submit(PA + 9, 5, priority=1),
            eng.submit(PA, 3, priority=1, deadline_s=0.0)]
    got = eng.run()
    return ids, got


def _records(events):
    return [(e["kind"], int(e["seq_id"]), int(e.get("slot", -1)))
            for e in events]


def test_victims_and_records_equal_the_jax_engine(model):
    jcfg, tcfg, jp, tp = model
    kw = dict(slots=3, pool_pages=6, pages_per_seq=3)
    tev, jev = [], []
    tids, tgot = _staged(_port(tp, tcfg, tev, **kw))
    jids, jgot = _staged(_jax(jp, jcfg, jev, **kw))
    assert tids == jids
    pre = [(e["seq_id"], e["slot"], e["for_seq_id"], e["tokens_done"])
           for e in tev if e["kind"] == "serve_preempt"]
    assert pre, "the staged schedule preempted nothing"
    assert pre == [(e["seq_id"], e["slot"], e["for_seq_id"],
                    e["tokens_done"])
                   for e in jev if e["kind"] == "serve_preempt"]
    assert _records(tev) == _records(jev)
    # every record carries JAX's field names
    for t, j in zip(tev, jev):
        assert set(t) == set(j), (t["kind"], set(t) ^ set(j))
    for sid in tids:
        np.testing.assert_array_equal(tgot[sid], np.asarray(jgot[sid]))


def test_migration_records_equal_the_jax_engine(model):
    jcfg, tcfg, jp, tp = model
    evs = {}
    for who, mk in (("port", lambda ev: (_port(tp, tcfg, ev),
                                          _port(tp, tcfg, ev))),
                    ("jax", lambda ev: (_jax(jp, jcfg, ev),
                                        _jax(jp, jcfg, ev)))):
        ev = evs[who] = []
        src, dst = mk(ev)
        src.submit(PA, 6)
        src.submit(PB, 4)
        src.service_round(decode=False)
        for slot in src.exportable_slots():
            bd = src.export_migration(slot)
            bd.seq = slot
            dst.install_migration(bd)
        dst.run()
    assert _records(evs["port"]) == _records(evs["jax"])
    kinds = [e["kind"] for e in evs["port"]]
    assert kinds.count("serve_migrate_out") == 2 \
        and kinds.count("serve_migrate_in") == 2
    for t, j in zip(evs["port"], evs["jax"]):
        assert set(t) == set(j)
        if t["kind"] == "serve_migrate_in":
            assert t["seq"] == j["seq"]


def test_preempted_segment_and_token_ts_match_jax(model):
    jcfg, tcfg, jp, tp = model
    trq.configure(enabled=True)
    jrq.configure(enabled=True)
    teng, jeng = _port(tp, tcfg), _jax(jp, jcfg)
    ta, tb, _ = _starve(teng)
    ja, jb, _ = _starve(jeng)
    tsnap = trq.active().snapshot(teng.stats)
    jsnap = jrq.active().snapshot(jeng.stats)

    def kinds(snap, sid):
        return [seg[0] for seg in snap["requests"][str(sid)]["segments"]]

    for t, j in ((ta, ja), (tb, jb)):
        assert kinds(tsnap, t) == kinds(jsnap, j)
        tts = tsnap["requests"][str(t)]["token_ts"]
        jts = jsnap["requests"][str(j)]["token_ts"]
        assert len(tts) == len(jts)
        assert tts == sorted(tts)
    assert "preempted" in kinds(tsnap, ta)
    # the victim's stamps: one per token it emitted, across both lives
    assert len(teng.stats[ta]["token_ts"]) == 20
    assert tsnap["coverage_frac"] == pytest.approx(1.0, abs=1e-6)
