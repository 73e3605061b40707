"""Tiered-memory serving in the port (``EngineCore(residency=...)`` over
``memory/residency.py``) against the JAX engine: an engine whose page
pool is too small for its streams' KV, fronting the manager's host tier
(cold rows paged out at chunk boundaries, swapped rows prefetched back
under the decode chunk), emits TOKEN-IDENTICAL streams to an all-HBM
engine and to the standalone ``paged_generate`` — greedy and sampled —
with preemption and migration composing on top (``export_swapped``
continues a parked row on a peer engine). One stream under
``ColdAfterNPolicy`` through both packages' tiered engines pages the same
rows at the same moments: equal ``swap_outs``/``swap_ins`` and the same
sequence of ``serve_swap_out``/``serve_swap_in`` records. The rest are
JAX's ``tests/test_residency_serving.py`` shapes: demand rules, windows
and gauges, the ``slow_host_transfer`` chaos site, reservation
bookkeeping. CPU, f32, the JAX tests' model carried across by
``models/convert.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.memory import ColdAfterNPolicy as JCold  # noqa: E402
from hpc_patterns_tpu.memory import ResidencyManager as JManager  # noqa: E402
from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.harness import chaos as chaoslib  # noqa: E402
from hpc_patterns_tpu_torch.harness import metrics as metricslib  # noqa: E402
from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib  # noqa: E402
from hpc_patterns_tpu_torch.harness import slo as slolib  # noqa: E402
from hpc_patterns_tpu_torch.harness import trace as tracelib  # noqa: E402
from hpc_patterns_tpu_torch.memory import (  # noqa: E402
    ColdAfterNPolicy,
    LRUPolicy,
    PriorityAwarePolicy,
    ResidencyManager,
)
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.models.decode import paged_generate  # noqa: E402
from hpc_patterns_tpu_torch.models.serving import (  # noqa: E402
    ContinuousBatcher,
    EngineCore,
)

BASE = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=128, dtype="float32", decode_attn="gather")
PAGE = 8
PROMPT_LEN, BUDGET = 8, 24
PPS = ContinuousBatcher.pages_needed(PROMPT_LEN, BUDGET, PAGE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (small models; see
    test_torch_spec_serving's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**BASE)
    tcfg = ttf.TransformerConfig(**BASE)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.fixture(scope="module")
def reqs():
    rng = np.random.RandomState(3)
    return [(rng.randint(0, 64, size=PROMPT_LEN).astype(np.int32), BUDGET)
            for _ in range(5)]


def _engine(model, pool_rows, mgr=None, slots=5, **kw):
    _, tcfg, _, tp = model
    return ContinuousBatcher(tp, tcfg, slots=slots,
                             pool_pages=pool_rows * PPS, pages_per_seq=PPS,
                             page_size=PAGE, chunk=4, residency=mgr,
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def base(model, reqs):
    """The all-HBM outputs, greedy, each equal to its standalone."""
    _, tcfg, _, tp = model
    eng = _engine(model, 5)
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    out = {i: got[s] for i, s in enumerate(ids)}
    for i, (p, b) in enumerate(reqs):
        want = paged_generate(tp, torch.from_numpy(p)[None], tcfg, b,
                              page_size=PAGE, device="cpu")[0].numpy()
        np.testing.assert_array_equal(out[i], want)
    return out


def _check(base, got, ids):
    for i, s in enumerate(ids):
        np.testing.assert_array_equal(base[i], got[s], err_msg=f"seq {i}")


def test_greedy_token_identical_under_rotation(model, reqs, base):
    mgr = ResidencyManager(host_blocks=5 * PPS, policy=ColdAfterNPolicy(2))
    eng = _engine(model, 2, mgr)
    ids = [eng.submit(p, b) for p, b in reqs]
    _check(base, eng.run(), ids)
    assert mgr.swap_outs > 0 and mgr.swap_ins > 0
    assert not eng._swapped and not eng._prefetching
    assert mgr.device == torch.device("cpu")  # bound to the engine


def test_same_paging_schedule_as_the_jax_engine(model, reqs):
    jcfg, tcfg, jp, tp = model
    runs = []
    for srv, params, cfg, mgr, extra in (
            (jsrv, jp, jcfg, JManager(host_blocks=5 * PPS,
                                      policy=JCold(2)), {}),
            (None, tp, tcfg, ResidencyManager(host_blocks=5 * PPS,
                                              policy=ColdAfterNPolicy(2)),
             {"device": "cpu"})):
        events = []
        cls = srv.ContinuousBatcher if srv else ContinuousBatcher
        eng = cls(params, cfg, slots=5, pool_pages=2 * PPS,
                  pages_per_seq=PPS, page_size=PAGE, chunk=4, residency=mgr,
                  emit=lambda **r: events.append(r), **extra)
        ids = [eng.submit(p, b) for p, b in reqs]
        got = eng.run()
        paging = [(e["kind"], e["seq_id"], e.get("slot"), e["pages"])
                  for e in events if e["kind"] in
                  ("serve_swap_out", "serve_prefetch", "serve_swap_in")]
        runs.append(([np.asarray(got[s]) for s in ids], paging,
                     mgr.swap_outs, mgr.swap_ins, mgr.prefetch_bytes))
    (jt, jpg, jo, ji, jb), (tt, tpg, to, ti, tb) = runs
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    assert (to, ti) == (jo, ji) and to > 0
    assert tpg == jpg
    assert tb == jb  # the same bytes moved (f32 pools of one geometry)


def test_lru_same_class_completes_without_thrash(model, reqs, base):
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=LRUPolicy())
    eng = _engine(model, 1, mgr, slots=4)
    ids = [eng.submit(p, b) for p, b in reqs[:4]]
    _check(base, eng.run(), ids)
    assert mgr.swap_outs == 0  # nothing demanded paging


def test_sampled_token_identical(model, reqs):
    kw = dict(temperature=0.8, top_k=8, seed=5)
    full = _engine(model, 5, **kw)
    fids = [full.submit(p, b) for p, b in reqs]
    want = full.run()
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=ColdAfterNPolicy(2))
    eng = _engine(model, 2, mgr, **kw)
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    for i, s in enumerate(ids):
        np.testing.assert_array_equal(want[fids[i]], got[s])
    assert mgr.swap_outs > 0  # the keys crossed the tier and back


def test_urgent_arrival_pages_out_background(model, reqs, base):
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=PriorityAwarePolicy())
    eng = _engine(model, 2, mgr, slots=3)
    sids = [eng.submit(p, b, priority=1) for p, b in reqs[:3]]
    eng.run(max_rounds=3)
    hi = eng.submit(reqs[3][0], reqs[3][1], priority=0)
    got = eng.run()
    _check(base, got, sids)
    np.testing.assert_array_equal(base[3], got[hi])
    assert mgr.swap_outs > 0
    assert sum(st["preemptions"] for st in eng.stats.values()) == 0


def test_hard_preemption_composes_when_host_tier_full(model, reqs, base):
    mgr = ResidencyManager(host_blocks=2, policy=LRUPolicy())
    eng = _engine(model, 2, mgr, slots=3, preempt=True)
    sids = [eng.submit(p, b, priority=1) for p, b in reqs[:2]]
    eng.run(max_rounds=3)
    hi = eng.submit(reqs[3][0], reqs[3][1], priority=0)
    got = eng.run()
    _check(base, got, sids)
    np.testing.assert_array_equal(base[3], got[hi])
    assert sum(st["preemptions"] for st in eng.stats.values()) >= 1
    assert mgr.swap_outs == 0


def test_export_swapped_continues_on_a_peer(model, reqs, base):
    # one row exported from the HOST tier, one from the pool: both seat
    # in an all-HBM engine and finish exactly
    _, tcfg, _, tp = model
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=ColdAfterNPolicy(1))
    src = EngineCore(tp, tcfg, slots=3, pool_pages=2 * PPS,
                     pages_per_seq=PPS, page_size=PAGE, chunk=4,
                     residency=mgr, device="cpu")
    for i in range(3):
        src.submit(reqs[i][0], reqs[i][1], seq_id=i)
    for _ in range(20):
        src.service_round()
        if src._swapped and any(s.active for s in src._slots):
            break
    assert src._swapped and any(s.active for s in src._slots)
    host_sid = next(iter(src._swapped))
    b_host = src.export_swapped(host_sid)
    assert all(a.device.type == "cpu"
               for arrs in b_host.pages_payload.values() for a in arrs)
    res_slot = next(i for i, s in enumerate(src._slots) if s.active)
    hbm_sid = src._slots[res_slot].seq_id
    b_hbm = src.export_migration(res_slot)
    assert src.stats[host_sid]["outcome"] == "migrated"
    assert host_sid not in {g.group for g in mgr.groups()}
    dst = EngineCore(tp, tcfg, slots=4, pool_pages=4 * PPS,
                     pages_per_seq=PPS, page_size=PAGE, chunk=4,
                     device="cpu")
    dst.install_migration(b_host)
    dst.install_migration(b_hbm)
    while dst.has_work():
        dst.service_round()
    np.testing.assert_array_equal(base[host_sid], dst.finished[host_sid])
    np.testing.assert_array_equal(base[hbm_sid], dst.finished[hbm_sid])


def test_export_swapped_rejects_unknown_and_resident(model, reqs):
    mgr = ResidencyManager(host_blocks=8 * PPS)
    eng = _engine(model, 2, mgr)
    sid = eng.submit(reqs[0][0], reqs[0][1])
    with pytest.raises(ValueError, match="not swapped out"):
        eng.export_swapped(sid)
    with pytest.raises(ValueError, match="not swapped out"):
        _engine(model, 2).export_swapped(0)


def test_draft_engines_refuse_residency(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="do not page"):
        ContinuousBatcher(tp, tcfg, slots=2, pool_pages=2 * PPS,
                          pages_per_seq=PPS, page_size=PAGE,
                          draft_params=tp, draft_cfg=tcfg, device="cpu",
                          residency=ResidencyManager(host_blocks=4))


def test_duplicate_seq_id_rejected_while_swapped(model, reqs):
    _, tcfg, _, tp = model
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=ColdAfterNPolicy(1))
    eng = EngineCore(tp, tcfg, slots=3, pool_pages=2 * PPS,
                     pages_per_seq=PPS, page_size=PAGE, chunk=4,
                     residency=mgr, device="cpu")
    for i in range(3):
        eng.submit(reqs[i][0], reqs[i][1], seq_id=i)
    for _ in range(20):
        eng.service_round()
        if eng._swapped:
            break
    assert eng._swapped
    with pytest.raises(ValueError, match="already queued"):
        eng.submit(reqs[0][0], reqs[0][1], seq_id=next(iter(eng._swapped)))


def test_windows_gauges_records_and_overlap_measured(model, reqs, base):
    rec = tracelib.configure(enabled=True)
    metricslib.configure(enabled=True, mirror_traces=False)
    reqtracelib.configure(enabled=True)
    try:
        events = []
        mgr = ResidencyManager(host_blocks=5 * PPS,
                               policy=ColdAfterNPolicy(2))
        eng = _engine(model, 2, mgr, emit=lambda **r: events.append(r))
        ids = [eng.submit(p, b) for p, b in reqs]
        _check(base, eng.run(), ids)
        wins = [ev for ev in rec.events
                if ev[0] == "X" and ev[1] == "device"]
        names = {ev[2] for ev in wins}
        assert {"mem.prefetch", "mem.evict", "serve.chunk"} <= names
        assert all(ev[6]["bytes"] > 0 for ev in wins
                   if ev[2] == "mem.prefetch")
        reg = metricslib.get_metrics()
        assert reg.gauge("mem.prefetch_bytes").last == mgr.prefetch_bytes
        assert reg.gauge("mem.hbm_pages").n > 0
        assert reg.counter("serve.swapped_out").value == mgr.swap_outs
        frac = mgr.prefetch_overlap_frac
        assert frac is not None and 0.0 <= frac <= 1.0
        kinds = [e["kind"] for e in events]
        assert kinds.count("serve_swap_out") == mgr.swap_outs
        assert kinds.count("serve_swap_in") == mgr.swap_ins \
            == kinds.count("serve_prefetch")
        # every swapped row's request trace walked swapped_out and
        # prefetch_wait before it decoded again
        snap = reqtracelib.active().snapshot(eng.stats)
        swapped = {e["seq_id"] for e in events
                   if e["kind"] == "serve_swap_out"}
        for sid in swapped:
            segs = [s[0] for s in snap["requests"][str(sid)]["segments"]] \
                if str(sid) in snap["requests"] else \
                [s[0] for s in snap["requests"][sid]["segments"]]
            assert "swapped_out" in segs and "prefetch_wait" in segs
    finally:
        reqtracelib.reset()
        tracelib.configure(enabled=False)
        metricslib.configure(enabled=False)


def test_slow_host_transfer_widens_prefetch_window(model, reqs, base):
    delay_s = 0.05
    targets = slolib.targets_from_classes([
        type("C", (), {"priority": 0, "ttft_slo_s": 30.0,
                       "tpot_slo_s": 5.0})()])
    rec = tracelib.configure(enabled=True)
    chaoslib.configure(f"slow_host_transfer:delay_ms={int(delay_s * 1e3)}")
    try:
        mgr = ResidencyManager(host_blocks=5 * PPS,
                               policy=ColdAfterNPolicy(2))
        eng = _engine(model, 2, mgr, slo=targets)
        ids = [eng.submit(p, b) for p, b in reqs]
        _check(base, eng.run(), ids)
        fired = [e for e in chaoslib.injections()
                 if e["site"] == "host_transfer"]
        assert len(fired) == mgr.swap_ins > 0
        assert all(e["kind"] == "slow_host_transfer" for e in fired)
        pf = [ev for ev in rec.events if ev[0] == "X"
              and ev[1] == "device" and ev[2] == "mem.prefetch"]
        assert pf and max(ev[5] for ev in pf) >= delay_s
        tot = eng.last_slo["total"]
        assert 0.0 <= tot["goodput_tok_s"] <= tot["tok_s"] + 1e-9
    finally:
        chaoslib.reset()
        tracelib.configure(enabled=False)


def test_balance_sizes_eviction_to_the_highwater_constraint(model, reqs,
                                                             base):
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=PriorityAwarePolicy())
    eng = _engine(model, 4, mgr, slots=4, admit_highwater=0.5)
    sids = [eng.submit(p, b, priority=1) for p, b in reqs[:2]]
    eng.run(max_rounds=2)
    hi = eng.submit(reqs[3][0], reqs[3][1], priority=0)
    got = eng.run()
    _check(base, got, sids)
    np.testing.assert_array_equal(base[3], got[hi])
    assert mgr.swap_outs > 0


def test_slot_bound_urgent_head_pages_out_a_resident(model, reqs, base):
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=PriorityAwarePolicy())
    eng = _engine(model, 4, mgr, slots=2)
    sids = [eng.submit(p, b, priority=1) for p, b in reqs[:2]]
    eng.run(max_rounds=2)
    hi = eng.submit(reqs[3][0], reqs[3][1], priority=0)
    got = eng.run()
    _check(base, got, sids)
    np.testing.assert_array_equal(base[3], got[hi])
    assert mgr.swap_outs > 0


def _fake_pull():
    return (type("B", (), {"n_pages": PPS, "seq_id": 99})(), None,
            (None, 0, 0, 0.0, {}))


def test_prefetch_reservation_blocks_admission_theft(model, reqs):
    mgr = ResidencyManager(host_blocks=8 * PPS)
    eng = _engine(model, 2, mgr, slots=2)
    eng.submit(reqs[0][0], reqs[0][1], seq_id=0)
    for _ in range(3):
        eng.service_round()
    assert eng._admissible(PPS, fresh=True)
    eng._prefetching.append(_fake_pull())
    try:
        assert eng._reserved_prefetch_pages() == PPS
        assert not eng._admissible(PPS, fresh=True)
        assert not eng.migration_admissible(PPS)
    finally:
        eng._prefetching.clear()


def test_highwater_counts_reserved_prefetch_pages_as_used(model, reqs):
    mgr = ResidencyManager(host_blocks=8 * PPS)
    eng = _engine(model, 3, mgr, slots=3, admit_highwater=2 / 3)
    eng.submit(reqs[0][0], reqs[0][1], seq_id=0)
    for _ in range(2):
        eng.service_round()
    assert eng._admissible(PPS, fresh=True)
    eng._prefetching.append(_fake_pull())
    try:
        assert not eng._admissible(PPS, fresh=True)
        assert eng._admissible(PPS, fresh=False)
    finally:
        eng._prefetching.clear()


def test_request_pages_pages_out_for_the_router(model, reqs):
    # install pressure from the serving plane's router: the next balance
    # pass pages a resident out to free the asked-for pages
    mgr = ResidencyManager(host_blocks=8 * PPS, policy=LRUPolicy())
    eng = _engine(model, 2, mgr, slots=3)
    for i in range(2):
        eng.submit(reqs[i][0], reqs[i][1], seq_id=i)
    for _ in range(2):
        eng.service_round()
    assert eng.free_page_count == 0 and mgr.swap_outs == 0
    eng.request_pages(PPS)
    eng.service_round()
    assert mgr.swap_outs == 1 and eng.free_page_count >= PPS
