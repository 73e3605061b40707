"""The port's request tracing (``hpc_patterns_tpu_torch.harness.reqtrace``)
held against the JAX package's: the same stamp sequence gives the same
segments, the same tiling (:func:`finalize`), coverage and snapshot, and
the JAX package's attribution table (``harness/explain.py``'s digest)
over a port snapshot equals the one over the JAX snapshot of the same
segments. Then the port engine's stamps: every request's segments tile
its life, a migrated bundle carries its history across engines and
through the wire codec, the history mirrors onto the request's Perfetto
lane, and with tracing off the tokens are the same and nothing is
recorded.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.harness import explain as jexplain  # noqa: E402
from hpc_patterns_tpu.harness import reqtrace as jrt  # noqa: E402
from hpc_patterns_tpu_torch.harness import reqtrace as trt  # noqa: E402
from hpc_patterns_tpu_torch.harness import trace as tt  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.serving_plane import migration as tmig  # noqa: E402,E501

KINDS = ("queued", "admit_wait", "prefill", "decode", "migrating")


@pytest.fixture(autouse=True)
def _reset():
    yield
    trt.reset()
    jrt.reset()
    tt.configure(enabled=False)


def _stamp(mod, seed, n=6):
    """Seeded lifecycles on a fresh recorder of ``mod``: a queue, an
    admission, prefill, decode, sometimes a migration (exported and
    re-installed) or a shed, with gaps the tiling must fill. Returns
    (recorder, stats)."""
    rng = np.random.default_rng(seed)
    rt = mod.ReqTrace()
    stats = {}
    for sid in range(n):
        t = float(rng.uniform(0, 1))
        t_submit = t
        rt.begin_request(sid, t)
        if rng.random() < 0.2:
            t += float(rng.uniform(0.01, 0.1))
            rt.finish_request(sid, t, final="shed")
            stats[sid] = {"t_submit": t_submit, "t_first": None,
                          "t_finish": t, "tokens": 0, "outcome": "shed",
                          "priority": sid % 2}
            continue
        for kind in ("admit_wait", "prefill", "decode"):
            t += float(rng.uniform(0.001, 0.05))
            rt.stamp_transition(sid, kind, t)
        t_first = t
        if rng.random() < 0.5:
            t += float(rng.uniform(0.001, 0.05))
            hist = rt.export_history(sid, t)
            rt.annotate_open(sid, seq=sid)
            t += float(rng.uniform(0.001, 0.05))
            rt.install_history(sid, hist, t=t, t_submit=t_submit)
        t += float(rng.uniform(0.01, 0.2))
        # a gap no stamp claims, before the finish
        rt.finish_request(sid, t + float(rng.uniform(0, 0.01)))
        stats[sid] = {"t_submit": t_submit, "t_first": t_first,
                      "t_finish": t + 0.02, "tokens": int(rng.integers(1, 9)),
                      "outcome": "ok", "priority": sid % 2}
    return rt, stats


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_same_stamps_same_segments(self, seed):
        t, _ = _stamp(trt, seed)
        j, _ = _stamp(jrt, seed)
        for sid in range(6):
            assert t.segments(sid) == j.segments(sid)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_finalize_and_coverage_equal(self, seed):
        t, stats = _stamp(trt, seed)
        for sid, rec in stats.items():
            segs = t.segments(sid)
            got = trt.finalize(segs, rec["t_submit"], rec["t_finish"])
            assert got == jrt.finalize(segs, rec["t_submit"],
                                       rec["t_finish"])
            tiled = got[0]
            assert tiled[0][1] == rec["t_submit"]
            assert tiled[-1][2] == rec["t_finish"]
            for a, b in zip(tiled, tiled[1:]):
                assert a[2] == b[1]  # no gap, no overlap
            assert trt.coverage_frac(segs, rec["t_submit"],
                                     rec["t_finish"]) == jrt.coverage_frac(
                segs, rec["t_submit"], rec["t_finish"])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_snapshot_and_attribution_table_equal(self, seed):
        t, stats = _stamp(trt, seed)
        j, _ = _stamp(jrt, seed)
        ts = json.loads(json.dumps(t.snapshot(stats)))
        js = json.loads(json.dumps(j.snapshot(stats)))
        assert ts == js
        assert 0.0 < ts["coverage_frac"] < 1.0  # the gaps are measured
        assert jexplain.digest([ts]) == jexplain.digest([js])
        assert jexplain.format_explain(jexplain.digest([ts])) == \
            jexplain.format_explain(jexplain.digest([js]))

    def test_constants_equal_jax(self):
        assert trt.SEGMENT_KINDS == jrt.SEGMENT_KINDS
        assert trt.LEGACY_SEGMENTS == jrt.LEGACY_SEGMENTS
        assert trt.EPS_S == jrt.EPS_S

    def test_legacy_install_resolves_to_untracked(self):
        for mod in (trt, jrt):
            rt = mod.ReqTrace()
            rt.install_history(4, None, t=2.0, t_submit=1.0)
            rt.finish_request(4, 3.0)
            assert rt.segments(4) == [["untracked", 1.0, 2.0, None],
                                      ["decode", 2.0, 3.0, None]]

    def test_disabled_by_default(self):
        trt.reset()
        assert trt.active() is None
        assert trt.configure(enabled=False) is not None
        assert trt.active() is None


SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32")
ENG = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8, chunk=2,
           device="cpu")


@pytest.fixture(scope="module")
def model():
    cfg = ttf.TransformerConfig(**SMALL, decode_attn="flash")
    params = ttf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
    return cfg, params


def _requests(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, size=int(rng.choice([5, 8, 11])))
             .astype(np.int32), int(rng.choice([3, 6, 9])))
            for _ in range(n)]


def _serve(model, reqs):
    cfg, params = model
    eng = tsrv.ContinuousBatcher(params, cfg, **ENG)
    ids = [eng.submit(p, m) for p, m in reqs]
    got = eng.run()
    return eng, [got[i] for i in ids]


class TestEngine:
    def test_segments_tile_every_life(self, model):
        reqs = _requests(5)
        rt = trt.configure(enabled=True)
        eng, _ = _serve(model, reqs)
        snap = rt.snapshot(eng.stats)
        assert snap["n"] == 5 and snap["coverage_frac"] > 0.99
        for entry in snap["requests"].values():
            kinds = [s[0] for s in entry["segments"]]
            assert kinds == ["queued", "admit_wait", "prefill", "decode"]
            tiled, untracked = trt.finalize(
                entry["segments"], entry["t_submit"], entry["t_finish"])
            assert untracked < 1e-3 * (entry["t_finish"]
                                       - entry["t_submit"]) + 1e-6

    def test_disabled_path_same_tokens_nothing_recorded(self, model):
        reqs = _requests(4, seed=3)
        trt.reset()
        _, off = _serve(model, reqs)
        rt = trt.configure(enabled=True)
        _, on = _serve(model, reqs)
        for a, b in zip(off, on):
            np.testing.assert_array_equal(a, b)
        assert len(rt._segs) == 4

    def test_migration_carries_history(self, model):
        cfg, params = model
        rt = trt.configure(enabled=True)
        src = tsrv.EngineCore(params, cfg, **ENG)
        dst = tsrv.EngineCore(params, cfg, **ENG)
        sid = src.submit(np.arange(5, dtype=np.int32), 6)
        src.service_round(decode=False)
        bundle = src.export_migration(src.exportable_slots()[0])
        assert [s[0] for s in bundle.segments] == [
            "queued", "admit_wait", "prefill", "decode", "migrating"]
        # through the wire codec both ways, then a cross-process install
        # (a fresh recorder: the carried copy seeds it)
        wire = json.loads(json.dumps(tmig.bundle_to_wire(bundle)))
        back = tmig.bundle_from_wire(wire)
        assert back.segments == bundle.segments
        rt2 = trt.configure(enabled=True)
        dst.install_migration(back)
        while dst.has_work():
            dst.service_round()
        segs = rt2.segments(sid)
        assert [s[0] for s in segs] == [
            "queued", "admit_wait", "prefill", "decode", "migrating",
            "decode"]
        assert rt.segments(sid)[-1][0] == "migrating"
        rec = dst.stats[sid]
        assert trt.coverage_frac(segs, rec["t_submit"],
                                 rec["t_finish"]) > 0.99

    def test_wire_legacy_bundle_decodes_to_untracked(self, model):
        cfg, params = model
        trt.reset()
        src = tsrv.EngineCore(params, cfg, **ENG)
        src.submit(np.arange(5, dtype=np.int32), 4)
        src.service_round(decode=False)
        wire = tmig.bundle_to_wire(src.export_migration(0))
        assert wire["segments"] is None  # the donor traced nothing
        del wire["segments"]
        assert tmig.bundle_from_wire(wire).segments == trt.LEGACY_SEGMENTS

    def test_history_mirrors_onto_the_request_lane(self, model):
        rec = tt.configure(enabled=True)
        trt.configure(enabled=True)
        _serve(model, _requests(2, seed=4))
        lanes = [e for e in rec.events if e[1] == "request"]
        assert {e[4] - tt.TID_REQUEST for e in lanes} == {0, 1}
        assert [e[2] for e in lanes if e[4] == tt.TID_REQUEST] == [
            "queued", "admit_wait", "prefill", "decode"]
