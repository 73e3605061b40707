"""The port's serving plane (``hpc_patterns_tpu_torch.serving_plane``) and
the engine's migration half, against the port's own oracles and the JAX
package's plane on the same params (carried over with
``models.convert.params_from_jax``), all in f32 on the CPU, where greedy
tokens must be equal (no tolerance).

- the disaggregation oracle: prefill -> migrate -> decode equals the
  standalone ``paged_generate`` byte for byte on every transport (dma
  between two logical ranks, device_put, wire), both arenas drained;
  the same requests through JAX's ``ServingPlane`` give equal tokens;
  over dma every pool dtype (f32, bf16, int8, fp8) equals the colocated
  engine;
- EOS after migration, open-loop arrivals, the placement policies, the
  SLO rollup, the validation guards, rows no decode replica can hold;
- what the elastic plane subclasses: ``replica_rounds``, ``rounds_total``
  and ``goodput_per_replica_round`` equal JAX's plane's, and a draining
  replica gets neither routing nor migrations;
- the transport ladder: a fallback warns and is counted, a kernel fault
  is no fallback;
- export/install guards, the seq_id collision, ``resume_prefix``, the
  priority order and deadline shedding, ``emit=`` records arriving, and
  later-slice options raising;
- the wire codec in both directions between the packages: a JAX bundle
  installed into a port engine continues to the JAX colocated engine's
  tokens and vice versa, and a round trip is bit-identical in each
  package at bf16 and fp8 pools (a JAX wire dict re-encoded by the port
  is the same JSON).
"""

import dataclasses
import json
import time
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu.serving_plane import migration as jmig  # noqa: E402
from hpc_patterns_tpu.serving_plane import router as jrouter  # noqa: E402
from hpc_patterns_tpu_torch import bench_serving  # noqa: E402
from hpc_patterns_tpu_torch.comm import migration_dma as md  # noqa: E402
from hpc_patterns_tpu_torch.harness import slo as tslo  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.models.decode import (  # noqa: E402
    paged_generate,
)
from hpc_patterns_tpu_torch.serving_plane import migration as tmig  # noqa: E402
from hpc_patterns_tpu_torch.serving_plane.router import (  # noqa: E402
    Replica,
    ServingPlane,
)
from hpc_patterns_tpu_torch.topology import LogicalDevice  # noqa: E402

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
ENG = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8, chunk=2)
POOLS = {"f32": {}, "bf16": {"dtype": "bfloat16"},
         "int8": {"kv_cache_dtype": "int8"}, "fp8": {"kv_cache_dtype": "fp8"}}
R0, R1 = LogicalDevice("cpu", 0), LogicalDevice("cpu", 1)


@pytest.fixture(scope="module")
def jp():
    return jtf.init_params(jax.random.PRNGKey(0),
                           jtf.TransformerConfig(**BASE))


@pytest.fixture(scope="module")
def tp(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tcfg(**over):
    return ttf.TransformerConfig(**{**BASE, **over}, decode_attn="flash")


def _jcfg(**over):
    return jtf.TransformerConfig(**{**BASE, **over}, decode_attn="gather")


def _eng(tp, cfg=None, cls=tsrv.EngineCore, **kw):
    return cls(tp, cfg or _tcfg(), **{**ENG, **kw}, device="cpu")


def _standalone(tp, cfg, prompt, max_new):
    return paged_generate(tp, torch.from_numpy(np.asarray(prompt))[None],
                          cfg, max_new, page_size=8, device="cpu")[0].numpy()


def _requests(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, size=int(rng.choice([5, 8, 11])))
             .astype(np.int32), int(rng.choice([3, 6, 9])))
            for _ in range(n)]


def _pd_plane(tp, migration="dma", cfg=None, placed=True, **kw):
    return ServingPlane([
        Replica(_eng(tp, cfg), name="p", role="prefill",
                device=R0 if placed else None),
        Replica(_eng(tp, cfg), name="d", role="decode",
                device=R1 if placed else None),
    ], migration=migration, **kw)


def _drained(plane):
    return all(sorted(r.engine.free_pages) == list(range(8))
               and (r.engine._table == r.engine.trash).all()
               for r in plane.replicas)


class TestDisaggregationOracle:
    @pytest.mark.parametrize("migration", ["dma", "device_put", "wire"])
    def test_prefill_migrate_decode_exact(self, tp, migration):
        plane = _pd_plane(tp, migration)
        reqs = _requests(5)
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        assert sorted(got) == sorted(ids)
        assert plane.migrations == len(reqs)
        assert dict(plane.migration_transports) == {migration: len(reqs)}
        for rid, (p, m) in zip(ids, reqs):
            np.testing.assert_array_equal(
                got[rid], _standalone(tp, _tcfg(), p, m),
                err_msg=f"rid {rid}")
        assert _drained(plane)
        assert plane.last_kv_migration_overlap_frac is not None
        assert (plane.last_dma_migration_overlap_frac is not None) == (
            migration == "dma")
        assert plane.migration_bytes_per_round > 0

    def test_host_shared_replicas_pass_through_locally(self, tp):
        plane = _pd_plane(tp, "device_put", placed=False)
        reqs = _requests(3, seed=2)
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        assert dict(plane.migration_transports) == {"local": 3}
        for rid, (p, m) in zip(ids, reqs):
            np.testing.assert_array_equal(got[rid],
                                          _standalone(tp, _tcfg(), p, m))

    def test_same_requests_through_the_jax_plane(self, jp, tp):
        reqs = _requests(5)
        jplane = jrouter.ServingPlane([
            jrouter.Replica(jsrv.EngineCore(jp, _jcfg(), **ENG), name="p",
                            role="prefill"),
            jrouter.Replica(jsrv.EngineCore(jp, _jcfg(), **ENG), name="d",
                            role="decode")])
        jids = [jplane.submit(p, m) for p, m in reqs]
        jgot = jplane.run()
        plane = _pd_plane(tp, "dma")
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        assert jplane.migrations == plane.migrations == len(reqs)
        for j, t in zip(jids, ids):
            np.testing.assert_array_equal(got[t], np.asarray(jgot[j]))

    @pytest.mark.parametrize("pool", list(POOLS))
    def test_dma_every_pool_dtype_equals_colocated(self, tp, pool):
        cfg = _tcfg(**POOLS[pool])
        reqs = _requests(4, seed=7)
        plane = _pd_plane(tp, "dma", cfg)
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        assert dict(plane.migration_transports) == {"dma": len(reqs)}
        colo = _eng(tp, cfg, cls=tsrv.ContinuousBatcher)
        cids = [colo.submit(p, m) for p, m in reqs]
        want = colo.run()
        for rid, cid in zip(ids, cids):
            np.testing.assert_array_equal(got[rid], want[cid])
        assert _drained(plane)

    def test_migrated_row_eos_still_truncates(self, tp):
        prompt = np.arange(5, dtype=np.int32)
        full = _standalone(tp, _tcfg(), prompt, 9)
        eos = int(full[3])
        first = int(np.argmax(full == eos))
        plane = ServingPlane([
            Replica(_eng(tp, eos_id=eos), name="p", role="prefill",
                    device=R0),
            Replica(_eng(tp, eos_id=eos), name="d", role="decode",
                    device=R1)], migration="dma")
        rid = plane.submit(prompt, 9)
        np.testing.assert_array_equal(plane.run()[rid], full[:first + 1])

    def test_open_loop_arrivals_through_the_plane(self, tp):
        plane = _pd_plane(tp, "dma")
        reqs = _requests(3, seed=9)
        arrivals = [(0.002 * i, dict(prompt=p, max_new=m))
                    for i, (p, m) in enumerate(reqs)]
        t0 = time.perf_counter()
        got = plane.run(arrivals=arrivals)
        assert sorted(got) == [0, 1, 2]
        for rid, (p, m) in zip(range(3), reqs):
            np.testing.assert_array_equal(got[rid],
                                          _standalone(tp, _tcfg(), p, m))
            # submit stamps are the schedule's instants
            assert plane.stats[rid]["t_submit"] - t0 == pytest.approx(
                0.002 * rid, abs=5e-3)

    def test_dma_matches_wire_path(self, tp):
        outs = {}
        for mig in ("dma", "wire"):
            plane = _pd_plane(tp, mig)
            ids = [plane.submit(p, m) for p, m in _requests(4, seed=3)]
            got = plane.run()
            assert plane.migration_transports[mig] == 4
            outs[mig] = [got[r] for r in ids]
        for a, b in zip(outs["dma"], outs["wire"]):
            np.testing.assert_array_equal(a, b)


class TestRouterMechanics:
    def test_homogeneous_round_robin_spreads_and_stays_exact(self, tp):
        plane = ServingPlane([Replica(_eng(tp), name=f"r{i}")
                              for i in range(2)], policy="round_robin")
        reqs = _requests(4, seed=3)
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        assert {plane.stats[r]["replica"] for r in ids} == {"r0", "r1"}
        assert plane.migrations == 0
        for rid, (p, m) in zip(ids, reqs):
            np.testing.assert_array_equal(got[rid],
                                          _standalone(tp, _tcfg(), p, m))

    def test_least_loaded_prefers_free_pages(self, tp):
        big = Replica(_eng(tp, pool_pages=12), name="big")
        small = Replica(_eng(tp), name="small")
        plane = ServingPlane([small, big], policy="least_loaded")
        rid = plane.submit(np.arange(5, dtype=np.int32), 3)
        assert plane.stats[rid]["replica"] == "big"
        plane.run()

    def test_weighted_follows_the_weights(self, tp):
        plane = ServingPlane(
            [Replica(_eng(tp), name="a"), Replica(_eng(tp), name="b")],
            policy="weighted", placement_weights={"b": 3.0})
        rids = [plane.submit(np.arange(5, dtype=np.int32), 3)
                for _ in range(3)]
        # 3 / (1 + b's queue) beats a's 1 / 1 until b holds two; the
        # third ties and goes to the earlier replica
        assert [plane.stats[r]["replica"] for r in rids] == ["b", "b", "a"]
        plane.run()

    def test_plane_slo_rollup_spans_replicas(self, tp):
        plane = _pd_plane(tp, "dma", slo={0: tslo.SLOTarget()})
        reqs = _requests(3, seed=11)
        for p, m in reqs:
            plane.submit(p, m)
        plane.run()
        tot = plane.last_slo["total"]
        assert tot["n"] == 3 and tot["served"] == 3
        assert tot["tokens"] == sum(m for _, m in reqs)
        assert tot["goodput_tok_s"] == tot["tok_s"] > 0
        # judged once, end to end: t_first from the prefill replica,
        # t_finish from the decode replica
        for rec in plane.stats.values():
            assert rec["replica"] == "d" and rec["outcome"] == "ok"
            assert rec["t_finish"] >= rec["t_first"] >= rec["t_submit"]

    def test_validation_guards(self, tp):
        with pytest.raises(ValueError, match="unique"):
            ServingPlane([Replica(_eng(tp), name="x"),
                          Replica(_eng(tp), name="x")])
        with pytest.raises(ValueError, match="policy"):
            ServingPlane([Replica(_eng(tp))], policy="nope")
        with pytest.raises(ValueError, match="disagrees on eos_id"):
            ServingPlane([Replica(_eng(tp), name="a"),
                          Replica(_eng(tp, eos_id=3), name="b")])
        with pytest.raises(ValueError, match="identical model config"):
            ServingPlane([Replica(_eng(tp), name="a", role="prefill"),
                          Replica(_eng(tp, _tcfg(kv_cache_dtype="int8")),
                                  name="b", role="decode")])
        with pytest.raises(ValueError, match="decode-capable"):
            ServingPlane([Replica(_eng(tp), role="prefill")])
        with pytest.raises(ValueError, match="prefill-capable"):
            ServingPlane([Replica(_eng(tp), role="decode")])
        with pytest.raises(ValueError, match="role"):
            Replica(_eng(tp), role="verifier")
        with pytest.raises(ValueError, match="engine lives on"):
            Replica(_eng(tp), device=torch.device("cuda:0"))
        plane = ServingPlane([Replica(_eng(tp), name="a")])
        with pytest.raises(ValueError, match="no live replica"):
            plane.submit(np.arange(40, dtype=np.int32), 30)

    def test_submit_rejects_rows_no_decode_replica_can_hold(self, tp):
        plane = ServingPlane([
            Replica(_eng(tp), name="p", role="prefill", device=R0),
            Replica(_eng(tp, pool_pages=4, pages_per_seq=2), name="d",
                    role="decode", device=R1)], migration="dma")
        with pytest.raises(ValueError, match="decode-capable"):
            plane.submit(np.arange(10, dtype=np.int32), 10)  # 3 pages
        rid = plane.submit(np.arange(5, dtype=np.int32), 3)
        np.testing.assert_array_equal(
            plane.run()[rid],
            _standalone(tp, _tcfg(), np.arange(5, dtype=np.int32), 3))

    @pytest.mark.parametrize("kw", [{"migration": "carrier-pigeon"}])
    def test_later_slice_and_unknown_options_raise(self, tp, kw):
        with pytest.raises(ValueError, match="not ported yet|transport"):
            ServingPlane([Replica(_eng(tp))], **kw)

    def test_emit_records_arrive(self, tp):
        # emit= is ported: every routed request and every migration
        # reaches the sink as a record, in order
        records = []
        plane = _pd_plane(tp, "dma",
                          emit=lambda **kw: records.append(kw))
        reqs = _requests(4)
        ids = [plane.submit(p, m) for p, m in reqs]
        plane.run()
        routes = [r for r in records if r["kind"] == "plane_route"]
        migrates = [r for r in records if r["kind"] == "plane_migrate"]
        assert [r["seq_id"] for r in routes] == ids
        assert {r["replica"] for r in routes} == {"p"}
        assert [r["seq"] for r in migrates] == list(range(plane.migrations))
        assert sorted(r["seq_id"] for r in migrates) == ids
        assert all(r["src"] == "p" and r["dst"] == "d" for r in migrates)

    def test_from_fitted_waits_for_autofit(self, tp):
        # autofit is ported: from_fitted takes only a FittedConfig, and
        # one without a placement section builds the default plane
        from hpc_patterns_tpu_torch.harness import autofit

        with pytest.raises(ValueError, match="not a fitted config"):
            ServingPlane.from_fitted([Replica(_eng(tp))], {})
        plane = ServingPlane.from_fitted([Replica(_eng(tp))],
                                         autofit.fit([]))
        assert plane.policy_name == "least_loaded"


class TestElasticHooks:
    """What the elastic plane subclasses: ``replica_rounds``, the
    ``goodput_per_replica_round`` property and ``Replica.draining``."""

    @pytest.mark.parametrize("roles", [("both", "both"),
                                       ("prefill", "decode")])
    def test_replica_rounds_and_goodput_equal_jax(self, jp, tp, roles):
        reqs = _requests(6, seed=4)
        slo_j = {0: jrouter.slolib.SLOTarget()}
        jplane = jrouter.ServingPlane(
            [jrouter.Replica(jsrv.EngineCore(jp, _jcfg(), **ENG), name=n,
                             role=r) for n, r in zip("ab", roles)],
            slo=slo_j)
        plane = ServingPlane([Replica(_eng(tp), name=n, role=r)
                              for n, r in zip("ab", roles)],
                             slo={0: tslo.SLOTarget()})
        assert plane.goodput_per_replica_round is None  # before a run
        for pl in (jplane, plane):
            for p, m in reqs:
                pl.submit(p, m)
            pl.run()
        assert plane.replica_rounds == jplane.replica_rounds > 0
        assert plane.rounds_total == jplane.rounds_total
        assert plane.replica_rounds == 2 * plane.rounds_total
        assert plane.goodput_per_replica_round == pytest.approx(
            jplane.goodput_per_replica_round, rel=1e-9)
        assert plane.goodput_per_replica_round == pytest.approx(
            sum(m for _, m in reqs) / plane.replica_rounds, rel=1e-9)
        assert plane._autoscale_round() is False  # the fixed plane

    def test_draining_replica_gets_no_routing_or_migrations(self, tp):
        plane = ServingPlane([
            Replica(_eng(tp), name="p", role="prefill"),
            Replica(_eng(tp), name="d0", role="decode"),
            Replica(_eng(tp), name="d1", role="decode"),
            Replica(_eng(tp), name="b", role="both")])
        plane.replicas[1].draining = True   # d0
        plane.replicas[3].draining = True   # b
        records = []
        plane._emit = lambda **kw: records.append(kw)
        reqs = _requests(6, seed=8)
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        routes = {r["replica"] for r in records
                  if r["kind"] == "plane_route"}
        dsts = {r["dst"] for r in records if r["kind"] == "plane_migrate"}
        assert routes == {"p"} and dsts == {"d1"}
        assert plane.migrations == len(reqs)
        for rid, (p, m) in zip(ids, reqs):
            np.testing.assert_array_equal(got[rid],
                                          _standalone(tp, _tcfg(), p, m))
        # with every other prefill-capable replica draining, a request
        # has nowhere to go
        plane.replicas[0].draining = True
        with pytest.raises(ValueError, match="no live replica"):
            plane.submit(np.arange(5, dtype=np.int32), 3)


class TestTransportLadder:
    def test_fallback_to_device_put_is_loud(self, tp):
        # device-less replicas cannot serve dma: exact all the same, but
        # warned, counted, and no dma overlap number
        plane = _pd_plane(tp, "dma", placed=False)
        reqs = _requests(3)
        ids = [plane.submit(p, m) for p, m in reqs]
        with pytest.warns(RuntimeWarning, match="fell back") as rec:
            got = plane.run()
        assert len([w for w in rec if "fell back" in str(w.message)]) == 1
        assert plane.migration_transports["dma"] == 0
        assert plane.last_dma_migration_overlap_frac is None
        for rid, (p, m) in zip(ids, reqs):
            np.testing.assert_array_equal(got[rid],
                                          _standalone(tp, _tcfg(), p, m))

    def test_budget_refusal_falls_back(self, tp, monkeypatch):
        monkeypatch.setattr(md, "LANDING_LIMIT", 64)
        plane = _pd_plane(tp, "dma")
        rid = plane.submit(np.arange(5, dtype=np.int32), 4)
        with pytest.warns(RuntimeWarning, match="budget"):
            got = plane.run()
        assert dict(plane.migration_transports) == {"device_put": 1}
        np.testing.assert_array_equal(
            got[rid],
            _standalone(tp, _tcfg(), np.arange(5, dtype=np.int32), 4))

    def test_kernel_fault_is_no_fallback(self, tp, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("migration exchange kernel: spin timed out")

        monkeypatch.setattr(md, "send_migration", broken)
        plane = _pd_plane(tp, "dma")
        plane.submit(np.arange(5, dtype=np.int32), 4)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            with pytest.raises(RuntimeError, match="kernel"):
                plane.run()
        assert not issubclass(RuntimeError, md.MigrationDmaError)


class TestMigrationPrimitives:
    def test_export_install_guards(self, tp):
        src = _eng(tp)
        src.submit(np.arange(5, dtype=np.int32), 4)
        src.service_round(decode=False)
        [slot] = src.exportable_slots()
        b = src.export_migration(slot)
        assert src.stats[b.seq_id]["outcome"] == "migrated"
        assert b.key.dtype == np.uint32 and not b.key.any()
        assert (b.temp, b.segments, b.transport) == (0.0, None, "local")
        assert b.rung == 5 and b.prefix_len == 0 and b.n_pages == 2
        with pytest.raises(ValueError, match="page_size"):
            _eng(tp, page_size=16).install_migration(b)
        with pytest.raises(ValueError, match="pools"):
            _eng(tp, _tcfg(kv_cache_dtype="int8")).install_migration(b)
        with pytest.raises(ValueError, match="no exportable row"):
            src.export_migration(slot)  # already released
        full = _eng(tp, pool_pages=1, pages_per_seq=1)
        assert not full.migration_admissible(b.n_pages)
        with pytest.raises(ValueError, match="not admissible"):
            full.install_migration(b)
        # a payload of the wrong dtype is refused, not cast
        bad = dataclasses.replace(b, pages_payload={
            k: tuple(a.double() for a in v)
            for k, v in b.pages_payload.items()})
        with pytest.raises(ValueError, match="does not fit"):
            _eng(tp).install_migration(bad)

    def test_migrated_seq_id_collision_refused(self, tp):
        src, dst = _eng(tp), _eng(tp)
        src.submit(np.arange(5, dtype=np.int32), 4, seq_id=7)
        dst.submit(np.arange(5, dtype=np.int32), 4, seq_id=7)
        src.service_round(decode=False)
        b = src.export_migration(src.exportable_slots()[0])
        with pytest.raises(ValueError, match="already known"):
            dst.install_migration(b)

    def test_installed_row_continues_exactly(self, tp):
        src, dst = _eng(tp), _eng(tp)
        prompt = np.arange(6, dtype=np.int32)
        src.submit(prompt, 5)
        src.service_round(decode=False)
        assert src.exportable_slots() == [0] and src.active_count == 1
        b = src.export_migration(0)
        assert src.free_page_count == src.pool_pages and not src.has_work()
        dst.install_migration(b)
        assert dst.active_count == 1
        while dst.has_work():
            dst.service_round()
        np.testing.assert_array_equal(dst.finished[0],
                                      _standalone(tp, _tcfg(), prompt, 5))
        assert dst.stats[0]["outcome"] == "ok" and dst.stats[0]["tokens"] == 5

    def test_resume_prefix_submit_path(self, tp):
        prompt = np.arange(7, dtype=np.int32)
        full = _standalone(tp, _tcfg(), prompt, 8)
        cut = 3
        eng = _eng(tp, cls=tsrv.ContinuousBatcher)
        eng.submit(np.concatenate([prompt, full[:cut]]), 8 - cut,
                   seq_id=0, resume_prefix=full[:cut])
        np.testing.assert_array_equal(eng.run()[0], full)
        with pytest.raises(ValueError, match="longer"):
            eng.submit(np.arange(2, dtype=np.int32), 3,
                       resume_prefix=np.arange(5, dtype=np.int32))

    def test_priority_order_and_deadline_shedding(self, tp):
        eng = _eng(tp, cls=tsrv.ContinuousBatcher, slots=1)
        a = eng.submit(np.arange(5, dtype=np.int32), 2, priority=1)
        b = eng.submit(np.arange(5, dtype=np.int32), 2, priority=0)
        c = eng.submit(np.arange(5, dtype=np.int32), 2, priority=0,
                       resume_prefix=np.zeros(1, np.int32))
        d = eng.submit(np.arange(5, dtype=np.int32), 2, deadline_s=0.0)
        assert [eng._queue[i].seq_id for i in eng._queue_order()] == [
            c, b, d, a]
        assert eng.queue_depth == 4
        time.sleep(0.002)
        got = eng.run()
        assert got[d].size == 0 and eng.stats[d]["outcome"] == "shed"
        assert [eng.stats[s]["outcome"] for s in (a, b, c)] == ["ok"] * 3
        # served in admission order: the resume first, the batch last
        assert eng.stats[c]["t_first"] < eng.stats[b]["t_first"] \
            < eng.stats[a]["t_first"]

    def test_observables_and_jax_parity(self, jp, tp):
        t, j = _eng(tp), jsrv.EngineCore(jp, _jcfg(), **ENG)
        for args in ((5, 3), (30, 30), (60, 2), (1, 1), (20, 12)):
            assert t.would_fit(*args) == j.would_fit(*args), args
        for e in (t, j):
            e.submit(np.arange(5, dtype=np.int32), 4)
            e.submit(np.arange(9, dtype=np.int32), 4)
            e.service_round(decode=False)
        assert (t.queue_depth, t.active_count, t.exportable_slots()) == (
            j.queue_depth, j.active_count, j.exportable_slots())
        for n in (1, 2, 4, 5):
            assert t.migration_admissible(n) == j.migration_admissible(n)

    @pytest.mark.parametrize("kw", [{"temperature": 0.5},
                                    {"key": np.zeros(2, np.uint32)}])
    def test_per_request_sampling_raises_on_greedy(self, tp, kw):
        with pytest.raises(ValueError, match="sampling engine"):
            _eng(tp).submit(np.arange(5, dtype=np.int32), 3, **kw)

    def test_engine_slo_rollup_equals_jax(self, jp, tp):
        targets = {0: tslo.SLOTarget(ttft_s=60.0), 1: tslo.SLOTarget()}
        eng = _eng(tp, cls=tsrv.ContinuousBatcher, slo=targets)
        for i, (p, m) in enumerate(_requests(4, seed=5)):
            eng.submit(p, m, priority=i % 2)
        eng.run()
        from hpc_patterns_tpu.harness import slo as jslo

        jt = {k: jslo.SLOTarget(v.ttft_s, v.tpot_s)
              for k, v in targets.items()}
        want = jslo.attainment(eng.stats, jt, eng._serve_s)
        assert eng.last_slo == want
        assert eng.last_slo["total"]["served"] == 4


def _raw(a) -> bytes:
    if torch.is_tensor(a):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(a).tobytes()


def _jax_bundle(jp, cfg, prompt, budget):
    eng = jsrv.EngineCore(jp, cfg, **ENG)
    eng.submit(prompt, budget)
    eng.service_round(decode=False)
    return eng.export_migration(eng.exportable_slots()[0])


def _port_bundle(tp, cfg, prompt, budget):
    eng = _eng(tp, cfg)
    eng.submit(prompt, budget)
    eng.service_round(decode=False)
    return eng.export_migration(eng.exportable_slots()[0])


def _jax_colocated(jp, cfg, prompt, budget):
    eng = jsrv.ContinuousBatcher(jp, cfg, **ENG)
    sid = eng.submit(prompt, budget)
    return np.asarray(eng.run()[sid])


class TestWireParity:
    PROMPT = np.array([3, 9, 27, 17, 60, 2, 44, 8, 1], np.int32)

    @pytest.mark.parametrize("pool", ["f32", "int8"])
    def test_jax_bundle_continues_in_a_port_engine(self, jp, tp, pool):
        jb = _jax_bundle(jp, _jcfg(**POOLS[pool]), self.PROMPT, 12)
        wire = json.loads(json.dumps(jmig.bundle_to_wire(jb)))
        tb = tmig.bundle_from_wire(wire)
        dst = _eng(tp, _tcfg(**POOLS[pool]))
        dst.install_migration(tb)
        while dst.has_work():
            dst.service_round()
        np.testing.assert_array_equal(
            dst.finished[jb.seq_id],
            _jax_colocated(jp, _jcfg(**POOLS[pool]), self.PROMPT, 12))

    @pytest.mark.parametrize("pool", ["f32", "int8"])
    def test_port_bundle_continues_in_a_jax_engine(self, jp, tp, pool):
        tb = _port_bundle(tp, _tcfg(**POOLS[pool]), self.PROMPT, 12)
        wire = json.loads(json.dumps(tmig.bundle_to_wire(tb)))
        jb = jmig.bundle_from_wire(wire)
        dst = jsrv.EngineCore(jp, _jcfg(**POOLS[pool]), **ENG)
        dst.install_migration(jb)
        while dst.has_work():
            dst.service_round()
        np.testing.assert_array_equal(
            np.asarray(dst.finished[tb.seq_id]),
            _jax_colocated(jp, _jcfg(**POOLS[pool]), self.PROMPT, 12))

    @pytest.mark.parametrize("pool", ["bf16", "fp8"])
    def test_roundtrip_bit_identical_in_each_package(self, jp, tp, pool):
        jb = _jax_bundle(jp, _jcfg(**POOLS[pool]), self.PROMPT, 5)
        jb.seq = 3
        jwire = jmig.bundle_to_wire(jb)
        jb2 = jmig.bundle_from_wire(jwire)
        tb = _port_bundle(tp, _tcfg(**POOLS[pool]), self.PROMPT, 5)
        tb.seq = 3
        twire = tmig.bundle_to_wire(tb)
        tb2 = tmig.bundle_from_wire(json.loads(json.dumps(twire)))
        for b, b2 in ((jb, jb2), (tb, tb2)):
            assert (b2.seq, b2.pos, b2.limit, b2.out, b2.transport) == (
                3, b.pos, b.limit, b.out, b.transport)
            np.testing.assert_array_equal(np.asarray(b2.key),
                                          np.asarray(b.key))
            for name, arrs in b.pages_payload.items():
                for a, a2 in zip(arrs, b2.pages_payload[name]):
                    assert a2.dtype == a.dtype and a2.shape == a.shape
                    assert _raw(a2) == _raw(a), name
        # the same JSON through the other package: the port re-encodes a
        # JAX wire dict (bf16/fp8 payload included) to the same dict
        assert tmig.bundle_to_wire(tmig.bundle_from_wire(jwire)) == jwire
        assert twire["payload"]["k"][0]["dtype"] == (
            "bfloat16" if pool == "bf16" else "float8_e4m3fn")
        assert twire.keys() == jwire.keys()

    def test_legacy_keys_decode_as_jax_decodes(self, jp):
        jb = _jax_bundle(jp, _jcfg(), self.PROMPT, 5)
        legacy = jmig.bundle_to_wire(jb)
        del legacy["transport"], legacy["segments"]
        jl, tl = jmig.bundle_from_wire(legacy), tmig.bundle_from_wire(legacy)
        assert tl.transport == jl.transport == "wire"
        assert tl.segments == tuple(tuple(s) for s in jl.segments)
        nulled = dict(legacy, segments=None)
        assert tmig.bundle_from_wire(nulled).segments is None
        assert set(tmig.REQUIRED_WIRE_FIELDS) == set(
            jmig.REQUIRED_WIRE_FIELDS)


def test_bench_plane_row_cpu():
    # the plane row at the CI shape over kernel 13's route: every leg on
    # its oracle (inside run_plane), JAX's result keys, the honest note
    conf = bench_serving.plane_smoke_config("cpu")
    res = bench_serving.run_plane(**conf, migration="dma", quiet=True)
    assert res["migration_transports"] == {"dma": res["migrations"]}
    assert res["migrations"] > 0 and res["placement_shares_host"]
    assert res["expected_padding_fit"] <= res["expected_padding_default"]
    assert res["dma_migration_overlap_frac"] is not None
    for leg in ("single", "plane", "disagg", "sampled"):
        assert res["oracle"][leg]["mismatch"] == 0
    assert res["sampled_migration_transports"] == {
        "dma": res["sampled_migrations"]} and res["sampled_migrations"] > 0
    assert {"t_single", "t_plane", "t_disagg", "plane_goodput_tok_s",
            "kv_migration_overlap_frac", "migration_bytes_per_round",
            "ladder_fit", "schedule"} <= set(res)


def test_bench_cli_cpu(capsys):
    assert bench_serving.main(["--plane", "--migration", "wire", "--device",
                               "cpu", "--smoke", "--kv-dtype", "int8"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["migration_transports"] == {"wire": res["migrations"]}
    with pytest.raises(SystemExit):
        # a transport the plane does not have is refused by the CLI (the
        # elastic row, once refused here, runs: test_torch_bench_serving)
        bench_serving.main(["--plane", "--migration", "carrier-pigeon",
                            "--device", "cpu"])
