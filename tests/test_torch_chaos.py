"""The port's chaos injectors (``hpc_patterns_tpu_torch/harness/chaos.py``,
a copy of the JAX module): the JAX tests' parse, activation, matching and
replica-site cases run against the port module (the replica site's
stub-replica probe on the port's ``service.StubAdapter``), then the live
wiring — the engine's ``engine_round`` stall and the serving plane's
``replica_round`` death — each beside the JAX package's result for the
same spec on the same schedule. Both modules' global state is reset
around every test.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.harness import chaos as jchaos  # noqa: E402
from hpc_patterns_tpu_torch.harness import chaos  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv(chaos.ENV_CHAOS, raising=False)
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


class TestParse:
    def test_straggler_spec(self):
        (f,) = chaos.parse("straggler:rank=1,delay_ms=40")
        assert f.kind == "straggler" and f.site == "collective"
        assert f.rank == 1 and f.delay_s == pytest.approx(0.04)
        assert f.every == 1  # stragglers recur by default

    def test_stall_and_die_fire_once_by_default(self):
        stall, die = chaos.parse("stall:at=3,delay_ms=100;die:rank=0,at=5")
        assert stall.site == "engine_round" and stall.every == 0
        assert stall.matches("engine_round", 3, 0)
        assert not stall.matches("engine_round", 4, 0)
        assert die.every == 0 and die.exit_code is None

    def test_slow_host_transfer_spec(self):
        # the round-11 tiered-memory injector: defaults to the
        # host_transfer site (the residency manager's prefetch
        # dispatch) and recurs like a straggler — degraded bandwidth
        # is a condition, not an event
        (f,) = chaos.parse("slow_host_transfer:delay_ms=40")
        assert f.kind == "slow_host_transfer"
        assert f.site == "host_transfer"
        assert f.delay_s == pytest.approx(0.04)
        assert f.every == 1
        assert f.matches("host_transfer", 0, 0)
        assert not f.matches("collective", 0, 0)
        (g,) = chaos.parse("slow_host_transfer:at=2,delay_ms=40,every=0")
        assert g.matches("host_transfer", 2, 0)
        assert not g.matches("host_transfer", 3, 0)

    def test_every_and_at_schedule(self):
        (f,) = chaos.parse("straggler:delay_ms=1,at=2,every=4")
        fired = [i for i in range(12) if f.matches("collective", i, 0)]
        assert fired == [2, 6, 10]

    def test_rank_filter(self):
        (f,) = chaos.parse("straggler:rank=1,delay_ms=1")
        assert f.matches("collective", 0, 1)
        assert not f.matches("collective", 0, 0)
        (g,) = chaos.parse("straggler:delay_ms=1")  # rank omitted = all
        assert g.matches("collective", 0, 0) and g.matches("collective", 0, 7)

    def test_bad_specs_raise(self):
        # a typo'd spec silently injecting nothing would fake a healthy
        # run out of a chaos scenario — every unknown token is an error
        with pytest.raises(ValueError, match="unknown chaos kind"):
            chaos.parse("stragler:delay_ms=1")
        with pytest.raises(ValueError, match="unknown chaos key"):
            chaos.parse("straggler:delay=1")
        with pytest.raises(ValueError, match="unknown chaos site"):
            chaos.parse("straggler:site=nowhere")

    def test_deterministic_jitter(self):
        (f,) = chaos.parse("straggler:delay_ms=10,jitter_ms=10,seed=3")
        a = [f.delay_at("collective", i) for i in range(8)]
        b = [f.delay_at("collective", i) for i in range(8)]
        assert a == b  # pure hash: a replay is the same perturbation
        assert all(0.01 <= d <= 0.02 for d in a)
        assert len(set(a)) > 1  # and it IS jitter, not a constant
        (g,) = chaos.parse("straggler:delay_ms=10,jitter_ms=10,seed=4")
        assert [g.delay_at("collective", i) for i in range(8)] != a


class TestActivation:
    def test_env_spec_parsed_and_cached(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_CHAOS, "stall:at=1,delay_ms=5")
        (f,) = chaos.active()
        assert f.kind == "stall"
        assert chaos.active()[0] is f  # cached per env value

    def test_configure_overrides_env_and_none_disables(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_CHAOS, "stall:at=1,delay_ms=5")
        chaos.configure("straggler:delay_ms=1")
        assert chaos.active()[0].kind == "straggler"
        chaos.configure(None)  # explicitly OFF, env notwithstanding
        assert chaos.active() is None
        chaos.reset()
        assert chaos.active()[0].kind == "stall"

    def test_no_spec_means_no_chaos(self):
        assert chaos.active() is None
        chaos.maybe_inject("collective", 0)  # no-op, no log
        assert chaos.injections() == ()

    def test_process_id_env_is_the_rank(self, monkeypatch):
        # the launcher's variable, spelled as the JAX package spells it
        assert chaos.ENV_PROCESS_ID == jchaos.ENV_PROCESS_ID
        chaos.configure("stall:rank=3,at=0,delay_ms=0")
        monkeypatch.setenv(chaos.ENV_PROCESS_ID, "3")
        chaos.maybe_inject("engine_round", 0)
        assert len(chaos.injections()) == 1
        monkeypatch.setenv(chaos.ENV_PROCESS_ID, "2")
        chaos.configure("stall:rank=3,at=0,delay_ms=0")
        chaos.maybe_inject("engine_round", 0)
        assert chaos.injections() == ()


class TestReplicaSite:
    """``replica_round`` is the serving plane's per-replica round site
    and ``replica=`` aliases ``rank=``."""

    def test_replica_key_aliases_rank(self):
        (f,) = chaos.parse("die:replica=2,at=5,site=replica_round")
        assert f.kind == "die" and f.site == "replica_round"
        assert f.rank == 2 and f.at == 5
        assert f.every == 0  # death still fires once definitionally

    def test_replica_round_site_matches_only_itself(self):
        (f,) = chaos.parse(
            "stall:replica=1,at=2,site=replica_round,delay_ms=5")
        assert f.matches("replica_round", 2, 1)
        assert not f.matches("engine_round", 2, 1)
        assert not f.matches("replica_round", 2, 0)

    def test_stub_replica_round_probe_fires(self, monkeypatch):
        # the plane's stub replica probes the site once per protocol
        # round — the same probe the real adapter makes
        from hpc_patterns_tpu_torch.serving_plane.service import StubAdapter

        chaos.configure("stall:at=1,delay_ms=30,site=replica_round")
        adapter = StubAdapter(slots=1, pool_pages=4, pages_per_seq=4,
                              page_size=8, chunk=2)
        t0 = time.perf_counter()
        adapter.round(None)
        adapter.round(None)  # index 1: the stall fires here
        dt = time.perf_counter() - t0
        fired = [e for e in chaos.injections()
                 if e["site"] == "replica_round"]
        assert len(fired) == 1 and fired[0]["index"] == 1
        assert dt >= 0.03

class TestMatching:
    """``matching``/``record_injection``: the caller-executed injection
    pair the in-process serving plane uses."""

    def test_matching_returns_without_executing(self):
        chaos.configure("die:replica=1,at=2,site=replica_round")
        # a die fault MATCHED but not executed: the process survives
        assert chaos.matching("replica_round", 2, rank=1)
        assert not chaos.matching("replica_round", 2, rank=0)
        assert not chaos.matching("replica_round", 1, rank=1)
        assert not chaos.matching("engine_round", 2, rank=1)
        assert chaos.injections() == ()  # nothing logged either

    def test_rank_overrides_process_rank(self, monkeypatch):
        # the explicit rank is the REPLICA ordinal, independent of
        # the process's own id
        monkeypatch.setenv(chaos.ENV_PROCESS_ID, "7")
        chaos.configure("stall:replica=3,at=0,delay_ms=1,"
                        "site=replica_round")
        assert chaos.matching("replica_round", 0, rank=3)
        assert not chaos.matching("replica_round", 0)  # process rank 7

    def test_record_injection_feeds_the_log(self):
        chaos.configure("die:replica=1,at=0,site=replica_round")
        chaos.record_injection("replica_round", 0, "die", rank=1)
        (e,) = chaos.injections()
        assert e == {"site": "replica_round", "index": 0,
                     "kind": "die", "rank": 1, "delay_s": 0.0}

    def test_matching_respects_suppression_and_off(self):
        chaos.configure("stall:at=0,delay_ms=1,site=replica_round")
        with chaos.suppress("replica_round"):
            assert chaos.matching("replica_round", 0, rank=0) == ()
        chaos.configure(None)
        assert chaos.matching("replica_round", 0, rank=0) == ()
class TestInjection:
    def test_straggler_sleeps_and_logs(self):
        chaos.configure("straggler:delay_ms=30,at=1")
        t0 = time.perf_counter()
        chaos.maybe_inject("collective", 0)  # below at: no delay
        assert time.perf_counter() - t0 < 0.02
        t0 = time.perf_counter()
        chaos.maybe_inject("collective", 1)
        assert time.perf_counter() - t0 >= 0.03
        log = chaos.injections()
        assert [e["index"] for e in log] == [1]
        assert log[0]["delay_s"] == pytest.approx(0.03)

    def test_the_two_modules_parse_alike(self):
        spec = ("straggler:rank=1,delay_ms=40,every=4;stall:at=3,"
                "delay_ms=100;die:replica=2,at=5,site=replica_round;"
                "slow_host_transfer:at=2,delay_ms=40,every=0;"
                "straggler:delay_ms=10,jitter_ms=10,seed=3")
        ours, theirs = chaos.parse(spec), jchaos.parse(spec)
        assert [vars(f) for f in ours] == [vars(f) for f in theirs]
        for f, g in zip(ours, theirs):
            assert [f.delay_at(f.site, i) for i in range(6)] == \
                [g.delay_at(g.site, i) for i in range(6)]
        assert chaos.SITES == jchaos.SITES and chaos.KINDS == jchaos.KINDS


# -- the live sites, beside the JAX package on the same schedule -----------

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")


@pytest.fixture(scope="module")
def model():
    from hpc_patterns_tpu.models import transformer as jtf
    from hpc_patterns_tpu_torch.models import transformer as ttf
    from hpc_patterns_tpu_torch.models.convert import params_from_jax

    jcfg = jtf.TransformerConfig(**BASE, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**BASE, decode_attn="flash")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _stalled_run(srv, params, cfg, mod, spec, **kw):
    eng = srv.ContinuousBatcher(params, cfg, slots=1, pool_pages=3,
                                pages_per_seq=3, page_size=8, chunk=2, **kw)
    sid = eng.submit(np.arange(5, dtype=np.int32), 8)
    mod.configure(spec)
    t0 = time.perf_counter()
    try:
        got = np.asarray(eng.run()[sid])
        dt = time.perf_counter() - t0
        fired = [(e["site"], e["index"], e["kind"])
                 for e in mod.injections()]
    finally:
        mod.reset()
    return got, dt, fired


@pytest.mark.parametrize("spec", ["stall:at=1,delay_ms=120",
                                  "stall:at=0,delay_ms=5,every=2"])
def test_engine_round_stall_equals_jax(model, spec):
    from hpc_patterns_tpu.models import serving as jsrv
    from hpc_patterns_tpu_torch.models import serving as tsrv

    jcfg, tcfg, jp, tp = model
    clean, _, none = _stalled_run(tsrv, tp, tcfg, chaos, None, device="cpu")
    assert none == []
    got, dt, fired = _stalled_run(tsrv, tp, tcfg, chaos, spec, device="cpu")
    jgot, _, jfired = _stalled_run(jsrv, jp, jcfg, jchaos, spec)
    # the same rounds stalled in both packages, and a stalled host is a
    # latency fault, not a correctness one
    assert fired and fired == jfired
    assert all(site == "engine_round" for site, _, _ in fired)
    np.testing.assert_array_equal(got, clean)
    np.testing.assert_array_equal(got, jgot)
    if "120" in spec:
        assert fired == [("engine_round", 1, "stall")] and dt >= 0.12


def _plane(pkg, params, cfg, roles, emit, device=None):
    if pkg == "port":
        from hpc_patterns_tpu_torch.models.serving import EngineCore
        from hpc_patterns_tpu_torch.serving_plane.router import (
            Replica,
            ServingPlane,
        )
        kw = {"device": "cpu"}
    else:
        from hpc_patterns_tpu.models.serving import EngineCore
        from hpc_patterns_tpu.serving_plane.router import (
            Replica,
            ServingPlane,
        )
        kw = {}
    reps = [Replica(EngineCore(params, cfg, slots=2, pool_pages=8,
                               pages_per_seq=4, page_size=8, chunk=2, **kw),
                    name=f"r{i}", role=role)
            for i, role in enumerate(roles)]
    return ServingPlane(reps, emit=emit)


def _die_run(pkg, params, cfg, mod, spec, roles=("both", "both")):
    ev = []
    plane = _plane(pkg, params, cfg, roles, lambda **r: ev.append(r))
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 64, size=int(rng.choice([5, 9])))
             .astype(np.int32), int(rng.choice([4, 8, 12])))
            for _ in range(8)]
    ids = [plane.submit(p, b) for p, b in reqs]
    mod.configure(spec)
    try:
        got = plane.run()
        fired = [(e["site"], e["index"], e["kind"], e["rank"])
                 for e in mod.injections()]
    finally:
        mod.reset()
    return plane, ids, reqs, got, fired, ev


def test_replica_round_death_equals_jax(model):
    jcfg, tcfg, jp, tp = model
    spec = "die:replica=1,at=1,site=replica_round"
    tplane, tids, reqs, tgot, tfired, tev = _die_run("port", tp, tcfg,
                                                     chaos, spec)
    jplane, jids, _, jgot, jfired, jev = _die_run("jax", jp, jcfg, jchaos,
                                                  spec)
    assert tfired == jfired == [("replica_round", 1, "die", 1)]
    assert tplane.deaths == jplane.deaths == ["r1"]
    assert tplane.shed_on_death == jplane.shed_on_death > 0
    shed = [e["seq_id"] for e in tev if e["kind"] == "plane_shed"]
    assert shed == [e["seq_id"] for e in jev if e["kind"] == "plane_shed"]
    (death,) = [e for e in tev if e["kind"] == "plane_replica_death"]
    (jdeath,) = [e for e in jev if e["kind"] == "plane_replica_death"]
    assert death == {k: jdeath[k] for k in death}
    # every casualty shed and counted; every survivor's tokens exact
    from hpc_patterns_tpu_torch.models.decode import paged_generate

    for rid, (p, b) in zip(tids, reqs):
        ps = tplane.stats[rid]
        assert ps["outcome"] == jplane.stats[rid]["outcome"]
        if rid in shed:
            assert ps["outcome"] == "shed" and tgot[rid].size == 0
            continue
        want = paged_generate(tp, torch.from_numpy(p)[None], tcfg, b,
                              page_size=8, device="cpu")[0].numpy()
        np.testing.assert_array_equal(tgot[rid], want)
        np.testing.assert_array_equal(tgot[rid], np.asarray(jgot[rid]))
    assert len(shed) == tplane.shed_on_death


def test_decode_replica_death_is_loud_as_in_jax(model):
    # a fixed disaggregated plane that loses its only decode replica
    # sheds what it held (the bundles parked toward it included) and then
    # cannot place the prefill replica's rows anywhere: both packages
    # stop with the deadlock error rather than serve them silently
    jcfg, tcfg, jp, tp = model
    spec = "die:replica=1,at=2,site=replica_round"
    out = {}
    for pkg, params, cfg, mod in (("port", tp, tcfg, chaos),
                                  ("jax", jp, jcfg, jchaos)):
        ev = []
        plane = _plane(pkg, params, cfg, ("prefill", "decode"),
                       lambda **r: ev.append(r))
        for i in range(6):
            plane.submit(np.arange(5 + i, dtype=np.int32), 6)
        mod.configure(spec)
        try:
            with pytest.raises(RuntimeError, match="deadlock"):
                plane.run()
        finally:
            mod.reset()
        out[pkg] = (plane.deaths, plane.shed_on_death,
                    [e["seq_id"] for e in ev if e["kind"] == "plane_shed"],
                    [e for e in ev if e["kind"] == "plane_replica_death"])
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][0] == ["r1"] and out["port"][1] > 0
    (d,), (jd,) = out["port"][3], out["jax"][3]
    assert d == {k: jd[k] for k in d}
