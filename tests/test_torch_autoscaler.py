"""The port's elastic plane (``hpc_patterns_tpu_torch.serving_plane.
autoscaler``: ``WarmParamPool``, ``ElasticServingPlane``) on the CPU — JAX's
six ``TestElasticPlane`` tests of ``tests/test_autoscaler.py`` under the
same names, on JAX's ``BASE``/``ENG`` geometry and JAX's
``init_params(PRNGKey(0))`` carried over with ``models.convert``. They are
written out here rather than run through ``tests/_torch_parity.py``: their
bodies build inputs with ``jax.random``/``jnp``.

Greedy streams must equal JAX's standalone ``paged_generate`` byte for byte
in f32; sampled streams the port's standalone with each row's key (the
packages' samplers agree in law only).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdecode  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.harness import chaos as chaoslib  # noqa: E402
from hpc_patterns_tpu_torch.harness import slo as slolib  # noqa: E402
from hpc_patterns_tpu_torch.harness import trace as tracelib  # noqa: E402
from hpc_patterns_tpu_torch.memory import kinds as kindslib  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.models.decode import (  # noqa: E402
    paged_generate,
)
from hpc_patterns_tpu_torch.models.serving import EngineCore  # noqa: E402
from hpc_patterns_tpu_torch.serving_plane.autoscaler import (  # noqa: E402
    SPINUP_TRACK_BASE,
    SPINUP_TRACKS,
    Autoscaler,
    AutoscalerPolicy,
    ElasticServingPlane,
    WarmParamPool,
)
from hpc_patterns_tpu_torch.serving_plane.router import (  # noqa: E402
    Replica,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
ENG = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8,
           chunk=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny models run fastest on one intra-op thread (and a parallel test
    run's workers do not spin on each other's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg = jtf.TransformerConfig(**BASE)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return ttf.TransformerConfig(**BASE, decode_attn="flash"), tp, jcfg, jp


def _jax_standalone(jcfg, jp, prompt, max_new):
    return np.asarray(jdecode.paged_generate(
        jp, jax.numpy.asarray(prompt, jax.numpy.int32)[None, :], jcfg,
        max_new, page_size=8))[0]


def _standalone(params, cfg, prompt, max_new, **kw):
    return paged_generate(
        params, torch.from_numpy(np.asarray(prompt, np.int32))[None, :],
        cfg, max_new, page_size=8, device="cpu", **kw)[0].numpy()


def _engine(params, cfg, **skw):
    return EngineCore(params, cfg, **ENG, **skw, device="cpu")


def _elastic(cfg, params, *, n_replicas=2, policy=None, **skw):
    pool = WarmParamPool(params)
    return ElasticServingPlane(
        [Replica(_engine(params, cfg, **skw), name=f"r{i}")
         for i in range(n_replicas)],
        engine_factory=lambda p: _engine(p, cfg, **skw), warm_pool=pool,
        autoscaler=Autoscaler(policy or AutoscalerPolicy(
            min_replicas=n_replicas, max_replicas=n_replicas + 1,
            up_queue=1.5, cooldown_rounds=2)),
        slo={0: slolib.SLOTarget()})


class TestElasticPlane:
    def test_death_resume_byte_exact_greedy_and_spinup(self, setup):
        cfg, params, jcfg, jp = setup
        rng = np.random.RandomState(1)
        reqs = [(rng.randint(0, 64, size=6).astype(np.int32), 6)
                for _ in range(4)]
        chaoslib.configure("die:replica=1,at=1,site=replica_round")
        try:
            plane = _elastic(cfg, params)
            ids = [plane.submit(p, m) for p, m in reqs]
            got = plane.run()
            died = [e for e in chaoslib.injections()
                    if e["kind"] == "die"]
        finally:
            chaoslib.reset()
        assert died and died[0]["rank"] == 1  # the replica ordinal
        assert plane.deaths == ["r1"]
        assert plane.shed_on_death == 0 and plane.resumed
        # the min-clamp replaced the dead replica on WARM params and the
        # spin-up span was measured
        assert len(plane.spinup_s) >= 1
        assert all(s > 0 for s in plane.spinup_s)
        for rid, (p, m) in zip(ids, reqs):
            assert plane.stats[rid]["outcome"] == "ok"
            np.testing.assert_array_equal(
                got[rid], _jax_standalone(jcfg, jp, p, m),
                err_msg=f"rid {rid}")

    def test_death_resume_byte_exact_sampled_key_checkpoint(self, setup):
        # an INVOLUNTARY death resumes sampled streams exactly: the plane
        # checkpoints each row's key every round and the resume seeds the
        # survivor's admission with it
        cfg, params, _, _ = setup
        skw = dict(temperature=0.8, top_k=8, seed=0)
        rng = np.random.RandomState(5)
        reqs = [(rng.randint(0, 64, size=6).astype(np.int32), 8)
                for _ in range(4)]
        chaoslib.configure("die:replica=0,at=1,site=replica_round")
        try:
            plane = _elastic(cfg, params, **skw)
            ids = [plane.submit(p, m) for p, m in reqs]
            got = plane.run()
        finally:
            chaoslib.reset()
        assert plane.deaths == ["r0"] and plane.resumed
        assert plane.shed_on_death == 0
        key_src = plane.replicas[1].engine
        for rid, (p, m) in zip(ids, reqs):
            assert plane.stats[rid]["outcome"] == "ok"
            np.testing.assert_array_equal(
                got[rid],
                _standalone(params, cfg, p, m,
                            key=key_src.request_key(rid),
                            temperature=0.8, top_k=8),
                err_msg=f"rid {rid}")
        # the resumed streams include a row that had already emitted
        assert any(plane.stats[r]["preemptions"] > 0
                   for r in plane.resumed)

    def test_scale_down_drains_by_migration_nothing_sheds(self, setup):
        # a voluntary drain: the victim stops receiving routing, its
        # in-flight rows EXPORT to survivors, and it retires once empty —
        # exact, zero shed
        cfg, params, jcfg, jp = setup
        rng = np.random.RandomState(9)
        reqs = [(rng.randint(0, 64, size=6).astype(np.int32), 12)
                for _ in range(3)]
        plane = _elastic(
            cfg, params, n_replicas=3,
            policy=AutoscalerPolicy(min_replicas=1, max_replicas=3,
                                    up_queue=50.0, down_queue=49.0,
                                    cooldown_rounds=0, window=1))
        ids = [plane.submit(p, m) for p, m in reqs]
        got = plane.run()
        assert plane.drained and plane.retired
        assert plane.shed_on_death == 0
        assert plane.migrations >= 1  # in-flight rows moved, not shed
        for rid, (p, m) in zip(ids, reqs):
            assert plane.stats[rid]["outcome"] == "ok"
            np.testing.assert_array_equal(
                got[rid], _jax_standalone(jcfg, jp, p, m),
                err_msg=f"rid {rid}")

    def test_drain_never_strands_a_role(self, setup):
        # the last prefill-capable replica is not a drain candidate
        cfg, params, jcfg, jp = setup
        pool = WarmParamPool(params)
        plane = ElasticServingPlane(
            [Replica(_engine(params, cfg), name="p", role="prefill"),
             Replica(_engine(params, cfg), name="d", role="decode")],
            engine_factory=lambda p: _engine(p, cfg),
            warm_pool=pool,
            autoscaler=Autoscaler(AutoscalerPolicy(
                min_replicas=1, max_replicas=2, up_queue=50.0,
                down_queue=49.0, cooldown_rounds=0, window=1)),
            slo={0: slolib.SLOTarget()})
        rid = plane.submit(np.arange(5, dtype=np.int32), 3)
        got = plane.run()
        assert not plane.drained  # neither role may be stranded
        np.testing.assert_array_equal(
            got[rid],
            _jax_standalone(jcfg, jp, np.arange(5, dtype=np.int32), 3))

    def test_spinup_window_recorded_under_trace(self, setup):
        cfg, params, _, _ = setup
        rng = np.random.RandomState(11)
        reqs = [(rng.randint(0, 64, size=6).astype(np.int32), 6)
                for _ in range(4)]
        tracelib.configure(enabled=True)
        chaoslib.configure("die:replica=1,at=1,site=replica_round")
        try:
            plane = _elastic(cfg, params)
            for p, m in reqs:
                plane.submit(p, m)
            plane.run()
            events = list(tracelib.active().events)
        finally:
            chaoslib.reset()
            tracelib.configure(enabled=False)
        assert len(plane.spinup_s) >= 1
        # each spin-up is one dispatch -> completion window on the spinup
        # subtrack band
        wins = [e for e in events
                if e[0] == "X" and e[2] == "plane.spinup"]
        assert len(wins) == len(plane.spinup_s)
        lo = tracelib.TID_DEVICE + SPINUP_TRACK_BASE
        assert all(lo <= e[4] < lo + SPINUP_TRACKS for e in wins)
        assert all(e[5] > 0 for e in wins)  # a real measured span

    def test_warm_pool_is_residency_backed(self, setup):
        _, params, _, _ = setup
        pool = WarmParamPool(params)
        # the parked copy lives in the HOST tier of a real manager
        assert pool.manager.host_blocks_used() > 0
        before = pool.manager.prefetch_bytes
        payload, handle = pool.pull()
        pool.complete(handle)
        assert pool.manager.prefetch_bytes > before
        # pulled bytes are the parked bytes, exactly, in new tensors
        for a, b in zip(kindslib.tree_tensors(payload),
                        kindslib.tree_tensors(params)):
            assert a.data_ptr() != b.data_ptr()
            assert torch.equal(a, b)
