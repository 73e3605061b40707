"""The port's metrics registry (``hpc_patterns_tpu_torch.harness.metrics``)
held against the JAX package's (``hpc_patterns_tpu.harness.metrics``) on
the same inputs, made from numpy seeds: bucket index and value,
percentiles of the same observations, snapshots loaded across the two
packages both ways, the disabled no-op singleton, nested and thread-local
spans, the ``torch.profiler`` mirror, and ``harness.timing.measure``'s
phases. Exact equality throughout: both modules compute in Python
floats.
"""

import json
import math
import threading

import numpy as np
import pytest

from hpc_patterns_tpu.harness import metrics as jm
from hpc_patterns_tpu_torch.harness import metrics as tm
from hpc_patterns_tpu_torch.harness import timing as ttiming

SEEDS = [0, 1, 2, 3]


def _samples(seed, n=200):
    """Log-uniform samples over 1e-10..1e4: past both ends of the
    layout, so the clamping buckets are exercised too."""
    rng = np.random.default_rng(seed)
    return [float(v) for v in 10.0 ** rng.uniform(-10, 4, n)]


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    tm.configure(enabled=False)
    jm.configure(enabled=False)


class TestBuckets:
    def test_layout_is_the_jax_layout(self):
        assert tm.BUCKET_LAYOUT == jm.BUCKET_LAYOUT
        assert tm.N_BUCKETS == jm.N_BUCKETS

    @pytest.mark.parametrize("seed", SEEDS)
    def test_bucket_index_and_value(self, seed):
        for v in _samples(seed) + [0.0, -1.0, 1e-9, 1e3]:
            i = tm.bucket_index(v)
            assert i == jm.bucket_index(v)
            assert tm.bucket_value(i) == jm.bucket_value(i)


class TestHistogram:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_percentiles_equal_jax(self, seed):
        th, jh = tm.Histogram(), jm.Histogram()
        for v in _samples(seed):
            th.observe(v)
            jh.observe(v)
        for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
            assert th.percentile(q) == jh.percentile(q)
        assert th.snapshot() == jh.snapshot()

    def test_nonfinite_samples_dropped_like_jax(self):
        th, jh = tm.Histogram(), jm.Histogram()
        for v in (1.0, math.nan, math.inf, -math.inf, 2.0):
            th.observe(v)
            jh.observe(v)
        assert th.snapshot() == jh.snapshot() and th.count == 2

    def test_empty_percentile_nan(self):
        assert math.isnan(tm.Histogram().percentile(50))

    @pytest.mark.parametrize("seed", SEEDS[:2])
    def test_snapshot_port_to_jax(self, seed):
        th = tm.Histogram()
        for v in _samples(seed):
            th.observe(v)
        snap = json.loads(json.dumps(th.snapshot()))
        jh = jm.Histogram.from_snapshot(snap)
        for q in (50, 95, 99):
            assert jh.percentile(q) == th.percentile(q)

    @pytest.mark.parametrize("seed", SEEDS[:2])
    def test_snapshot_jax_to_port(self, seed):
        jh = jm.Histogram()
        for v in _samples(seed):
            jh.observe(v)
        snap = json.loads(json.dumps(jh.snapshot()))
        th = tm.Histogram.from_snapshot(snap)
        for q in (50, 95, 99):
            assert th.percentile(q) == jh.percentile(q)

    def test_merge_equals_jax(self):
        a, b = _samples(5, 50), _samples(6, 70)
        tms = [tm.Histogram(), tm.Histogram()]
        jms = [jm.Histogram(), jm.Histogram()]
        for h, src in ((tms[0], a), (tms[1], b), (jms[0], a), (jms[1], b)):
            for v in src:
                h.observe(v)
        tms[0].merge(tms[1])
        jms[0].merge(jms[1])
        assert tms[0].snapshot() == jms[0].snapshot()


def _drive(mod, seed):
    """The same instrument calls on a fresh enabled registry of ``mod``."""
    reg = mod.configure(enabled=True)
    rng = np.random.default_rng(seed)
    for i in range(20):
        reg.counter("c.a").inc(int(rng.integers(1, 5)))
        reg.gauge("g.x").set(float(rng.normal()))
        reg.histogram("h.t").observe(float(rng.lognormal(-5, 2)))
    reg.gauge("g.nan").set(math.nan)
    reg.counter("c.b").inc(2.5)
    return reg


class TestRegistry:
    @pytest.mark.parametrize("seed", SEEDS[:2])
    def test_registry_snapshot_equals_jax(self, seed):
        assert _drive(tm, seed).snapshot() == _drive(jm, seed).snapshot()

    @pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
    def test_snapshot_loads_in_the_other_report(self, direction):
        from hpc_patterns_tpu.harness import report as jreport
        from hpc_patterns_tpu_torch.harness import report as treport

        src, dst = ((tm, jreport) if direction == "port_to_jax"
                    else (jm, treport))
        snap = json.loads(json.dumps(_drive(src, 7).snapshot()))
        agg = dst.aggregate([{"kind": "metrics", **snap}])
        assert agg["counters"] == snap["counters"]
        assert agg["n_layout_skipped"] == 0
        h = agg["histograms"]["h.t"]
        want = src.Histogram.from_snapshot(snap["histograms"]["h.t"])
        assert h.percentile(99) == want.percentile(99)
        assert agg["gauges"]["g.nan"].n == 1

    def test_nonfinite_gauge_is_strict_json_null(self):
        reg = tm.configure(enabled=True)
        reg.gauge("loss").set(math.nan)
        text = json.dumps(reg.snapshot(), allow_nan=False)
        assert json.loads(text)["gauges"]["loss"]["last"] is None

    def test_disabled_registry_is_the_shared_noop(self):
        reg = tm.configure(enabled=False)
        assert reg.counter("a") is reg.gauge("b") is reg.histogram("c") \
            is tm._NOOP
        reg.counter("a").inc()
        reg.gauge("b").set(1.0)
        reg.histogram("c").observe(1.0)
        assert reg.snapshot()["counters"] == {}
        assert reg.snapshot()["histograms"] == {}

    def test_disabled_span_is_the_shared_nullcontext(self):
        reg = tm.configure(enabled=False)
        assert reg.span("a") is reg.span("b") is tm._NULL_SPAN
        assert tm.span("c") is tm._NULL_SPAN

    def test_configure_installs_a_fresh_registry(self):
        a = tm.configure(enabled=True)
        a.counter("x").inc()
        b = tm.configure(enabled=True)
        assert a is not b and tm.get_metrics() is b
        assert b.snapshot()["counters"] == {}


class TestSpans:
    def test_nested_spans_build_paths_like_jax(self):
        for mod in (tm, jm):
            reg = mod.configure(enabled=True)
            with reg.span("outer", k=1):
                with reg.span("inner"):
                    pass
                with reg.span("inner"):
                    pass
        t = tm.get_metrics().snapshot()["histograms"]
        j = jm.get_metrics().snapshot()["histograms"]
        assert sorted(t) == sorted(j) == ["span.outer", "span.outer/inner"]
        assert t["span.outer/inner"]["count"] == 2

    def test_span_stack_survives_exceptions(self):
        reg = tm.configure(enabled=True)
        with pytest.raises(RuntimeError):
            with reg.span("a"):
                raise RuntimeError("boom")
        with reg.span("b"):
            pass
        assert sorted(reg.snapshot()["histograms"]) == ["span.a", "span.b"]

    def test_spans_are_thread_local(self):
        reg = tm.configure(enabled=True)
        gate = threading.Barrier(2)

        def worker(name):
            with reg.span(name):
                gate.wait()  # both spans open at once
                with reg.span("leaf"):
                    gate.wait()

        threads = [threading.Thread(target=worker, args=(n,))
                   for n in ("t0", "t1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(reg.snapshot()["histograms"]) == [
            "span.t0", "span.t0/leaf", "span.t1", "span.t1/leaf"]

    def test_mirror_annotates_the_torch_profiler(self):
        import torch

        reg = tm.configure(enabled=False, mirror_traces=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with reg.span("mirrored.phase", n=3):
                torch.ones(4).sum()
        names = {e.name for e in prof.events()}
        assert "mirrored.phase" in names
        assert reg.snapshot()["histograms"] == {}  # recording stays off


class TestMeasure:
    def test_disabled_measure_records_nothing(self):
        reg = tm.configure(enabled=False)
        r = ttiming.measure(lambda: None, repetitions=3, warmup=1)
        assert len(r.times_s) == 3 and reg.snapshot()["histograms"] == {}

    def test_enabled_measure_phases_match_jax(self):
        from hpc_patterns_tpu.harness import timing as jtiming

        names = {}
        for mod, tmod in ((tm, ttiming), (jm, jtiming)):
            reg = mod.configure(enabled=True)
            tmod.measure(lambda: None, repetitions=4, warmup=2,
                         label="probe")
            snap = reg.snapshot()["histograms"]
            names[mod] = {k: v["count"] for k, v in snap.items()}
        assert names[tm] == names[jm] == {
            "probe.rep_s": 4, "span.probe.timed": 1,
            "span.probe.warmup": 1}

    def test_forced_and_amortized_labels_like_jax(self):
        import torch

        reg = tm.configure(enabled=True)
        ttiming.amortized_seconds(lambda n: torch.ones(n), iters=4,
                                  repetitions=2, label="amo")
        assert sorted(reg.snapshot()["histograms"]) == [
            "amo.base.rep_s", "amo.many.rep_s", "span.amo.base.timed",
            "span.amo.base.warmup", "span.amo.many.timed",
            "span.amo.many.warmup"]


class TestRunLog:
    def test_snapshot_roundtrips_through_the_runlog(self, tmp_path):
        from hpc_patterns_tpu_torch.harness.runlog import RunLog

        reg = _drive(tm, 3)
        path = tmp_path / "run.jsonl"
        RunLog(path).emit(kind="metrics", **reg.snapshot())
        rec = json.loads(path.read_text())
        assert rec["counters"] == reg.snapshot()["counters"]
        h = tm.Histogram.from_snapshot(rec["histograms"]["h.t"])
        assert h.percentile(50) == reg.histogram("h.t").percentile(50)
