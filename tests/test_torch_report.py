"""The port's run-log report (``hpc_patterns_tpu_torch.harness.report``)
held against the JAX package's: logs written by the two packages from the
same seeded instrument calls (metrics snapshot, flight-recorder snapshot
at a fixed clock, request trace, results) — JAX's report over the port's
log equals the port's report over JAX's log, and each package's log
renders the same in both reports; a real app log of each package renders
the same in both. Tables are compared after replacing the package name
in the CLI hints they print.
"""

import itertools
import json
import time

import numpy as np
import pytest

from hpc_patterns_tpu.harness import metrics as jm
from hpc_patterns_tpu.harness import report as jreport
from hpc_patterns_tpu.harness import reqtrace as jrt
from hpc_patterns_tpu.harness import trace as jt
from hpc_patterns_tpu.harness.runlog import RunLog as JRunLog
from hpc_patterns_tpu_torch.harness import metrics as tm
from hpc_patterns_tpu_torch.harness import report as treport
from hpc_patterns_tpu_torch.harness import reqtrace as trt
from hpc_patterns_tpu_torch.harness import trace as tt
from hpc_patterns_tpu_torch.harness.runlog import RunLog as TRunLog

PACKAGES = {"port": (tm, tt, trt, TRunLog), "jax": (jm, jt, jrt, JRunLog)}


@pytest.fixture(autouse=True)
def _reset():
    yield
    for m, t, r, _ in PACKAGES.values():
        m.configure(enabled=False)
        t.configure(enabled=False)
        r.reset()


def _norm(text: str) -> str:
    return text.replace("hpc_patterns_tpu_torch", "hpc_patterns_tpu")


def _write_log(which, path, seed, monkeypatch):
    """One package's log of the same seeded run: results, a metrics
    snapshot, a trace snapshot at a fixed clock and a reqtrace record."""
    m, t, r, RunLog = PACKAGES[which]
    rng = np.random.default_rng(seed)
    steps = itertools.accumulate(rng.uniform(1e-5, 1e-3, 5000),
                                 initial=50.0)
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(steps)))
    reg = m.configure(enabled=True)
    rec = t.TraceRecorder()
    rtr = r.ReqTrace()
    log = RunLog(path)
    for i in range(8):
        with reg.span("serve.round"):
            reg.counter("serve.tokens").inc(int(rng.integers(1, 9)))
            reg.gauge("serve.queue_depth").set(int(rng.integers(0, 5)))
            reg.histogram("serve.ttft_s").observe(
                float(rng.lognormal(-4, 1)))
        td = rec.mark_dispatch("serve.chunk", {"i": i})
        rec.mark_complete("serve.chunk", td, {"i": i})
        rtr.begin_request(i, float(i))
        rtr.stamp_transition(i, "decode", float(i) + 0.5)
        rtr.finish_request(i, float(i) + 1.0)
        log.emit(kind="result", name=f"p{i}", success=i != 3)
    rec.compile_event("build", 0.25)
    log.emit(kind="metrics", **reg.snapshot())
    log.emit(kind="trace", **rec.snapshot())
    stats = {i: {"t_submit": float(i), "t_first": float(i) + 0.5,
                 "t_finish": float(i) + 1.0, "tokens": 2, "outcome": "ok"}
             for i in range(8)}
    log.emit(kind="reqtrace", **rtr.snapshot(stats))
    return path


def _render(report_mod, path):
    recs = report_mod.load_records([path])
    return _norm(report_mod.format_report(report_mod.aggregate(recs)))


class TestCrossPackage:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_jax_report_of_port_log_equals_port_report_of_jax_log(
            self, seed, tmp_path, monkeypatch):
        port_log = _write_log("port", tmp_path / "port.jsonl", seed,
                              monkeypatch)
        jax_log = _write_log("jax", tmp_path / "jax.jsonl", seed,
                             monkeypatch)
        got = _render(jreport, port_log)
        assert got == _render(treport, jax_log)
        assert "results: 7 SUCCESS / 1 FAILURE" in got
        assert "serve.ttft_s" in got and "span.serve.round" in got
        assert "reqtrace: 8 request(s), attribution coverage 100.0%" in got

    @pytest.mark.parametrize("which", ["port", "jax"])
    def test_a_log_renders_the_same_in_both(self, which, tmp_path,
                                            monkeypatch):
        log = _write_log(which, tmp_path / "run.jsonl", 5, monkeypatch)
        assert _render(treport, log) == _render(jreport, log)

    def test_aggregate_equal(self, tmp_path, monkeypatch):
        log = _write_log("port", tmp_path / "run.jsonl", 3, monkeypatch)
        recs = treport.load_records([log])
        a, b = treport.aggregate(recs), jreport.aggregate(recs)
        assert a["counters"] == b["counters"] and a["kinds"] == b["kinds"]
        assert {k: h.snapshot() for k, h in a["histograms"].items()} == \
            {k: h.snapshot() for k, h in b["histograms"].items()}
        assert a["traces"] == b["traces"] and a["reqtraces"] == b[
            "reqtraces"]


def _app_log(tmp_path, which):
    """A real pingpong run's log in ``which`` package, on the CPU."""
    path = tmp_path / f"{which}.jsonl"
    argv = ["--min-p", "3", "-p", "4", "--repetitions", "2", "--warmup",
            "1", "--metrics", "--trace", "--log", str(path)]
    if which == "port":
        from hpc_patterns_tpu_torch.apps import pingpong_app

        assert pingpong_app.main(argv + ["--device", "cpu", "--world",
                                         "4"]) == 0
    else:
        from hpc_patterns_tpu.apps import pingpong_app

        assert pingpong_app.main(argv + ["--backend", "cpu"]) == 0
    return path


class TestAppLogs:
    @pytest.mark.parametrize("which", ["port", "jax"])
    def test_app_log_renders_the_same_in_both(self, which, tmp_path):
        log = _app_log(tmp_path, which)
        got = _render(treport, log)
        assert got == _render(jreport, log)
        assert "pingpong.rep_s" in got and "comm.pingpong" in got
        assert "merged 1 metrics snapshot(s)" in got

    def test_port_app_log_has_the_jax_app_tables(self, tmp_path):
        port = treport.aggregate(treport.load_records(
            [_app_log(tmp_path, "port")]))
        jax_ = jreport.aggregate(jreport.load_records(
            [_app_log(tmp_path, "jax")]))
        assert sorted(port["histograms"]) == sorted(jax_["histograms"])
        assert sorted(port["gauges"]) == sorted(jax_["gauges"])
        assert port["kinds"].keys() == jax_["kinds"].keys()


class TestCli:
    def test_cli_prints_the_table(self, tmp_path, monkeypatch, capsys):
        log = _write_log("port", tmp_path / "run.jsonl", 0, monkeypatch)
        assert treport.main([str(log)]) == 0
        out = capsys.readouterr().out
        assert "counter" in out and "histogram" in out
        assert "python -m hpc_patterns_tpu_torch.harness.trace" in out

    def test_cli_empty_input_fails(self, tmp_path, capsys):
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert treport.main([str(empty)]) == 2

    def test_truncated_last_line_is_skipped(self, tmp_path):
        path = tmp_path / "run.jsonl"
        path.write_text('{"kind": "result", "success": true}\n{"kind": "me')
        assert len(treport.load_records([path])) == 1

    def test_layout_mismatch_skips_histograms(self, tmp_path, capsys):
        reg = tm.configure(enabled=True)
        reg.histogram("h").observe(1.0)
        reg.counter("c").inc()
        snap = reg.snapshot()
        snap["bucket_layout"] = {"lo_decade": -6, "hi_decade": 3,
                                 "per_decade": 4}
        path = tmp_path / "run.jsonl"
        path.write_text(json.dumps({"kind": "metrics", **snap}) + "\n")
        assert treport.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "different bucket layout" in out and "c " in out
