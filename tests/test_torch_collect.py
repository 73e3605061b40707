"""The port's cross-rank trace collection (``hpc_patterns_tpu_torch.
harness.collect``) held against the JAX package's: JAX's own tier-1
bodies (``tests/test_collect.py``) run unchanged on the port's module;
rank snapshots written by both packages' flight recorders at fixed
clocks (device windows of matched collectives, sync anchors, the
collective-schedule chains) merge to the same Chrome JSON, rollup,
``dumps_rollup`` bytes and summary in both; the CLIs write the same files
from a directory of per-rank files; real traced app logs of both
packages merge the same; the port's trace CLI goes through the merge, and
both reports render the ``kind=trace_merged`` record with its
``rollup_out``.
"""

import itertools
import json
import os

import numpy as np
import pytest

from hpc_patterns_tpu.analysis import runtime as jruntime
from hpc_patterns_tpu.harness import collect as jcollect
from hpc_patterns_tpu.harness import report as jreport
from hpc_patterns_tpu.harness import trace as jt
from hpc_patterns_tpu_torch.harness import collect as tcollect
from hpc_patterns_tpu_torch.harness import report as treport
from hpc_patterns_tpu_torch.harness import trace as tt

import _torch_parity as parity

BODIES = parity.load("test_collect")
CASES = parity.cases(BODIES, ["TestClockAlignment", "TestMerge", "TestCLI",
                              "TestUnionSeconds", "TestScheduleCheck"])
#: each package's recorder module and its collective-schedule module
RECORDERS = {"port": (tt, tt), "jax": (jt, jruntime)}


class FakeClock:
    """A deterministic ``time.perf_counter``: seeded increments."""

    def __init__(self, seed):
        steps = np.random.default_rng(seed).uniform(1e-6, 1e-3, 10_000)
        self._it = itertools.accumulate(steps, initial=1000.0)

    def __call__(self):
        return float(next(self._it))


@pytest.fixture(autouse=True)
def _reset():
    yield
    for t, chain in RECORDERS.values():
        t.configure(enabled=False)
        chain.reset_collective_schedule()


@pytest.mark.parametrize("cls,method", CASES)
def test_jax_body_on_the_port(cls, method, request):
    parity.call(BODIES, cls, method, request)


def _rank_snapshot(which, rank, n_ranks, seed, monkeypatch, *, ops=6,
                   diverge=False):
    """One rank's snapshot from ``which`` package's recorder: spans, a
    device window of each collective (args ``seq``, skewed by rank), the
    same collectives in the schedule chain (one op renamed on a divergent
    rank), a request segment and two barrier anchors."""
    t, chain = RECORDERS[which]
    monkeypatch.setenv("HPCPAT_PROCESS_ID", str(rank))
    monkeypatch.setenv("HPCPAT_NUM_PROCESSES", str(n_ranks))
    monkeypatch.setattr("time.perf_counter", FakeClock(seed * 10 + rank))
    chain.reset_collective_schedule()
    rec = t.TraceRecorder()
    rec.mark_sync("barrier")
    for k in range(ops):
        rec.span_begin("comm.allreduce", {"seq": k})
        op = "allgather" if diverge and rank == 1 and k == 3 else \
            "allreduce"
        chain.record_collective(op, k, shape=(4, 1024),
                                dtype="float32", algorithm="fused")
        d = rec.mark_dispatch("comm.allreduce", {"seq": k})
        for _ in range(rank + k % 3):
            rec.span_begin("comm.skew", {})
            rec.span_end("comm.skew")
        rec.mark_complete("comm.allreduce", d, {"seq": k})
        rec.span_end("comm.allreduce")
    if rank == 0:  # a collective only one rank saw
        d = rec.mark_dispatch("comm.pingpong", {"seq": 0})
        rec.mark_complete("comm.pingpong", d, {"seq": 0})
    rec.mark_request_segment(rank, "queued", 1000.0, 1000.5, {"seq": 0})
    rec.mark_sync("barrier")
    snap = rec.snapshot()
    return snap


def _ranks(monkeypatch, seed, order=("port", "jax"), **kw):
    n = len(order)
    return [_rank_snapshot(which, r, n, seed, monkeypatch, **kw)
            for r, which in enumerate(order)]


@pytest.mark.parametrize("order", [("port", "jax"), ("jax", "port"),
                                   ("port", "port", "jax")])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_equal(seed, order, monkeypatch):
    snaps = _ranks(monkeypatch, seed, order)
    got, want = tcollect.merge(snaps), jcollect.merge(snaps)
    assert got == want
    assert tcollect.dumps_rollup(got["rollup"]) == \
        jcollect.dumps_rollup(want["rollup"])
    assert tcollect.format_rollup(got["rollup"]) == \
        jcollect.format_rollup(want["rollup"])
    r = got["rollup"]
    # one lane a rank, the two chains (one from each package) agree, the
    # six allreduces matched across every rank with paired flow events
    assert r["n_ranks"] == len(order) and r["align"]["method"] == "sync"
    assert r["schedule"]["verdict"] == "consistent"
    assert r["n_matched"] == 6 and r["n_unmatched"] == 1
    flows = [e for e in got["chrome"]["traceEvents"]
             if e.get("cat") == "collective"]
    by_id = {}
    for e in flows:
        by_id.setdefault(e["id"], []).append(e["ph"])
    assert len(by_id) == 6 and all(
        p[0] == "s" and p[-1] == "f" and len(p) == len(order)
        for p in by_id.values())


def test_divergent_schedules_named_the_same(monkeypatch):
    snaps = _ranks(monkeypatch, 3, diverge=True)
    got, want = tcollect.merge(snaps), jcollect.merge(snaps)
    assert got == want
    sched = got["rollup"]["schedule"]
    assert sched["verdict"] == "divergent"
    assert sched["first_divergence"]["index"] == 3
    assert "COLLECTIVE SCHEDULE DIVERGENCE at #3" in \
        tcollect.format_rollup(got["rollup"])


def test_rank_dir_clis_write_the_same(tmp_path, monkeypatch, capsys):
    rank_dir = tmp_path / "ranks"
    for snap in _ranks(monkeypatch, 5):
        tt.write_rank_snapshot(tt.TraceRecorder(), rank_dir, snapshot=snap)
    monkeypatch.undo()
    files = {}
    for name, mod in (("port", tcollect), ("jax", jcollect)):
        out, roll = tmp_path / f"{name}.json", tmp_path / f"{name}.roll"
        log = tmp_path / f"{name}.jsonl"
        assert mod.main([str(rank_dir), "-o", str(out), "--rollup-out",
                         str(roll), "--log", str(log)]) == 0
        printed = capsys.readouterr().out
        for p, tag in ((out, "OUT"), (roll, "ROLL")):
            printed = printed.replace(str(p), tag)
        rec = json.loads(log.read_text())
        rec.pop("ts")
        for k, tag in (("out", "OUT"), ("rollup_out", "ROLL")):
            assert rec[k] == str(out if k == "out" else roll)
            rec[k] = tag
        roll_doc = json.loads(roll.read_text())
        assert roll_doc["out"] == str(out)
        roll_doc.update(out="OUT", rollup_out="ROLL")
        files[name] = (out.read_bytes(), roll_doc, printed, rec)
    assert files["port"] == files["jax"]
    chrome = json.loads(files["port"][0])
    assert len({e["pid"] for e in chrome["traceEvents"]}) == 2
    assert "collective schedules consistent across 2 rank(s)" in \
        files["port"][2]


def test_reports_render_the_trace_merged_record(tmp_path, monkeypatch):
    rank_dir = tmp_path / "ranks"
    for snap in _ranks(monkeypatch, 6):
        tt.write_rank_snapshot(tt.TraceRecorder(), rank_dir, snapshot=snap)
    monkeypatch.undo()
    log = tmp_path / "run.jsonl"
    assert tcollect.main([str(rank_dir), "-o", str(tmp_path / "m.json"),
                          "--rollup-out", str(tmp_path / "r.json"),
                          "--log", str(log)]) == 0
    got = treport.format_report(treport.aggregate(
        treport.load_records([log])))
    want = jreport.format_report(jreport.aggregate(
        jreport.load_records([log])))
    assert got.replace("hpc_patterns_tpu_torch", "hpc_patterns_tpu") == \
        want
    assert "trace_merged: 2 rank(s)" in got
    assert f"rollup: {tmp_path / 'r.json'}" in got


def _app_log(tmp_path, which):
    """A real traced pingpong run's log in ``which`` package (CPU)."""
    path = tmp_path / f"{which}.jsonl"
    argv = ["--min-p", "3", "-p", "4", "--repetitions", "2", "--warmup",
            "1", "--trace", "--log", str(path)]
    if which == "port":
        from hpc_patterns_tpu_torch.apps import pingpong_app

        assert pingpong_app.main(argv + ["--device", "cpu"]) == 0
    else:
        from hpc_patterns_tpu.apps import pingpong_app

        assert pingpong_app.main(argv + ["--backend", "cpu"]) == 0
    return path


def test_real_app_logs_merge_the_same(tmp_path):
    logs = [_app_log(tmp_path, w) for w in ("port", "jax")]
    snaps = tcollect.load_rank_snapshots(logs)
    assert snaps == jcollect.load_rank_snapshots(logs) and len(snaps) == 2
    got, want = tcollect.merge(snaps), jcollect.merge(snaps)
    assert got == want
    assert tcollect.dumps_rollup(got["rollup"]) == \
        jcollect.dumps_rollup(want["rollup"])
    # two single-process logs: two lanes, named by their files
    names = {e["args"]["name"] for e in got["chrome"]["traceEvents"]
             if e["name"] == "process_name"}
    assert names == {"port.jsonl", "jax.jsonl"}


def test_trace_cli_merges_through_collect(tmp_path, capsys):
    log = _app_log(tmp_path, "port")
    out = tmp_path / "t.json"
    assert tt.main([str(log), "-o", str(out)]) == 0
    assert "1 pid lane(s)" in capsys.readouterr().out
    snaps = tt.load_trace_snapshots([log])
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        tcollect.merge(snaps)["chrome"]))
    jout = tmp_path / "j.json"
    assert jt.main([str(log), "-o", str(jout)]) == 0
    assert json.loads(out.read_text()) == json.loads(jout.read_text())


def test_no_snapshots_exits_2_in_both(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcollect.main([str(empty)]) == 2
    port_err = capsys.readouterr().err
    assert jcollect.main([str(empty)]) == 2
    assert "no trace snapshots" in port_err
    assert os.listdir(empty) == []
