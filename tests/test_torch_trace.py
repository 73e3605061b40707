"""The port's flight recorder (``hpc_patterns_tpu_torch.harness.trace``)
held against the JAX package's (``hpc_patterns_tpu.harness.trace``): the
same event sequence at the same (fixed) timestamps gives equal snapshot
events and equal Chrome JSON once the process identity and wall-clock
anchors are normalized; the ring's eviction re-balance; a merge of one
port snapshot with one JAX snapshot in either package; the CLI export from
a run log, by both packages' CLIs; the collective-schedule chain; the
port's build-event counterparts of the jit-cache helpers; the per-rank
handoff; host-clock device windows on the CPU. A window timed by CUDA
events needs a card (marked ``cuda``, skipped here).
"""

import itertools
import json
import time
from collections import Counter

import numpy as np
import pytest

from hpc_patterns_tpu.harness import metrics as jm
from hpc_patterns_tpu.harness import trace as jt
from hpc_patterns_tpu_torch.harness import metrics as tm
from hpc_patterns_tpu_torch.harness import trace as tt


@pytest.fixture(autouse=True)
def _reset():
    yield
    for m, t in ((tm, tt), (jm, jt)):
        m.configure(enabled=False)
        t.configure(enabled=False)


class FakeClock:
    """A deterministic ``time.perf_counter``: seeded increments."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        steps = rng.uniform(1e-6, 1e-3, 10_000)
        self._it = itertools.accumulate(steps, initial=1000.0)

    def __call__(self):
        return float(next(self._it))


def _script(mod, rec, seed):
    """One event sequence: spans (nested, with attrs), device windows on
    the decode and admit tracks, a compile event, a memory counter, a
    request segment and a sync anchor. Windows use the bare-stamp
    protocol both modules share."""
    rng = np.random.default_rng(seed)
    for i in range(int(rng.integers(3, 8))):
        rec.span_begin("serve.round", {"i": i})
        rec.span_begin("serve.round/admit", {})
        t = rec.mark_dispatch("serve.admit", {"slot": i % 3},
                              track=1 + i % 3)
        rec.span_end("serve.round/admit")
        t2 = rec.mark_dispatch("serve.chunk", {"rows": i})
        rec.mark_complete("serve.chunk", t2, {"rows": i})
        rec.mark_complete("serve.admit", t, {"slot": i % 3},
                          track=1 + i % 3)
        rec.span_end("serve.round")
    rec.compile_event("nvcc.x", float(rng.uniform(0.1, 1.0)),
                      args={"source": "x"})
    rec.counter("mem", {"live_bytes": float(rng.integers(1, 1 << 30))})
    rec.mark_request_segment(3, "queued", 1000.0, 1000.5, {"seq": 1})
    rec.mark_sync("barrier")


def _recorded(mod, seed, monkeypatch, capacity=4096):
    monkeypatch.setattr(time, "perf_counter", FakeClock(seed))
    rec = mod.TraceRecorder(capacity=capacity)
    _script(mod, rec, seed)
    return rec


def _normalized(chrome):
    """Chrome JSON without the process identity (process_name arg)."""
    out = []
    for ev in chrome["traceEvents"]:
        ev = dict(ev)
        if ev.get("name") == "process_name":
            ev["args"] = None
        out.append(ev)
    return out


class TestSameSequence:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_events_and_chrome_equal_jax(self, seed, monkeypatch):
        t = _recorded(tt, seed, monkeypatch)
        j = _recorded(jt, seed, monkeypatch)
        assert [list(e) for e in t.events] == [list(e) for e in j.events]
        assert _normalized(t.to_chrome()) == _normalized(j.to_chrome())

    @pytest.mark.parametrize("seed", [0, 1])
    def test_snapshot_schema_equal_jax(self, seed, monkeypatch):
        ts = _recorded(tt, seed, monkeypatch).snapshot()
        js = _recorded(jt, seed, monkeypatch).snapshot()
        assert set(ts) == set(js)
        for key in ("events", "by_cat", "compile", "mem", "n_events",
                    "n_dropped", "capacity", "sync"):
            assert ts[key] == js[key], key
        assert set(ts["collectives"]) == set(js["collectives"])

    @pytest.mark.parametrize("capacity", [5, 9, 17])
    def test_eviction_rebalance_equal_jax(self, capacity, monkeypatch):
        t = _recorded(tt, 4, monkeypatch, capacity=capacity)
        j = _recorded(jt, 4, monkeypatch, capacity=capacity)
        tb, jb = t._balanced_events(), j._balanced_events()
        assert [list(e) for e in tb] == [list(e) for e in jb]
        depth = {}
        for ph, _, name, _, tid, _, _ in tb:
            if ph == "B":
                depth[tid] = depth.get(tid, 0) + 1
            elif ph == "E":
                depth[tid] -= 1
                assert depth[tid] >= 0
        assert all(d == 0 for d in depth.values())
        assert t.snapshot()["n_dropped"] == j.snapshot()["n_dropped"] > 0

    def test_track_labels_equal_jax(self):
        for tid in (tt.TID_DEVICE, tt.TID_DEVICE + 1, tt.TID_DEVICE + 64,
                    tt.TID_DEVICE + 75, tt.TID_DEVICE + 200,
                    tt.TID_COMPILE, tt.TID_COUNTER, tt.TID_REQUEST + 7,
                    1234):
            assert tt._track_label(tid) == jt._track_label(tid)
        assert tt.TRACK_BANDS == jt.TRACK_BANDS
        from hpc_patterns_tpu.serving_plane.service import migration_track

        assert [tt.migration_track(s) for s in range(20)] == [
            migration_track(s) for s in range(20)]


class TestMerge:
    @pytest.mark.parametrize("merger", ["port", "jax"])
    def test_one_port_and_one_jax_snapshot(self, merger, monkeypatch):
        ts = json.loads(json.dumps(
            _recorded(tt, 0, monkeypatch).snapshot()))
        js = json.loads(json.dumps(
            _recorded(jt, 1, monkeypatch).snapshot()))
        mod = tt if merger == "port" else jt
        other = jt if merger == "port" else tt
        got = mod.chrome_from_snapshots([ts, js])
        assert _normalized(got) == _normalized(
            other.chrome_from_snapshots([ts, js]))
        n_x = sum(1 for e in got["traceEvents"] if e["ph"] == "X")
        assert n_x == sum(1 for s in (ts, js) for e in s["events"]
                          if e[0] == "X")
        assert min(e["ts"] for e in got["traceEvents"] if "ts" in e) == 0


def _structure(chrome):
    return Counter((e["name"], e.get("cat"), e["ph"], e.get("tid"))
                   for e in chrome["traceEvents"] if e["ph"] != "M")


class TestCli:
    def _log(self, tmp_path, monkeypatch, n=1):
        from hpc_patterns_tpu_torch.harness.runlog import RunLog

        paths = []
        for i in range(n):
            path = tmp_path / f"run{i}.jsonl"
            log = RunLog(path)
            log.emit(kind="result", name="x", success=True)
            snap = _recorded(tt, i, monkeypatch).snapshot()
            log.emit(kind="trace", **snap)
            paths.append(path)
        return paths

    def test_export_from_a_runlog(self, tmp_path, monkeypatch, capsys):
        (path,) = self._log(tmp_path, monkeypatch)
        out = tmp_path / "t.json"
        assert tt.main([str(path), "-o", str(out)]) == 0
        chrome = json.loads(out.read_text())
        assert "1 pid lane" in capsys.readouterr().out
        snap = tt.load_trace_snapshots([path])[0]
        assert _structure(chrome) == _structure(
            tt.chrome_from_snapshots([snap]))

    def test_both_clis_same_event_structure(self, tmp_path, monkeypatch):
        paths = self._log(tmp_path, monkeypatch, n=2)
        t_out, j_out = tmp_path / "t.json", tmp_path / "j.json"
        assert tt.main([*map(str, paths), "-o", str(t_out)]) == 0
        assert jt.main([*map(str, paths), "-o", str(j_out)]) == 0
        t_chrome = json.loads(t_out.read_text())
        j_chrome = json.loads(j_out.read_text())
        j_events = {"traceEvents": [e for e in j_chrome["traceEvents"]
                                    if e["ph"] in ("B", "E", "i", "X",
                                                   "C", "M")]}
        assert _structure(t_chrome) == _structure(j_events)
        assert len({e["pid"] for e in t_chrome["traceEvents"]}) == 2

    def test_no_trace_records_is_an_error(self, tmp_path, capsys):
        path = tmp_path / "empty.jsonl"
        path.write_text('{"kind": "result"}\n')
        assert tt.main([str(path)]) == 2
        assert "no kind=trace" in capsys.readouterr().err


class TestSchedule:
    def test_chain_digest_equals_jax(self):
        from hpc_patterns_tpu.analysis import runtime as jrt

        t, j = tt.CollectiveSchedule(), jrt.CollectiveSchedule()
        rng = np.random.default_rng(9)
        for seq in range(30):
            kw = dict(shape=(4, int(rng.integers(1, 99))), dtype="float32",
                      axis="x", algorithm=str(rng.choice(["ring", "fused"])))
            assert t.record("allreduce", seq, **kw) == j.record(
                "allreduce", seq, **kw)
        assert t.snapshot() == j.snapshot()

    def test_configure_restarts_the_chain(self):
        tt.record_collective("a", 0)
        tt.configure(enabled=True)
        assert tt.collective_schedule().n == 0

    def test_progress_file_under_trace_dir(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HPCPAT_TRACE_DIR", str(tmp_path))
        monkeypatch.setenv("HPCPAT_PROCESS_ID", "2")
        tt.reset_collective_schedule()
        tt.record_collective("allreduce", 0)
        got = json.loads((tmp_path / "rank00002.sched.json").read_text())
        assert got["n"] == 1 and got["last"]["op"] == "allreduce"


class TestBuildWatchers:
    def test_disabled_hooks_are_shared_noops(self):
        tt.configure(enabled=False)
        assert tt.compile_watch("a") is tt.compile_watch("b") is tt._NULL
        assert tm.span("x") is tm._NULL_SPAN

    def test_compile_watch_records_builds(self, monkeypatch):
        from hpc_patterns_tpu_torch.ops import _build

        rec = tt.configure(enabled=True)
        n = iter([3, 3, 3, 5])
        monkeypatch.setattr(_build, "loaded_count", lambda: next(n))
        with tt.compile_watch("decode.paged_generate", batch=1):
            pass  # no build
        with tt.compile_watch("decode.paged_generate", batch=2):
            pass  # two builds
        (ev,) = [e for e in rec.events if e[1] == "compile"]
        assert ev[2] == "decode.paged_generate"
        assert ev[6] == {"batch": 2, "new_variants": 2}
        assert rec.compile_count == 0  # ops/_build.py counted them

    def test_instrument_jit_names_shapes(self, monkeypatch):
        import torch

        from hpc_patterns_tpu_torch.ops import _build

        rec = tt.configure(enabled=True)
        n = iter([0, 11])
        monkeypatch.setattr(_build, "loaded_count", lambda: next(n))
        fn = tt.instrument_jit(lambda a: a + 1, "train.step")
        assert fn(torch.zeros(2, 3)).sum() == 6
        (ev,) = [e for e in rec.events if e[1] == "compile"]
        assert ev[2] == "train.step"
        assert ev[6] == {"shapes": ["torch.float32[2, 3]"]}
        assert fn.__wrapped__ is not None

    def test_build_stamps_one_event_per_compiled_source(self,
                                                          monkeypatch):
        from hpc_patterns_tpu_torch.ops import _build

        rec = tt.configure(enabled=True)
        monkeypatch.setitem(_build.build_info, "busy_wait",
                            {"seconds": 1.5, "log": "", "cached": False})
        _build._stamp_builds(["busy_wait"], time.perf_counter())
        (ev,) = list(rec.events)
        assert ev[:3] == ("X", "compile", "nvcc.busy_wait")
        assert ev[5] == 1.5 and rec.compile_count == 1

    def test_helpers_without_a_counterpart(self):
        tt.configure(enabled=True)
        assert tt.record_executable_memory("x", object()) is None
        assert isinstance(tt.jit_cache_size(), int)


class TestWindows:
    def test_host_window_on_the_cpu(self):
        import torch

        rec = tt.configure(enabled=True)
        w = rec.open_window(torch.device("cpu"))
        assert w and w.start is None
        torch.ones(8).sum()
        assert rec.mark_dispatch("serve.chunk", {"rows": 2}, window=w) is w
        rec.wait_window(w)
        rec.mark_complete("serve.chunk", w, {"rows": 2})
        disp, x = list(rec.events)
        assert disp[:3] == ("i", "device", "serve.chunk.dispatch")
        assert x[:3] == ("X", "device", "serve.chunk")
        assert x[3] == w.ts and x[5] >= 0 and x[6] == {"rows": 2}

    def test_memory_sampling_waits_for_cuda(self):
        rec = tt.configure(enabled=True)
        assert rec.sample_memory() is None  # no card initialized here
        assert rec.snapshot()["mem"] == {"peak_live_bytes": 0}

    @pytest.mark.cuda
    def test_event_window_on_the_card(self):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card")
        rec = tt.configure(enabled=True)
        x = torch.randn(1 << 20, device="cuda")
        w = rec.open_window(x.device)
        for _ in range(20):
            x = x * 1.0001
        rec.mark_dispatch("probe", window=w)
        x.sum().item()  # the caller's readback completes the window
        rec.mark_complete("probe", w)
        ev = list(rec.events)[-1]
        assert ev[6]["clock"] == tt.EVENT_CLOCK and 0 < ev[5] < 1.0
        w2 = rec.open_window(x.device)
        rec.mark_dispatch("early", window=w2)
        w2.end.synchronize()
        rec.mark_complete("early", w2)  # complete: no raise

    @pytest.mark.cuda
    def test_exec_memory_window_peak_on_the_card(self):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card")
        rec = tt.configure(enabled=True)
        big = 1 << 28  # above any earlier high-water mark of this test
        fn = tt.instrument_jit(
            lambda: torch.empty(big, dtype=torch.uint8,
                                device="cuda").fill_(1).sum(),
            "alloc", exec_memory=True)
        fn()
        (ev,) = [e for e in rec.events if e[2] == "exec_mem.alloc"]
        assert ev[6]["peak_memory_in_bytes"] >= big


class TestProfilerRegion:
    def test_maybe_trace_mirrors_and_restores_on_raise(self, tmp_path):
        from hpc_patterns_tpu_torch.harness.profiling import maybe_trace

        reg = tm.configure(enabled=False)
        rec = tt.configure(enabled=True)
        with pytest.raises(RuntimeError):
            with maybe_trace(True, str(tmp_path)):
                assert reg.mirror_traces
                raise RuntimeError("inside the region")
        assert not reg.mirror_traces
        assert [e[2] for e in rec.events] == ["profiler.trace.dispatch",
                                              "profiler.trace"]

    def test_maybe_trace_writes_its_artifact(self, tmp_path):
        import torch

        from hpc_patterns_tpu_torch.harness.profiling import maybe_trace

        with maybe_trace(True, str(tmp_path)) as d:
            torch.ones(4).sum()
        assert (tmp_path / "trace.json").is_file() and d == str(tmp_path)


class TestHandoff:
    def test_snapshot_carries_process_and_clock_anchors(self, monkeypatch):
        monkeypatch.setenv("HPCPAT_PROCESS_ID", "3")
        monkeypatch.setenv("HPCPAT_NUM_PROCESSES", "4")
        snap = tt.TraceRecorder().snapshot()
        assert snap["process"] == {"process_id": 3, "num_processes": 4,
                                   "slice_id": 0}
        assert set(snap["clock"]) == {"wall0", "mono0", "wall1", "mono1"}

    def test_write_rank_snapshot(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HPCPAT_PROCESS_ID", "1")
        rec = tt.TraceRecorder()
        rec.span_begin("a", {})
        rec.span_end("a")
        path = tt.write_rank_snapshot(rec, tmp_path)
        assert path == tmp_path / "rank00001.trace.json"
        snap = json.loads(path.read_text())
        assert snap["kind"] == "trace" and len(snap["events"]) == 2

    def test_run_instrumented_hands_off_under_env(self, tmp_path,
                                                  monkeypatch):
        import argparse

        from hpc_patterns_tpu_torch.apps import common

        monkeypatch.setenv("HPCPAT_TRACE_DIR", str(tmp_path))
        args = argparse.Namespace(metrics=False, trace=True, log=None,
                                  trace_capacity=None)

        def run(_):
            with tm.span("app"):
                return 0

        assert common.run_instrumented(run, args) == 0
        snap = json.loads((tmp_path / "rank00000.trace.json").read_text())
        assert [e[2] for e in snap["events"]] == ["app", "app"]
