"""The observability layer wired through the port's paths, held against
the JAX package's on the same inputs (numpy seeds, shared params via
``models.convert.params_from_jax``), all on the CPU:

- the serving engines: the same small greedy stream through both, with
  the same slots, pages and chunk — equal tokens, equal counter names and
  values, equal span names, equal device-window and request-lane track
  sets;
- the train step's gauges and histograms (``record_step_metrics``), and
  a traced ``train_app`` run;
- the Communicator: spans, device windows with their sequence stamps and
  the schedule chain against JAX's Communicator on a 4-device mesh, and
  the bandwidth gauges;
- the concurrency app's overlap gauges;
- the plane's ``emit=`` record kinds and counts against JAX's plane over
  ``device_put``, and its counters;
- every ported app with ``--metrics --trace --log`` appending its closing
  records (and nothing without the flags); serve_app's ``--reqtrace`` and
  ``--trace-out``.
"""

import json
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from hpc_patterns_tpu.harness import metrics as jm  # noqa: E402
from hpc_patterns_tpu.harness import reqtrace as jrt  # noqa: E402
from hpc_patterns_tpu.harness import trace as jt  # noqa: E402
from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.harness import metrics as tm  # noqa: E402
from hpc_patterns_tpu_torch.harness import reqtrace as trt  # noqa: E402
from hpc_patterns_tpu_torch.harness import trace as tt  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)


@pytest.fixture(autouse=True)
def _reset():
    yield
    for m, t, r in ((tm, tt, trt), (jm, jt, jrt)):
        m.configure(enabled=False)
        t.configure(enabled=False)
        r.reset()


BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
ENG = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8, chunk=2)


@pytest.fixture(scope="module")
def params():
    jp = jtf.init_params(jax.random.PRNGKey(0), jtf.TransformerConfig(**BASE))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _jcfg():
    return jtf.TransformerConfig(**BASE, decode_attn="gather")


def _tcfg():
    return ttf.TransformerConfig(**BASE, decode_attn="flash")


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, size=int(rng.choice([5, 8, 11])))
             .astype(np.int32), int(rng.choice([3, 6, 9])))
            for _ in range(n)]


def _instrumented(pkg):
    m, t, r = pkg
    return (m.configure(enabled=True), t.configure(enabled=True),
            r.configure(enabled=True))


class TestEngine:
    @pytest.mark.parametrize("seed", [1, 2])
    def test_counters_spans_and_tracks_equal_jax(self, params, seed):
        jp, tp = params
        reqs = _requests(5, seed)
        out = {}
        for name, pkg, mk in (
                ("jax", (jm, jt, jrt), lambda: jsrv.ContinuousBatcher(
                    jp, _jcfg(), **ENG, prompt_buckets=(8, 16))),
                ("port", (tm, tt, trt), lambda: tsrv.ContinuousBatcher(
                    tp, _tcfg(), **ENG, prompt_buckets=(8, 16),
                    device="cpu"))):
            reg, rec, rtr = _instrumented(pkg)
            eng = mk()
            ids = [eng.submit(p, b) for p, b in reqs]
            got = eng.run()
            snap = reg.snapshot()
            events = rec.snapshot()["events"]
            out[name] = {
                "tokens": [np.asarray(got[i]) for i in ids],
                "counters": snap["counters"],
                "spans": {k for k in snap["histograms"]
                          if k.startswith("span.")},
                "hists": set(snap["histograms"]),
                "gauges": set(snap["gauges"]),
                "windows": Counter((e[2], e[4]) for e in events
                                   if e[1] == "device"),
                "lanes": Counter((e[2], e[4]) for e in events
                                 if e[1] == "request"),
                "coverage": rtr.snapshot(eng.stats)["coverage_frac"],
            }
        j, t = out["jax"], out["port"]
        for a, b in zip(j["tokens"], t["tokens"]):
            np.testing.assert_array_equal(a, b)
        assert t["counters"] == j["counters"]
        assert t["counters"]["serve.admitted"] == len(reqs)
        assert t["counters"]["serve.tokens"] == sum(b for _, b in reqs)
        assert t["spans"] == j["spans"] == {
            "span.serve.prefill", "span.serve.decode_dispatch",
            "span.serve.decode_round"}
        assert t["hists"] == j["hists"]
        # the JAX engine's prefill-compile gauge reads its jit cache,
        # which the port does not have
        assert t["gauges"] == j["gauges"] - {"serve.prefill_compiles"}
        assert t["windows"] == j["windows"]
        assert t["lanes"] == j["lanes"]
        assert t["coverage"] > 0.99 and j["coverage"] > 0.99

    def test_no_flags_no_records_same_tokens(self, params):
        _, tp = params
        reqs = _requests(4, 3)

        def serve():
            eng = tsrv.ContinuousBatcher(tp, _tcfg(), **ENG,
                                         prompt_buckets=(8, 16),
                                         device="cpu")
            ids = [eng.submit(p, b) for p, b in reqs]
            got = eng.run()
            return [got[i] for i in ids]

        off = serve()
        assert tm.get_metrics().snapshot()["counters"] == {}
        assert tt.active() is None and trt.active() is None
        _instrumented((tm, tt, trt))
        on = serve()
        for a, b in zip(off, on):
            np.testing.assert_array_equal(a, b)


class TestTrain:
    def test_step_metrics_equal_jax(self):
        from hpc_patterns_tpu.models.train import record_step_metrics as jr
        from hpc_patterns_tpu_torch.models.train import (
            record_step_metrics as tr,
        )

        rng = np.random.default_rng(0)
        rows = [(i, float(rng.normal(5, 1)), float(rng.uniform(0.01, 1)))
                for i in range(6)]
        snaps = []
        for mod, fn in ((jm, jr), (tm, tr)):
            reg = mod.configure(enabled=True)
            for i, loss, dt in rows:
                fn(i, loss, dt, 4096)
            snaps.append(reg.snapshot())
        assert snaps[0] == snaps[1]
        assert sorted(snaps[1]["gauges"]) == [
            "train.compile_s", "train.loss", "train.step_time_s",
            "train.tokens_per_s"]

    def test_train_app_metrics_and_trace(self, tmp_path):
        from hpc_patterns_tpu_torch.apps import train_app

        log = tmp_path / "t.jsonl"
        assert train_app.main(
            ["--device", "cpu", "--batch", "2", "--seq", "32",
             "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
             "--vocab", "64", "--steps", "3", "--metrics", "--trace",
             "--log", str(log)]) == 0
        recs = [json.loads(x) for x in log.read_text().splitlines()]
        (snap,) = [r for r in recs if r["kind"] == "metrics"]
        steps = [r for r in recs if r["kind"] == "step"]
        assert snap["counters"]["train.steps"] == 3
        assert snap["histograms"]["train.step_s"]["count"] == 2
        assert snap["gauges"]["train.step_time_s"]["last"] == \
            steps[-1]["dt_s"]
        assert [r["kind"] for r in recs][-2:] == ["metrics", "trace"]


def _comm_script(comm, x):
    comm.allreduce(x, "collective")
    comm.allreduce(x, "ring")
    comm.pingpong(x)
    comm.sendrecv_ring(x)
    comm.all_gather(x)
    comm.allreduce_into(x, algorithm="collective")


class TestCommunicator:
    def test_spans_windows_and_seq_stamps_equal_jax(self):
        from hpc_patterns_tpu import topology
        from hpc_patterns_tpu.analysis import runtime as jruntime
        from hpc_patterns_tpu.comm import Communicator as JComm
        from hpc_patterns_tpu_torch.comm.communicator import (
            Communicator as TComm,
        )

        got = {}
        for name, pkg, comm in (
                ("jax", (jm, jt, jrt), JComm(topology.make_mesh(
                    {"x": 4}, jax.devices("cpu")[:4]), "x")),
                ("port", (tm, tt, trt), TComm({"x": 4}, "x",
                                              device="cpu"))):
            reg, rec, _ = _instrumented(pkg)
            _comm_script(comm, comm.rank_filled(8))
            chain = (jruntime.collective_schedule() if name == "jax"
                     else tt.collective_schedule())
            got[name] = (
                {k: v["count"] for k, v in
                 reg.snapshot()["histograms"].items()},
                [(e[0], e[2], e[6]) for e in rec.events
                 if e[1] == "device"],
                [(e["op"], e["seq"], e["algorithm"], e["shape"],
                  e["dtype"]) for e in chain.snapshot()["entries"]])
        assert got["port"] == got["jax"]
        spans, windows, chain = got["port"]
        assert spans["span.comm.allreduce"] == 2
        assert [w[2] for w in windows if w[0] == "X"] == [
            {"seq": s} for s in range(6)]
        assert [c[1] for c in chain] == list(range(6))

    def test_no_recording_no_wait_no_chain(self):
        from hpc_patterns_tpu_torch.comm.communicator import Communicator

        tt.configure(enabled=False)
        comm = Communicator({"x": 4}, "x", device="cpu")
        tt.reset_collective_schedule()
        _comm_script(comm, comm.rank_filled(8))
        assert tt.collective_schedule().n == 0
        assert comm._seq == 6  # stamps advance either way, as in JAX

    def test_bandwidth_gauges_equal_jax(self):
        from hpc_patterns_tpu.comm.communicator import (
            record_collective_bandwidth as jr,
        )
        from hpc_patterns_tpu_torch.comm.communicator import (
            record_collective_bandwidth as tr,
        )

        snaps = []
        for mod, fn in ((jm, jr), (tm, tr)):
            reg = mod.configure(enabled=True)
            fn("allreduce.ring", 1 << 20, 1e-3, busbw_gbps=1.5)
            fn("pingpong", 4096, 2e-6, latency_us=2.0)
            snaps.append(reg.snapshot())
        assert snaps[0] == snaps[1]

    def test_allreduce_app_sweep_metrics(self, tmp_path):
        from hpc_patterns_tpu_torch.apps import allreduce_app

        log = tmp_path / "a.jsonl"
        assert allreduce_app.main(
            ["--sweep", "--min-p", "3", "-p", "5", "--device", "cpu",
             "--repetitions", "2", "--warmup", "1", "--metrics",
             "--log", str(log)]) == 0
        recs = [json.loads(x) for x in log.read_text().splitlines()]
        (snap,) = [r for r in recs if r["kind"] == "metrics"]
        res = [r for r in recs if r["kind"] == "result"]
        for alg in allreduce_app.ALGORITHMS:
            last = [r for r in res if r["name"] == f"allreduce[{alg}]"][-1]
            g = snap["gauges"][f"comm.allreduce.{alg}.busbw_gbps"]
            assert g["last"] == last["busbw_gbps"] and g["n"] == 3
            assert snap["histograms"][f"allreduce.{alg}.rep_s"][
                "count"] == 3 * 2


class TestConcurrency:
    def test_overlap_gauges_equal_jax(self):
        from hpc_patterns_tpu.apps import concurrency_app as japp
        from hpc_patterns_tpu.harness.verdict import concurrency_verdict
        from hpc_patterns_tpu_torch.apps import concurrency_app as tapp

        snaps = []
        for mod, app in ((jm, japp), (tm, tapp)):
            reg = mod.configure(enabled=True)
            v = concurrency_verdict([1.0, 0.8], 1.1)
            app._record_overlap_metrics("dispatch.async", ["C", "M2D"],
                                        1.8, 1.1, v)
            snaps.append(reg.snapshot())
        assert snaps[0] == snaps[1]

    def test_app_records_its_pair(self, tmp_path):
        from hpc_patterns_tpu_torch.apps import concurrency_app

        log = tmp_path / "c.jsonl"
        assert concurrency_app.main(
            ["async", "C", "M2D", "--engine", "dispatch", "--device", "cpu",
             "--tripcount", "2", "--copy-elements", "1024",
             "--repetitions", "2", "--warmup", "1", "--metrics", "--log",
             str(log)]) in (0, 1)  # the verdict is the CPU's business
        recs = [json.loads(x) for x in log.read_text().splitlines()]
        (snap,) = [r for r in recs if r["kind"] == "metrics"]
        assert {"concurrency.dispatch.async.C+M2D.serial_s",
                "concurrency.dispatch.async.C+M2D.concurrent_s"} <= set(
            snap["gauges"])


class TestPlane:
    def test_emit_kinds_and_counts_equal_jax(self, params):
        from hpc_patterns_tpu.harness import slo as jslo
        from hpc_patterns_tpu.serving_plane import router as jrouter
        from hpc_patterns_tpu_torch.harness import slo as tslo
        from hpc_patterns_tpu_torch.serving_plane.router import (
            Replica,
            ServingPlane,
        )

        jp, tp = params
        reqs = _requests(5, 1)
        got = {}
        for name in ("jax", "port"):
            records = []
            emit = lambda **kw: records.append(kw)  # noqa: E731
            if name == "jax":
                reg = jm.configure(enabled=True)
                plane = jrouter.ServingPlane([
                    jrouter.Replica(jsrv.EngineCore(jp, _jcfg(), **ENG),
                                    name="p", role="prefill"),
                    jrouter.Replica(jsrv.EngineCore(jp, _jcfg(), **ENG),
                                    name="d", role="decode")],
                    migration="device_put", emit=emit,
                    slo={0: jslo.SLOTarget()})
            else:
                reg = tm.configure(enabled=True)
                plane = ServingPlane([
                    Replica(tsrv.EngineCore(tp, _tcfg(), **ENG,
                                            device="cpu"),
                            name="p", role="prefill"),
                    Replica(tsrv.EngineCore(tp, _tcfg(), **ENG,
                                            device="cpu"),
                            name="d", role="decode")],
                    migration="device_put", emit=emit,
                    slo={0: tslo.SLOTarget()})
            ids = [plane.submit(p, b) for p, b in reqs]
            out = plane.run()
            kinds = Counter(r["kind"] for r in records)
            got[name] = (kinds, reg.snapshot()["counters"],
                         [np.asarray(out[i]) for i in ids],
                         plane.rounds_total)
        (jk, jc, jtok, jrounds), (tk, tc, ttok, trounds) = (
            got["jax"], got["port"])
        for a, b in zip(jtok, ttok):
            np.testing.assert_array_equal(a, b)
        assert tk.keys() == jk.keys() == {"plane_route", "plane_migrate",
                                          "plane_attainment"}
        assert tk["plane_route"] == jk["plane_route"] == len(reqs)
        assert tk["plane_migrate"] == jk["plane_migrate"] == len(reqs)
        assert tk["plane_attainment"] == trounds
        assert jk["plane_attainment"] == jrounds
        assert tc == jc

    def test_traced_plane_migration_windows(self, params):
        from hpc_patterns_tpu_torch.serving_plane.router import (
            Replica,
            ServingPlane,
        )
        from hpc_patterns_tpu_torch.topology import LogicalDevice

        _, tp = params
        rec = tt.configure(enabled=True)
        rtr = trt.configure(enabled=True)
        plane = ServingPlane([
            Replica(tsrv.EngineCore(tp, _tcfg(), **ENG, device="cpu"),
                    name="p", role="prefill",
                    device=LogicalDevice("cpu", 0)),
            Replica(tsrv.EngineCore(tp, _tcfg(), **ENG, device="cpu"),
                    name="d", role="decode",
                    device=LogicalDevice("cpu", 1))], migration="dma")
        ids = [plane.submit(p, b) for p, b in _requests(4, 2)]
        plane.run()
        xs = [e for e in rec.events
              if e[0] == "X" and e[2] == "plane.kv_migration"]
        assert len(xs) == plane.migrations == 4
        assert {e[4] - tt.TID_DEVICE for e in xs} == {64, 65, 66, 67}
        chain = tt.collective_schedule().snapshot()["entries"]
        assert [(c["op"], c["algorithm"]) for c in chain] == [
            ("kv_migration", "dma")] * 4
        for rid in ids:
            kinds = [s[0] for s in rtr.segments(rid)]
            assert kinds == ["queued", "admit_wait", "prefill", "decode",
                             "migrating", "decode"]
            mig = rtr.segments(rid)[4]
            assert mig[3] and "seq" in mig[3]


def _kinds(path):
    return [json.loads(x)["kind"] for x in path.read_text().splitlines()]


TRAIN = ["--device", "cpu", "--batch", "2", "--seq", "32", "--d-model",
         "32", "--n-layers", "2", "--n-heads", "4", "--vocab", "64"]
APPS = {
    "serve_app": ["--device", "cpu", "--dtype", "float32", "--requests",
                  "3", "--slots", "2"],
    "train_app": TRAIN + ["--steps", "2"],
    "eval_app": TRAIN + ["--batches", "2"],
    "allreduce_app": ["-p", "4", "--device", "cpu", "--repetitions", "2"],
    "pingpong_app": ["--min-p", "3", "-p", "4", "--device", "cpu",
                     "--repetitions", "2"],
    "interop_app": ["--device", "cpu", "-n", "256"],
    "concurrency_app": ["async", "C", "M2D", "--engine", "dispatch",
                        "--device", "cpu", "--tripcount", "2",
                        "--copy-elements", "1024", "--repetitions", "2",
                        "--warmup", "1"],
    "sweep": ["--modes", "async", "--device", "cpu", "--tripcount", "2",
              "--copy-elements", "1024", "--repetitions", "2",
              "--warmup", "1"],
}


class TestApps:
    @pytest.mark.parametrize("app", sorted(APPS))
    def test_flags_append_closing_records(self, app, tmp_path):
        import importlib

        mod = importlib.import_module(f"hpc_patterns_tpu_torch.apps.{app}")
        log = tmp_path / "on.jsonl"
        rc = mod.main(APPS[app] + ["--metrics", "--trace", "--log",
                                   str(log)])
        assert rc == 0 or app in ("concurrency_app", "sweep")
        kinds = _kinds(log)
        assert kinds[-2:] == ["metrics", "trace"]
        off = tmp_path / "off.jsonl"
        mod.main(APPS[app] + ["--log", str(off)])
        assert not {"metrics", "trace"} & set(_kinds(off))

    def test_serve_app_reqtrace_and_trace_out(self, tmp_path, capsys):
        from hpc_patterns_tpu_torch.apps import serve_app
        from hpc_patterns_tpu_torch.harness import report

        log, out = tmp_path / "s.jsonl", tmp_path / "s.trace.json"
        assert serve_app.main(APPS["serve_app"] + [
            "--prompt-mix", "--metrics", "--reqtrace", "--log", str(log),
            "--trace-out", str(out)]) == 0
        assert capsys.readouterr().out.count("SUCCESS") == 1
        recs = [json.loads(x) for x in log.read_text().splitlines()]
        (rq,) = [r for r in recs if r["kind"] == "reqtrace"]
        assert rq["n"] == 3 and rq["coverage_frac"] > 0.99
        (snap,) = [r for r in recs if r["kind"] == "metrics"]
        assert snap["counters"]["serve.admitted"] == 3  # warm-up excluded
        assert snap["histograms"]["span.serve.measure"]["count"] == 1
        assert snap["gauges"]["serve.tokens_per_s"]["n"] == 1
        chrome = json.loads(out.read_text())
        depth = Counter()
        for e in chrome["traceEvents"]:
            if e["ph"] == "B":
                depth[e["tid"]] += 1
            elif e["ph"] == "E":
                depth[e["tid"]] -= 1
        assert not any(depth.values())
        names = {e["name"] for e in chrome["traceEvents"]}
        assert {"serve.chunk", "serve.admit", "serve.measure"} <= names
        assert report.main([str(log)]) == 0
        assert "span.serve.measure/serve.decode_round" in \
            capsys.readouterr().out
        assert trt.active() is None  # the run's request trace is dropped
