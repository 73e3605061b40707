"""The port's tail attribution (``hpc_patterns_tpu_torch.harness.explain``)
held against the JAX package's on the same inputs: request traces written
by both packages' recorders from numpy-seeded transitions at fixed
instants, and real ``serve_app --explain --log`` runs of the smoke model
in both packages. The digests are equal, the tables equal, and the CLIs
print the same and write the same digest (after the package name is
normalized in the usage hints).
"""

import json

import pytest

from hpc_patterns_tpu.harness import explain as jexplain
from hpc_patterns_tpu.harness import reqtrace as jrt
from hpc_patterns_tpu.harness.runlog import RunLog as JRunLog
from hpc_patterns_tpu_torch.harness import explain as texplain
from hpc_patterns_tpu_torch.harness import reqtrace as trt
from hpc_patterns_tpu_torch.harness.runlog import RunLog as TRunLog

from _torch_parity import seeded_reqtrace, serve_log

RECORDERS = {"port": (trt, TRunLog), "jax": (jrt, JRunLog)}


def _norm(text: str) -> str:
    return text.replace("hpc_patterns_tpu_torch", "hpc_patterns_tpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_recorders_write_the_same_trace(seed):
    assert seeded_reqtrace(trt, seed) == seeded_reqtrace(jrt, seed)


@pytest.mark.parametrize("worst", [0, 5])
@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_digest_and_table_equal(seed, which, worst):
    snap = seeded_reqtrace(RECORDERS[which][0], seed)
    got = texplain.digest([snap], worst_n=worst)
    want = jexplain.digest([snap], worst_n=worst)
    assert got == want
    assert texplain.format_explain(got) == jexplain.format_explain(want)
    assert 0.0 <= got["coverage_frac"] <= 1.0 and got["n"] == 24


def test_several_snapshots_fold_the_same():
    snaps = [seeded_reqtrace(trt, s) for s in (4, 5)]
    assert texplain.digest(snaps) == jexplain.digest(snaps)


def test_digest_from_stats_equals_the_snapshot_digest():
    rtr = trt.ReqTrace()
    rtr.begin_request(0, 1.0)
    rtr.stamp_transition(0, "prefill", 1.5)
    rtr.stamp_transition(0, "decode", 1.75)
    rtr.finish_request(0, 2.0)
    stats = {0: {"priority": 0, "t_submit": 1.0, "t_first": 1.75,
                 "t_finish": 2.0, "tokens": 3, "outcome": "ok",
                 "token_ts": [1.75, 1.8, 2.0]}}
    got = texplain.digest_from_stats(stats, rtr)
    assert got == jexplain.digest([rtr.snapshot(stats)])
    assert got["ttft_p99_band_shares"] == {"queued": 2 / 3,
                                           "prefill": 1 / 3}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_clis_print_and_write_the_same(which, tmp_path, capsys):
    rt, RunLog = RECORDERS[which]
    log = tmp_path / "run.jsonl"
    RunLog(log).emit(kind="reqtrace", **seeded_reqtrace(rt, 7))
    outs = {}
    for name, mod in (("port", texplain), ("jax", jexplain)):
        dig = tmp_path / f"{name}.json"
        assert mod.main([str(log), "--worst", "3", "-o", str(dig)]) == 0
        printed = capsys.readouterr().out.replace(str(dig), "DIGEST")
        outs[name] = (printed, json.loads(dig.read_text()))
    assert outs["port"] == outs["jax"]


def test_no_reqtrace_records_exits_2_in_both(tmp_path, capsys):
    log = tmp_path / "empty.jsonl"
    log.write_text('{"kind": "result", "success": true}\n')
    assert texplain.main([str(log)]) == 2
    port_err = capsys.readouterr().err
    assert jexplain.main([str(log)]) == 2
    assert port_err == capsys.readouterr().err


@pytest.fixture(scope="module")
def serve_logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return {w: serve_log(w, d / f"{w}.jsonl") for w in ("port", "jax")}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_real_serve_logs_digest_the_same(serve_logs, which):
    snaps = [r for r in texplain.load_records([serve_logs[which]])
             if r.get("kind") == "reqtrace"]
    assert len(snaps) == 1 and snaps[0]["n"] == 8
    got, want = texplain.digest(snaps), jexplain.digest(snaps)
    assert got == want
    assert texplain.format_explain(got) == jexplain.format_explain(want)
    # the smoke stream queues behind two slots: every request's window
    # is covered and the TTFT tail is queueing
    assert got["coverage_frac"] > 0.95
    assert max(got["ttft_p99_band_shares"],
               key=got["ttft_p99_band_shares"].get) == "queued"


def test_serve_app_prints_the_table_and_writes_the_digest(tmp_path,
                                                          capsys):
    out = tmp_path / "digest.json"
    serve_log("port", tmp_path / "run.jsonl", "--explain-out", out)
    printed = capsys.readouterr().out
    assert "request forensics  n=8" in printed and "SUCCESS" in printed
    dig = json.loads(out.read_text())
    recs = [json.loads(line) for line in
            (tmp_path / "run.jsonl").read_text().splitlines()]
    (snap,) = [r for r in recs if r["kind"] == "reqtrace"]
    assert dig == json.loads(json.dumps(jexplain.digest([snap])))
    assert _norm(texplain.format_explain(texplain.digest([snap]))) in \
        _norm(printed)
