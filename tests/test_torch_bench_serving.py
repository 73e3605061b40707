"""The port's serving benchmark rows on the CPU (``hpc_patterns_tpu_torch.
bench_serving``): JAX's own tier-1 tests of the base row
(``test_smoke_engine_beats_static_on_mixed_workload``) and of the chaos
scenario (``test_smoke_chaos_scenario_still_beats_static_and_reports_
goodput``) run unchanged against the port's rows — the same verdicts on
the same keys — and the rows return every key JAX's rows return, the
scenario's tail-attribution shares and budget breaches among them (its
digest, written through ``explain_out``, is the row's). Each row holds
every sequence against its standalone before it returns. The ``--fit``
row is held in ``tests/test_torch_autofit.py``.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu_torch import bench_serving as tbs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: the keys JAX's run_bench returns (benchmarks/bench_serving.py:327-337)
BENCH_KEYS = {"t_static", "t_engine", "tokens", "tokens_per_s_static",
              "tokens_per_s_engine", "speedup", "bubble_frac",
              "prefill_compiles", "ladder", "distinct_lengths"}
#: run_scenario's (:581-605)
SCENARIO_KEYS = {"t_static", "t_engine", "tokens", "served_tokens",
                 "tokens_per_s_static", "tokens_per_s_engine", "speedup",
                 "goodput_tok_s", "attained_frac", "preemptions", "shed",
                 "bubble_frac", "stall_injections", "stall_injected_s",
                 "prefill_compiles", "ladder", "attribution_coverage_frac",
                 "ttft_p99_queue_share", "tpot_p99_stall_share",
                 "budget_breaches", "schedule"}


def _jax_tests():
    spec = importlib.util.spec_from_file_location(
        "_jax_test_bench_serving", ROOT / "tests" / "test_bench_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def jax_bench(monkeypatch, tmp_path):
    """JAX's bench module with its rows and configs swapped for the
    port's (on the CPU), so JAX's test bodies call the port. One intra-op
    thread while they run: under a parallel test run a worker's thread
    pool, spinning on cores the other workers hold, made a row 10x slower
    (the barrier of every threaded op waits on a descheduled thread)."""
    if str(ROOT) not in sys.path:
        monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.bench_serving as jbs

    rows = {}

    def capture(name, fn):
        def run(**kw):
            rows[name] = fn(**kw)
            return rows[name]
        return run

    monkeypatch.setattr(jbs, "smoke_config",
                        lambda: tbs.smoke_config("cpu"))
    monkeypatch.setattr(jbs, "run_bench", capture("bench", tbs.run_bench))
    monkeypatch.setattr(jbs, "scenario_smoke_config",
                        lambda: tbs.scenario_smoke_config("cpu"))
    # the scenario row also writes its attribution digest
    monkeypatch.setattr(jbs, "run_scenario", capture(
        "scenario", lambda **kw: tbs.run_scenario(
            **kw, explain_out=tmp_path / "digest.json")))
    rows["digest"] = tmp_path / "digest.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield rows
    torch.set_num_threads(threads)


def test_jax_engine_beats_static_test_passes_on_the_port(jax_bench):
    _jax_tests().test_smoke_engine_beats_static_on_mixed_workload()
    r = jax_bench["bench"]
    assert set(r) == BENCH_KEYS
    assert r["ladder"] == 2 and r["prefill_compiles"] <= 2


def test_jax_chaos_scenario_test_passes_on_the_port(jax_bench):
    _jax_tests(). \
        test_smoke_chaos_scenario_still_beats_static_and_reports_goodput()
    r = jax_bench["scenario"]
    assert SCENARIO_KEYS <= set(r)
    # the staged pool forces the eviction; the victim resumed and every
    # row (it included) matched its standalone exactly in f32
    assert r["preemptions"] >= 1 and r["shed"] == 0
    assert r["oracle"]["exact"] == 8 and r["admissions"] == 8 + \
        r["preemptions"]
    assert r["attribution_coverage_frac"] >= 0.95
    # the shares are the timed leg's attribution digest's
    dig = json.loads(jax_bench["digest"].read_text())
    assert r["ttft_p99_queue_share"] == dig["ttft_p99_queue_share"]
    assert r["tpot_p99_stall_share"] == dig["tpot_p99_stall_share"]
    assert r["attribution_coverage_frac"] == dig["coverage_frac"]
    assert isinstance(r["budget_breaches"], int) and \
        r["budget_breaches"] >= 0


@pytest.mark.parametrize("flag", ["--offload", "--shared", "--elastic",
                                  "--slo-budget", "--quant"])
def test_later_rows_name_what_they_wait_for(flag, capsys):
    with pytest.raises(SystemExit):
        tbs.main([flag, "--device", "cpu", "--smoke"])
    assert "not ported yet" in capsys.readouterr().err


def test_slo_budget_waits_for_tiered_memory_only(capsys):
    with pytest.raises(SystemExit):
        tbs.main(["--slo-budget", "--device", "cpu", "--smoke"])
    err = capsys.readouterr().err
    assert "ROADMAP item 3" in err and "item 2" not in err
    assert "fit" not in tbs.LATER_ROWS
