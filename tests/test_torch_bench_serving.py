"""The port's serving benchmark rows on the CPU (``hpc_patterns_tpu_torch.
bench_serving``): JAX's own tier-1 tests of the base row
(``test_smoke_engine_beats_static_on_mixed_workload``), of the chaos
scenario (``test_smoke_chaos_scenario_still_beats_static_and_reports_
goodput``) and of the tiered-memory rows (``test_smoke_offload_row_...``,
``test_smoke_shared_row_...``, ``test_smoke_slo_budget_row_...``) and of
the quantized row (``test_smoke_quantized_row_...``) and of the elastic
row (``test_smoke_elastic_row_beats_static_and_reports_efficiency``) run
unchanged against the port's rows — the same verdicts on the same keys —
and the rows return every key JAX's rows return, the
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


#: run_elastic's (:1628-1646)
ELASTIC_KEYS = {"elastic_slo_attainment", "static_slo_attainment",
                "per_class_attainment", "goodput_per_replica_round",
                "static_goodput_per_replica_round", "static_shed_on_death",
                "elastic_shed_on_death", "spinups", "warm_spinup_s",
                "cold_init_s", "resumed", "drained", "replica_rounds",
                "static_replica_rounds", "sampled_resumed"}


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
    # the tiered-memory rows
    for name, conf in (("offload", tbs.offload_smoke_config),
                       ("shared", tbs.shared_smoke_config),
                       ("slo_budget", tbs.slo_budget_smoke_config)):
        monkeypatch.setattr(jbs, f"{name}_smoke_config",
                            lambda conf=conf: conf("cpu"))
        monkeypatch.setattr(jbs, f"run_{name}",
                            capture(name, getattr(tbs, f"run_{name}")))
    # the quantized row
    monkeypatch.setattr(jbs, "quantized_smoke_config",
                        lambda: tbs.quantized_smoke_config("cpu"))
    monkeypatch.setattr(jbs, "run_quantized",
                        capture("quantized", tbs.run_quantized))
    # the elastic row
    monkeypatch.setattr(jbs, "elastic_smoke_config",
                        lambda: tbs.elastic_smoke_config("cpu"))
    monkeypatch.setattr(jbs, "run_elastic",
                        capture("elastic", tbs.run_elastic))
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


#: run_offload's keys (benchmarks/bench_serving.py:758-771)
OFFLOAD_KEYS = {"t_full", "t_tiered", "tokens", "tokens_per_s_full",
                "tokens_per_s_tiered", "full_goodput_tok_s",
                "offload_goodput_tok_s", "prefetch_overlap_frac",
                "swap_outs", "swap_ins", "prefetch_bytes", "hbm_pool",
                "full_pool", "bubble_frac"}
#: run_shared's (:1064-1081)
SHARED_KEYS = {"t_private", "t_shared", "tokens", "tokens_per_s_private",
               "tokens_per_s_shared", "private_goodput_tok_s",
               "shared_goodput_tok_s", "prefill_skip_frac", "prefix_hits",
               "prefix_misses", "ladder", "pool_pages", "bubble_frac",
               "schedule"}
#: run_slo_budget's (:916-926)
SLO_BUDGET_KEYS = {"wall_s", "n", "tokens", "swap_outs", "stall_injections",
                   "stall_injected_s", "attribution_coverage_frac",
                   "tpot_p99_stall_share", "budget_breach_segments",
                   "budget_breaches"}


def test_jax_offload_row_test_passes_on_the_port(jax_bench):
    _jax_tests().test_smoke_offload_row_forces_eviction_and_reports_overlap()
    r = jax_bench["offload"]
    assert OFFLOAD_KEYS <= set(r)
    # the row held every tiered sequence against the all-HBM one and both
    # against the standalone, exactly in f32
    assert r["oracle"]["tiered_vs_full"] == {"exact": 8, "differ": 0}
    assert r["oracle"]["tiered"] == {"exact": 8, "near_tie": 0}
    assert r["evict_bytes"] == r["prefetch_bytes"] > 0


def test_jax_shared_row_test_passes_on_the_port(jax_bench):
    _jax_tests().test_smoke_shared_row_skips_prefill_and_reports_goodput()
    r = jax_bench["shared"]
    assert SHARED_KEYS <= set(r)
    assert r["oracle"]["shared"]["exact"] == 16


def test_jax_slo_budget_row_test_passes_on_the_port(jax_bench):
    _jax_tests().test_smoke_slo_budget_row_blames_the_injected_mechanism()
    r = jax_bench["slo_budget"]
    assert SLO_BUDGET_KEYS <= set(r)
    assert r["oracle"] == {"exact": 5, "near_tie": 0}


#: run_quantized's keys (benchmarks/bench_serving.py:1263-1278)
QUANT_KEYS = {"t_baseline", "t_quant", "tokens", "tokens_per_s_baseline",
              "tokens_per_s_quant", "baseline_goodput_tok_s",
              "quant_goodput_tok_s", "kv_pool_bytes_frac", "kv_pool_bytes",
              "bf16_pool_bytes", "kv_dtype", "quant_weights",
              "greedy_agreement", "tv_mean", "tv_max",
              "baseline_bubble_frac", "quant_bubble_frac"}


def test_jax_quantized_row_test_passes_on_the_port(jax_bench):
    _jax_tests().test_smoke_quantized_row_reports_goodput_and_pool_bytes()
    r = jax_bench["quantized"]
    assert set(r) == QUANT_KEYS
    # one-byte values and an f32 scale a row and kv head over bf16: the
    # closed form (D + 4) / 2D at the smoke model's head dim 64
    assert r["kv_pool_bytes_frac"] == (64 + 4) / (2 * 64)
    assert r["tv_max"] >= r["tv_mean"] >= 0.0


def test_quant_row_through_the_cli_at_fp8(capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tbs.main(["--quant", "--smoke", "--device", "cpu",
                         "--kv-dtype", "fp8"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    r = json.loads(out.strip().splitlines()[-1])
    assert set(r) == QUANT_KEYS and r["kv_dtype"] == "fp8"
    assert "precision law: greedy agreement" in out
    with pytest.raises(SystemExit, match="needs a quantized --kv-dtype"):
        tbs.main(["--quant", "--smoke", "--device", "cpu", "--kv-dtype",
                  "bf16"])


def test_tiered_rows_through_the_cli(capsys, one_thread):
    assert tbs.main(["--slo-budget", "--device", "cpu", "--explain"]) == 0
    out = capsys.readouterr().out
    r = json.loads(out.strip().splitlines()[-1])
    assert r["budget_breach_segments"] == ["prefetch_wait"]
    assert "SLO BUDGET BREACHES" in out
    with pytest.raises(SystemExit):
        tbs.main(["--shared", "--smoke", "--device", "cpu", "--kv-dtype",
                  "int8"])
    assert "--shared refuses --kv-dtype int8" in capsys.readouterr().err


def test_jax_elastic_row_test_passes_on_the_port(jax_bench):
    _jax_tests().test_smoke_elastic_row_beats_static_and_reports_efficiency()
    r = jax_bench["elastic"]
    assert ELASTIC_KEYS <= set(r)
    # every served stream held exactly on the CPU, resumed rows included
    assert r["oracle"]["near_tie"] == 0 and r["oracle"]["exact"] > 0
    assert r["warm_vs_cold"] == "warm spin-up faster"
    assert r["replica_rounds"] > r["static_replica_rounds"] > 0


@pytest.fixture()
def one_thread():
    """One intra-op thread (the ``jax_bench`` fixture's reason)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_elastic_row_through_the_cli(capsys, one_thread):
    assert tbs.main(["--elastic", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    r = json.loads(out.strip().splitlines()[-1])
    assert ELASTIC_KEYS <= set(r) and "schedule" not in r
    assert r["elastic_slo_attainment"] > r["static_slo_attainment"]
    assert r["static_shed_on_death"] >= 1 and r["elastic_shed_on_death"] == 0
    assert "every served stream on its standalone" in out
