"""The port's autofit (``hpc_patterns_tpu_torch.harness.autofit``) and the
autoscaler's pure controller (``serving_plane/autoscaler.py``) held
against the JAX package's, and the consumers of a FittedConfig.

- JAX's own tier-1 bodies run unchanged on the port's modules:
  ``tests/test_autofit.py``'s determinism, ladder, residency, placement,
  autoscaler and blame classes and its autoscaler-policy consumer, and
  ``tests/test_autoscaler.py::TestAutoscalerPolicy``;
- on records written by both packages (numpy-seeded admissions, gauges,
  trajectories, request traces) and on real ``serve_app --log`` runs of
  the smoke model in both, ``dumps_config`` is byte-identical across the
  packages, and a config fitted by either loads in the other;
- ``EngineCore.from_fitted`` applies the ladder (an explicit one wins),
  ``ServingPlane.from_fitted`` picks ``weighted`` from skewed gauges,
  ``serve_app --autofit`` serves the fitted ladder to SUCCESS, and
  ``bench_serving``'s ``--fit`` row records, fits and wins strictly on
  padding with both legs on their standalone.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from hpc_patterns_tpu.harness import autofit as jautofit
from hpc_patterns_tpu.harness import reqtrace as jrt
from hpc_patterns_tpu.serving_plane import autoscaler as jscaler
from hpc_patterns_tpu_torch import bench_serving as tbs
from hpc_patterns_tpu_torch.harness import autofit as tautofit
from hpc_patterns_tpu_torch.harness import reqtrace as trt
from hpc_patterns_tpu_torch.models.serving import (
    ContinuousBatcher,
    EngineCore,
)
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from hpc_patterns_tpu_torch.serving_plane import autoscaler as tscaler
from hpc_patterns_tpu_torch.serving_plane.router import Replica, ServingPlane

import _torch_parity as parity

BODIES = parity.load("test_autofit")
CASES = parity.cases(
    BODIES, ["TestDeterminism", "TestLadderFit", "TestResidencyFit",
             "TestPlacementFit", "TestAutoscalerFit", "TestBlameFit",
             "TestConsumers"],
    skip=("test_residency_manager_from_fitted_applies_depth",))
SCALER_BODIES = parity.load("test_autoscaler")
SCALER_CASES = parity.cases(SCALER_BODIES, ["TestAutoscalerPolicy"])
REDIRECT = ("hpc_patterns_tpu.serving_plane.autoscaler",)


@pytest.fixture()
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cls,method", CASES)
def test_jax_autofit_body_on_the_port(cls, method, request):
    parity.call(BODIES, cls, method, request, redirect=REDIRECT)


@pytest.mark.parametrize("cls,method", SCALER_CASES)
def test_jax_autoscaler_body_on_the_port(cls, method, request):
    parity.call(SCALER_BODIES, cls, method, request)


def test_controllers_decide_the_same():
    rng = np.random.RandomState(5)
    pol = dict(min_replicas=1, max_replicas=4, up_queue=2.0,
               down_queue=0.5, cooldown_rounds=2, window=3)
    got = tscaler.Autoscaler(tscaler.AutoscalerPolicy(**pol))
    want = jscaler.Autoscaler(jscaler.AutoscalerPolicy(**pol))
    for r in range(60):
        kw = dict(round=r, replicas=int(rng.randint(1, 5)),
                  queued=int(rng.randint(0, 12)), active=0,
                  attained=int(rng.randint(0, 4)), judged=3)
        got.observe(tscaler.Signals(**kw))
        want.observe(jscaler.Signals(**kw))
    assert [dataclasses.astuple(d) for d in got.decisions] == \
        [dataclasses.astuple(d) for d in want.decisions]
    assert tscaler.spinup_track(9) == jscaler.spinup_track(9)


def _records(seed: int, which: str) -> list:
    """Every signal family the fitters read, numpy-seeded: admissions of
    two classes, paging records with trace windows and gauges, placement
    gauges, an attainment trajectory and one package's request trace."""
    rng = np.random.default_rng(seed)
    lengths = rng.choice([16, 24, 40, 64, 100], size=40,
                         p=[0.1, 0.2, 0.4, 0.2, 0.1])
    recs = [{"kind": "serve_admit", "seq_id": i, "slot": i % 4,
             "prompt_len": int(t), "padded_len": int(t),
             "priority": int(i % 2)} for i, t in enumerate(lengths)]
    recs += [{"kind": "serve_swap_out", "seq_id": s} for s in range(3)]
    recs += [{"kind": "serve_prefetch", "seq_id": int(s)}
             for s in rng.integers(0, 3, 7)]
    ev = [["X", "serve", "serve.chunk", 10.0 * i, 0, 8.0, None]
          for i in range(6)]
    ev += [["X", "mem", "mem.prefetch", float(t), 0, 3.0, None]
           for t in rng.uniform(0, 60, 4)]
    recs.append({"kind": "trace", "events": ev})
    gauges = {"mem.hbm_pages": 6.0, "mem.host_pages": 3.0,
              "plane.r0.queue_depth": float(rng.integers(0, 3)),
              "plane.r1.queue_depth": float(rng.integers(4, 9))}
    recs.append({"kind": "metrics", "gauges": {
        k: {"last": v, "min": v / 2, "max": v, "n": 3}
        for k, v in gauges.items()}})
    recs += [{"kind": "plane_attainment", "round": r,
              "replicas": int(rng.integers(1, 3)),
              "queued": int(rng.integers(0, 8)), "active": 2,
              "attained_round": int(rng.integers(0, 3)),
              "judged_round": 2} for r in range(10)]
    rt = trt if which == "port" else jrt
    recs.append(dict(parity.seeded_reqtrace(rt, seed), kind="reqtrace"))
    return recs


@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fitted_configs_byte_identical(seed, which):
    recs = _records(seed, which)
    got = tautofit.dumps_config(tautofit.fit(recs))
    assert got == jautofit.dumps_config(jautofit.fit(recs))
    fitted = json.loads(got)
    assert all(fitted[k] is not None for k in
               ("ladder", "residency", "placement", "autoscaler", "blame"))


def test_rollups_feed_placement_the_same(tmp_path):
    rollup = {"busy": {"0": {"busy_frac": 0.8}, "1": {"busy_frac": 0.2}}}
    recs = _records(4, "port")[:40]
    assert tautofit.dumps_config(tautofit.fit(recs, rollups=rollup)) == \
        jautofit.dumps_config(jautofit.fit(recs, rollups=rollup))


def test_configs_load_across_packages(tmp_path):
    recs = _records(5, "jax")
    for src, dst in ((tautofit, jautofit), (jautofit, tautofit)):
        path = tmp_path / f"{src.__name__}.json"
        path.write_text(src.dumps_config(src.fit(recs)))
        assert dst.load_fitted(path) == json.loads(path.read_text())
        assert dst.ladder_from(dst.load_fitted(path), max_seq=64) == \
            src.ladder_from(src.load_fitted(path), max_seq=64)
    assert (tautofit.FITTED_KIND, tautofit.FITTED_VERSION) == \
        (jautofit.FITTED_KIND, jautofit.FITTED_VERSION)


@pytest.fixture(scope="module")
def serve_logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return {w: parity.serve_log(w, d / f"{w}.jsonl")
            for w in ("port", "jax")}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_real_logs_emit_the_same_bytes(serve_logs, which, tmp_path, capsys):
    log = serve_logs[which]
    out = {}
    for name, mod in (("port", tautofit), ("jax", jautofit)):
        path = tmp_path / f"{name}.json"
        assert mod.main([str(log), "--emit", str(path)]) == 0
        out[name] = path.read_bytes()
    capsys.readouterr()
    assert out["port"] == out["jax"]
    fitted = json.loads(out["port"])
    assert fitted["ladder"]["expected_padding"] <= \
        fitted["ladder"]["default_expected_padding"]
    assert fitted["residency"] is None  # the port emits no mem.* signals


def test_both_packages_fit_the_same_ladder(serve_logs):
    ladders = {w: tautofit.fit_paths([log])["ladder"]
               for w, log in serve_logs.items()}
    assert ladders["port"] == ladders["jax"]


CFG = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, max_seq=48, dtype="float32",
                        decode_attn="gather")
FITTED = tautofit.fit([{"kind": "serve_admit", "prompt_len": t,
                        "padded_len": t} for t in [8] * 3 + [24] * 9 + [40] * 3
                       + [56] * 2])
ENG = dict(slots=2, pool_pages=16, pages_per_seq=8, page_size=8, chunk=2,
           device="cpu")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, generator=torch.Generator().manual_seed(0),
                       device="cpu")


@pytest.mark.parametrize("cls", [EngineCore, ContinuousBatcher])
def test_engine_from_fitted_applies_the_clamped_ladder(cls, params):
    eng = cls.from_fitted(params, CFG, FITTED, **ENG)
    assert isinstance(eng, cls)
    # 56 clamps to max_seq 48; the rest as fitted
    want = tuple(sorted({min(b, CFG.max_seq)
                         for b in FITTED["ladder"]["buckets"]}))
    assert eng.prompt_buckets == want and max(want) == 48
    assert 24 in want


def test_engine_explicit_ladder_wins(params):
    eng = EngineCore.from_fitted(params, CFG, FITTED,
                                 prompt_buckets=(16, 48), **ENG)
    assert eng.prompt_buckets == (16, 48)
    no_ladder = dict(FITTED, ladder=None)
    assert EngineCore.from_fitted(params, CFG, no_ladder,
                                  **ENG).prompt_buckets is None
    with pytest.raises(ValueError, match="kind"):
        EngineCore.from_fitted(params, CFG, {"kind": "x"}, **ENG)


def test_fitted_engine_serves_its_standalone(params, _one_thread):
    from hpc_patterns_tpu_torch.models.decode import paged_generate

    eng = ContinuousBatcher.from_fitted(params, CFG, FITTED, **ENG)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, size=t).astype(np.int32)
               for t in (8, 24, 20, 40)]
    ids = [eng.submit(p, 6) for p in prompts]
    got = eng.run()
    for sid, p in zip(ids, prompts):
        want = paged_generate(params, torch.from_numpy(p)[None], CFG, 6,
                              page_size=8, device="cpu")[0].numpy()
        np.testing.assert_array_equal(got[sid], want)
    assert eng.prefill_rungs <= set(eng.prompt_buckets)


def _plane_fitted(gauges):
    recs = [{"kind": "metrics", "gauges": {
        f"plane.{k}.queue_depth": {"last": v, "min": v, "max": v, "n": 2}
        for k, v in gauges.items()}}]
    return tautofit.fit(recs)


def _replicas(params):
    return [Replica(EngineCore(params, CFG, **ENG), name=f"r{i}")
            for i in range(2)]


def test_serving_plane_from_fitted_picks_weighted(params):
    fitted = _plane_fitted({"r0": 0.0, "r1": 8.0})
    plane = ServingPlane.from_fitted(_replicas(params), fitted)
    assert plane.policy_name == "weighted"
    w = plane.placement_weights
    assert w["r0"] > w["r1"] and abs(sum(w.values()) - 1.0) < 1e-6
    # uniform gauges: round robin; an explicit policy wins over the fit
    even = _plane_fitted({"r0": 2.0, "r1": 2.0})
    assert ServingPlane.from_fitted(_replicas(params),
                                    even).policy_name == "round_robin"
    assert ServingPlane.from_fitted(_replicas(params), fitted,
                                    policy="least_loaded").policy_name == \
        "least_loaded"
    # no placement signal: the default plane
    assert ServingPlane.from_fitted(
        _replicas(params), tautofit.fit([])).policy_name == \
        ServingPlane(_replicas(params)).policy_name


def test_serve_app_autofit_serves_the_fitted_ladder(tmp_path, capsys,
                                                    _one_thread):
    from hpc_patterns_tpu_torch.apps import serve_app

    log = parity.serve_log("port", tmp_path / "run.jsonl")
    cfg_path = tmp_path / "fitted.json"
    assert tautofit.main([str(log), "--emit", str(cfg_path)]) == 0
    fitted = tautofit.load_fitted(cfg_path)
    base = [*parity.SMOKE_SERVE, "--device", "cpu", "--dtype", "float32",
            "--autofit", str(cfg_path)]
    capsys.readouterr()
    assert serve_app.main(base) == 0
    printed = capsys.readouterr().out
    ladder = list(tautofit.ladder_from(fitted, max_seq=12))
    assert f"autofit ladder from {cfg_path}: {ladder}" in printed
    assert "mismatch 0" in printed and "SUCCESS" in printed
    # an explicit --prompt-buckets wins over the fit
    assert serve_app.main(base + ["--prompt-buckets", "12"]) == 0
    assert "autofit ladder" not in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "other", "version": 1}))
    assert serve_app.main(base[:-1] + [str(bad)]) == 1
    assert "not a fitted config" in capsys.readouterr().out


def test_fit_row_records_fits_and_wins_on_padding(tmp_path, capsys,
                                                  _one_thread):
    out = tmp_path / "fitted.json"
    assert tbs.main(["--fit", "--smoke", "--device", "cpu", "--fit-out",
                     str(out)]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the strict padding win is asserted in the row before any clock;
    # both legs held every sequence against its standalone (exact in f32)
    assert r["expected_padding_fitted"] < r["expected_padding_default"]
    assert r["ladder_default"] == [16, 32, 64] and 40 in r["ladder_fitted"]
    assert r["oracle"] == {"default": {"exact": 16, "near_tie": 0},
                           "fitted": {"exact": 16, "near_tie": 0},
                           "blame_recorded": {"exact": 5, "near_tie": 0},
                           "blame_fitted": {"exact": 5, "near_tie": 0}}
    assert r["fitted_goodput_tok_s"] > 0 and "ladder" in r[
        "config_sections"]
    # the blame A/B: the seeded stall blamed on its mechanism, and the
    # blame-fitted residency shrank the blamed share
    assert r["blame_segment"] == "prefetch_wait"
    assert r["blame_share_fitted"] < r["blame_share_default"]
    fitted = tautofit.load_fitted(out)
    assert list(tautofit.ladder_from(fitted)) == r["ladder_fitted"]
    # the row replays an existing config through --autofit
    assert tbs.main(["--fit", "--smoke", "--device", "cpu", "--autofit",
                     str(out)]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["ladder_fitted"] == r["ladder_fitted"]
