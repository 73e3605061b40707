"""torchlint against jaxlint on the same inputs.

- Every JAX shardlint and host-sync fixture (and the suppression
  fixture) has a line-for-line torch twin in
  ``tests/fixtures/analysis_torch/``; the port's findings on the twin
  equal JAX's on the original, as (line, rule) sets, live and suppressed
  (JAX's rule names mapped to the port's where a torch hazard takes a
  JAX rule's place).
- JAX's five contractlint fixture pairs run through both analyzers give
  equal (line, rule) sets: the extraction is framework-free, copied.
- Suppression parsing agrees on the same source with the prefix swapped,
  and a baseline written by either engine loads in the other.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from hpc_patterns_tpu.analysis import core as jcore
from hpc_patterns_tpu_torch.analysis import core as tcore

JAX_FIX = Path(__file__).parent / "fixtures" / "analysis"
TORCH_FIX = Path(__file__).parent / "fixtures" / "analysis_torch"

#: JAX rule -> the port rule that takes its hazard's place
RULE_MAP = {"donation-alias": "inplace-alias",
            "recompile-hazard": "rebuild-hazard",
            "prng-key-reuse": "generator-reuse",
            "tracer-leak": "autograd-leak"}

TWINS = [f"{kind}_{name}.py" for name in (
    "host_sync", "collective_divergence", "collective_order",
    "unchecked_permutation", "spec_mismatch") for kind in ("bad", "clean")
] + ["suppressed.py"]

CONTRACT = [f"{kind}_{name}.py" for name in (
    "gate_key_orphan", "record_kind_drift", "wire_field_compat",
    "track_band_collision", "chaos_site_drift") for kind in ("bad", "clean")]

CONTRACT_RULES = frozenset({"gate-key-orphan", "record-kind-drift",
                            "wire-field-compat", "track-band-collision",
                            "chaos-site-drift"})


def _sets(findings, mapped=False):
    return {(f.line, RULE_MAP.get(f.rule, f.rule) if mapped else f.rule)
            for f in findings}


@pytest.mark.parametrize("name", TWINS)
def test_twin_findings_equal_jaxs_line_for_line(name):
    j_src = (JAX_FIX / name).read_text().splitlines()
    t_src = (TORCH_FIX / name).read_text().splitlines()
    assert len(j_src) == len(t_src), "a twin keeps every line's number"
    j_live, j_supp = jcore.analyze_file(JAX_FIX / name)
    t_live, t_supp = tcore.analyze_file(TORCH_FIX / name)
    assert _sets(t_live) == _sets(j_live, mapped=True)
    assert _sets(t_supp) == _sets(j_supp, mapped=True)
    if name.startswith("bad_"):
        assert t_live  # the twin is a caught hazard, not an empty match


@pytest.mark.parametrize("name", CONTRACT)
def test_contractlint_equal_on_jaxs_fixtures(name):
    j_live, _ = jcore.analyze_file(
        JAX_FIX / name, jcore.AnalysisConfig(select=CONTRACT_RULES))
    t_live, _ = tcore.analyze_file(
        JAX_FIX / name, tcore.AnalysisConfig(select=CONTRACT_RULES))
    assert _sets(t_live) == _sets(j_live)
    assert bool(t_live) == name.startswith("bad_")


def test_suppression_parsing_agrees_with_the_prefix_swapped():
    src = (JAX_FIX / "suppressed.py").read_text()
    j_known = frozenset(jcore.registered_rules())
    t_known = frozenset(tcore.registered_rules())
    j_map, j_bad = jcore.parse_suppressions(
        jcore.ModuleInfo.parse("s.py", src), j_known)
    swapped = src.replace("jaxlint", "torchlint")
    for old, new in RULE_MAP.items():
        swapped = swapped.replace(f"disable={old}", f"disable={new}")
    t_map, t_bad = tcore.parse_suppressions(
        tcore.ModuleInfo.parse("s.py", swapped), t_known)
    assert {ln: {RULE_MAP.get(r, r) for r in rs}
            for ln, rs in j_map.items()} == t_map
    assert [(f.line, f.rule) for f in j_bad] == [
        (f.line, f.rule) for f in t_bad]


def test_baselines_round_trip_across_the_engines(tmp_path):
    j_report = jcore.run_paths([JAX_FIX / "bad_host_sync.py"])
    t_report = tcore.run_paths([TORCH_FIX / "bad_host_sync.py"])
    jb, tb = tmp_path / "j.json", tmp_path / "t.json"
    jcore.write_baseline(jb, j_report.findings)
    tcore.write_baseline(tb, t_report.findings)
    assert tcore.load_baseline(jb) == jcore.load_baseline(jb)
    assert jcore.load_baseline(tb) == tcore.load_baseline(tb)
    # the same hazards at the same lines: equal keys, the paths aside
    strip = lambda keys: {(r, ln) for _, r, ln in keys}  # noqa: E731
    assert strip(tcore.load_baseline(tb)) == strip(jcore.load_baseline(jb))
    again = tcore.run_paths([TORCH_FIX / "bad_host_sync.py"],
                            baseline=tcore.load_baseline(tb))
    assert not again.findings and len(again.baselined) == 6
