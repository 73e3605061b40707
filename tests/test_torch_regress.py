"""The port's bench regression gate (``hpc_patterns_tpu_torch.harness.
regress``) held against the JAX package's: JAX's own tier-1 bodies
(``tests/test_regress.py``, the checked-in ``BENCH_r*.json`` read only)
run unchanged on the port's module; over the checked-in rounds and over
synthetic rounds of the port bench's line, the two gates compare the same
rows, print the same table and exit with the same code; the port bench's
``--gate DIR`` writes its rounds in the JAX round schema, never into the
repository root, and fails a halved headline.
"""

import dataclasses
import glob
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from hpc_patterns_tpu.harness import regress as jregress
from hpc_patterns_tpu_torch import bench as tbench
from hpc_patterns_tpu_torch.harness import regress as tregress

import _torch_parity as parity

REPO = Path(__file__).resolve().parent.parent
ROUNDS = sorted(glob.glob(str(REPO / "BENCH_r0*.json")))
BODIES = parity.load("test_regress")
CASES = parity.cases(BODIES, [
    "TestCheckedInTrajectory", "TestGateMechanics", "TestQuantizedSpecs",
    "TestElasticSpecs", "TestAutofitSpecs", "TestReqtraceSpecs",
    "TestStrictCoverage"])


@pytest.mark.parametrize("cls,method", CASES)
def test_jax_body_on_the_port(cls, method, request, tmp_path):
    def trajectory():
        paths = []
        for p in ROUNDS:
            shutil.copy(p, tmp_path / Path(p).name)
            paths.append(str(tmp_path / Path(p).name))
        return paths

    parity.call(BODIES, cls, method, request, trajectory=trajectory)


def test_specs_equal():
    assert [dataclasses.astuple(s) for s in tregress.SPECS] == \
        [dataclasses.astuple(s) for s in jregress.SPECS]


def _port_line(rng, *, scale=1.0, drop=()):
    """A line of the port bench's shape (``bench.overlap_headline`` plus
    ``fused_collective_detail``), numpy-seeded within a few percent of
    one reading, every key times ``scale``."""
    detail = {
        "t_dma_us": float(rng.uniform(15, 16)),
        "dma_gbps": float(rng.uniform(1000, 1050)),
        "degenerate": False, "backend": "cuda",
        "fused_allreduce_gbps": float(rng.uniform(250, 260)) * scale,
        "allreduce_busbw_gbps": float(rng.uniform(250, 260)) * scale,
        "allreduce_overlap_frac": float(rng.uniform(0.2, 0.22)),
    }
    for k in drop:
        detail.pop(k)
    value = float(rng.uniform(1.40, 1.45)) * scale
    return {"metric": "onchip_overlap_speedup", "value": value,
            "unit": "x", "vs_baseline": value / 1.4, "detail": detail}


def _write_rounds(d, lines):
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for n, parsed in enumerate(lines, 1):
        p = d / f"BENCH_r{n:02d}.json"
        p.write_text(json.dumps({"n": n, "cmd": "python -m "
                                 "hpc_patterns_tpu_torch.bench --gate",
                                 "rc": 0 if parsed else 1, "tail": "",
                                 "parsed": parsed}))
        paths.append(str(p))
    return paths


def _both(paths, capsys, *extra):
    out = {}
    for name, mod in (("port", tregress), ("jax", jregress)):
        rc = mod.main([*paths, *extra])
        cap = capsys.readouterr()
        rounds = [mod.load_round(p) for p in paths]
        res = mod.compare(rounds, tolerance=0.1)
        rows = [dataclasses.astuple(r) for r in res["rows"]]
        out[name] = (rc, cap.out, cap.err, rows, res["coverage_loss"])
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.mark.parametrize("extra", [(), ("--strict-coverage",),
                                   ("--tolerance", "0.3")])
def test_checked_in_rounds_gate_the_same(extra, capsys):
    rc, printed, _, rows, _ = _both(ROUNDS, capsys, *extra)
    assert rc == 0 and "GATE: PASS" in printed and rows


@pytest.mark.parametrize("case", ["steady", "halved", "dropped", "failed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_rounds_gate_the_same(case, seed, tmp_path, capsys):
    rng = np.random.default_rng(seed)
    lines = [_port_line(rng) for _ in range(3)]
    if case == "halved":
        lines.append(_port_line(rng, scale=0.5))
    elif case == "dropped":
        lines.append(_port_line(rng, drop=("allreduce_busbw_gbps",)))
    elif case == "failed":
        lines.append(None)
    paths = _write_rounds(tmp_path / "r", lines)
    rc, printed, err, rows, lost = _both(paths, capsys)
    if case == "halved":
        assert rc == 1 and "REGRESSION" in printed
    else:
        assert rc == 0
    if case == "dropped":
        assert lost and "coverage loss" in err
        assert _both(paths, capsys, "--strict-coverage")[0] == 1
    # the port's rounds carry no serving key: it is absent, not zero
    assert not any("serving" in r[0] for r in rows)


def test_bench_gate_writes_rounds_and_fails_a_halved_headline(tmp_path,
                                                             capsys):
    d = tmp_path / "rounds"
    line = json.dumps(_port_line(np.random.default_rng(4)))
    assert tbench.gate(line, d, argv=["--gate", str(d)]) == 0
    assert tbench.gate(line, d, argv=["--gate", str(d)]) == 0
    r2 = json.loads((d / "BENCH_r02.json").read_text())
    assert set(r2) == {"n", "cmd", "rc", "tail", "parsed"}
    assert r2["n"] == 2 and r2["rc"] == 0 and r2["parsed"] == json.loads(
        line)
    assert r2["cmd"] == f"python -m hpc_patterns_tpu_torch.bench --gate {d}"
    printed = capsys.readouterr().out
    assert "headline value" in printed and "GATE: PASS" in printed
    halved = dict(r2["parsed"], value=r2["parsed"]["value"] / 2)
    assert tbench.gate(json.dumps(halved), d) == 1
    assert "REGRESSION" in capsys.readouterr().out
    # a capture that parsed to nothing is a failed round
    assert tbench.gate("RuntimeError: no card", d) == 1
    assert json.loads((d / "BENCH_r04.json").read_text())["parsed"] is None


def test_bench_gate_refuses_the_repository_root(tmp_path):
    before = sorted(glob.glob(str(REPO / "BENCH_r*.json")))
    with pytest.raises(SystemExit, match="repository root"):
        tbench.gate("{}", REPO)
    assert sorted(glob.glob(str(REPO / "BENCH_r*.json"))) == before


def test_bench_cli_gate_on_the_cpu(tmp_path, capsys):
    d = tmp_path / "rounds"
    assert tbench.main(["--device", "cpu", "--gate", str(d)]) == 0
    printed = capsys.readouterr().out
    assert "wrote round 1" in printed and "nothing to gate" in printed
    parsed = json.loads((d / "BENCH_r01.json").read_text())["parsed"]
    assert parsed["metric"] == "onchip_overlap_speedup"
    assert parsed["detail"]["backend"] == "cpu"
