"""The port's segment SLO budgets (``hpc_patterns_tpu_torch.harness.
budget``) held against the JAX package's: JAX's own tier-1 bodies
(``tests/test_budget.py``) run unchanged on the port's module; on request
traces written by both packages' recorders from numpy-seeded transitions
at fixed instants, and on real ``serve_app --explain`` runs of the smoke
model in both packages, the two evaluators return the same breach rows
and format the same table; ``publish`` emits the same records and bumps
the same counters.
"""

import pytest

from hpc_patterns_tpu.harness import budget as jbudget
from hpc_patterns_tpu.harness import metrics as jm
from hpc_patterns_tpu.harness import reqtrace as jrt
from hpc_patterns_tpu.harness import slo as jslo
from hpc_patterns_tpu_torch.harness import budget as tbudget
from hpc_patterns_tpu_torch.harness import metrics as tm
from hpc_patterns_tpu_torch.harness import reqtrace as trt
from hpc_patterns_tpu_torch.harness import slo as tslo
from hpc_patterns_tpu_torch.harness.report import load_records

import _torch_parity as parity

BODIES = parity.load("test_budget")
CASES = parity.cases(BODIES, ["TestEvaluate", "TestPublishAndFormat"])

#: per-class targets tight enough that the seeded traces breach on both
#: axes (the classes of bench_serving's scenario are 3 s / 1 s)
TIGHT = {0: (0.08, 0.02), 1: (0.15, 0.05)}
#: a budget on every kind the seeded walks stamp
WIDE = dict(ttft_shares={"queued": 0.2, "admit_wait": 0.2, "prefill": 0.5,
                         "untracked": 0.05},
            tpot_shares={k: 0.2 for k in parity.SEEDED_KINDS[2:]})


@pytest.fixture(autouse=True)
def _metrics_off():
    yield
    tm.configure(enabled=False)
    jm.configure(enabled=False)


@pytest.mark.parametrize("cls,method", CASES)
def test_jax_body_on_the_port(cls, method, request):
    parity.call(BODIES, cls, method, request)


def _targets(slo_mod):
    return {p: slo_mod.SLOTarget(ttft_s=a, tpot_s=b)
            for p, (a, b) in TIGHT.items()}


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breach_rows_and_table_equal(seed, which, wide):
    snap = parity.seeded_reqtrace(trt if which == "port" else jrt, seed)
    tb = tbudget.SLOBudget(**WIDE) if wide else tbudget.DEFAULT_BUDGET
    jb = jbudget.SLOBudget(**WIDE) if wide else jbudget.DEFAULT_BUDGET
    got = tbudget.evaluate(snap, _targets(tslo), tb)
    want = jbudget.evaluate(snap, _targets(jslo), jb)
    assert got == want and got  # the tight targets breach
    assert tbudget.format_budget(got) == jbudget.format_budget(want)
    assert tbudget.breached_segments(got) == jbudget.breached_segments(
        want)


@pytest.mark.parametrize("seed", [0, 1])
def test_publish_emits_and_counts_the_same(seed):
    snap = parity.seeded_reqtrace(trt, seed)
    breaches = tbudget.evaluate(snap, _targets(tslo))
    runs = {}
    for name, budget, metrics in (("port", tbudget, tm),
                                  ("jax", jbudget, jm)):
        emitted = []
        metrics.configure(enabled=True)
        budget.publish(breaches, emit=lambda **kw: emitted.append(kw))
        runs[name] = (emitted, metrics.get_metrics().snapshot()["counters"])
        metrics.configure(enabled=False)
    assert runs["port"] == runs["jax"]
    emitted, counters = runs["port"]
    assert [r["kind"] for r in emitted] == ["slo_budget"] * len(breaches)
    assert sum(counters.values()) == sum(b["breached"] for b in breaches)


@pytest.fixture(scope="module")
def serve_snaps(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    out = {}
    for which in ("port", "jax"):
        log = parity.serve_log(which, d / f"{which}.jsonl")
        (out[which],) = [r for r in load_records([log])
                         if r.get("kind") == "reqtrace"]
    return out


@pytest.mark.parametrize("which", ["port", "jax"])
def test_real_serve_traces_breach_the_same(serve_snaps, which):
    snap = serve_snaps[which]
    # the smoke stream queues behind two slots for tens of ms: a 5 ms
    # TTFT target breaches its queued share on both packages' runs
    targets = {0: (0.005, 0.001)}
    got = tbudget.evaluate(snap, {p: tslo.SLOTarget(*t)
                                  for p, t in targets.items()})
    want = jbudget.evaluate(snap, {p: jslo.SLOTarget(*t)
                                   for p, t in targets.items()})
    assert got == want
    assert "queued" in tbudget.breached_segments(got)
    assert tbudget.format_budget(got) == jbudget.format_budget(want)
