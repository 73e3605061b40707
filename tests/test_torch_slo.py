"""The port's copy of the SLO accounting (``hpc_patterns_tpu_torch.
harness.slo``) against the JAX package's: ``attainment`` over one stats
table (served, shed, in-flight and migrated rows, several classes, rows
that miss each target) is the same rollup, and so are the class targets,
the per-request latencies, the sliding window and the formatted table.
"""

import pytest

pytest.importorskip("jax")

from hpc_patterns_tpu.harness import loadgen as jlg  # noqa: E402
from hpc_patterns_tpu.harness import slo as jslo  # noqa: E402
from hpc_patterns_tpu_torch.harness import loadgen as tlg  # noqa: E402
from hpc_patterns_tpu_torch.harness import slo as tslo  # noqa: E402

STATS = {
    0: {"priority": 0, "t_submit": 0.0, "t_first": 0.5, "t_finish": 2.5,
        "tokens": 5, "outcome": "ok", "preemptions": 0},
    1: {"priority": 0, "t_submit": 0.1, "t_first": 4.0, "t_finish": 5.0,
        "tokens": 3, "outcome": "ok", "preemptions": 1},   # misses TTFT
    2: {"priority": 0, "t_submit": 0.2, "t_first": 0.3, "t_finish": 9.3,
        "tokens": 4, "outcome": "ok", "preemptions": 0},   # misses TPOT
    3: {"priority": 1, "t_submit": 0.0, "t_first": None, "t_finish": 0.4,
        "tokens": 0, "outcome": "shed", "preemptions": 0},
    4: {"priority": 1, "t_submit": 0.0, "t_first": 1.0, "t_finish": 1.0,
        "tokens": 1, "outcome": "ok", "preemptions": 0},   # no TPOT
    5: {"priority": 1, "t_submit": 0.3, "t_first": 0.9, "t_finish": None,
        "tokens": 0, "outcome": None, "preemptions": 0},   # in flight
    6: {"priority": 2, "t_submit": 0.0, "t_first": 0.2, "t_finish": None,
        "tokens": 0, "outcome": "migrated", "preemptions": 0},
}


def _targets(mod):
    return {0: mod.SLOTarget(ttft_s=3.0, tpot_s=1.0),
            1: mod.SLOTarget(ttft_s=2.0)}


@pytest.mark.parametrize("wall_s", [10.0, 0.0])
def test_attainment_equals_jax(wall_s):
    got = tslo.attainment(STATS, _targets(tslo), wall_s)
    want = jslo.attainment(STATS, _targets(jslo), wall_s)
    assert got == want
    assert got["total"]["attained"] == 2 and got["total"]["shed"] == 1
    assert tslo.format_slo(got) == jslo.format_slo(want)


def test_targets_latencies_and_window_equal_jax():
    classes = (tlg.PriorityClass("i", 0, ttft_slo_s=3.0, tpot_slo_s=1.0),
               tlg.PriorityClass("b", 1))
    jclasses = (jlg.PriorityClass("i", 0, ttft_slo_s=3.0, tpot_slo_s=1.0),
                jlg.PriorityClass("b", 1))
    t, j = (tslo.targets_from_classes(classes),
            jslo.targets_from_classes(jclasses))
    assert {k: (v.ttft_s, v.tpot_s) for k, v in t.items()} == \
        {k: (v.ttft_s, v.tpot_s) for k, v in j.items()}
    tw, jw = tslo.AttainmentWindow(4), jslo.AttainmentWindow(4)
    for sid, rec in STATS.items():
        assert tslo.request_latencies(rec) == jslo.request_latencies(rec)
        prio = rec["priority"]
        assert tw.judge(rec, t.get(prio, tslo.SLOTarget())) == \
            jw.judge(rec, j.get(prio, jslo.SLOTarget()))
    assert tw.snapshot() == jw.snapshot()
    assert (tw.judged, tw.attained) == (jw.judged, jw.attained)
    with pytest.raises(ValueError):
        tslo.AttainmentWindow(0)
