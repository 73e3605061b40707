"""The port's copy of the load generator (``hpc_patterns_tpu_torch.
harness.loadgen``) and the engine's ladder fit, against the JAX
package's: the same arguments give the same schedule JSON (arrival
instants, classes, shapes and spec) for every process, the same staged
and shared-prefix schedules and prompt bytes, and ``fit_bucket_ladder`` /
``expected_padding`` give JAX's ladders and padding on the cases of
``tests/test_serving_plane.py::TestLadderAutotune``.
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

from hpc_patterns_tpu.harness import loadgen as jlg  # noqa: E402
from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu_torch.harness import loadgen as tlg  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402


def _classes(mod):
    return (mod.PriorityClass("interactive", 0, weight=0.4, ttft_slo_s=3.0,
                              tpot_slo_s=1.0, deadline_s=30.0),
            mod.PriorityClass("batch", 1, weight=0.6))


@pytest.mark.parametrize("process,kw", [
    ("poisson", {}),
    ("bursty", dict(burst_factor=8.0, mean_quiet_s=0.5, mean_burst_s=0.2)),
    ("diurnal", dict(period_s=2.0, depth=0.8)),
])
@pytest.mark.parametrize("seed", [7, 11])
def test_make_schedule_json_equals_jax(process, kw, seed):
    args = dict(rate_rps=32.0, prompt_lens=(32, 64, 128),
                budgets=(32, 128, 256), budget_probs=(0.5, 0.3, 0.2),
                process=process, seed=seed, **kw)
    j = jlg.make_schedule(32, classes=_classes(jlg), **args)
    t = tlg.make_schedule(32, classes=_classes(tlg), **args)
    assert t.to_json() == j.to_json()
    back = tlg.Schedule.from_json(j.to_json())
    assert back.to_json() == j.to_json() and back.n == 32
    assert t.duration_s == j.duration_s


def test_staged_and_shared_prefix_equal_jax():
    ji, jb = _classes(jlg)
    ti, tb = _classes(tlg)
    stages = [(0.0, 1, 32, 160), (0.05, 0, 16, 16), (0.1, 1, 32, 160)]
    j = jlg.staged_schedule([(t, (ji, jb)[c], p, m)
                             for t, c, p, m in stages], spec={"name": "s"})
    t = tlg.staged_schedule([(t, (ti, tb)[c], p, m)
                             for t, c, p, m in stages], spec={"name": "s"})
    assert t.to_json() == j.to_json()
    args = dict(rate_rps=20.0, n_templates=3, template_len=(8, 16, 24),
                tail_lens=(4, 8), budgets=(8, 16), tree_frac=0.3, seed=5)
    j = jlg.make_shared_prefix_schedule(12, classes=(ji, jb), **args)
    t = tlg.make_shared_prefix_schedule(12, classes=(ti, tb), **args)
    assert t.to_json() == j.to_json()
    for i in range(12):
        np.testing.assert_array_equal(
            tlg.materialize_prompt(t, i, 256, seed=3),
            jlg.materialize_prompt(j, i, 256, seed=3))


def test_fit_beats_default_on_long_tail_like_jax():
    rng = np.random.RandomState(0)
    lengths = (list(rng.choice([7, 9, 11, 13], size=400))
               + list(rng.choice([100, 240], size=20)))
    default = tsrv.bucket_ladder(256)
    fit = tsrv.fit_bucket_ladder(lengths, max_rungs=len(default),
                                 max_len=256)
    assert fit == jsrv.fit_bucket_ladder(lengths, max_rungs=len(default),
                                         max_len=256)
    assert tsrv.expected_padding(fit, lengths) \
        < tsrv.expected_padding(default, lengths)
    assert tsrv.expected_padding(fit, lengths) == \
        jsrv.expected_padding(fit, lengths)
    assert max(fit) >= 256 and len(fit) <= len(default)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_fit_is_optimal_on_small_cases_like_jax(r):
    lengths = [2, 2, 5, 9, 9, 9, 14]
    cand = sorted(set(lengths))
    fit = tsrv.fit_bucket_ladder(lengths, r)
    assert fit == jsrv.fit_bucket_ladder(lengths, r)
    best = min(tsrv.expected_padding(c + (max(cand),), lengths)
               for k in range(r)
               for c in itertools.combinations(cand[:-1], k))
    assert tsrv.expected_padding(fit, lengths) == pytest.approx(best)


def test_fit_guards_and_degenerates_like_jax():
    for args, kw in ((([5, 5, 5], 3), {}), (([3], 1), {"max_len": 10})):
        assert tsrv.fit_bucket_ladder(*args, **kw) == \
            jsrv.fit_bucket_ladder(*args, **kw)
    assert tsrv.fit_bucket_ladder([3], 1, max_len=10) == (10,)
    for bad in (([], 2), ([4], 0)):
        with pytest.raises(ValueError):
            tsrv.fit_bucket_ladder(*bad)
    assert tsrv.bucket_ladder.fit is tsrv.fit_bucket_ladder
    assert tsrv.expected_padding(None, [3, 4]) == 0.0
