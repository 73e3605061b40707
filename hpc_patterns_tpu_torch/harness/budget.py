"""Per-segment SLO budgets: alert when ONE lifecycle segment alone
blows the target — the counterpart of
``hpc_patterns_tpu/harness/budget.py``, copied.

The attainment rollup (harness/slo.py) says *whether* a class missed
its TTFT/TPOT target; the attribution digest (harness/explain.py)
says *where* the tail's time went. This module closes the gap between
them: an :class:`SLOBudget` declares how much of each target a single
segment is ALLOWED to eat (``admit_wait <= 0.3 * ttft_slo_s``), and a
pure evaluator walks the finalized ``reqtrace`` segment tilings per
priority class and emits one breach record per over-budget
``(class, axis, segment)`` — so "p99 missed" becomes "prefetch_wait
spent 62ms of its 34ms decode allowance on 3 of 5 requests" before
anyone opens a trace.

Axes mirror slo.py's two latencies:

- **ttft**: segment time inside ``[t_submit, t_first]`` vs
  ``share * ttft_slo_s``;
- **tpot**: segment time inside ``[t_first, t_finish]`` (the decode
  phase) vs ``share * tpot_slo_s * (tokens - 1)`` — the whole-phase
  allowance implied by the per-token target, so a single long stall
  and death-by-a-thousand-pauses are judged by the same yardstick.

The evaluator is pure (snapshot in, records out). :func:`publish`
does the side effects: ``kind=slo_budget`` through a RunLog emit
(rendered by harness/report.py as the per-class breach table) and a
``budget.breach.<segment>`` counter per breached segment. The
``--explain`` surfaces (bench_serving's scenario row) print
:func:`format_budget`'s loud section.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import reqtrace

#: record kind of one breach row (consumed by harness/report.py)
BUDGET_KIND = "slo_budget"


@dataclass(frozen=True)
class SLOBudget:
    """Per-segment shares of the TTFT/TPOT targets. A segment absent
    from a map is unbudgeted (never breaches); shares may sum past
    1.0 — each is an independent alarm line, not a partition."""

    ttft_shares: Mapping[str, float] = field(default_factory=dict)
    tpot_shares: Mapping[str, float] = field(default_factory=dict)


#: conservative default: scheduling may eat half the TTFT target,
#: admission a third; any single decode-phase stall mechanism may eat
#: a third of the decode allowance; unclaimed time is alarmed tight
#: on both axes (untracked time hiding a stall is itself a finding)
DEFAULT_BUDGET = SLOBudget(
    ttft_shares={"queued": 0.5, "admit_wait": 0.3, "preempted": 0.3,
                 "untracked": 0.15},
    tpot_shares={"preempted": 0.35, "swapped_out": 0.35,
                 "prefetch_wait": 0.35, "migrating": 0.35,
                 "untracked": 0.15},
)


def _segment_time(tiled: Iterable, lo: float, hi: float
                  ) -> dict[str, float]:
    """Per-kind seconds of one request's canonical tiling inside
    ``[lo, hi]`` (the same intersection explain's windows use)."""
    out: dict[str, float] = {}
    for kind, s0, s1, _meta in tiled:
        ov = min(float(s1), hi) - max(float(s0), lo)
        if ov > 0:
            out[kind] = out.get(kind, 0.0) + ov
    return out


def evaluate(snapshot: Mapping[str, Any],
             targets: Mapping[int, Any],
             budget: SLOBudget = DEFAULT_BUDGET) -> list[dict[str, Any]]:
    """Walk one ``kind=reqtrace`` snapshot against per-class SLO
    targets (``{priority: slo.SLOTarget}``, the engine's ``slo=``
    map) and return one record per breached ``(class, axis,
    segment)`` — empty list when every segment stayed inside its
    allowance. Pure: no emission, no counters (see :func:`publish`)."""
    # (priority, axis, segment) -> running aggregate
    agg: dict[tuple[int, str, str], dict[str, Any]] = {}

    def _check(prio: int, axis: str, seg: str, share: float,
               spent: float, allowance: float, sid: int) -> None:
        key = (prio, axis, seg)
        a = agg.setdefault(key, {
            "kind": BUDGET_KIND, "priority": prio, "axis": axis,
            "segment": seg, "share": float(share), "allowance_s": 0.0,
            "n": 0, "breached": 0, "worst_s": 0.0,
            "worst_seq_id": None,
        })
        a["n"] += 1
        if spent > allowance:
            a["breached"] += 1
        if spent >= a["worst_s"]:
            a["worst_s"] = float(spent)
            a["worst_seq_id"] = sid
            # report the allowance of the worst offender: on the tpot
            # axis it scales with the request's own token count
            a["allowance_s"] = float(allowance)

    for sid_str, entry in (snapshot.get("requests") or {}).items():
        sid = int(sid_str)
        prio = int(entry.get("priority") or 0)
        tgt = targets.get(prio)
        if tgt is None:
            continue
        t_submit = entry.get("t_submit")
        t_first = entry.get("t_first")
        t_finish = entry.get("t_finish")
        if t_submit is None or t_finish is None:
            continue  # still in flight: no finalized window to judge
        tiled, _ = reqtrace.finalize(entry.get("segments") or (),
                                     t_submit, t_finish)
        ttft_slo = getattr(tgt, "ttft_slo_s", None)
        if ttft_slo is None:
            ttft_slo = getattr(tgt, "ttft_s", None)
        tpot_slo = getattr(tgt, "tpot_slo_s", None)
        if tpot_slo is None:
            tpot_slo = getattr(tgt, "tpot_s", None)
        if ttft_slo is not None and t_first is not None:
            spent = _segment_time(tiled, float(t_submit),
                                  float(t_first))
            for seg, share in budget.ttft_shares.items():
                _check(prio, "ttft", seg, share,
                       spent.get(seg, 0.0), share * float(ttft_slo),
                       sid)
        tokens = int(entry.get("tokens") or 0)
        if tpot_slo is not None and t_first is not None and tokens >= 2:
            spent = _segment_time(tiled, float(t_first),
                                  float(t_finish))
            decode_allow = float(tpot_slo) * (tokens - 1)
            for seg, share in budget.tpot_shares.items():
                _check(prio, "tpot", seg, share,
                       spent.get(seg, 0.0), share * decode_allow, sid)

    return sorted((a for a in agg.values() if a["breached"]),
                  key=lambda a: (a["priority"], a["axis"],
                                 -a["worst_s"]))


def breached_segments(breaches: Iterable[Mapping[str, Any]]
                      ) -> set[str]:
    return {str(b["segment"]) for b in breaches}


def publish(breaches: Iterable[Mapping[str, Any]],
            emit: Callable[..., Any] | None = None) -> None:
    """The side-effect half: one ``kind=slo_budget`` record per breach
    through ``emit`` (a RunLog.emit) and a ``budget.breach.<segment>``
    counter bump per breached request."""
    m = metricslib.get_metrics()
    for b in breaches:
        if emit is not None:
            emit(**dict(b))
        if m.enabled:
            m.counter(f"budget.breach.{b['segment']}").inc(
                int(b["breached"]))


def _ms(v: float) -> str:
    return f"{v * 1e3:.0f}ms"


def format_budget(breaches: list[dict[str, Any]]) -> str:
    """The loud ``--explain`` section: name the over-budget segment
    with its spend vs allowance, or say plainly that every segment
    stayed inside."""
    if not breaches:
        return "slo budgets: all segments within allowance"
    lines = ["SLO BUDGET BREACHES:"]
    for b in breaches:
        lines.append(
            f"  class {b['priority']} {b['axis']}: {b['segment']} "
            f"spent {_ms(b['worst_s'])} of {_ms(b['allowance_s'])} "
            f"allowance ({b['share']:.0%} of target) — "
            f"{b['breached']}/{b['n']} request(s), worst seq "
            f"{b['worst_seq_id']}")
    return "\n".join(lines)
