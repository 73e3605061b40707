"""SLO accounting: TTFT/TPOT attainment per priority class, goodput.

The port's copy of ``hpc_patterns_tpu/harness/slo.py`` (numpy
only, so it carries over unchanged; the JAX package's harness
``__init__`` imports jax, so the port does not import it from there).

Raw tokens/s is the throughput number every serving benchmark reports,
and it is the wrong number under load: a server can post excellent
tok/s while every interactive request blows its latency target (the
classic throughput-vs-SLO tension). The production metric is
**goodput** — tokens/s counted ONLY over requests that met their
declared service-level objectives — reported *next to* raw tok/s so
the gap between them is the visible cost of a scheduling policy.

Two latency objectives per class (the standard LLM-serving pair):

- **TTFT** (time to first token): submit → first token available.
- **TPOT** (time per output token): the mean inter-token time over the
  rest of the generation, ``(t_finish - t_first) / (tokens - 1)``.

A request ATTAINS its SLO iff it was served (not shed) and both
targets hold (a ``None`` target is trivially attained). Shed requests
— dropped by admission control before serving — count against
attainment but contribute zero tokens.

Attainment says WHETHER a class met its targets; it does not say
which mechanism ate the time when it did not. ``harness/budget.py``
splits the same two targets into per-segment allowances (shares of
TTFT/TPOT a lifecycle segment may consume) and emits a breach record
per segment that overspends — the budget layer on top of the verdict
this module renders.

The input is the serving engine's per-request stats table
(``ContinuousBatcher.stats``: ``t_submit``/``t_first``/``t_finish``/
``tokens``/``priority``/``outcome``/``preemptions`` per request).
Percentiles here are EXACT (numpy over the raw per-request values, not
bucketed) — the request count is benchmark-scale, and SLO verdicts
should not be quantized; the metrics-registry histograms
(``serve.ttft_s`` etc.) remain the bucketed live view.

Import-light (numpy only), same discipline as loadgen/chaos.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0)


@dataclass(frozen=True)
class SLOTarget:
    """Declared targets for one priority class; None = no target on
    that axis (trivially attained)."""
    ttft_s: float | None = None
    tpot_s: float | None = None


def targets_from_classes(classes: Iterable) -> dict[int, SLOTarget]:
    """{priority: SLOTarget} from ``loadgen.PriorityClass``-shaped
    objects (duck-typed: ``priority``/``ttft_slo_s``/``tpot_slo_s``)."""
    return {int(c.priority): SLOTarget(ttft_s=c.ttft_slo_s,
                                       tpot_s=c.tpot_slo_s)
            for c in classes}


def _pcts(values: list[float]) -> dict[str, float | None]:
    if not values:
        return {f"p{int(q)}": None for q in PERCENTILES}
    arr = np.asarray(values, np.float64)
    return {f"p{int(q)}": float(np.percentile(arr, q))
            for q in PERCENTILES}


def request_latencies(rec: Mapping[str, Any]) -> tuple[float | None,
                                                       float | None]:
    """(ttft_s, tpot_s) of one served request's stats record; None
    where undefined (unserved / single-token generations have no
    TPOT)."""
    if rec.get("t_first") is None or rec.get("t_submit") is None:
        return None, None
    ttft = float(rec["t_first"]) - float(rec["t_submit"])
    tokens = int(rec.get("tokens") or 0)
    tpot = None
    if rec.get("t_finish") is not None and tokens > 1:
        tpot = (float(rec["t_finish"]) - float(rec["t_first"])) / (
            tokens - 1)
    return ttft, tpot


def attained(rec: Mapping[str, Any], target: SLOTarget) -> bool:
    """Did this request meet its class targets? Shed requests never
    attain; missing targets are trivially met."""
    if rec.get("outcome") != "ok":
        return False
    ttft, tpot = request_latencies(rec)
    if target.ttft_s is not None and (ttft is None or ttft > target.ttft_s):
        return False
    if target.tpot_s is not None and tpot is not None \
            and tpot > target.tpot_s:
        return False
    return True


class AttainmentWindow:
    """A sliding window over the most recent per-request SLO judgments
    — the ONE attainment signal the serving planes emit per round (as a
    metrics gauge, a trace counter, and a ``kind=plane_attainment``
    RunLog record), so the in-process autoscaler, the launched router,
    and the offline autofit threshold fitter all read the same number
    instead of three subtly different recomputations.

    Judgments enter as requests RESOLVE (served → :func:`attained`
    verdict; shed → not attained), so the window tracks recent service
    quality, not the full-run average :func:`attainment` reports at the
    end. Pure bookkeeping: no clocks, no I/O."""

    def __init__(self, window: int = 64):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._judgments: deque[tuple[int, bool]] = deque(
            maxlen=self.window)
        self.judged = 0      # lifetime totals (per-round deltas are
        self.attained = 0    # the autoscaler's Signals currency)

    def judge(self, rec: Mapping[str, Any], target: SLOTarget) -> bool:
        """Judge one resolved stats record against its class target and
        fold the verdict into the window."""
        ok = attained(rec, target)
        self.observe(int(rec.get("priority", 0)), ok)
        return ok

    def observe(self, priority: int, ok: bool) -> None:
        self._judgments.append((int(priority), bool(ok)))
        self.judged += 1
        self.attained += int(bool(ok))

    def snapshot(self) -> dict[str, Any]:
        """``{"n", "overall", "per_class"}`` over the current window;
        ``overall`` is None while nothing has been judged."""
        per: dict[int, list[bool]] = {}
        for prio, ok in self._judgments:
            per.setdefault(prio, []).append(ok)
        n = len(self._judgments)
        return {
            "n": n,
            "overall": (sum(ok for _, ok in self._judgments) / n
                        if n else None),
            "per_class": {p: sum(v) / len(v)
                          for p, v in sorted(per.items())},
        }


def attainment(stats: Mapping[int, Mapping[str, Any]],
               targets: Mapping[int, SLOTarget],
               wall_s: float) -> dict[str, Any]:
    """The SLO rollup over an engine's stats table.

    Returns ``{"wall_s", "classes": {priority: {...}}, "total": {...}}``
    where each class entry carries counts (``n``/``served``/``shed``/
    ``attained``), exact TTFT/TPOT percentiles, raw ``tok_s`` and
    ``goodput_tok_s`` (SLO-attained tokens over the same wall clock),
    and the declared targets; ``total`` aggregates across classes. A
    priority with no declared target gets the all-None
    :class:`SLOTarget` (trivially attained when served)."""
    classes: dict[int, dict[str, Any]] = {}
    by_prio: dict[int, list[Mapping[str, Any]]] = {}
    for rec in stats.values():
        by_prio.setdefault(int(rec.get("priority", 0)), []).append(rec)
    tot_tokens = tot_good = 0
    tot_n = tot_served = tot_shed = tot_attained = tot_preempt = 0
    for prio in sorted(by_prio):
        recs = by_prio[prio]
        target = targets.get(prio, SLOTarget())
        ttfts, tpots = [], []
        n_served = n_shed = n_att = tokens = good = n_preempt = 0
        for rec in recs:
            if rec.get("outcome") == "shed":
                n_shed += 1
                continue
            if rec.get("outcome") != "ok":
                continue  # still in flight: not judged
            n_served += 1
            tokens += int(rec.get("tokens") or 0)
            n_preempt += int(rec.get("preemptions") or 0)
            ttft, tpot = request_latencies(rec)
            if ttft is not None:
                ttfts.append(ttft)
            if tpot is not None:
                tpots.append(tpot)
            if attained(rec, target):
                n_att += 1
                good += int(rec.get("tokens") or 0)
        n = n_served + n_shed
        classes[prio] = {
            "n": n, "served": n_served, "shed": n_shed,
            "attained": n_att, "preemptions": n_preempt,
            "tokens": tokens,
            "attained_frac": (n_att / n) if n else None,
            "ttft_s": _pcts(ttfts), "tpot_s": _pcts(tpots),
            "tok_s": tokens / wall_s if wall_s > 0 else 0.0,
            "goodput_tok_s": good / wall_s if wall_s > 0 else 0.0,
            "target": {"ttft_s": target.ttft_s, "tpot_s": target.tpot_s},
        }
        tot_tokens += tokens
        tot_good += good
        tot_n += n
        tot_served += n_served
        tot_shed += n_shed
        tot_attained += n_att
        tot_preempt += n_preempt
    return {
        "wall_s": wall_s,
        "classes": classes,
        "total": {
            "n": tot_n, "served": tot_served, "shed": tot_shed,
            "attained": tot_attained, "preemptions": tot_preempt,
            "tokens": tot_tokens,
            "attained_frac": (tot_attained / tot_n) if tot_n else None,
            "tok_s": tot_tokens / wall_s if wall_s > 0 else 0.0,
            "goodput_tok_s": tot_good / wall_s if wall_s > 0 else 0.0,
        },
    }


def format_slo(report: Mapping[str, Any]) -> str:
    """The human table: one row per class plus the total — goodput
    NEXT TO raw tok/s, the whole point."""
    lines = []
    t = report["total"]
    lines.append(
        f"SLO over {t['n']} request(s) in {report['wall_s']:.3f}s: "
        f"{t['attained']} attained / {t['shed']} shed / "
        f"{t['preemptions']} preemption(s); "
        f"{t['tok_s']:,.1f} tok/s raw, "
        f"{t['goodput_tok_s']:,.1f} tok/s goodput")
    if report["classes"]:
        lines.append(
            f"{'class':<6} {'n':>4} {'attained':>9} {'shed':>5} "
            f"{'ttft p50':>10} {'ttft p99':>10} {'tpot p99':>10} "
            f"{'tok/s':>10} {'goodput':>10}")
    for prio, c in sorted(report["classes"].items()):
        def _f(v):
            return "-" if v is None else f"{v * 1e3:.1f}ms"
        att = ("-" if c["attained_frac"] is None
               else f"{c['attained']}/{c['n']}")
        lines.append(
            f"p{prio:<5} {c['n']:>4} {att:>9} {c['shed']:>5} "
            f"{_f(c['ttft_s']['p50']):>10} {_f(c['ttft_s']['p99']):>10} "
            f"{_f(c['tpot_s']['p99']):>10} "
            f"{c['tok_s']:>10,.1f} {c['goodput_tok_s']:>10,.1f}")
    return "\n".join(lines)
