"""Runlog aggregator: per-phase/per-metric summary over JSONL logs — the
counterpart of ``hpc_patterns_tpu/harness/report.py``, copied.

Point it at any run log — one app run or a whole sweep, one file or
several, written by either package — and it merges every
``kind=metrics`` snapshot (``harness/metrics.py``) into one table of
counters, gauges, and histogram percentiles, plus a result-record
summary and one line each for ``kind=trace``, ``kind=reqtrace`` and the
other rollup records. Histogram percentiles are recomputed from the
snapshots' fixed log-spaced bucket counts, so the table shows exactly
what a live registry would (quantized to bucket resolution).

Usage::

    python -m hpc_patterns_tpu_torch.harness.report run.jsonl [more.jsonl ...]

Exit 0 when records were read (even with no metrics snapshots — the
result summary still prints); 2 on unreadable/empty input.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Any, Iterable

from hpc_patterns_tpu_torch.harness.metrics import (
    BUCKET_LAYOUT,
    Gauge,
    Histogram,
)

# p99 joined in round 8: SLO accounting (harness/slo.py) judges tail
# latency, and a per-phase table without the tail hides exactly the
# requests that blow their targets. Quantized to bucket resolution
# like every column here (the exact-percentile view is slo.py's).
PERCENTILES = (50.0, 95.0, 99.0)


def load_records(paths: Iterable[str | Path]) -> list[dict[str, Any]]:
    """All JSON records across ``paths``, in file-then-line order.
    Unparseable lines are skipped (a crashed run can truncate its last
    line; the rest of the log is still worth aggregating)."""
    records = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return records


def aggregate(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Merge every ``kind=metrics`` snapshot: counters sum, gauges keep
    the last value (min/max/n across snapshots), histograms merge
    bucket counts. Returns the merged tables plus record-kind stats."""
    counters: dict[str, float] = {}
    gauges: dict[str, Gauge] = {}
    histograms: dict[str, Histogram] = {}
    kinds: dict[str, int] = {}
    traces: list[dict[str, Any]] = []
    merged_traces: list[dict[str, Any]] = []
    analyses: list[dict[str, Any]] = []
    reqtraces: list[dict[str, Any]] = []
    budgets: list[dict[str, Any]] = []
    n_ok = n_bad = n_snapshots = n_layout_skipped = 0
    for rec in records:
        kind = rec.get("kind", "?")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "result":
            if rec.get("success"):
                n_ok += 1
            else:
                n_bad += 1
        if kind == "analysis":
            # a static-analysis verdict (``python -m
            # hpc_patterns_tpu_torch.analysis --log``: torchlint, with its
            # shared-memory rollup; a JAX package log's is jaxlint's, with
            # its VMEM one), surfaced next to the runtime rollups
            analyses.append({
                "tool": rec.get("tool", "jaxlint"),
                "ok": rec.get("ok", False),
                "findings": rec.get("findings", 0),
                "suppressed": rec.get("suppressed", 0),
                "baselined": rec.get("baselined", 0),
                "files": rec.get("files", 0),
                "by_rule": rec.get("by_rule", {}),
                "smem": rec.get("smem"),
                "vmem": rec.get("vmem"),
            })
        if kind == "trace_merged":
            # cross-rank merge verdict (harness/collect.py): the
            # launcher's skew/straggler rollup over all rank timelines
            merged_traces.append({
                "n_ranks": rec.get("n_ranks", 0),
                "n_matched": rec.get("n_matched", 0),
                "align": rec.get("align", {}),
                "skew": rec.get("skew", {}),
                "schedule": rec.get("schedule", {}),
                "stragglers": rec.get("stragglers", {}),
                "out": rec.get("out"),
                "rollup_out": rec.get("rollup_out"),
            })
        if kind == "reqtrace":
            # request-lifecycle snapshot (harness/reqtrace.py):
            # surface the run's attribution coverage here; the
            # per-class tail table is the explain CLI's job
            # (`python -m hpc_patterns_tpu_torch.harness.explain`)
            reqtraces.append({
                "n": rec.get("n", 0),
                "coverage_frac": rec.get("coverage_frac"),
            })
        if kind == "slo_budget":
            # segment SLO budget breach (harness/budget.py): one row
            # per over-budget (class, axis, segment) — rendered as
            # the per-class breach table next to the percentile tables
            budgets.append({
                "priority": rec.get("priority", 0),
                "axis": rec.get("axis", "?"),
                "segment": rec.get("segment", "?"),
                "share": rec.get("share"),
                "allowance_s": rec.get("allowance_s"),
                "n": rec.get("n", 0),
                "breached": rec.get("breached", 0),
                "worst_s": rec.get("worst_s"),
            })
        if kind == "trace":
            # flight-recorder snapshot (harness/trace.py): summarize
            # the rollups here; the full timeline is the trace CLI's
            # job (`python -m hpc_patterns_tpu_torch.harness.trace`)
            traces.append({
                "n_events": rec.get("n_events", 0),
                "n_dropped": rec.get("n_dropped", 0),
                "by_cat": rec.get("by_cat", {}),
                "compile": rec.get("compile", {}),
                "peak_live_bytes": rec.get("mem", {}).get(
                    "peak_live_bytes", 0),
            })
        if kind != "metrics":
            continue
        n_snapshots += 1
        for name, value in rec.get("counters", {}).items():
            counters[name] = counters.get(name, 0) + value
        for name, snap in rec.get("gauges", {}).items():
            # null means the live value was non-finite (diverged loss):
            # last renders as "-", min/max just don't update
            g = gauges.setdefault(name, Gauge())
            g.last = (math.nan if snap["last"] is None
                      else float(snap["last"]))
            if snap["min"] is not None:
                g.min = min(g.min, float(snap["min"]))
            if snap["max"] is not None:
                g.max = max(g.max, float(snap["max"]))
            g.n += int(snap["n"])
        # bucket indices only mean the same thing under the same layout:
        # a snapshot written under a different one cannot be merged —
        # its percentiles would silently shift by up to a decade
        layout = rec.get("bucket_layout")
        if layout is not None and layout != BUCKET_LAYOUT:
            n_layout_skipped += 1
            continue
        for name, snap in rec.get("histograms", {}).items():
            h = histograms.setdefault(name, Histogram())
            h.merge(Histogram.from_snapshot(snap))
    return {
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "kinds": kinds,
        "traces": traces,
        "merged_traces": merged_traces,
        "analyses": analyses,
        "reqtraces": reqtraces,
        "budgets": budgets,
        "n_snapshots": n_snapshots,
        "n_layout_skipped": n_layout_skipped,
        "results": (n_ok, n_bad),
    }


def _fmt(v: float) -> str:
    if not math.isfinite(v):
        return "-"
    return f"{v:.4g}"


def format_report(agg: dict[str, Any], source: str = "") -> str:
    """The human table. Span histograms (``span.<path>``) are the
    per-phase timing attribution; everything else is per-metric."""
    lines = []
    n_records = sum(agg["kinds"].values())
    ok, bad = agg["results"]
    kinds = ", ".join(f"{k}={n}" for k, n in sorted(agg["kinds"].items()))
    head = f"{n_records} records"
    if source:
        head += f" from {source}"
    head += f" ({kinds})"
    lines.append(head)
    if ok or bad:
        lines.append(f"results: {ok} SUCCESS / {bad} FAILURE")
    for a in agg.get("analyses", []):
        rules = ", ".join(f"{k}={n}"
                          for k, n in sorted(a["by_rule"].items()))
        lines.append(
            f"analysis: {'CLEAN' if a['ok'] else 'FINDINGS'} — "
            f"{a['findings']} finding(s)"
            + (f" [{rules}]" if rules else "")
            + f", {a['suppressed']} suppressed"
            + (f", {a['baselined']} baselined" if a["baselined"] else "")
            + f" across {a['files']} file(s) ({a.get('tool', 'jaxlint')})")
        sm = a.get("smem")
        if sm:
            # the shared-memory rollup (analysis/smem.py): every kernel
            # instantiation, the ones whose bytes bind, the fullest named
            bound = [r for r in sm.get("rows", [])
                     if r.get("bytes") is not None]
            worst = max(bound, key=lambda r: r["bytes"] / r["limit"],
                        default=None)
            line = (f"  smem: {sm.get('kernels', 0)} kernel(s), "
                    f"{len(bound)} bound, {sm.get('over_limit', 0)} over "
                    f"the opt-in limit")
            if worst is not None:
                line += (f"; fullest {worst['kernel']} "
                         f"{worst['bytes']:,}/{worst['limit']:,} bytes")
            lines.append(line)
        vm = a.get("vmem")
        if vm:
            # the pallaslint VMEM budget rollup (analysis/vmem.py):
            # the worst model-dim kernel named so a chip session's
            # lowering failure is never the first warning
            worst = max(vm.get("rows", []),
                        key=lambda r: (r.get("bytes", 0)
                                       / max(r.get("limit", 1), 1)),
                        default=None)
            line = (f"  vmem: {vm.get('kernels', 0)} kernel(s), "
                    f"{vm.get('over_limit', 0)} over model-dim budget")
            if worst is not None:
                line += (f"; worst {worst['kernel']} "
                         f"{worst['bytes'] / 1e6:.1f}/"
                         f"{worst['limit'] / 1e6:.0f} MB")
            lines.append(line)
    for t in agg.get("merged_traces", []):
        worst_name, worst = None, 0.0
        for name, s in t["skew"].items():
            if s.get("max_start_skew_s", 0.0) >= worst:
                worst_name, worst = name, s["max_start_skew_s"]
        strag = max(t["stragglers"].items(),
                    key=lambda kv: kv[1].get("last", 0),
                    default=(None, {}))
        line = (f"trace_merged: {t['n_ranks']} rank(s), "
                f"{t['n_matched']} collective(s) matched "
                f"(clock align: {t['align'].get('method', '?')})")
        if worst_name is not None:
            line += f", max start skew {worst * 1e3:.3f} ms ({worst_name})"
        if strag[0] is not None and strag[1].get("last"):
            line += (f", straggler rank {strag[0]} "
                     f"({strag[1]['last']}/{strag[1].get('of', 0)} last)")
        # the desync check (analysis/runtime.py chains, cross-checked
        # by collect._schedule_check): one glance says whether the
        # ranks PROVABLY ran the same collective program
        sched = t.get("schedule") or {}
        if sched.get("verdict") == "consistent":
            line += (f", schedules consistent "
                     f"({sched.get('n_collectives', 0)} collectives)")
        elif sched.get("verdict") == "divergent":
            fd = sched.get("first_divergence") or {}
            line += f", SCHEDULE DIVERGENCE at #{fd.get('index', '?')}"
        if t.get("out"):
            line += f" — timeline: {t['out']}"
        if t.get("rollup_out"):
            # the versioned rollup artifact (collect --rollup-out):
            # name it so the autofit leg knows what to consume
            line += f", rollup: {t['rollup_out']}"
        lines.append(line)
    for t in agg.get("reqtraces", []):
        cov = t.get("coverage_frac")
        lines.append(
            f"reqtrace: {t['n']} request(s), attribution coverage "
            + (f"{cov:.1%}" if cov is not None else "-")
            + " — attribute: python -m hpc_patterns_tpu_torch.harness.explain")
    if agg.get("budgets"):
        # the per-class breach table (harness/budget.py): which
        # lifecycle segment alone blew the class's TTFT/TPOT target
        lines.append(f"slo budget breaches: {len(agg['budgets'])} "
                     "(class axis segment: worst/allowance, count)")
        lines.append(f"  {'class':<6} {'axis':<5} {'segment':<14} "
                     f"{'share':>6} {'allowance':>10} {'worst':>10} "
                     f"{'count':>8}")
        for b in sorted(agg["budgets"],
                        key=lambda b: (b["priority"], b["axis"],
                                       -(b.get("worst_s") or 0.0))):
            share = (f"{b['share']:.0%}"
                     if b.get("share") is not None else "-")
            allow = (f"{b['allowance_s'] * 1e3:.0f}ms"
                     if b.get("allowance_s") is not None else "-")
            worst = (f"{b['worst_s'] * 1e3:.0f}ms"
                     if b.get("worst_s") is not None else "-")
            lines.append(
                f"  {b['priority']:<6} {b['axis']:<5} "
                f"{b['segment']:<14} {share:>6} {allow:>10} "
                f"{worst:>10} {b['breached']:>4}/{b['n']:<3}")
    for t in agg.get("traces", []):
        cats = ", ".join(f"{k}={n}" for k, n in sorted(t["by_cat"].items()))
        comp = t.get("compile", {})
        mem = t.get("peak_live_bytes", 0)
        lines.append(
            f"trace: {t['n_events']} events ({cats}; "
            f"{t['n_dropped']} evicted), "
            f"{comp.get('count', 0)} compiles "
            f"totalling {_fmt(comp.get('total_s', 0.0))}s"
            + (f", peak live {mem / 1e6:.1f} MB" if mem else "")
            + " — export: python -m hpc_patterns_tpu_torch.harness.trace")
    if not agg["n_snapshots"]:
        lines.append("no kind=metrics snapshots (run apps with "
                     "--metrics --log to record them)")
        return "\n".join(lines)
    lines.append(f"merged {agg['n_snapshots']} metrics snapshot(s)")
    if agg.get("n_layout_skipped"):
        lines.append(
            f"WARNING: histograms from {agg['n_layout_skipped']} "
            "snapshot(s) skipped — written under a different bucket "
            "layout (counters/gauges still merged)")

    if agg["counters"]:
        lines.append("")
        lines.append(f"{'counter':<44} {'total':>12}")
        for name, value in sorted(agg["counters"].items()):
            lines.append(f"{name:<44} {_fmt(value):>12}")

    if agg["gauges"]:
        lines.append("")
        lines.append(f"{'gauge':<44} {'last':>12} {'min':>12} "
                     f"{'max':>12} {'n':>6}")
        for name, g in sorted(agg["gauges"].items()):
            lines.append(f"{name:<44} {_fmt(g.last):>12} {_fmt(g.min):>12} "
                         f"{_fmt(g.max):>12} {g.n:>6}")

    if agg["histograms"]:
        lines.append("")
        cols = " ".join(f"{'p%g' % q:>12}" for q in PERCENTILES)
        lines.append(f"{'histogram':<44} {'count':>8} {cols} {'max':>12}")
        for name, h in sorted(agg["histograms"].items()):
            pcts = " ".join(f"{_fmt(h.percentile(q)):>12}"
                            for q in PERCENTILES)
            hmax = h.max if h.count else math.nan
            lines.append(f"{name:<44} {h.count:>8} {pcts} "
                         f"{_fmt(hmax):>12}")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("logs", nargs="+", help="runlog JSONL file(s)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        records = load_records(args.logs)
    except OSError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    if not records:
        print("ERROR: no records in input", file=sys.stderr)
        return 2
    print(format_report(aggregate(records), source=", ".join(args.logs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
