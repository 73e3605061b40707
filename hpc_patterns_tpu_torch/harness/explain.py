"""Tail attribution: render WHERE every p99 went, per class — the
counterpart of ``hpc_patterns_tpu/harness/explain.py``, copied.

The read side of harness/reqtrace.py. Input is one or more
``kind=reqtrace`` RunLog records (each request's segment history
zipped with its stats endpoints); output is the question the
device-centric ladder could never answer: *for the requests that blew
the tail, which lifecycle state ate the time?* —

    class 0 (interactive)  n=24  ttft p99 812ms
      p99-TTFT band: 61% queued, 22% prefill, 9% admit_wait, ...

Attribution is over the **TTFT window** ``[t_submit, t_first]`` (the
window the SLO judges; a request that was shed before serving is
attributed over its whole ``[t_submit, t_finish]`` life instead), on
the canonical tiling :func:`reqtrace.finalize` produces — so shares
per request sum to exactly 1.0 and unclaimed time shows up as an
explicit ``untracked`` share, never as a silently shrunk denominator.
The tail band is the class's requests with TTFT at or above the exact
p99 (numpy over raw values, the harness/slo.py discipline — at bench
scale that is "the worst few requests", which is the point).

Attribution does NOT stop at the first token: the **inter-token
digest** tiles the same canonical segments over every gap between
consecutive token-availability stamps (``token_ts`` in the stats
table, stamped at chunk readback by models/serving.py) inside
``[t_first, t_finish]`` — so a decode-phase stall (a swap, a pull, a
preemption, a migration) is blamed on the mechanism that caused it
instead of vanishing into a fat TPOT mean. The gap band is the gaps
at/above the exact pooled p99 of gap width.

Three numbers feed the bench gate (harness/regress.py):

- ``coverage_frac`` — 1 - untracked share over all finished requests
  (gated HIGHER with tight slack: attribution that quietly loses
  coverage is worse than no attribution);
- ``ttft_p99_queue_share`` — queued share of the pooled p99 band's
  TTFT windows (captured per round; the single scalar that says
  whether the tail is a scheduling problem or a compute problem);
- ``tpot_p99_stall_share`` — the :data:`TPOT_STALL_KINDS` share of
  the pooled p99 inter-token gap band (the single scalar that says
  whether the decode tail is the model or the memory/control plane).

Usage::

    python -m hpc_patterns_tpu_torch.harness.explain run.jsonl [more ...]
           [--worst N] [-o digest.json]

Exit 0 when at least one reqtrace record was found; 2 otherwise.
The same :func:`digest`/:func:`format_explain` pair backs the
``--explain`` flag of serve_app and bench_serving
(harness/cli.add_explain_args).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np

from hpc_patterns_tpu_torch.harness import reqtrace
from hpc_patterns_tpu_torch.harness.report import load_records

#: how many worst-TTFT requests the digest itemizes by default
WORST_N = 5

#: decode-phase segment kinds the inter-token digest counts as STALL
#: time — everything that is not the row making forward progress (or
#: the explicit unclaimed remainder). ``decode``/``prefill`` in a gap
#: is compute; these are the mechanisms a fitter can act on.
TPOT_STALL_KINDS = ("preempted", "swapped_out", "prefetch_wait",
                    "migrating", "untracked")


def _decode_gaps(entry: Mapping[str, Any]) -> list[tuple[float, float]]:
    """Inter-token windows of one request: consecutive pairs of token
    availability stamps, clamped to ``[t_first, t_finish]``. Empty for
    shed rows (no tokens), single-token responses (no gap), and legacy
    snapshots without ``token_ts``."""
    ts = entry.get("token_ts") or ()
    t_first, t_finish = entry.get("t_first"), entry.get("t_finish")
    if t_first is None or t_finish is None or len(ts) < 2:
        return []
    lo, hi = float(t_first), float(t_finish)
    pts = sorted(min(max(float(t), lo), hi) for t in ts)
    return [(a, b) for a, b in zip(pts, pts[1:]) if b - a > 0]


def _gap_rows(entry: Mapping[str, Any]
              ) -> list[tuple[dict[str, float], float]]:
    """``(shares, width_s)`` per inter-token gap of one request —
    the same canonical :func:`reqtrace.finalize` tiling the TTFT
    window uses, intersected with each gap, so shares per gap sum to
    exactly 1.0 (a gap fully inside one stamped ``decode`` span is
    100% decode — honest: the chunk was simply slow)."""
    gaps = _decode_gaps(entry)
    if not gaps:
        return []
    tiled, _ = reqtrace.finalize(entry.get("segments") or (),
                                 entry["t_submit"], entry["t_finish"])
    rows: list[tuple[dict[str, float], float]] = []
    for g0, g1 in gaps:
        width = g1 - g0
        shares: dict[str, float] = {}
        for kind, s0, s1, _meta in tiled:
            ov = min(s1, g1) - max(s0, g0)
            if ov > 0:
                shares[kind] = shares.get(kind, 0.0) + ov / width
        rows.append((shares, width))
    return rows


def _gap_band(rows: list[tuple[dict[str, float], float]]) -> tuple[
        list[tuple[dict[str, float], float]], float | None]:
    """Gaps at/above the exact p99 of gap width (the slo.py numpy
    discipline, same as the TTFT band)."""
    if not rows:
        return [], None
    widths = np.asarray([w for _, w in rows], np.float64)
    p99 = float(np.percentile(widths, 99.0))
    return [r for r in rows if r[1] >= p99], p99


def _stall_share(shares: Mapping[str, float]) -> float:
    return float(sum(shares.get(k, 0.0) for k in TPOT_STALL_KINDS))


def _window_shares(entry: Mapping[str, Any]) -> tuple[
        dict[str, float], float, float] | None:
    """Per-kind share of one request's attribution window. Returns
    ``(shares, window_s, untracked_in_window_s)`` or None when the
    request never resolved (no window to attribute)."""
    t_submit, t_finish = entry.get("t_submit"), entry.get("t_finish")
    if t_submit is None or t_finish is None:
        return None
    t_end = entry.get("t_first")
    if t_end is None:
        t_end = t_finish  # shed / zero-token life: attribute it all
    tiled, _ = reqtrace.finalize(entry.get("segments") or (),
                                 t_submit, t_finish)
    window = max(0.0, float(t_end) - float(t_submit))
    shares: dict[str, float] = {}
    for kind, s0, s1, _meta in tiled:
        ov = min(s1, float(t_end)) - max(s0, float(t_submit))
        if ov > 0:
            shares[kind] = shares.get(kind, 0.0) + ov
    if window > 0:
        shares = {k: v / window for k, v in shares.items()}
    return shares, window, shares.get("untracked", 0.0) * window


def _merge_shares(rows: list[tuple[dict[str, float], float]]
                  ) -> dict[str, float]:
    """Window-weighted mean of per-request shares (a 2s wait counts
    double a 1s wait — the band total is what the table explains)."""
    total = sum(w for _, w in rows)
    if total <= 0:
        return {}
    out: dict[str, float] = {}
    for shares, w in rows:
        for k, v in shares.items():
            out[k] = out.get(k, 0.0) + v * w
    return {k: v / total for k, v in sorted(
        out.items(), key=lambda kv: -kv[1])}


def digest(snapshots: Iterable[Mapping[str, Any]],
           worst_n: int = WORST_N) -> dict[str, Any]:
    """Fold ``kind=reqtrace`` record payloads into the attribution
    digest: per-class tail bands, run coverage, the two gate scalars,
    and the worst-N request itemization."""
    requests: dict[str, dict[str, Any]] = {}
    for snap in snapshots:
        requests.update(snap.get("requests") or {})

    per_req: list[dict[str, Any]] = []
    gap_rows_by_prio: dict[int, list[tuple[dict[str, float], float]]] \
        = {}
    untracked_s = span_s = 0.0
    for sid, entry in requests.items():
        ws = _window_shares(entry)
        if ws is None:
            continue
        shares, window, _ = ws
        prio_key = int(entry.get("priority") or 0)
        gap_rows_by_prio.setdefault(prio_key, []).extend(
            _gap_rows(entry))
        ttft = (float(entry["t_first"]) - float(entry["t_submit"])
                if entry.get("t_first") is not None else None)
        span = float(entry["t_finish"]) - float(entry["t_submit"])
        _, u = reqtrace.finalize(entry.get("segments") or (),
                                 entry["t_submit"], entry["t_finish"])
        untracked_s += u
        span_s += max(0.0, span)
        per_req.append({
            "seq_id": int(sid),
            "priority": int(entry.get("priority") or 0),
            "outcome": entry.get("outcome"),
            "preemptions": int(entry.get("preemptions") or 0),
            "ttft_s": ttft,
            "span_s": span,
            "window_s": window,
            "shares": shares,
        })

    def _band(rows: list[dict[str, Any]]) -> tuple[
            list[dict[str, Any]], float | None]:
        """Rows at/above the exact p99 of TTFT (served rows only)."""
        ttfts = [r["ttft_s"] for r in rows if r["ttft_s"] is not None]
        if not ttfts:
            return [], None
        p99 = float(np.percentile(np.asarray(ttfts, np.float64), 99.0))
        return [r for r in rows
                if r["ttft_s"] is not None and r["ttft_s"] >= p99], p99

    def _tpot(rows: list[tuple[dict[str, float], float]]
              ) -> dict[str, Any]:
        """The inter-token-tail table for one pool of gaps."""
        widths = [w for _, w in rows]
        band, p99 = _gap_band(rows)
        band_shares = _merge_shares(band)
        span_shares = _merge_shares(rows)
        return {
            "n_gaps": len(rows),
            "n_band": len(band),
            "gap": ({"p50": float(np.percentile(widths, 50.0)),
                     "p95": float(np.percentile(widths, 95.0)),
                     "p99": p99} if widths else
                    {"p50": None, "p95": None, "p99": None}),
            "band_shares": band_shares,
            "band_stall_share": _stall_share(band_shares),
            "span_shares": span_shares,
            "span_stall_share": _stall_share(span_shares),
        }

    classes: dict[int, dict[str, Any]] = {}
    for prio in sorted({r["priority"] for r in per_req}):
        rows = [r for r in per_req if r["priority"] == prio]
        ttfts = [r["ttft_s"] for r in rows if r["ttft_s"] is not None]
        band, p99 = _band(rows)
        classes[prio] = {
            "n": len(rows),
            "n_band": len(band),
            "ttft": ({"p50": float(np.percentile(ttfts, 50.0)),
                      "p95": float(np.percentile(ttfts, 95.0)),
                      "p99": p99} if ttfts else
                     {"p50": None, "p95": None, "p99": None}),
            "band_shares": _merge_shares(
                [(r["shares"], r["window_s"]) for r in band]),
            "span_shares": _merge_shares(
                [(r["shares"], r["window_s"]) for r in rows]),
            "tpot": _tpot(gap_rows_by_prio.get(prio, [])),
        }

    pooled_band, _ = _band(per_req)
    pooled = _merge_shares([(r["shares"], r["window_s"])
                            for r in pooled_band])
    pooled_tpot = _tpot([g for rows in gap_rows_by_prio.values()
                         for g in rows])
    worst = sorted(per_req,
                   key=lambda r: -(r["ttft_s"] if r["ttft_s"]
                                   is not None else r["span_s"]))
    return {
        "n": len(per_req),
        "coverage_frac": (1.0 - untracked_s / span_s
                          if span_s > 0 else 1.0),
        "ttft_p99_queue_share": pooled.get("queued", 0.0),
        "ttft_p99_band_shares": pooled,
        "tpot_p99_stall_share": pooled_tpot["band_stall_share"],
        "tpot_p99_band_shares": pooled_tpot["band_shares"],
        "tpot": pooled_tpot,
        "classes": classes,
        "worst": worst[:max(0, int(worst_n))],
    }


def _fmt_shares(shares: Mapping[str, float]) -> str:
    parts = [f"{frac:.0%} {kind}" for kind, frac in shares.items()
             if frac >= 0.005]
    return ", ".join(parts) if parts else "(no attributed time)"


def _ms(v: float | None) -> str:
    return "-" if v is None else f"{v * 1e3:.0f}ms"


def _dominant(shares: Mapping[str, float]) -> str:
    """``"61% queued"`` for the band's biggest segment — whatever kind
    it is (a prefetch_wait-dominated band must not be summarized as
    "queue share 0%"); ``_merge_shares`` already sorted descending."""
    for kind, frac in shares.items():
        return f"{frac:.0%} {kind}"
    return "none"


def format_explain(dig: Mapping[str, Any]) -> str:
    """The human table the ``--explain`` surfaces print after the
    goodput row (same fixed-layout style as slo.format_slo)."""
    lines = [
        f"request forensics  n={dig['n']}  "
        f"coverage {dig['coverage_frac']:.1%}  "
        f"p99-band dominant "
        f"{_dominant(dig.get('ttft_p99_band_shares') or {})}  "
        f"tpot-p99 stall share "
        f"{dig.get('tpot_p99_stall_share', 0.0):.0%}"]
    for prio, cls in sorted(dig["classes"].items()):
        t = cls["ttft"]
        lines.append(
            f"  class {prio}  n={cls['n']}  ttft p50/p95/p99 "
            f"{_ms(t['p50'])}/{_ms(t['p95'])}/{_ms(t['p99'])}")
        lines.append(
            f"    p99-TTFT band (n={cls['n_band']}): "
            f"{_fmt_shares(cls['band_shares'])}")
        lines.append(f"    all requests:  "
                     f"{_fmt_shares(cls['span_shares'])}")
        tp = cls.get("tpot") or {}
        if tp.get("n_gaps"):
            g = tp["gap"]
            lines.append(
                f"    inter-token gaps n={tp['n_gaps']}  p50/p95/p99 "
                f"{_ms(g['p50'])}/{_ms(g['p95'])}/{_ms(g['p99'])}")
            lines.append(
                f"    p99-gap band (n={tp['n_band']}, stall "
                f"{tp['band_stall_share']:.0%}): "
                f"{_fmt_shares(tp['band_shares'])}")
    if dig["worst"]:
        lines.append("  worst requests by TTFT:")
        for r in dig["worst"]:
            tag = (f"ttft {_ms(r['ttft_s'])}" if r["ttft_s"] is not None
                   else f"{r['outcome'] or 'unserved'}")
            pre = (f"  preempt x{r['preemptions']}"
                   if r["preemptions"] else "")
            lines.append(
                f"    seq {r['seq_id']}  prio {r['priority']}  {tag}"
                f"  span {r['span_s'] * 1e3:.0f}ms{pre}: "
                f"{_fmt_shares(r['shares'])}")
    return "\n".join(lines)


def digest_from_stats(stats: Mapping[int, Mapping[str, Any]],
                      tracer: reqtrace.ReqTrace,
                      worst_n: int = WORST_N) -> dict[str, Any]:
    """One-step digest for in-process surfaces (serve_app/
    bench_serving): snapshot the live recorder against the run's
    stats table and fold it."""
    return digest([tracer.snapshot(stats)], worst_n=worst_n)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hpc_patterns_tpu_torch.harness.explain",
        description="per-class tail attribution from kind=reqtrace "
                    "records in run logs")
    ap.add_argument("logs", nargs="+", help="JSONL run logs")
    ap.add_argument("--worst", type=int, default=WORST_N,
                    help="worst-N requests to itemize "
                         f"(default {WORST_N})")
    ap.add_argument("-o", "--out", default=None,
                    help="also write the digest as JSON")
    args = ap.parse_args(argv)

    records = load_records(args.logs)
    snaps = [r for r in records if r.get("kind") == "reqtrace"]
    if not snaps:
        print("no kind=reqtrace records (run apps with --explain "
              "--log PATH)", file=sys.stderr)
        return 2
    dig = digest(snaps, worst_n=args.worst)
    print(format_explain(dig))
    if args.out:
        Path(args.out).write_text(json.dumps(dig) + "\n")
        print(f"digest -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
