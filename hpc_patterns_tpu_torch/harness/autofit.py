"""autofit — profile-driven configuration: observability becomes control;
the counterpart of ``hpc_patterns_tpu/harness/autofit.py``, copied.

The observability ladder (metrics registry → flight recorder →
regression gate → distributed merge + rollups) stops at diagnosis: a
human reads the Perfetto fan and hand-tunes the prompt ladder, the
residency knobs, the placement policy, and the autoscaler thresholds.
This module closes the loop: it consumes the RunLog records a prior run
already writes (``kind=serve_admit`` / ``kind=trace`` /
``kind=trace_merged`` / ``kind=metrics``, plus ``collect.py``'s
``--rollup-out`` JSON) and emits a versioned ``FittedConfig`` — the
config *derived from* the run, the first-touch idea of automatic
data-movement tuning applied to our serving tiers.

Five independent fitters, each deterministic and pure (no RNG, no
timestamps, no device dispatch — same records in, bit-identical JSON
out):

- **ladder** — prompt-length bucket ladder via the exact-DP
  :func:`~hpc_patterns_tpu_torch.models.serving.fit_bucket_ladder`, fed from
  the observed ``serve_admit`` prompt/padded lengths (one more rung than
  the shape-blind default ladder, so the fit can only remove padding);
- **residency** — eviction policy, anti-thrash floor and prefetch depth
  from the ``mem.prefetch`` overlap fractions in the trace and the
  ``mem.hbm_pages`` / ``mem.host_pages`` pressure gauges;
- **placement** — per-replica weights from the merged busy/bubble
  rollups and the ``plane.<name>.queue_depth`` gauges;
- **autoscaler** — hysteresis bands picked by replaying the observed
  attainment/queue trajectory (``kind=plane_attainment`` records, the
  sliding-window gauge both planes emit) through the pure
  :class:`~hpc_patterns_tpu_torch.serving_plane.autoscaler.Autoscaler`
  offline and keeping the candidate that never flaps;
- **blame** — acts on *why* the tail happened, not just on raw
  signals: the pooled attribution digest (``kind=reqtrace`` records
  through :func:`harness.explain.digest`) names the dominant p99-band
  segment, and the fitter maps blame to a knob — ``prefetch_wait``
  refits the prefetch depth from the wait-overlap structure
  (stacked waits cap at one in-flight pull; serialized waits deepen
  to the parked-row peak), ``queued`` widens the autoscaler band
  (scale up at a shallower backlog), ``admit_wait`` recommends a
  higher admission high-water. Blame overrides the signal fit where
  both speak: the digest sees the REQUEST's wait, the trace only
  sees the transfer.

A section whose signals are absent from the input is emitted as
``null`` — consumers fall back to their defaults, so a config fitted
from a trace that never paged still applies its ladder.

Consumers in the port: ``EngineCore.from_fitted`` /
``ContinuousBatcher``, ``ServingPlane.from_fitted`` and
``AutoscalerPolicy.from_fitted``; serve_app takes ``--autofit
config.json`` and bench_serving's ``--fit`` row runs the whole loop. The
port emits no ``mem.*`` paging signals until the residency manager is
ported, so on its own runs the residency section is ``null``; a config
fitted by either package loads in the other (same kind and version,
byte-identical ``dumps_config`` on the same records).

Usage::

    python -m hpc_patterns_tpu_torch.harness.autofit run.jsonl --emit config.json
    python -m hpc_patterns_tpu_torch.harness.autofit run.jsonl --rollups rollups.json

Exit 0: config emitted (even if every section is null — that is a
statement about the input, not an error). 2: unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

FITTED_VERSION = 1
FITTED_KIND = "fitted_config"

# deterministic fitter constants (documented, not tunable per-call: two
# people fitting the same trace must get the same config)
EXTRA_RUNGS = 1           # fitted ladder may use default rungs + this
THRASH_PULLS_PER_SEQ = 1.5  # pulls/seq above this = re-eviction churn
MIN_OVERLAP_FOR_DEPTH = 0.2  # exposed pulls => depth 1, don't stack
ROUND_ROBIN_MAX_SKEW = 1.25  # weight skew below this: uniform is fine
MIN_TRAJECTORY_ROUNDS = 4   # fewer observed rounds fit nothing
MIN_BLAME_SHARE = 0.25      # a band share below this blames nobody
MAX_BLAME_DEPTH = 8         # deepened prefetch depth is still bounded
BLAME_RESIDENT_ROUNDS = 8   # blamed churn escalates the anti-thrash
                            # floor to this: long enough that a
                            # bench-scale decode finishes its stint
                            # instead of paying an exposed pull mid-way


# ---------------------------------------------------------------------------
# record ingestion


def read_records(paths) -> list[dict[str, Any]]:
    """All JSON records from the given RunLog JSONL files, in file then
    line order. Non-JSON lines are skipped (RunLog files share stdout
    real estate with grep-able text in some harnesses)."""
    records: list[dict[str, Any]] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    return records


def _iter_trace_events(records):
    """Yield ``(ph, cat, name, ts, tid, dur, args)`` tuples from every
    ``kind=trace`` record's event list (JSON round-trips the recorder's
    tuples as lists)."""
    for rec in records:
        if rec.get("kind") != "trace":
            continue
        for ev in rec.get("events") or ():
            if isinstance(ev, (list, tuple)) and len(ev) == 7:
                yield tuple(ev)


def _windows(records, name: str) -> list[tuple[float, float]]:
    """Completed ``(start, end)`` device windows with the given name
    (``ph == "X"`` events carry a duration)."""
    out = []
    for ph, _cat, ev_name, ts, _tid, dur, _args in _iter_trace_events(
            records):
        if ph == "X" and ev_name == name and dur is not None:
            out.append((float(ts), float(ts) + float(dur)))
    return sorted(out)


def _gauges(records) -> dict[str, dict[str, Any]]:
    """The union of gauge tables from every ``kind=metrics`` record
    (later records win a key collision — they snapshot later state)."""
    gauges: dict[str, dict[str, Any]] = {}
    for rec in records:
        if rec.get("kind") == "metrics" and isinstance(
                rec.get("gauges"), dict):
            gauges.update(rec["gauges"])
    return gauges


def _merged_rollup(records) -> dict[str, Any] | None:
    """The last ``kind=trace_merged`` record (collect.py's cross-rank
    rollup appended to the shared log), if any."""
    rollup = None
    for rec in records:
        if rec.get("kind") == "trace_merged":
            rollup = rec
    return rollup


def _union_len(intervals) -> float:
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def _overlap_frac(pulls, chunks) -> float | None:
    """Mean fraction of each pull window hidden under the union of
    decode-chunk windows — the same quantity the live engine folds into
    ``prefetch_overlap_frac``, recomputed from the recorded timeline."""
    if not pulls:
        return None
    merged = []
    for lo, hi in sorted(chunks):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    fracs = []
    for lo, hi in pulls:
        dur = hi - lo
        if dur <= 0:
            continue
        covered = _union_len(
            [(max(lo, a), min(hi, b)) for a, b in merged
             if b > lo and a < hi])
        fracs.append(covered / dur)
    if not fracs:
        return None
    return sum(fracs) / len(fracs)


def _max_concurrency(intervals) -> int:
    events = sorted([(lo, 1) for lo, _ in intervals]
                    + [(hi, -1) for _, hi in intervals],
                    key=lambda e: (e[0], e[1]))
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


# ---------------------------------------------------------------------------
# section fitters


def fit_ladder(records) -> dict[str, Any] | None:
    """Prompt-length bucket ladder from the observed ``serve_admit``
    stream: the exact DP gets ONE more rung than the shape-blind
    default ladder over the same range, so the fitted ladder can only
    pad less (the default is in the DP's feasible set)."""
    from hpc_patterns_tpu_torch.models.serving import (
        bucket_ladder,
        expected_padding,
        fit_bucket_ladder,
    )

    admits = [r for r in records if r.get("kind") == "serve_admit"
              and isinstance(r.get("prompt_len"), int)]
    if not admits:
        return None
    lengths = sorted(r["prompt_len"] for r in admits)
    max_len = max(max(lengths),
                  max((r.get("padded_len") or 0 for r in admits)))
    default = bucket_ladder(max_len)
    max_rungs = max(2, len(default) + EXTRA_RUNGS)
    buckets = fit_bucket_ladder(lengths, max_rungs, max_len=max_len)
    counts: dict[int, int] = {}
    for t in lengths:
        counts[t] = counts.get(t, 0) + 1
    return {
        "buckets": [int(b) for b in buckets],
        "max_rungs": max_rungs,
        "max_len": int(max_len),
        "n_admits": len(admits),
        "observed_lengths": [[int(t), counts[t]] for t in sorted(counts)],
        "expected_padding": round(expected_padding(buckets, lengths), 6),
        "default_ladder": [int(b) for b in default],
        "default_expected_padding": round(
            expected_padding(default, lengths), 6),
    }


def fit_residency(records) -> dict[str, Any] | None:
    """Eviction policy + anti-thrash floor + prefetch depth from the
    paging signals. Rules (deterministic, in order):

    - two or more priority classes among the admitted rows → the
      ``priority`` policy (evict batch before interactive); else LRU;
    - pulls-per-swapped-sequence above ``THRASH_PULLS_PER_SEQ`` means
      rows are being re-evicted before they finish → raise
      ``min_resident_rounds`` to 2 (the anti-thrash floor);
    - the recorded ``mem.prefetch`` windows' overlap against the
      ``serve.chunk`` windows picks the prefetch depth: well-hidden
      pulls (≥ ``MIN_OVERLAP_FOR_DEPTH``) keep the observed peak
      concurrency; exposed pulls cap the engine at one in-flight pull
      so transfers never stack in the open.
    """
    swaps = sum(1 for r in records if r.get("kind") == "serve_swap_out")
    pulls = [r for r in records if r.get("kind") == "serve_prefetch"]
    gauges = _gauges(records)
    hbm = gauges.get("mem.hbm_pages")
    host = gauges.get("mem.host_pages")
    if not swaps and not pulls and host is None:
        return None  # this run never paged — nothing to fit
    prios = sorted({r["priority"] for r in records
                    if r.get("kind") == "serve_admit"
                    and r.get("priority") is not None})
    policy = "priority" if len(prios) >= 2 else "lru"
    seqs = {r.get("seq_id") for r in pulls}
    pulls_per_seq = (len(pulls) / len(seqs)) if seqs else 0.0
    min_resident_rounds = 2 if pulls_per_seq > THRASH_PULLS_PER_SEQ else 1
    pull_windows = _windows(records, "mem.prefetch")
    chunk_windows = _windows(records, "serve.chunk")
    overlap = _overlap_frac(pull_windows, chunk_windows)
    if overlap is None:
        prefetch_depth = None  # no timeline — leave the engine's default
    elif overlap >= MIN_OVERLAP_FOR_DEPTH:
        prefetch_depth = max(1, _max_concurrency(pull_windows))
    else:
        prefetch_depth = 1
    hbm_peak = float(hbm["max"]) if hbm else None
    host_peak = float(host["max"]) if host else None
    pressure = None
    if hbm_peak is not None and host_peak is not None \
            and hbm_peak + host_peak > 0:
        pressure = round(host_peak / (hbm_peak + host_peak), 6)
    return {
        "policy": policy,
        "min_resident_rounds": min_resident_rounds,
        "prefetch_depth": prefetch_depth,
        "observed": {
            "swap_outs": swaps,
            "pulls": len(pulls),
            "pulls_per_seq": round(pulls_per_seq, 6),
            "priority_classes": [int(p) for p in prios],
            "prefetch_overlap_frac": (None if overlap is None
                                      else round(overlap, 6)),
            "hbm_pages_peak": hbm_peak,
            "host_pages_peak": host_peak,
            "host_pressure": pressure,
        },
    }


def fit_placement(records, rollups=None) -> dict[str, Any] | None:
    """Per-replica placement weights from the queue-depth gauges
    (preferred — they name replicas) or, cross-rank, from the merged
    busy/bubble rollups (idle share = capacity share). Near-uniform
    weights pick ``round_robin`` (no information to act on); skewed
    weights pick the ``weighted`` policy so the router sends work where
    the capacity is."""
    gauges = _gauges(records)
    raw: dict[str, float] = {}
    source = None
    qd = {k[len("plane."):-len(".queue_depth")]: v
          for k, v in gauges.items()
          if k.startswith("plane.") and k.endswith(".queue_depth")}
    if qd:
        source = "queue_depth_gauges"
        for name, g in sorted(qd.items()):
            # mean queue depth over the run ≈ how backed-up the
            # replica stayed; weight is inverse pressure
            n = max(1, int(g.get("n") or 1))
            mean_q = (float(g.get("last") or 0.0)
                      if n == 1 else
                      (float(g.get("min") or 0.0)
                       + float(g.get("max") or 0.0)) / 2.0)
            raw[name] = 1.0 / (1.0 + max(0.0, mean_q))
    else:
        rollup = rollups if isinstance(rollups, dict) else None
        rollup = rollup or _merged_rollup(records)
        busy = (rollup or {}).get("busy")
        if not isinstance(busy, dict) or not busy:
            return None
        source = "busy_rollup"
        for pid, row in sorted(busy.items()):
            busy_frac = float(row.get("busy_frac") or 0.0)
            raw[str(pid)] = max(0.0, 1.0 - busy_frac)
    if not raw:
        return None
    total = sum(raw.values())
    if total <= 0.0:
        weights = {k: round(1.0 / len(raw), 6) for k in sorted(raw)}
    else:
        weights = {k: round(v / total, 6) for k, v in sorted(raw.items())}
    lo, hi = min(weights.values()), max(weights.values())
    skew = (hi / lo) if lo > 0 else float("inf")
    policy = ("round_robin" if skew <= ROUND_ROBIN_MAX_SKEW
              else "weighted")
    return {
        "policy": policy,
        "weights": weights,
        "skew": (None if skew == float("inf") else round(skew, 6)),
        "source": source,
    }


def _trajectory(records) -> list[dict[str, Any]]:
    """The per-round attainment/queue trajectory: the sliding-window
    ``kind=plane_attainment`` records both planes emit (satellite of
    the same PR), sorted by round."""
    rows = [r for r in records if r.get("kind") == "plane_attainment"
            and isinstance(r.get("round"), int)]
    return sorted(rows, key=lambda r: r["round"])


def replay(trajectory, policy) -> list:
    """Replay an observed trajectory through a fresh pure controller —
    the offline harness the threshold fitter (and its tests) use. Each
    trajectory row carries the per-round signal fields the planes
    record: ``round``, ``replicas``, ``queued``, ``active``,
    ``attained_round``, ``judged_round``."""
    from hpc_patterns_tpu_torch.serving_plane.autoscaler import (
        Autoscaler,
        Signals,
    )

    scaler = Autoscaler(policy)
    decisions = []
    for row in trajectory:
        sig = Signals(
            round=int(row["round"]),
            replicas=int(row.get("replicas") or 1),
            queued=int(row.get("queued") or 0),
            active=int(row.get("active") or 0),
            attained=int(row.get("attained_round") or 0),
            judged=int(row.get("judged_round") or 0),
        )
        decisions.append(scaler.observe(sig))
    return decisions


def flap_count(decisions) -> int:
    """Direction reversals among the non-hold decisions: an ``up``
    followed (next non-hold) by a ``down`` or vice versa. The quantity
    the threshold fit minimizes — hysteresis bands exist so a steady
    boundary trajectory never oscillates."""
    acts = [d.action for d in decisions if d.action != "hold"]
    return sum(1 for a, b in zip(acts, acts[1:]) if a != b)


def fit_autoscaler(records) -> dict[str, Any] | None:
    """Hysteresis bands from the observed attainment/queue trajectory:
    a small deterministic candidate grid, each candidate replayed
    through the pure controller offline, keeping the lexicographically
    best ``(flaps, changes, thresholds…)`` — i.e. never-flapping first,
    least-twitchy second, tightest bands as the tie-break."""
    from hpc_patterns_tpu_torch.serving_plane.autoscaler import AutoscalerPolicy

    trajectory = _trajectory(records)
    if len(trajectory) < MIN_TRAJECTORY_ROUNDS:
        return None
    max_seen = max(int(r.get("replicas") or 1) for r in trajectory)
    max_replicas = max(2, max_seen)
    candidates = []
    for up_queue in (1.5, 2.0, 3.0, 4.0):
        for margin in (0.02, 0.05, 0.10):
            for cooldown in (2, 3, 4, 6):
                for window in (4, 8):
                    candidates.append(AutoscalerPolicy(
                        min_replicas=1,
                        max_replicas=max_replicas,
                        up_queue=up_queue,
                        down_queue=round(up_queue / 4.0, 6),
                        up_attainment=round(0.98 - margin, 6),
                        down_attainment=0.98,
                        cooldown_rounds=cooldown,
                        window=window,
                    ))
    best = None
    for pol in candidates:
        decisions = replay(trajectory, pol)
        flaps = flap_count(decisions)
        changes = sum(1 for d in decisions if d.action != "hold")
        key = (flaps, changes, pol.up_queue, pol.down_attainment
               - pol.up_attainment, pol.cooldown_rounds, pol.window)
        if best is None or key < best[0]:
            best = (key, pol, flaps, changes)
    _key, pol, flaps, changes = best
    return {
        "min_replicas": pol.min_replicas,
        "max_replicas": pol.max_replicas,
        "up_queue": pol.up_queue,
        "down_queue": pol.down_queue,
        "up_attainment": pol.up_attainment,
        "down_attainment": pol.down_attainment,
        "cooldown_rounds": pol.cooldown_rounds,
        "window": pol.window,
        "replay": {
            "rounds": len(trajectory),
            "flaps": flaps,
            "changes": changes,
            "candidates": len(candidates),
        },
    }


# ---------------------------------------------------------------------------
# blame: the attribution digest becomes a knob


def _segment_intervals(snaps, kinds) -> list[tuple[float, float]]:
    """Canonically-tiled ``(start, end)`` intervals of the given
    segment kinds across every request in the reqtrace snapshots —
    the overlap structure :func:`fit_blame` reads depth from."""
    from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib

    out: list[tuple[float, float]] = []
    for snap in snaps:
        for entry in (snap.get("requests") or {}).values():
            t_submit = entry.get("t_submit")
            t_finish = entry.get("t_finish")
            if t_submit is None or t_finish is None:
                continue
            tiled, _ = reqtracelib.finalize(
                entry.get("segments") or (), t_submit, t_finish)
            out.extend((float(s0), float(s1))
                       for kind, s0, s1, _meta in tiled
                       if kind in kinds and s1 > s0)
    return sorted(out)


def fit_blame(records) -> dict[str, Any] | None:
    """Blame-driven fitting: digest the run's ``kind=reqtrace``
    records (harness/explain.py) and map the dominant p99-band
    segment to a config action. Candidates and rules (deterministic):

    - ``prefetch_wait`` dominating the pooled p99 *inter-token gap*
      band → the decode tail is paying for mid-decode churn: escalate
      the anti-thrash floor to ``BLAME_RESIDENT_ROUNDS`` (a resident
      row finishes its stint instead of paging out and paying an
      exposed pull to come back) and refit the prefetch depth from
      the wait overlap — waits that STACK (peak concurrency ≥ 2)
      mean exposed transfers piled onto one host, cap at one
      in-flight pull; waits that never overlap while rows sit parked
      mean the serializing depth IS the stall, deepen to the
      parked-row peak (bounded by ``MAX_BLAME_DEPTH``);
    - ``queued`` dominating the pooled p99 *TTFT* band → widen the
      autoscaler band: scale up at a backlog of 1 (the tail already
      proved the queue is where the time goes);
    - ``admit_wait`` dominating the pooled p99 TTFT band → recommend
      the full admission high-water (stop holding arena back from a
      tail that is waiting on it).

    Precedence is fixed, not max-share: a decode-phase stall
    mechanism outranks the TTFT candidates, because ``queued``
    dominating the TTFT band is the DEFAULT look of any saturated
    open-loop stream while a stall-dominated inter-token band is the
    rarer, sharper finding. A share below ``MIN_BLAME_SHARE`` blames
    nobody (empty actions). Returns None when the input has no
    reqtrace records at all.
    """
    from hpc_patterns_tpu_torch.harness import explain as explainlib

    snaps = [r for r in records if r.get("kind") == "reqtrace"]
    if not snaps:
        return None
    dig = explainlib.digest(snaps, worst_n=0)
    ttft_band = dig.get("ttft_p99_band_shares") or {}
    tpot_band = dig.get("tpot_p99_band_shares") or {}
    candidates = {
        "tpot.prefetch_wait": float(tpot_band.get("prefetch_wait",
                                                  0.0)),
        "ttft.queued": float(ttft_band.get("queued", 0.0)),
        "ttft.admit_wait": float(ttft_band.get("admit_wait", 0.0)),
    }
    axis = dominant = None
    share = 0.0
    for key in ("tpot.prefetch_wait", "ttft.queued",
                "ttft.admit_wait"):
        if candidates[key] >= MIN_BLAME_SHARE:
            axis, dominant = key.split(".", 1)
            share = candidates[key]
            break
    actions: dict[str, Any] = {}
    waits: dict[str, Any] = {}
    if dominant == "prefetch_wait":
        wait_iv = _segment_intervals(snaps, ("prefetch_wait",))
        parked_iv = _segment_intervals(
            snaps, ("prefetch_wait", "swapped_out"))
        stacked = _max_concurrency(wait_iv)
        parked = _max_concurrency(parked_iv)
        actions["min_resident_rounds"] = BLAME_RESIDENT_ROUNDS
        actions["prefetch_depth"] = (
            1 if stacked >= 2
            else max(2, min(MAX_BLAME_DEPTH, parked)))
        waits = {"stacked_waits_peak": stacked,
                 "parked_rows_peak": parked}
    elif dominant == "queued":
        actions["up_queue"] = 1
    elif dominant == "admit_wait":
        actions["admit_highwater"] = 1.0
    return {
        "axis": axis,
        "dominant": dominant,
        "share": round(float(share), 6),
        "candidates": {k: round(v, 6)
                       for k, v in sorted(candidates.items())},
        "actions": actions,
        "observed": {"n_requests": int(dig.get("n") or 0),
                     "tpot_p99_stall_share": round(float(
                         dig.get("tpot_p99_stall_share") or 0.0), 6),
                     **waits},
    }


# ---------------------------------------------------------------------------
# the FittedConfig


def fit(records, *, rollups=None) -> dict[str, Any]:
    """The full FittedConfig from a run's records (+ optional rollups
    JSON from ``collect.py --rollup-out``). Pure and deterministic."""
    ladder = fit_ladder(records)
    residency = fit_residency(records)
    placement = fit_placement(records, rollups)
    autoscaler = fit_autoscaler(records)
    blame = fit_blame(records)
    # blame overrides the signal fit where both speak: the trace only
    # proves the transfer was exposed; the digest proves a request's
    # p99 PAID for it — act on the latter
    if blame and residency is not None \
            and blame["actions"].get("prefetch_depth") is not None:
        residency = dict(residency,
                         prefetch_depth=blame["actions"][
                             "prefetch_depth"])
    if blame and residency is not None \
            and blame["actions"].get("min_resident_rounds") is not None:
        residency = dict(residency,
                         min_resident_rounds=max(
                             int(residency.get(
                                 "min_resident_rounds") or 1),
                             int(blame["actions"][
                                 "min_resident_rounds"])))
    if blame and autoscaler is not None \
            and blame["actions"].get("up_queue") is not None:
        autoscaler = dict(autoscaler,
                          up_queue=min(int(autoscaler["up_queue"]),
                                       int(blame["actions"][
                                           "up_queue"])))
    return {
        "version": FITTED_VERSION,
        "kind": FITTED_KIND,
        "source": {
            "n_records": len(records),
            "n_serve_admit": sum(
                1 for r in records if r.get("kind") == "serve_admit"),
            "n_trace": sum(
                1 for r in records if r.get("kind") == "trace"),
            "n_metrics": sum(
                1 for r in records if r.get("kind") == "metrics"),
            "n_trace_merged": sum(
                1 for r in records if r.get("kind") == "trace_merged"),
            "n_plane_attainment": sum(
                1 for r in records
                if r.get("kind") == "plane_attainment"),
            "n_reqtrace": sum(
                1 for r in records if r.get("kind") == "reqtrace"),
            "rollups": bool(rollups),
        },
        "ladder": ladder,
        "residency": residency,
        "placement": placement,
        "autoscaler": autoscaler,
        "blame": blame,
    }


def fit_paths(paths, rollups_path=None) -> dict[str, Any]:
    records = read_records(paths)
    rollups = None
    if rollups_path:
        with open(rollups_path) as f:
            rollups = json.load(f)
    return fit(records, rollups=rollups)


def dumps_config(fitted: dict[str, Any]) -> str:
    """The canonical serialization: sorted keys, fixed indent, trailing
    newline — byte-identical for equal configs (the determinism pin in
    tests/test_autofit.py diffs these bytes)."""
    return json.dumps(fitted, sort_keys=True, indent=2) + "\n"


def load_fitted(path) -> dict[str, Any]:
    """Read and validate a FittedConfig emitted by this module — the
    one ingestion point every ``from_fitted`` / ``--autofit`` consumer
    routes through."""
    with open(path) as f:
        fitted = json.load(f)
    return validate_fitted(fitted)


def validate_fitted(fitted) -> dict[str, Any]:
    if not isinstance(fitted, dict):
        raise ValueError(f"fitted config must be a JSON object, got "
                         f"{type(fitted).__name__}")
    if fitted.get("kind") != FITTED_KIND:
        raise ValueError(
            f"not a fitted config (kind={fitted.get('kind')!r}, "
            f"expected {FITTED_KIND!r})")
    if fitted.get("version") != FITTED_VERSION:
        raise ValueError(
            f"fitted config version {fitted.get('version')!r} not "
            f"supported (this build reads version {FITTED_VERSION})")
    return fitted


def ladder_from(fitted, *, max_seq: int | None = None):
    """The fitted prompt ladder as engine-ready ``prompt_buckets``
    (or None when the config has no ladder section). Rungs above the
    consumer's ``max_seq`` are clamped — a ladder fitted on a bigger
    model must not make a smaller engine refuse to boot."""
    section = (fitted or {}).get("ladder")
    if not section:
        return None
    rungs = [int(b) for b in section["buckets"]]
    if max_seq is not None:
        rungs = [min(b, int(max_seq)) for b in rungs]
    rungs = sorted(set(b for b in rungs if b >= 1))
    return tuple(rungs) or None


# ---------------------------------------------------------------------------
# CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hpc_patterns_tpu_torch.harness.autofit",
        description=__doc__.splitlines()[0])
    p.add_argument("logs", nargs="+",
                   help="RunLog JSONL files from the run to fit "
                        "(serve_admit/trace/metrics/trace_merged "
                        "records)")
    p.add_argument("--rollups", default=None,
                   help="rollups JSON from `collect.py --rollup-out` "
                        "(the cross-rank busy/bubble input)")
    p.add_argument("--emit", default=None,
                   help="write the FittedConfig JSON here (default: "
                        "print to stdout)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        fitted = fit_paths(args.logs, args.rollups)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    text = dumps_config(fitted)
    if args.emit:
        Path(args.emit).write_text(text)
        sections = [k for k in ("ladder", "residency", "placement",
                                "autoscaler", "blame")
                    if fitted.get(k)]
        print(f"fitted config -> {args.emit} "
              f"(sections: {', '.join(sections) or 'none'})")
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
