"""Cross-rank trace collection: clock-aligned merge + skew rollups —
the counterpart of ``hpc_patterns_tpu/harness/collect.py``, copied.

Rung 4 of the observability ladder. Rungs 1–3 (metrics histograms,
flight recorder + Chrome-trace export, regression gate) see exactly one
process — but the reference's miniapps only ever run under ``mpirun
-np 4``, and for communication patterns the interesting signal IS
cross-rank: collective skew, stragglers, and the rank-MAX timing rule
the suite already uses (PAPERS.md: stream-aware message passing and
GPU-communication analyses both work from per-rank stream timelines).

The pipeline:

1. **Per-rank capture** — each process running an app with ``--trace``
   under ``HPCPAT_PROCESS_ID``/``HPCPAT_NUM_PROCESSES`` writes its
   recorder snapshot (the ``kind=trace`` payload, stamped with
   ``process`` identity, clock anchors and its collective-schedule
   chain) to ``HPCPAT_TRACE_DIR`` as ``rank<id>.trace.json``
   (apps/common.run_instrumented → trace.write_rank_snapshot). The
   launcher (``apps/launch.py``) sets the variables, and a traced
   launched run records a sync anchor after a gloo barrier at its
   rendezvous (``trace.mark_rendezvous``); processes started by hand
   set the variables themselves and carry wall anchors only.
2. **Clock-aligned merge** (this module) — per-rank clock offsets are
   estimated from each snapshot's two monotonic↔wall anchor pairs
   (drift-bounded by their disagreement), then refined by barrier-echo
   sync anchors when every rank carries them (all ranks exit a global
   barrier within its release-propagation window — micro-seconds on one
   host, network-RTT across hosts — far tighter than NTP wall-clock
   skew). The per-rank rings merge into ONE Chrome-trace/Perfetto JSON
   with one ``pid`` lane per rank, and Perfetto flow events link the N
   per-rank slices of the same collective — matched by slice name +
   sequence index (``comm/communicator.py``'s per-communicator counter,
   ``harness/timing.py``'s repetition index) — so allreduce skew is
   visible as a fan of arrows.
3. **Cross-rank rollups** — per-collective skew (max−min start,
   max−min duration), per-rank busy/bubble fractions over the device
   track, and a straggler table (which rank finished last, how often),
   printed by the CLI and carried as one ``kind=trace_merged`` RunLog
   record that ``harness.report`` renders.

Usage::

    HPCPAT_TRACE_DIR=ranks HPCPAT_NUM_PROCESSES=2 HPCPAT_PROCESS_ID=0 \
        python -m hpc_patterns_tpu_torch.apps.allreduce_app -p 8 --trace &
    HPCPAT_TRACE_DIR=ranks HPCPAT_NUM_PROCESSES=2 HPCPAT_PROCESS_ID=1 \
        python -m hpc_patterns_tpu_torch.apps.allreduce_app -p 8 --trace
    python -m hpc_patterns_tpu_torch.harness.collect ranks/ -o merged.json \
        --rollup-out rollup.json

Exit 0 on a merge (even with nothing matched — the lanes still help);
2 on unreadable input / no snapshots.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Iterable

from hpc_patterns_tpu_torch.harness import trace as tracelib

# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_rank_snapshots(paths: Iterable[str | Path]) -> list[dict[str, Any]]:
    """Flight-recorder snapshots from ``paths``: directories are
    globbed for the per-rank handoff files (``rank*.trace.json``),
    ``.json`` files are read as one snapshot object, and anything else
    is treated as a runlog JSONL whose ``kind=trace`` records are the
    snapshots (so a merged view can also be built from N per-rank
    ``--log`` files). Unparseable lines are skipped, same tolerance as
    harness.report."""
    snaps: list[dict[str, Any]] = []
    for path in paths:
        path = Path(path)
        if path.is_dir():
            for f in sorted(path.glob("rank*.trace.json")):
                snaps.extend(_read_snapshot_file(f))
        else:
            snaps.extend(_read_snapshot_file(path))
    return snaps


def _read_snapshot_file(path: Path) -> list[dict[str, Any]]:
    try:
        obj = json.loads(path.read_text())
        if isinstance(obj, dict) and "events" in obj:
            obj.setdefault("_source", str(path))
            return [obj]
        return []
    except json.JSONDecodeError:
        # not one JSON object: a runlog JSONL — trace.py owns that
        # parsing contract (kind=trace filter, skip-unparseable
        # tolerance, _source annotation)
        return tracelib.load_trace_snapshots([path])


def rank_of(snap: dict[str, Any], default: int = 0) -> int:
    return int(snap.get("process", {}).get("process_id", default))


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------


def anchor_pairs(snap: dict[str, Any]) -> list[tuple[float, float]]:
    """(mono, wall) anchor pairs of a snapshot: construction time
    always; snapshot time when present (older records carry one)."""
    c = snap.get("clock", {})
    pairs = [(float(c["mono0"]), float(c["wall0"]))]
    if "mono1" in c and "wall1" in c:
        pairs.append((float(c["mono1"]), float(c["wall1"])))
    return pairs


def wall_offset(snap: dict[str, Any]) -> tuple[float, float]:
    """(offset, drift_bound): ``wall ≈ mono + offset`` for this rank's
    clocks. With two anchor pairs the offset is their mean and the
    bound half their disagreement (clock drift over the run, plus the
    scheduling noise of taking the anchors)."""
    offs = [w - m for m, w in anchor_pairs(snap)]
    mid = sum(offs) / len(offs)
    return mid, (max(offs) - min(offs)) / 2.0


def _sync_keyed(snap: dict[str, Any]) -> dict[tuple[str, int], float]:
    """Sync anchors keyed by (name, occurrence index) — the k-th
    barrier of a given name is the same global event on every rank."""
    counts: dict[str, int] = {}
    out: dict[tuple[str, int], float] = {}
    for a in snap.get("sync", []):
        name = str(a.get("name", "sync"))
        i = counts.get(name, 0)
        counts[name] = i + 1
        out[(name, i)] = float(a["mono"])
    return out


def estimate_alignment(
        snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """Per-rank clock offsets onto one shared timeline (public form:
    one snapshot per rank, keyed by the snapshot's process id).

    Base estimate: each rank's wall anchors (``offset = wall − mono``),
    valid to NTP skew across hosts and exact on one host. Refinement:
    when every rank carries the same sync anchors (name + index), those
    instants are treated as simultaneous — each rank's offset is
    corrected so its anchors land on the earliest rank's (the earliest
    barrier exit is closest to the true release) — shrinking alignment
    error from wall-clock skew to barrier-exit spread.

    Returns ``{"offsets": {rank: offset_s}, "method": "wall"|"sync",
    "drift_bound_s", "wall_disagreement_s", "residual_s"}`` —
    ``wall_disagreement_s`` is how far the wall estimate was off per
    the sync anchors (the error a wall-only merge would have carried),
    ``residual_s`` the spread of corrections across multiple anchors
    (0 with one; the floor on post-refinement error)."""
    return _align_lanes({rank_of(s): s for s in snaps})


def _align_lanes(reps: dict[int, dict[str, Any]]) -> dict[str, Any]:
    """:func:`estimate_alignment` keyed by merge lane: ``reps`` maps
    lane id → its representative snapshot."""
    offsets: dict[int, float] = {}
    drift = 0.0
    keyed: dict[int, dict[tuple[str, int], float]] = {}
    for lane, snap in reps.items():
        off, d = wall_offset(snap)
        offsets[lane] = off
        drift = max(drift, d)
        keyed[lane] = _sync_keyed(snap)
    align = {"offsets": offsets, "method": "wall",
             "drift_bound_s": drift, "wall_disagreement_s": 0.0,
             "residual_s": drift}
    if len(keyed) < 2:
        return align
    common = set.intersection(*(set(k) for k in keyed.values()))
    if not common:
        return align
    corrections: dict[int, list[float]] = {r: [] for r in keyed}
    disagreement = 0.0
    for key in sorted(common):
        aligned = {r: keyed[r][key] + offsets[r] for r in keyed}
        ref = min(aligned.values())
        disagreement = max(disagreement,
                           max(aligned.values()) - ref)
        for r, v in aligned.items():
            corrections[r].append(v - ref)
    residual = 0.0
    for r, cs in corrections.items():
        offsets[r] -= sum(cs) / len(cs)
        residual = max(residual, (max(cs) - min(cs)) / 2.0)
    align.update(method="sync", wall_disagreement_s=disagreement,
                 residual_s=residual)
    return align


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def annotate(snaps: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Attach merge metadata to each snapshot: ``_pid`` (the Chrome
    process lane), ``_pname`` (lane label), and ``_offset`` (seconds
    added to its monotonic stamps to land on the shared timeline), plus
    the alignment verdict on every snapshot under ``_align`` (same
    object).

    One lane per (source file, process id): snapshots of the same
    process in the same log share a lane (they share a clock — e.g. an
    app emitting several sub-run records), while records from DIFFERENT
    files or ranks never collapse onto one pid — distinct lanes get the
    rank id where ranks are distinct, and are re-numbered in input
    order where they collide (two unrelated single-process logs both
    claiming rank 0)."""
    lanes: dict[tuple[Any, int], int] = {}
    used: set[int] = set()
    reps: dict[int, dict[str, Any]] = {}
    out = []
    for i, snap in enumerate(snaps):
        r = rank_of(snap)
        key = (snap.get("_source", i), r)
        if key in lanes:
            pid = lanes[key]
        else:
            pid = r
            while pid in used:
                pid += 1
            used.add(pid)
            lanes[key] = pid
            reps[pid] = snap
        out.append((pid, snap))
    align = _align_lanes(reps)
    annotated = []
    for pid, snap in out:
        proc = snap.get("process", {})
        n = int(proc.get("num_processes", 1) or 1)
        r = rank_of(snap)
        name = f"rank {r}/{n}"
        if proc.get("slice_id"):
            name += f" (slice {proc['slice_id']})"
        src = snap.get("_source")
        if src and n == 1:
            name = f"{Path(src).name}"
        snap = dict(snap)
        snap["_pid"] = pid
        snap["_pname"] = name
        snap["_offset"] = align["offsets"].get(pid, 0.0)
        snap["_align"] = align
        annotated.append(snap)
    return annotated


def _device_windows(annotated: list[dict[str, Any]]):
    """Sequence-stamped device X slices per snapshot, on the shared
    timeline: ``{(name, seq): [window, ...]}`` where a window is
    ``{"rank", "pid", "tid", "start", "dur"}``. These are the
    collective spans the flow fan and the skew rollups run over."""
    groups: dict[tuple[str, int], list[dict[str, Any]]] = {}
    for snap in annotated:
        off = snap["_offset"]
        for ev in snap.get("events", []):
            ph, cat, name, ts, tid, dur, args = ev
            if ph != "X" or cat != "device" or not isinstance(args, dict):
                continue
            seq = args.get("seq")
            if not isinstance(seq, int):
                continue
            groups.setdefault((name, seq), []).append({
                "rank": rank_of(snap), "pid": snap["_pid"],
                "tid": int(tid), "start": float(ts) + off,
                "dur": float(dur or 0.0),
            })
    return groups


def _schedule_check(annotated: list[dict[str, Any]]) -> dict[str, Any]:
    """Cross-rank collective schedule verification — the merge-time
    half of the shardlint story (analysis/runtime.py records, this
    cross-checks). Each snapshot carries its rank's hash chain over
    ``(op, seq, shape, dtype, axis)`` fingerprints; equal final
    digests prove the SPMD schedules matched, and on mismatch the
    retained entry windows localize the FIRST divergent collective
    per rank — the "rank 2 is at allreduce#17, rank 0 at
    sendrecv_ring#17" a deadlock debug needs first.

    Returns the ``schedule`` field of the trace_merged rollup:
    ``verdict`` is ``consistent`` / ``divergent`` / ``single_rank``
    (one chain: nothing to cross-check) / ``not_recorded``; a
    divergent verdict carries ``first_divergence`` with the index and
    each rank's ``(op, seq)`` there (or ``ended_at`` for a rank whose
    chain stopped short)."""
    chains: dict[int, dict[str, Any]] = {}
    for snap in annotated:
        c = snap.get("collectives")
        if not isinstance(c, dict) or not int(c.get("n", 0) or 0):
            continue
        pid = snap["_pid"]
        cur = chains.get(pid)
        # several snapshots of one process: the longest chain is the
        # final state (the chain only grows within a run)
        if cur is None or int(c["n"]) > int(cur["n"]):
            chains[pid] = c
    if not chains:
        return {"verdict": "not_recorded", "n_ranks_recorded": 0}
    base = {
        "n_ranks_recorded": len(chains),
        "n_collectives": max(int(c["n"]) for c in chains.values()),
    }
    if len(chains) == 1:
        return {"verdict": "single_rank", **base}
    ns = {int(c["n"]) for c in chains.values()}
    digests = {c.get("digest", "") for c in chains.values()}
    if len(ns) == 1 and len(digests) == 1:
        return {"verdict": "consistent", **base,
                "digest": next(iter(digests))}
    # localize: walk absolute indices; at the first index where the
    # per-rank entry digests disagree (or a chain has ended), name each
    # rank's position. Indices evicted from some chain's window are
    # skipped (unjudgeable); chains here are far below the window in
    # practice. Keys are merge LANES (same ids as the rollup's
    # ``ranks``/``stragglers`` tables): ranks are guaranteed-distinct
    # lane ids, while two unrelated single-process logs may both claim
    # process_id 0 and must not collapse onto one report key.
    maps: dict[int, tuple[dict[int, dict[str, Any]], int]] = {}
    for pid, c in sorted(chains.items()):
        maps[pid] = ({int(e["i"]): e for e in c.get("entries", [])},
                     int(c["n"]))
    hi = max(n for _, n in maps.values())
    first = None
    for i in range(hi):
        seen: dict[int, str | None] = {}
        evicted = False
        for pid, (entries, n) in maps.items():
            if i >= n:
                seen[pid] = None  # this rank never issued collective #i
            elif i in entries:
                seen[pid] = entries[i]["digest"]
            else:
                evicted = True
                break
        if evicted:
            continue
        if len(set(seen.values())) > 1:
            first = i
            break
    divergence = None
    if first is not None:
        ranks_at: dict[str, dict[str, Any]] = {}
        for pid, (entries, n) in sorted(maps.items()):
            e = entries.get(first)
            if e is None or first >= n:
                ranks_at[str(pid)] = {"ended_at": n}
            else:
                ranks_at[str(pid)] = {"op": e["op"], "seq": e["seq"]}
        divergence = {"index": first, "ranks": ranks_at}
    return {"verdict": "divergent", **base,
            "first_divergence": divergence}


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals — busy time
    must not double-count overlapped windows on different subtracks."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merge(snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """The full cross-rank merge: ``{"chrome": <Perfetto JSON>,
    "rollup": <kind=trace_merged payload>}``.

    The Chrome JSON has one ``pid`` lane per rank (process_name +
    process_sort_index metadata), every rank's events re-based onto the
    shared clock, and flow events (``s``/``t``/``f`` with a shared id)
    threading the per-rank slices of each matched collective — load it
    in Perfetto and a skewed allreduce shows as a fan of arrows from
    the early ranks to the straggler."""
    annotated = annotate(snaps)
    align = annotated[0]["_align"] if annotated else {
        "offsets": {}, "method": "wall", "drift_bound_s": 0.0,
        "wall_disagreement_s": 0.0, "residual_s": 0.0}
    # shared origin: earliest event start across every rank
    t0 = None
    for snap in annotated:
        off = snap["_offset"]
        base = float(snap["clock"]["mono0"]) + off
        t0 = base if t0 is None else min(t0, base)
        for ev in snap.get("events", []):
            t0 = min(t0, float(ev[3]) + off)
    t0 = t0 or 0.0

    meta: list[dict[str, Any]] = []
    events: list[dict[str, Any]] = []
    for snap in annotated:
        pid, off = snap["_pid"], snap["_offset"]
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": snap["_pname"]}})
        meta.append({"name": "process_sort_index", "ph": "M",
                     "pid": pid, "args": {"sort_index": pid}})
        tids = set()
        for ev in snap.get("events", []):
            ph, cat, name, ts, tid, dur, args = ev
            tids.add(int(tid))
            rec: dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph,
                "ts": (float(ts) + off - t0) * 1e6,
                "pid": pid, "tid": int(tid),
            }
            if ph == "X":
                rec["dur"] = (dur or 0.0) * 1e6
            if ph == "i":
                rec["s"] = "t"
            if ph == "C":
                rec["args"] = {k: v for k, v in (args or {}).items()}
            elif args:
                rec["args"] = {k: str(v) for k, v in args.items()}
            events.append(rec)
        for tid in sorted(tids):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid,
                         "args": {"name": tracelib._track_label(tid)}})

    # the matched subset is computed ONCE: flows and the rollup tables
    # must agree on what counts as "the same collective seen by >= 2
    # ranks" by construction, not by parallel re-derivation
    groups = _device_windows(annotated)
    matched = {key: wins for key, wins in sorted(groups.items())
               if len({w["pid"] for w in wins}) >= 2}
    n_unmatched = len(groups) - len(matched)
    flow_id = 0
    for (name, _seq), wins in matched.items():
        flow_id += 1
        # bind each flow point mid-slice (an edge stamp is ambiguous
        # between adjacent slices) and order the chain by the binding
        # points — Chrome flow ts must be non-decreasing along the id
        wins = sorted(wins, key=lambda w: w["start"] + w["dur"] / 2.0)
        for i, w in enumerate(wins):
            ph = "s" if i == 0 else ("f" if i == len(wins) - 1 else "t")
            rec = {"name": name, "cat": "collective", "ph": ph,
                   "id": flow_id, "pid": w["pid"], "tid": w["tid"],
                   "ts": (w["start"] + w["dur"] / 2.0 - t0) * 1e6}
            if ph == "f":
                rec["bp"] = "e"
            events.append(rec)

    # request-forensics lanes (harness/reqtrace.py): each
    # request's lifecycle segments already merged above as cat=request
    # X slices on its own TID_REQUEST lane; here every `migrating`
    # segment carrying the plane's migration seq is threaded by a flow
    # chain into the matched plane.kv_migration device windows of the
    # same seq — reading a p99 in Perfetto, the arrow leads from the
    # request's wait into the transfer that caused it
    n_req_lanes = set()
    n_mig_links = 0
    for snap in annotated:
        off = snap["_offset"]
        for ev in snap.get("events", []):
            ph, cat, name, ts, tid, dur, args = ev
            if ph != "X" or cat != "request":
                continue
            n_req_lanes.add((snap["_pid"], int(tid)))
            if name != "migrating" or not isinstance(args, dict) \
                    or not isinstance(args.get("seq"), int):
                continue
            wins = groups.get(("plane.kv_migration", args["seq"]))
            if not wins:
                continue
            n_mig_links += 1
            flow_id += 1
            chain = sorted(
                [{"pid": snap["_pid"], "tid": int(tid),
                  "start": float(ts) + off,
                  "dur": float(dur or 0.0)}] + wins,
                key=lambda w: w["start"] + w["dur"] / 2.0)
            for i, w in enumerate(chain):
                fph = "s" if i == 0 else (
                    "f" if i == len(chain) - 1 else "t")
                rec = {"name": "plane.kv_migration", "cat": "request",
                       "ph": fph, "id": flow_id, "pid": w["pid"],
                       "tid": w["tid"],
                       "ts": (w["start"] + w["dur"] / 2.0 - t0) * 1e6}
                if fph == "f":
                    rec["bp"] = "e"
                events.append(rec)

    rollup = _rollup(annotated, matched, align, n_unmatched)
    rollup["requests"] = {"n_lanes": len(n_req_lanes),
                          "n_migration_links": n_mig_links}
    chrome = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    return {"chrome": chrome, "rollup": rollup}


def _rollup(annotated, matched, align, n_unmatched):
    """The cross-rank numbers: per-collective skew, straggler counts,
    per-rank busy/bubble — the ``kind=trace_merged`` record payload.
    ``matched`` is merge()'s matched-group subset (>= 2 ranks each)."""
    ranks = sorted({snap["_pid"] for snap in annotated})
    skew: dict[str, dict[str, Any]] = {}
    last_counts: dict[int, int] = {r: 0 for r in ranks}
    n_matched = len(matched)
    for (name, _seq), wins in matched.items():
        starts = [w["start"] for w in wins]
        durs = [w["dur"] for w in wins]
        s = skew.setdefault(name, {
            "n": 0, "max_start_skew_s": 0.0, "sum_start_skew_s": 0.0,
            "max_dur_skew_s": 0.0})
        start_skew = max(starts) - min(starts)
        s["n"] += 1
        s["max_start_skew_s"] = max(s["max_start_skew_s"], start_skew)
        s["sum_start_skew_s"] += start_skew
        s["max_dur_skew_s"] = max(s["max_dur_skew_s"],
                                  max(durs) - min(durs))
        last = max(wins, key=lambda w: w["start"] + w["dur"])
        last_counts[last["pid"]] = last_counts.get(last["pid"], 0) + 1
    for s in skew.values():
        s["mean_start_skew_s"] = s.pop("sum_start_skew_s") / s["n"]

    # busy/bubble per lane: several snapshots of one process aggregate
    # into that lane's single fraction
    lane_stamps: dict[int, list[float]] = {}
    lane_intervals: dict[int, list[tuple[float, float]]] = {}
    total_events = 0
    for snap in annotated:
        off = snap["_offset"]
        pid = snap["_pid"]
        stamps = lane_stamps.setdefault(pid, [])
        intervals = lane_intervals.setdefault(pid, [])
        for ev in snap.get("events", []):
            total_events += 1
            stamps.append(float(ev[3]) + off)
            if ev[0] == "X" and ev[1] == "device":
                s0 = float(ev[3]) + off
                intervals.append((s0, s0 + float(ev[5] or 0.0)))
    busy: dict[str, dict[str, float]] = {}
    for pid, stamps in lane_stamps.items():
        if not stamps:
            continue
        intervals = lane_intervals[pid]
        window = max(max(stamps), max((e for _, e in intervals),
                                      default=max(stamps))) - min(stamps)
        busy_s = _union_seconds(intervals)
        frac = busy_s / window if window > 0 else 0.0
        busy[str(pid)] = {
            "busy_frac": frac, "bubble_frac": 1.0 - frac,
            "window_s": window,
        }

    num_processes = max(
        (int(s.get("process", {}).get("num_processes", 1) or 1)
         for s in annotated), default=0)
    return {
        "num_processes": num_processes,
        "ranks": ranks,
        "n_ranks": len(ranks),
        "n_events": total_events,
        "n_matched": n_matched,
        "n_unmatched": n_unmatched,
        "align": {
            "method": align["method"],
            "offsets_s": {str(r): align["offsets"].get(r, 0.0)
                          for r in sorted(align["offsets"])},
            "drift_bound_s": align["drift_bound_s"],
            "wall_disagreement_s": align["wall_disagreement_s"],
            "residual_s": align["residual_s"],
        },
        "skew": skew,
        "schedule": _schedule_check(annotated),
        "stragglers": {str(r): {"last": last_counts.get(r, 0),
                                "of": n_matched}
                       for r in ranks},
        "busy": busy,
    }


# ---------------------------------------------------------------------------
# rendering + CLI
# ---------------------------------------------------------------------------


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.3f} s"
    if v >= 1e-3:
        return f"{v * 1e3:.3f} ms"
    return f"{v * 1e6:.1f} us"


def format_rollup(rollup: dict[str, Any]) -> str:
    """The human skew/straggler summary the launcher and the CLI
    print; ``harness.report`` renders a one-line digest of the same
    record."""
    lines = []
    a = rollup["align"]
    lines.append(
        f"merged {rollup['n_ranks']} rank(s) "
        f"({rollup['n_events']} events; clock align: {a['method']}"
        + (f", residual ≤ {_fmt_s(a['residual_s'])}"
           if a["method"] == "sync" else
           f", drift ≤ {_fmt_s(a['drift_bound_s'])}")
        + f"); {rollup['n_matched']} collective(s) matched across ranks"
        + (f", {rollup['n_unmatched']} single-rank"
           if rollup["n_unmatched"] else ""))
    reqs = rollup.get("requests") or {}
    if reqs.get("n_lanes"):
        lines.append(
            f"request lanes: {reqs['n_lanes']} request(s), "
            f"{reqs['n_migration_links']} migration flow link(s) "
            "(harness/explain.py attributes the tails)")
    sched = rollup.get("schedule") or {}
    verdict = sched.get("verdict")
    if verdict == "consistent":
        lines.append(
            f"collective schedules consistent across "
            f"{sched['n_ranks_recorded']} rank(s): "
            f"{sched['n_collectives']} collective(s), "
            f"digest {sched['digest']}")
    elif verdict == "divergent":
        fd = sched.get("first_divergence")
        if fd:
            at = ", ".join(
                (f"rank {r} is at {info['op']}#{info['seq']}"
                 if "op" in info
                 else f"rank {r} ended after {info['ended_at']}")
                for r, info in sorted(fd["ranks"].items(),
                                      key=lambda kv: int(kv[0])))
            lines.append(
                f"COLLECTIVE SCHEDULE DIVERGENCE at #{fd['index']}: "
                f"{at}")
        else:
            lines.append(
                "COLLECTIVE SCHEDULE DIVERGENCE (first divergent "
                "collective evicted from every chain window)")
    if rollup["skew"]:
        lines.append("")
        lines.append(f"{'collective':<36} {'n':>4} {'max start skew':>15} "
                     f"{'mean start skew':>16} {'max dur skew':>13}")
        for name, s in sorted(rollup["skew"].items()):
            lines.append(
                f"{name:<36} {s['n']:>4} "
                f"{_fmt_s(s['max_start_skew_s']):>15} "
                f"{_fmt_s(s['mean_start_skew_s']):>16} "
                f"{_fmt_s(s['max_dur_skew_s']):>13}")
    strag = [(r, v) for r, v in sorted(rollup["stragglers"].items(),
                                       key=lambda kv: int(kv[0]))
             if v["of"]]
    if strag:
        lines.append("")
        lines.append(f"{'rank':<6} {'finished last':>14} "
                     f"{'busy':>8} {'bubble':>8}")
        for r, v in strag:
            b = rollup["busy"].get(r, {})
            lines.append(
                f"r{r:<5} {v['last']:>7}/{v['of']:<6} "
                f"{b.get('busy_frac', 0.0):>7.1%} "
                f"{b.get('bubble_frac', 0.0):>7.1%}")
        worst = max(strag, key=lambda kv: kv[1]["last"])
        if worst[1]["last"]:
            lines.append(
                f"straggler: rank {worst[0]} finished last in "
                f"{worst[1]['last']}/{worst[1]['of']} matched "
                "collective(s)")
    return "\n".join(lines)


#: schema version of the ``--rollup-out`` artifact — bump on any
#: breaking change to the rollup key layout so downstream fitters
#: (harness/autofit.py) can refuse a layout they don't understand
ROLLUP_VERSION = 1
ROLLUP_KIND = "trace_rollup"


def dumps_rollup(rollup: dict[str, Any]) -> str:
    """The stable serialized form of the ``--rollup-out`` artifact:
    the trace_merged payload wrapped in a version/kind envelope,
    sorted keys, trailing newline — byte-identical for identical
    rollups, so a fitted config derived from it is reproducible."""
    doc = {"version": ROLLUP_VERSION, "kind": ROLLUP_KIND,
           **{k: v for k, v in rollup.items()
              if not k.startswith("_")}}
    return json.dumps(doc, sort_keys=True, indent=2, default=str) + "\n"


def write_rollup(rollup: dict[str, Any], path: str | Path) -> Path:
    """Write the versioned rollup JSON and record its location in the
    rollup itself (``rollup_out``), so the ``kind=trace_merged`` runlog
    record — and harness.report's digest line — name the artifact."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rollup["rollup_out"] = str(path)
    path.write_text(dumps_rollup(rollup))
    return path


def collect_to_file(inputs: Iterable[str | Path],
                    out: str | Path) -> dict[str, Any] | None:
    """Load, merge, and write the Perfetto JSON to ``out``. Returns the
    rollup (None when no snapshots were found) — the one call the
    launcher makes at exit."""
    snaps = load_rank_snapshots(inputs)
    if not snaps:
        return None
    merged = merge(snaps)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        json.dump(merged["chrome"], f)
    rollup = merged["rollup"]
    rollup["out"] = str(out)
    return rollup


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Merge per-rank flight-recorder snapshots into one "
                    "clock-aligned Perfetto timeline with cross-rank "
                    "skew/straggler rollups")
    p.add_argument("inputs", nargs="+",
                   help="rank directory (HPCPAT_TRACE_DIR), per-rank "
                        "rank*.trace.json files, or runlog JSONL files "
                        "with kind=trace records")
    p.add_argument("-o", "--out", default=None,
                   help="merged Chrome-trace JSON path (default: "
                        "<first input>/merged.trace.json for a "
                        "directory, <first input>.merged.json otherwise)")
    p.add_argument("--log", default=None,
                   help="append the kind=trace_merged rollup record to "
                        "this runlog JSONL (harness.report renders it)")
    p.add_argument("--rollup-out", default=None, metavar="PATH",
                   help="also write the cross-rank rollup as a stable "
                        "versioned JSON artifact (kind=trace_rollup, "
                        f"version {ROLLUP_VERSION}; sorted keys, "
                        "reproducible bytes) — the file "
                        "harness/autofit.py consumes for placement "
                        "fitting, named in harness.report's digest "
                        "line")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    first = Path(args.inputs[0])
    if args.out:
        out = Path(args.out)
    elif first.is_dir():
        out = first / "merged.trace.json"
    else:
        out = first.with_suffix(".merged.json")
    try:
        rollup = collect_to_file(args.inputs, out)
    except OSError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    if rollup is None:
        print("ERROR: no trace snapshots in input (per-rank "
              "rank*.trace.json files are written by --trace runs "
              "under HPCPAT_TRACE_DIR; kind=trace records by "
              "--trace --log runs)", file=sys.stderr)
        return 2
    if args.rollup_out:
        # BEFORE the --log emit: the trace_merged record must carry
        # the artifact's location for report's digest line
        try:
            write_rollup(rollup, args.rollup_out)
        except OSError as e:
            print(f"ERROR: cannot write --rollup-out: {e}",
                  file=sys.stderr)
            return 2
        print(f"rollup artifact: {args.rollup_out} "
              f"(kind={ROLLUP_KIND} v{ROLLUP_VERSION})")
    print(format_rollup(rollup))
    print(f"{out}: open in Perfetto (ui.perfetto.dev) or "
          "chrome://tracing — one pid lane per rank, flow arrows link "
          "each collective's ranks")
    if args.log:
        from hpc_patterns_tpu_torch.harness.runlog import RunLog

        RunLog(args.log, truncate=False).emit(kind="trace_merged",
                                              **rollup)
    return 0


if __name__ == "__main__":
    sys.exit(main())
