"""Request-scoped lifecycle tracing: where every request's time went —
the counterpart of ``hpc_patterns_tpu/harness/reqtrace.py``, copied.

The metrics registry and the flight recorder are device- and
phase-centric: their rollups can say the admission bubble was 12% of
the run, but not "why was THIS request's TTFT 3x the p50?" — the
per-request stats table carries only endpoint stamps (``t_submit``/
``t_first``/``t_finish``). Here the unit is the **segment**, one per
lifecycle state the engine already owns a transition for:

``queued`` (submitted, not yet admitted), ``admit_wait`` (inside the
admission pass that seats it — the per-request share of the admission
bubble), ``prefill`` (admission dispatch -> first-token readback),
``decode`` (first token -> completion), ``preempted`` (evicted back to
the queue, awaiting re-admission), ``swapped_out`` (paged to the host
tier), ``prefetch_wait`` (host->HBM pull in flight), ``migrating``
(exported from one engine, not yet installed in another), ``shed``
(terminal zero-length marker), and ``untracked`` — the explicit filler
for any span no stamp claimed. The port's engine stamps queued,
admit_wait, prefill, decode, preempted, migrating and shed (and each
token's availability instant in its stats row's ``token_ts``, which
:meth:`ReqTrace.snapshot` carries); swapped_out and prefetch_wait
wait for tiered residency.

The load-bearing contract is the **coverage invariant**: a finished
request's finalized segments tile ``[t_submit, t_finish]`` exactly
(:func:`finalize`), with gaps surfacing as ``untracked`` segments so
unattributed time is a measured number, not silence. Cross-replica,
the history rides the :class:`~hpc_patterns_tpu_torch.models.serving.
MigrationBundle` and the wire codec (``segments``); a reader of a legacy
artifact decodes the absent key to ONE ``untracked`` segment
(:data:`LEGACY_SEGMENTS`).

Zero-cost when disabled: every engine/router stamp site does ONE
module-global read (:func:`active`) and nothing else. The stamp helpers
run inside the serving loop with chunks in flight, so they stay pure
host list work — a device readback to "timestamp precisely" would stall
exactly the pipeline the attribution exists to explain.

Import-light (stdlib only). Segments and snapshots are the JAX module's
schema, so a ``kind=reqtrace`` record from either package reads in the
other.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Mapping

#: every segment kind a stamp may open (``untracked`` is synthesized
#: by :func:`finalize`, never stamped)
SEGMENT_KINDS = (
    "queued", "admit_wait", "prefill", "decode", "preempted",
    "swapped_out", "prefetch_wait", "migrating", "shed", "untracked",
)

#: what an ABSENT ``segments`` field on a legacy wire artifact decodes
#: to (serving_plane/migration.bundle_from_wire): one open untracked
#: segment — :meth:`ReqTrace.install_history` resolves its start to
#: the bundle's ``t_submit`` and its end to the install instant, so a
#: pre-round-18 bundle's whole donor-side life is one measured
#: untracked span, not a silent gap
LEGACY_SEGMENTS = (("untracked", None, None),)

#: tiling tolerance (seconds): gaps below it are clock-stamp noise and
#: are absorbed, not reported as untracked
EPS_S = 1e-7


def _now() -> float:
    return time.perf_counter()


class ReqTrace:
    """Per-request segment recorder.

    Segments are compact JSON-able lists ``[kind, t0, t1, meta]``
    (``t1`` is None while the segment is open; ``meta`` an optional
    dict — e.g. the plane migration sequence number, for the merge's
    flow arrows). Histories are keyed by ``seq_id`` — the engine's
    and the plane's request ids share one space per recorder, exactly
    like the stats tables they annotate. All stamps are
    ``time.perf_counter`` instants: one recorder = one clock (the
    launched plane stamps ONLY at its router for this reason).
    """

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._segs: dict[int, list[list]] = {}

    # -- stamping (dispatch-critical: pure host list work) ---------------

    def _open(self, segs: list[list]) -> list | None:
        if segs and segs[-1][2] is None:
            return segs[-1]
        return None

    def _close(self, segs: list[list], t: float) -> None:
        seg = self._open(segs)
        if seg is not None:
            t0 = seg[1]
            seg[2] = t if t0 is None else max(t, t0)

    def begin_request(self, seq_id: int, t: float | None = None) -> None:
        """Open the ``queued`` segment at submit time. A re-begin of a
        known id CONTINUES its history (the plane's death-resume path
        resubmits the same plane-global id to a surviving replica —
        one user-visible life, one tiling)."""
        t = _now() if t is None else t
        segs = self._segs.get(seq_id)
        if segs:
            self.stamp_transition(seq_id, "queued", t)
            return
        self._segs[seq_id] = [["queued", t, None, None]]

    def restamp_submit(self, seq_id: int, t: float) -> None:
        """Move the FIRST segment's start back to the open-loop
        arrival instant — the same restamp the engines apply to
        ``stats[sid]["t_submit"]`` when a scheduled arrival is drained
        late (the request queued on the USER's clock, and the tiling
        is against the restamped ``t_submit``)."""
        segs = self._segs.get(seq_id)
        if segs:
            segs[0][1] = min(t, segs[0][1]) if segs[0][1] is not None \
                else t

    def stamp_transition(self, seq_id: int, kind: str,
                         t: float | None = None) -> None:
        """Close the open segment and open ``kind`` at the same
        instant — THE transition stamp every engine/router site calls.
        An unknown ``seq_id`` starts a fresh history at ``kind`` (the
        leading gap back to ``t_submit`` finalizes as untracked
        rather than losing the request)."""
        t = _now() if t is None else t
        segs = self._segs.get(seq_id)
        if segs is None:
            segs = self._segs[seq_id] = []
        self._close(segs, t)
        segs.append([kind, t, None, None])

    def annotate_open(self, seq_id: int, **meta: Any) -> None:
        """Attach metadata to the currently open segment (e.g. the
        router's migration ``seq`` — the handle harness/collect.py
        matches flow arrows on)."""
        segs = self._segs.get(seq_id)
        seg = self._open(segs) if segs else None
        if seg is not None:
            seg[3] = {**(seg[3] or {}), **meta}

    def finish_request(self, seq_id: int, t: float | None = None,
                       final: str | None = None) -> None:
        """Close the open segment at the request's resolution instant;
        ``final`` appends a zero-length terminal marker (``shed``).
        When a flight recorder is active the finished history is
        mirrored onto the request's Perfetto lane."""
        t = _now() if t is None else t
        segs = self._segs.get(seq_id)
        if segs is None:
            return
        self._close(segs, t)
        if final is not None:
            segs.append([final, t, t, None])
        self._emit_lane(seq_id, segs)

    # -- cross-engine history transport ----------------------------------

    def export_history(self, seq_id: int,
                       t: float | None = None) -> tuple:
        """Transition to ``migrating`` and return a JSON-able copy of
        the history — the donor half: what
        :class:`~hpc_patterns_tpu_torch.models.serving.MigrationBundle`
        carries (and the wire codec serializes) so a migrated
        request's destination-side record does NOT start fresh."""
        t = _now() if t is None else t
        self.stamp_transition(seq_id, "migrating", t)
        return tuple(tuple(s) for s in self._segs[seq_id])

    def install_history(self, seq_id: int, segments, *,
                        t: float | None = None,
                        t_submit: float | None = None) -> None:
        """Adopt a bundle's carried history on the installing engine
        and open ``decode`` — the receiver half. A LOCAL history wins
        when one exists (the in-process plane shares one recorder, and
        the live history carries annotations — the migration ``seq``
        tag — the bundle's exported copy predates); the carried
        ``segments`` seed a fresh recorder (the cross-process install).
        Both absent — donor traced nothing, or a legacy artifact
        decoded to :data:`LEGACY_SEGMENTS` — resolves to one
        ``untracked`` span from ``t_submit``."""
        t = _now() if t is None else t
        segs = self._segs.get(seq_id)
        if segs is None:
            if segments is not None:
                segs = [list(s) + [None] * (4 - len(s))
                        for s in segments]
            else:
                segs = [["untracked", t_submit, None, None]]
            self._segs[seq_id] = segs
        self._close(segs, t)
        segs.append(["decode", t, None, None])

    # -- read side -------------------------------------------------------

    def segments(self, seq_id: int) -> list[list] | None:
        segs = self._segs.get(seq_id)
        return [list(s) for s in segs] if segs is not None else None

    def snapshot(self, stats: Mapping[int, Mapping[str, Any]]
                 ) -> dict[str, Any]:
        """The ``kind=reqtrace`` record payload: every request's raw
        segment history zipped with its stats endpoints, plus the
        run-level coverage number the bench gate captures. ``stats``
        is the engine's/plane's per-request table (the same input
        harness/slo.py consumes)."""
        requests: dict[str, dict[str, Any]] = {}
        untracked_s = total_s = 0.0
        for sid, rec in stats.items():
            segs = self._segs.get(sid)
            entry = {
                "priority": rec.get("priority", 0),
                "t_submit": rec.get("t_submit"),
                "t_first": rec.get("t_first"),
                "t_finish": rec.get("t_finish"),
                "tokens": rec.get("tokens", 0),
                "outcome": rec.get("outcome"),
                "preemptions": rec.get("preemptions", 0),
                "segments": ([list(s) for s in segs]
                             if segs is not None else None),
                # per-token availability instants (models/serving.py
                # collect readbacks) — None on a legacy stats table;
                # harness/explain.py tiles decode-phase stalls over
                # the gaps between consecutive stamps
                "token_ts": (list(rec["token_ts"])
                             if rec.get("token_ts") else None),
            }
            if rec.get("replica") is not None:
                entry["replica"] = rec["replica"]
            requests[str(sid)] = entry
            if rec.get("t_submit") is not None \
                    and rec.get("t_finish") is not None:
                tiled, u = finalize(segs or (), rec["t_submit"],
                                    rec["t_finish"])
                untracked_s += u
                total_s += max(0.0, rec["t_finish"] - rec["t_submit"])
        return {
            "n": len(requests),
            "coverage_frac": (1.0 - untracked_s / total_s
                              if total_s > 0 else 1.0),
            "requests": requests,
        }

    # -- the Perfetto lane mirror ----------------------------------------

    def _emit_lane(self, seq_id: int, segs: Iterable) -> None:
        from hpc_patterns_tpu_torch.harness import trace as tracelib

        rec = tracelib.active()
        if rec is None:
            return
        for kind, t0, t1, meta in segs:
            if t0 is None or t1 is None or t1 < t0:
                continue  # unresolved legacy spans have no lane form
            rec.mark_request_segment(seq_id, kind, t0, t1,
                                     args=meta)


def finalize(segments: Iterable, t_submit: float, t_finish: float
             ) -> tuple[list[list], float]:
    """Canonicalize a raw history into the tiling the coverage
    invariant is stated over: clamp every segment into
    ``[t_submit, t_finish]``, resolve open/unknown ends, and fill
    every gap wider than :data:`EPS_S` with an explicit ``untracked``
    segment. Returns ``(tiled, untracked_seconds)`` — the tiled list's
    spans sum to exactly ``t_finish - t_submit``, always."""
    span = max(0.0, t_finish - t_submit)
    out: list[list] = []
    cursor = t_submit
    untracked = 0.0
    for seg in segments:
        kind, t0, t1 = seg[0], seg[1], seg[2]
        meta = seg[3] if len(seg) > 3 else None
        s0 = cursor if t0 is None else max(float(t0), cursor)
        s1 = t_finish if t1 is None else float(t1)
        s0 = min(s0, t_finish)
        s1 = min(max(s1, s0), t_finish)
        if s0 - cursor > EPS_S:
            out.append(["untracked", cursor, s0, None])
            untracked += s0 - cursor
        if s1 > s0 or (kind == "shed" and s1 == s0):
            out.append([kind, s0, s1, meta])
            if kind == "untracked":
                # a literal untracked segment (the legacy-artifact
                # decode) counts against coverage like the synthesized
                # gap filler does
                untracked += s1 - s0
        cursor = max(cursor, s1)
    if t_finish - cursor > EPS_S:
        out.append(["untracked", cursor, t_finish, None])
        untracked += t_finish - cursor
    if not out and span > 0:
        out.append(["untracked", t_submit, t_finish, None])
        untracked = span
    return out, untracked


def coverage_frac(segments: Iterable, t_submit: float,
                  t_finish: float) -> float:
    """1 - untracked share of ``[t_submit, t_finish]`` (1.0 for a
    zero-length life) — the per-request form of the gated run-level
    ``attribution_coverage_frac``."""
    span = max(0.0, t_finish - t_submit)
    if span <= 0:
        return 1.0
    _, untracked = finalize(segments, t_submit, t_finish)
    return 1.0 - untracked / span


# ---------------------------------------------------------------------------
# process-wide recorder (the chaos/trace module-global discipline)
# ---------------------------------------------------------------------------

_tracer: ReqTrace | None = None


def active() -> ReqTrace | None:
    """The enabled recorder, or None — THE fast-path check every stamp
    site makes (one module-global read; the disabled path never
    allocates, never stamps, never touches a clock)."""
    rt = _tracer
    if rt is not None and rt.enabled:
        return rt
    return None


def configure(*, enabled: bool = False) -> ReqTrace:
    """Install a FRESH process-wide recorder (``--explain`` surfaces
    call this once per run; each bench leg reconfigures so seq-id
    spaces never bleed across legs)."""
    global _tracer
    _tracer = ReqTrace(enabled=enabled)
    return _tracer


def reset() -> None:
    """Drop the recorder entirely (tests; mirrors chaos.reset)."""
    global _tracer
    _tracer = None
