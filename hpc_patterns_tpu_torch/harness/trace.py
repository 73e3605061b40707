"""Flight recorder: per-event trace timeline with Chrome-trace export — the
counterpart of ``hpc_patterns_tpu/harness/trace.py``.

The metrics registry (``harness/metrics.py``) aggregates phase times into
fixed-bucket histograms; this module records the individual timestamped
events in a bounded ring buffer, ordered in time, with build and memory
causes attached. Event sources, all zero-cost when disabled:

- **spans** — every ``Metrics.span()`` begin/end feeds the recorder when
  one is installed; nesting paths and attrs ride along.
- **device windows** — the serving engine's admissions and decode chunks,
  the ``Communicator``'s collectives, ``harness.timing.measure``'s
  repetitions and the plane's KV migrations. On a card a window is two
  CUDA timing events on the current stream: :meth:`TraceRecorder.
  open_window` records the start before the work is enqueued,
  :meth:`TraceRecorder.mark_dispatch` the end right after it (with the
  host-side dispatch marker), and :meth:`TraceRecorder.mark_complete`
  reads the elapsed time only after the caller's own readback has
  completed the end event — no synchronize on the dispatch path. The
  events land on the host timeline through an anchor pair taken once at
  :func:`configure` (a host stamp and an event recorded after one
  synchronize). An event that cannot be recorded raises; it never falls
  back to the host clock. On the CPU a window is the host clock from its
  opening to completion (the JAX module's runs from dispatch: its CPU
  work is asynchronous, the port's runs as it is issued).
- **compile events** — the port's kernel builds: ``ops/_build.py`` stamps
  one event per compiled source (name, seconds of ``nvcc``);
  :func:`compile_watch` and :func:`instrument_jit` attach a call's name
  and shapes when the call built kernels.
- **memory samples** — ``torch.cuda.memory_allocated`` per device at span
  boundaries (throttled), once CUDA is initialized.

The ring buffer is bounded (``capacity`` events, oldest evicted); export
re-balances B/E pairs across the eviction edge so the JSON always loads.
Event tuples, snapshot keys, track ids and labels are the JAX module's,
so snapshots from either package merge (:func:`chrome_from_snapshots`)
and either package's ``report`` reads them. Routes out:

- live: ``TraceRecorder.export(path)`` (serve_app ``--trace-out``);
- offline: the recorder's snapshot lands as one ``kind=trace`` run-log
  record (``apps/common.run_instrumented`` under ``--trace --log``), and
  ``python -m hpc_patterns_tpu_torch.harness.trace run.jsonl -o out.json``
  rebuilds the Chrome JSON through ``harness/collect.py``'s merge (one
  pid lane per process and file, clocks aligned);
- per rank: with ``HPCPAT_TRACE_DIR`` set, the snapshot is also written
  there (:func:`write_rank_snapshot`), and ``python -m
  hpc_patterns_tpu_torch.harness.collect DIR`` merges the ranks.

The collective-schedule fingerprint chain (:class:`CollectiveSchedule`,
the JAX package's ``analysis/runtime.py`` copy) lives here too: every
eager ``Communicator`` collective, traced timing repetition and plane
migration folds ``(op, seq, shape, dtype, axis, algorithm)`` into a hash
chain that snapshots carry, so two ranks' schedules compare by one digest.

Torch-free at import time: torch is touched only inside enabled-path
helpers (windows on a card, memory samples), so the disabled path costs
one module-global None check.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any

from hpc_patterns_tpu_torch import topology
from hpc_patterns_tpu_torch.harness import metrics as metricslib

# Synthetic track ids for events that are not host-thread work (the JAX
# module's numbering). Device windows get SUBTRACKS (TID_DEVICE + track):
# Chrome-trace sync slices on one tid must nest, and an admission runs
# behind an in-flight decode chunk by design, so each admission slot
# renders on its own subtrack.
TID_DEVICE = 1 << 20
TID_COMPILE = 1 << 21
TID_COUNTER = (1 << 21) + 1
# request lifecycle lanes (harness/reqtrace.py): one per request
TID_REQUEST = 1 << 22

#: device-subtrack bands, ``name -> (base, count)``, offsets added to
#: TID_DEVICE: the decode chunk, the admission slots (slot N on N+1), the
#: KV-migration lanes, and the JAX package's spin-up and residency lanes
#: (kept so its snapshots label the same here)
TRACK_BANDS: dict[str, tuple[int, int]] = {
    "decode": (0, 1),
    "admit": (1, 63),
    "migration": (64, 8),
    "spinup": (72, 8),
    "residency": (80, 8),
}


def track_band(name: str) -> tuple[int, int]:
    """``(base, count)`` for a declared subtrack band."""
    return TRACK_BANDS[name]


def migration_track(seq: int) -> int:
    """The device subtrack a plane migration's window lands on (the JAX
    ``serving_plane/service.py`` formula)."""
    base, count = track_band("migration")
    return base + int(seq) % count


def _track_label(tid: int) -> str:
    if tid == TID_COMPILE:
        return "compile"
    if tid == TID_COUNTER:
        return "memory"
    if tid == TID_DEVICE:
        return "device (dispatch→completion)"
    if TID_DEVICE < tid < TID_COMPILE:
        track = tid - TID_DEVICE
        for name, (base, count) in TRACK_BANDS.items():
            if base <= track < base + count:
                if name == "admit":
                    return f"device (admit slot {track - base})"
                return f"device ({name} lane {track - base})"
        return f"device (subtrack {track})"
    if tid >= TID_REQUEST:
        return f"request {tid - TID_REQUEST}"
    return f"host thread {tid}"


DEFAULT_CAPACITY = 16384

#: the ``clock`` arg a device window timed by CUDA events carries
EVENT_CLOCK = "cuda_event"


class Window:
    """One device window in flight: the host stamp of its opening and,
    on a card, its start and end timing events (held until
    :meth:`TraceRecorder.mark_complete` reads them). Truthy, like the
    JAX module's nonzero dispatch stamp."""

    __slots__ = ("ts", "device", "start", "end")

    def __init__(self, ts: float, device: int | None = None,
                 start=None):
        self.ts = ts
        self.device = device
        self.start = start
        self.end = None

    def __bool__(self) -> bool:
        return True


def _cuda_index(device) -> int | None:
    """The CUDA device index a window on ``device`` times, or None for a
    host-clock window (``device`` None or a CPU device)."""
    if device is None:
        return None
    device = getattr(device, "device", device)  # a LogicalDevice's card
    if device.type != "cuda":
        return None
    import torch

    return (device.index if device.index is not None
            else torch.cuda.current_device())


class TraceRecorder:
    """Bounded ring-buffer event recorder.

    Events are compact tuples ``(ph, cat, name, ts, tid, dur, args)``:
    ``ph`` is the Chrome phase (B/E/i/X/C), ``cat`` the event kind
    (span/device/compile/counter/request), ``ts`` a ``time.perf_counter``
    stamp, ``dur`` only for X slices. ``t0_wall``/``t0_mono`` anchor the
    monotonic stamps to wall time.
    """

    def __init__(self, *, enabled: bool = True,
                 capacity: int = DEFAULT_CAPACITY,
                 mem_interval_s: float = 0.05):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.n_events = 0  # total recorded, incl. evicted
        self.t0_wall = time.time()
        self.t0_mono = time.perf_counter()
        self.mem_interval_s = mem_interval_s
        self._last_mem_sample = self.t0_mono
        self._lock = threading.Lock()
        self.sync_anchors: list[dict[str, Any]] = []
        # rollups that survive ring eviction
        self.compile_count = 0
        self.compile_total_s = 0.0
        self.peak_live_bytes = 0
        #: CUDA device index -> (host stamp, anchor event)
        self._anchors: dict[int, tuple[float, Any]] = {}

    # -- primitive ---------------------------------------------------------

    def _push(self, ph: str, cat: str, name: str, ts: float, tid: int,
              dur: float | None = None,
              args: dict[str, Any] | None = None) -> None:
        self.events.append((ph, cat, name, ts, tid, dur, args))
        self.n_events += 1

    # -- span feed (installed as metrics._trace_sink) ----------------------

    def span_begin(self, path: str, attrs: dict[str, Any],
                   ts: float | None = None) -> None:
        self._push("B", "span", path,
                   time.perf_counter() if ts is None else ts,
                   threading.get_ident(),
                   args=dict(attrs) if attrs else None)

    def span_end(self, path: str, ts: float | None = None) -> None:
        self._push("E", "span", path,
                   time.perf_counter() if ts is None else ts,
                   threading.get_ident())
        self.maybe_sample_memory()

    # -- device windows ----------------------------------------------------

    def anchor_device(self, index: int) -> None:
        """Take the anchor pair that places device ``index``'s events on
        the host timeline: one synchronize, an event recorded and waited
        for, then a host stamp (the event's device time and the stamp
        agree to within the event's completion latency)."""
        import torch

        with torch.cuda.device(index):
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self._anchors[index] = (time.perf_counter(), ev)

    def open_window(self, device=None) -> Window:
        """Start a device window on ``device``'s current stream: call it
        BEFORE the window's work is enqueued. On a card this records the
        start event (raising if it cannot); on the CPU, or with
        ``device`` None, the window is host-clock only."""
        index = _cuda_index(device)
        if index is None:
            return Window(time.perf_counter())
        if index not in self._anchors:
            raise RuntimeError(
                f"no clock anchor for cuda:{index}: the recorder was "
                "configured before CUDA was available on that device "
                "(trace.configure anchors every visible card)")
        import torch

        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(index))
        return Window(time.perf_counter(), index, start)

    def mark_dispatch(self, name: str,
                      args: dict[str, Any] | None = None,
                      track: int = 0, *,
                      window: Window | None = None) -> Window | float:
        """Instant marker: device work for ``name`` was enqueued NOW.
        ``track`` selects a device subtrack (``TID_DEVICE + track``).
        With a ``window`` from :meth:`open_window` on a card, its end
        event is recorded here, behind the enqueued work, and the window
        is returned for :meth:`mark_complete`; without one the return is
        the host stamp (the JAX module's protocol)."""
        ts = time.perf_counter()
        self._push("i", "device", f"{name}.dispatch", ts,
                   TID_DEVICE + track, args=args)
        if window is None:
            return ts
        if window.start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(window.device))
            window.end = end
        return window

    def wait_window(self, window: Window) -> None:
        """Wait for a window's end event — for callers with no readback
        of their own whose contract is to block anyway (a timed
        repetition, a recording collective span). A host window has
        nothing to wait for."""
        if window.end is not None:
            window.end.synchronize()

    def mark_complete(self, name: str, t_dispatch: Window | float,
                      args: dict[str, Any] | None = None,
                      track: int = 0) -> None:
        """Completion observed (a readback or synchronize resolved): draw
        the window as one X slice on the device (sub)track. A host-clock
        window spans its opening (or, for a bare stamp, its dispatch) ->
        now — the port's CPU ops run as they are issued, so the work lies
        between opening and dispatch; an event window spans its start
        event -> its end event, read only once the end event completed
        (the caller's readback must have waited for it: an incomplete
        end event raises rather than block here)."""
        win = t_dispatch if isinstance(t_dispatch, Window) else None
        if win is None or win.start is None:
            t0 = win.ts if win is not None else t_dispatch
            self._push("X", "device", name, t0, TID_DEVICE + track,
                       dur=time.perf_counter() - t0, args=args)
            return
        if win.end is None or not win.end.query():
            raise RuntimeError(
                f"device window {name!r} read before its end event "
                "completed: mark_complete must follow the readback that "
                "waits for the window's work")
        host0, anchor = self._anchors[win.device]
        t0 = host0 + anchor.elapsed_time(win.start) / 1e3
        dur = win.start.elapsed_time(win.end) / 1e3
        self._push("X", "device", name, t0, TID_DEVICE + track, dur=dur,
                   args={**(args or {}), "clock": EVENT_CLOCK})

    def mark_request_segment(self, seq_id: int, kind: str, t0: float,
                             t1: float,
                             args: dict[str, Any] | None = None
                             ) -> None:
        """One finished lifecycle segment on a request's own lane
        (``TID_REQUEST + seq_id``) — harness/reqtrace.py mirrors a
        request's history here at finish."""
        self._push("X", "request", kind, t0,
                   TID_REQUEST + int(seq_id), dur=t1 - t0,
                   args={**(args or {}), "seq_id": int(seq_id)})

    def mark_sync(self, name: str) -> float:
        """Record a cross-rank sync anchor (call right after a barrier
        returns). Returns the monotonic stamp."""
        ts = time.perf_counter()
        self.sync_anchors.append({"name": name, "mono": ts})
        return ts

    # -- compile events ----------------------------------------------------

    def compile_event(self, name: str, dur_s: float,
                      args: dict[str, Any] | None = None,
                      t_end: float | None = None,
                      count: bool = True) -> None:
        """One build: an X slice of ``dur_s`` on the compile track ending
        at ``t_end`` (now by default). ``count=False`` records the slice
        without bumping the ``compile.count/total_s`` rollups — the named
        :func:`compile_watch` / :func:`instrument_jit` hooks see a build
        that ``ops/_build.py`` already counted."""
        t_end = time.perf_counter() if t_end is None else t_end
        self._push("X", "compile", name, t_end - dur_s, TID_COMPILE,
                   dur=dur_s, args=args)
        if count:
            self.compile_count += 1
            self.compile_total_s += dur_s

    # -- memory samples ----------------------------------------------------

    def counter(self, name: str, values: dict[str, float]) -> None:
        self._push("C", "counter", name, time.perf_counter(),
                   TID_COUNTER, args=dict(values))

    def sample_memory(self) -> dict[str, float] | None:
        """Bytes the caching allocator hands out on each CUDA device
        (``torch.cuda.memory_allocated``), recorded as a Counter event.
        None (nothing recorded) when torch is not imported or CUDA is not
        initialized — sampling must never be what first initializes it."""
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        try:
            if not torch.cuda.is_initialized():
                return None
            per_dev = {f"live_bytes.cuda:{i}":
                       float(torch.cuda.memory_allocated(i))
                       for i in range(torch.cuda.device_count())}
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            return None
        total = sum(per_dev.values())
        sample = {"live_bytes": total, **per_dev}
        self.counter("mem", sample)
        self.peak_live_bytes = max(self.peak_live_bytes, int(total))
        return sample

    def maybe_sample_memory(self) -> None:
        """Throttled :meth:`sample_memory` — called at span boundaries,
        at most once per ``mem_interval_s``."""
        now = time.perf_counter()
        if now - self._last_mem_sample < self.mem_interval_s:
            return
        with self._lock:
            if now - self._last_mem_sample < self.mem_interval_s:
                return
            self._last_mem_sample = now
        self.sample_memory()

    # -- snapshot / export -------------------------------------------------

    def _balanced_events(self) -> list[tuple]:
        """Buffer contents with span B/E pairs re-balanced across the
        ring's eviction edge: an E whose B was evicted is dropped, a B
        still open at snapshot time gets a synthesized E at the last
        stamp — so every exported B has a matching E."""
        out: list[tuple] = []
        stacks: dict[int, list[str]] = {}
        max_ts = self.t0_mono
        for ev in list(self.events):
            ph, name, ts, tid = ev[0], ev[2], ev[3], ev[4]
            max_ts = max(max_ts, ts + (ev[5] or 0.0))
            if ph == "B":
                stacks.setdefault(tid, []).append(name)
            elif ph == "E":
                stack = stacks.get(tid)
                if not stack or stack[-1] != name:
                    continue  # orphan: its B fell off the ring
                stack.pop()
            out.append(ev)
        for tid, stack in stacks.items():
            for name in reversed(stack):
                out.append(("E", "span", name, max_ts, tid, None, None))
        return out

    def snapshot(self) -> dict[str, Any]:
        """JSON-able recorder state — the payload of the ``kind=trace``
        run-log record and of the per-rank file. ``clock`` carries two
        monotonic/wall anchor pairs (construction and snapshot time);
        ``process`` says whose timeline this is; ``collectives`` is the
        schedule hash chain."""
        events = self._balanced_events()
        by_cat: dict[str, int] = {}
        for ev in events:
            by_cat[ev[1]] = by_cat.get(ev[1], 0) + 1
        process_id, num_processes, slice_id = _process_info()
        return {
            "clock": {"wall0": self.t0_wall, "mono0": self.t0_mono,
                      "wall1": time.time(),
                      "mono1": time.perf_counter()},
            "process": {"process_id": process_id,
                        "num_processes": num_processes,
                        "slice_id": slice_id},
            "sync": [dict(a) for a in self.sync_anchors],
            "capacity": self.capacity,
            "n_events": self.n_events,
            "n_dropped": max(0, self.n_events - len(self.events)),
            "by_cat": by_cat,
            "compile": {"count": self.compile_count,
                        "total_s": self.compile_total_s},
            "mem": {"peak_live_bytes": self.peak_live_bytes},
            "collectives": _schedule.snapshot(),
            "events": [list(ev) for ev in events],
        }

    def to_chrome(self) -> dict[str, Any]:
        return chrome_from_snapshots([self.snapshot()])

    def export(self, path: str | Path) -> Path:
        """Write the Chrome-trace JSON (Perfetto: open -> this file)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            json.dump(self.to_chrome(), f)
        return path


#: the launcher env protocol (``topology``'s names, the JAX package's)
ENV_TRACE_DIR = topology.ENV_TRACE_DIR
ENV_PROCESS_ID = topology.ENV_PROCESS_ID
ENV_NUM_PROCESSES = topology.ENV_NUM_PROCESSES


def _process_info() -> tuple[int, int, int]:
    """(process_id, num_processes, slice_id) from the launcher env
    protocol (``apps/launch.py``), else the process group, else (0, 1,
    0)."""
    try:
        return topology.process_env_info()
    except ValueError:
        return 0, 1, 0


def mark_rendezvous(name: str = "rendezvous") -> float | None:
    """At a launched run's rendezvous: take a global barrier across the
    process group and record a sync anchor right after it on the active
    recorder (all ranks leave a barrier within its release window, so
    the cross-rank merge aligns their clocks on these anchors, tighter
    than the wall anchors). None — and no barrier — without a recorder
    or without a group of more than one process; every rank runs the
    same command line, so either all of them take the barrier or none
    does."""
    rec = active()
    if rec is None or not topology.is_multihost():
        return None
    sys.modules["torch.distributed"].barrier()
    return rec.mark_sync(name)


def rank_snapshot_path(trace_dir: str | Path, process_id: int) -> Path:
    """The per-rank handoff file under ``HPCPAT_TRACE_DIR``."""
    return Path(trace_dir) / f"rank{process_id:05d}.trace.json"


def write_rank_snapshot(rec: TraceRecorder, trace_dir: str | Path,
                        snapshot: dict[str, Any] | None = None
                        ) -> Path | None:
    """Write ``rec``'s snapshot (or ``snapshot``, when one was already
    taken for the ``--log`` record, so both carry the same events) to its
    per-rank file. None when the write failed: a full disk must not turn
    a successful run into a failure."""
    snap = dict(rec.snapshot() if snapshot is None else snapshot)
    snap["kind"] = "trace"
    path = rank_snapshot_path(trace_dir, snap["process"]["process_id"])
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            json.dump(snap, f)
    except OSError as e:
        print(f"WARNING: could not write per-rank trace {path}: {e}",
              file=sys.stderr)
        return None
    return path


def chrome_from_snapshots(snaps: list[dict[str, Any]],
                          pid: int = 1) -> dict[str, Any]:
    """Chrome-trace JSON from one or more ``kind=trace`` snapshots of one
    process: spans as B/E pairs on per-thread tracks, device windows and
    builds as X slices on their synthetic tracks, memory samples as
    Counter events. Timestamps are microseconds since the earliest
    monotonic anchor or event start."""
    if not snaps:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    mono0 = min(float(s["clock"]["mono0"]) for s in snaps)
    for s in snaps:
        for ev in s.get("events", []):
            mono0 = min(mono0, float(ev[3]))
    trace_events: list[dict[str, Any]] = []
    tids_seen: set[int] = set()
    for snap in snaps:
        for ev in snap.get("events", []):
            ph, cat, name, ts, tid, dur, args = ev
            tids_seen.add(int(tid))
            rec: dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph,
                "ts": (float(ts) - mono0) * 1e6,
                "pid": pid, "tid": int(tid),
            }
            if ph == "X":
                rec["dur"] = (dur or 0.0) * 1e6
            if ph == "i":
                rec["s"] = "t"  # thread-scoped instant arrow
            if ph == "C":
                rec["args"] = {k: v for k, v in (args or {}).items()}
            elif args:
                rec["args"] = {k: str(v) for k, v in args.items()}
            trace_events.append(rec)
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "hpc_patterns_tpu"}},
    ]
    for tid in sorted(tids_seen):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": _track_label(tid)}})
    return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# the collective-schedule fingerprint chain
# ---------------------------------------------------------------------------

#: chain entries retained per process (the digest covers the full history)
SCHEDULE_WINDOW = 4096


class CollectiveSchedule:
    """Per-rank hash chain over collective fingerprints: ``record(op, seq,
    ...)`` folds ``op|seq|shape|dtype|axis|algorithm`` into the running
    digest, so two ranks that issued the identical sequence hold the
    identical digest, and the retained window names the first divergent
    entry. The JAX package's chain, entry for entry."""

    def __init__(self, *, window: int = SCHEDULE_WINDOW):
        self._lock = threading.Lock()
        self.window = window
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.n = 0
            self.digest = ""
            self.entries: deque = deque(maxlen=self.window)

    def record(self, op: str, seq: int, *, shape=None, dtype=None,
               axis=None, algorithm=None) -> dict:
        fp = (f"{op}|{int(seq)}|{tuple(shape) if shape is not None else ()}"
              f"|{dtype or ''}|{axis or ''}|{algorithm or ''}")
        with self._lock:
            digest = hashlib.sha256(
                f"{self.digest}\x1f{fp}".encode()).hexdigest()[:16]
            entry = {
                "i": self.n, "op": str(op), "seq": int(seq),
                "shape": list(shape) if shape is not None else None,
                "dtype": str(dtype) if dtype is not None else None,
                "axis": str(axis) if axis is not None else None,
                "algorithm": (str(algorithm) if algorithm is not None
                              else None),
                "digest": digest,
            }
            self.digest = digest
            self.entries.append(entry)
            self.n += 1
        return entry

    def snapshot(self) -> dict:
        with self._lock:
            return {"n": self.n, "digest": self.digest,
                    "window": self.window,
                    "entries": [dict(e) for e in self.entries]}


_schedule = CollectiveSchedule()


def collective_schedule() -> CollectiveSchedule:
    """The process-wide chain."""
    return _schedule


def reset_collective_schedule() -> None:
    _schedule.reset()


def record_collective(op: str, seq: int, *, shape=None, dtype=None,
                      axis=None, algorithm=None) -> dict:
    """Fingerprint one collective into the process chain, at issue time.
    With ``HPCPAT_TRACE_DIR`` set, each record also writes the chain head
    to ``rank<id>.sched.json`` there (write-then-rename), so a hung rank's
    position is readable after the fact."""
    entry = _schedule.record(op, seq, shape=shape, dtype=dtype, axis=axis,
                             algorithm=algorithm)
    trace_dir = os.environ.get(ENV_TRACE_DIR)
    if trace_dir:
        pid = _process_info()[0]
        payload = {"process_id": pid, "n": entry["i"] + 1,
                   "digest": entry["digest"],
                   "last": {"i": entry["i"], "op": entry["op"],
                            "seq": entry["seq"]}}
        path = os.path.join(trace_dir, f"rank{pid:05d}.sched.json")
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            pass  # forensics are best-effort; never fail the collective
    return entry


def schedule_consumer() -> bool:
    """Whether anything consumes the chain: a live recorder (snapshots
    carry it) or a launcher's ``HPCPAT_TRACE_DIR`` (the progress file)."""
    return active() is not None or ENV_TRACE_DIR in os.environ


# ---------------------------------------------------------------------------
# process-wide recorder + the metrics-span sink hookup
# ---------------------------------------------------------------------------

_recorder: TraceRecorder | None = None


def get_tracer() -> TraceRecorder | None:
    return _recorder


def active() -> TraceRecorder | None:
    """The enabled recorder, or None — THE fast-path check every hook
    makes (one module-global read; the disabled path never allocates)."""
    rec = _recorder
    if rec is not None and rec.enabled:
        return rec
    return None


def configure(*, enabled: bool = False,
              capacity: int = DEFAULT_CAPACITY,
              mem_interval_s: float = 0.05) -> TraceRecorder:
    """Install a FRESH process-wide recorder (apps call this once per run
    via ``--trace``). Enabling installs it as the metrics-span sink and,
    where torch sees a card, takes each card's clock anchor (the one
    synchronize the recorder ever adds, at configure time); disabling
    detaches the sink. Either way the schedule chain restarts."""
    global _recorder
    rec = TraceRecorder(enabled=enabled, capacity=capacity,
                        mem_interval_s=mem_interval_s)
    if enabled:
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available():
            for index in range(torch.cuda.device_count()):
                rec.anchor_device(index)
    _recorder = rec
    metricslib._trace_sink = rec if enabled else None
    reset_collective_schedule()
    return rec


# ---------------------------------------------------------------------------
# build watchers (the port's counterpart of the jit-cache probes)
# ---------------------------------------------------------------------------


def jit_cache_size(fn=None, *, strict: bool = False) -> int:
    """The port's nearest counterpart of a jit cache's size: the number
    of kernel libraries built or loaded in this process
    (``ops/_build.py``). There is no per-function compiled-variant cache
    in PyTorch eager, so ``fn`` is accepted for the JAX signature and
    ignored, and ``strict`` has nothing to guard (a count the port does
    not have cannot silently read 0)."""
    from hpc_patterns_tpu_torch.ops import _build

    return _build.loaded_count()


_NULL = contextlib.nullcontext()


class _CompileWatch:
    """Diff the process's kernel-build count around a call: growth means
    THIS call built kernels, and its wall time is the build-dominated
    cost the event records (``ops/_build.py`` already counted the builds,
    so this event carries ``count=False`` and adds the name and attrs)."""

    __slots__ = ("rec", "name", "attrs", "n0", "t0")

    def __init__(self, rec: TraceRecorder, name: str,
                 attrs: dict[str, Any]):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.n0 = jit_cache_size()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        grew = jit_cache_size() - self.n0
        if grew > 0:
            self.rec.compile_event(self.name, dt, count=False,
                                   args={**self.attrs,
                                         "new_variants": grew})
        return False


def compile_watch(name: str, fn=None, **attrs):
    """``with compile_watch("decode.paged_generate", batch=1): ...`` —
    records a compile event iff the call built kernels. ``fn`` is
    accepted for the JAX signature. The disabled path returns a shared
    nullcontext."""
    rec = active()
    if rec is None:
        return _NULL
    return _CompileWatch(rec, name, attrs)


def _shape_strs(args) -> list[str]:
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None:
            out.append(f"{dtype}{list(shape)}")
    return out


def record_executable_memory(name: str, compiled) -> dict | None:
    """No counterpart in the port: PyTorch eager has no compiled
    executable whose ``memory_analysis()`` could be read. Kept for the
    JAX signature; records nothing and returns None. The port's nearest
    reading is :func:`instrument_jit`'s ``exec_memory`` window peak."""
    return None


def _window_peak(index: int, alloc0: int, max0: int) -> dict | None:
    """The peak-memory delta of a call's window on CUDA device ``index``:
    how far the call raised the allocator's high-water mark above what
    was allocated at its entry. Readable only when the call set a new
    high-water mark (the allocator's peak is not reset here, which would
    disturb a caller's own peak measurement); None otherwise."""
    import torch

    max1 = torch.cuda.max_memory_allocated(index)
    if max1 <= max0:
        return None
    return {"peak_memory_in_bytes": float(max1 - alloc0),
            "allocated_delta_bytes":
                float(torch.cuda.memory_allocated(index) - alloc0)}


def instrument_jit(fn, name: str, *, exec_memory: bool = False):
    """Wrap a callable so every call that built kernels records a
    compile event (name, argument shapes, wall time; ``count=False``).
    ``exec_memory=True`` also records, on a card, the call window's
    peak-memory delta (:func:`_window_peak`) as an ``exec_mem.<name>``
    counter. With no recorder active the wrapper is one global read and
    a passthrough call."""

    def wrapped(*args, **kwargs):
        rec = active()
        if rec is None:
            return fn(*args, **kwargs)
        n0 = jit_cache_size()
        mem0 = None
        if exec_memory:
            torch = sys.modules.get("torch")
            if torch is not None and torch.cuda.is_initialized():
                i = torch.cuda.current_device()
                mem0 = (i, torch.cuda.memory_allocated(i),
                        torch.cuda.max_memory_allocated(i))
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        if jit_cache_size() > n0:
            rec.compile_event(name, dt, count=False,
                              args={"shapes": _shape_strs(args)})
        if mem0 is not None:
            vals = _window_peak(*mem0)
            if vals is not None:
                rec.counter(f"exec_mem.{name}", vals)
        return out

    wrapped.__wrapped__ = fn
    wrapped.__name__ = getattr(fn, "__name__", name)
    return wrapped


# ---------------------------------------------------------------------------
# CLI: kind=trace run-log records -> Chrome-trace JSON
# ---------------------------------------------------------------------------

def load_trace_snapshots(paths) -> list[dict[str, Any]]:
    """Every ``kind=trace`` record across the given run-log JSONL files
    (unparseable lines skipped), each annotated with its ``_source``."""
    snaps = []
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
                if rec.get("kind") == "trace":
                    rec.setdefault("_source", str(path))
                    snaps.append(rec)
    return snaps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export kind=trace runlog records as Chrome-trace "
                    "JSON (load in Perfetto / chrome://tracing)")
    p.add_argument("logs", nargs="+",
                   help="runlog JSONL file(s) from a --trace --log run")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <first log>.trace.json)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        snaps = load_trace_snapshots(args.logs)
    except OSError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    if not snaps:
        print("ERROR: no kind=trace records in input (run apps with "
              "--trace --log to record them)", file=sys.stderr)
        return 2
    out = Path(args.out) if args.out else Path(
        args.logs[0]).with_suffix(".trace.json")
    # the cross-rank merge (harness/collect.py): one pid lane per source
    # process and file, the clocks aligned, flow arrows across ranks
    from hpc_patterns_tpu_torch.harness import collect as collectlib

    chrome = collectlib.merge(snaps)["chrome"]
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        json.dump(chrome, f)
    n_ev = len(chrome["traceEvents"])
    n_lanes = len({e["pid"] for e in chrome["traceEvents"]})
    n_comp = sum(s.get("compile", {}).get("count", 0) for s in snaps)
    dropped = sum(s.get("n_dropped", 0) for s in snaps)
    print(f"{out}: {n_ev} trace events from {len(snaps)} snapshot(s) "
          f"on {n_lanes} pid lane(s) ({n_comp} compiles, {dropped} "
          f"evicted by the ring) — open in Perfetto (ui.perfetto.dev) "
          f"or chrome://tracing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
