"""Process-wide metrics registry + span tracing — the counterpart of
``hpc_patterns_tpu/harness/metrics.py``, copied with its schema intact.

- **counters** (monotonic totals), **gauges** (last value with min/max
  tracking), and **histograms** with FIXED log-spaced buckets, so any
  percentile computed from a snapshot equals the one computed live —
  the snapshot IS the histogram (quantized to bucket resolution) and
  percentiles survive JSON round trips through the run log.
- **spans**: ``with span("measure.timed"): ...`` measures a wall-time
  phase, nests (a thread-local stack builds ``outer/inner`` paths),
  records into a ``span.<path>`` histogram, and — when profiling is on
  — mirrors into ``torch.profiler.record_function`` so a profiler trace
  and the JSONL snapshot attribute time to the same named phases.

The bucket layout, the instruments, the snapshot schema and
:func:`_finite_or_none` are the JAX module's, so a snapshot written by
either package loads in the other (``harness/report.py`` of both).

Disabled by default with a no-op fast path: ``get_metrics()`` returns a
disabled registry whose instruments are a shared no-op singleton and
whose ``span()`` is a reusable ``nullcontext`` — callers instrument
unconditionally and untraced timings are untouched. Apps enable it per
run via ``--metrics`` (``apps/common.run_instrumented`` installs a fresh
registry and appends one ``kind=metrics`` snapshot record to the run
log); ``python -m hpc_patterns_tpu_torch.harness.report`` aggregates
those records into a per-phase summary table.

Torch-free at module level: the only torch touch is the lazy
``record_function`` import inside an enabled, mirroring span.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Iterator

# Fixed bucket layout shared by every histogram (and by report.py's
# reconstruction): 4 log-spaced buckets per decade over 1e-9..1e3 —
# ns-scale kernel times through ks-scale sweeps at ~±33% resolution.
# Changing this invalidates checked-in snapshots; bump with care (the
# layout is embedded in every snapshot for forward compatibility).
LO_DECADE = -9
HI_DECADE = 3
PER_DECADE = 4
N_BUCKETS = (HI_DECADE - LO_DECADE) * PER_DECADE

BUCKET_LAYOUT = {
    "lo_decade": LO_DECADE,
    "hi_decade": HI_DECADE,
    "per_decade": PER_DECADE,
}


def bucket_index(value: float) -> int:
    """Bucket holding ``value``; out-of-range values clamp to the end
    buckets (their true extrema are preserved by min/max tracking)."""
    if value <= 0:
        return 0
    i = math.floor((math.log10(value) - LO_DECADE) * PER_DECADE)
    return min(max(i, 0), N_BUCKETS - 1)


def bucket_value(index: int) -> float:
    """Representative (geometric-midpoint) value of a bucket."""
    return 10.0 ** (LO_DECADE + (index + 0.5) / PER_DECADE)


class Histogram:
    """Sparse fixed-bucket histogram: counts per bucket plus exact
    count/sum/min/max. Everything needed to reproduce its percentiles
    is in :meth:`snapshot`, by construction."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            # NaN has no bucket (floor(nan) raises) and inf would poison
            # sum; telemetry drops the sample rather than crash the run
            return
        i = bucket_index(value)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def percentile(self, q: float) -> float:
        """Rank-based percentile at bucket resolution, clamped to the
        observed [min, max] so p0/p100 are exact. The last order
        statistic IS the tracked max — returning the bucket midpoint
        there undershot it whenever the max sat in the upper half of
        its log bucket (a real flake: a load-spiked rep set whose
        samples all share one bucket)."""
        if not self.count:
            return math.nan
        rank = max(1, math.ceil(q / 100.0 * self.count))
        if rank >= self.count:
            return self.max
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                return min(max(bucket_value(i), self.min), self.max)
        return self.max

    def merge(self, other: "Histogram") -> None:
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def snapshot(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            # JSON objects key by string; report.py converts back
            "counts": {str(i): c for i, c in sorted(self.counts.items())},
        }

    @classmethod
    def from_snapshot(cls, snap: dict[str, Any]) -> "Histogram":
        h = cls()
        h.counts = {int(i): int(c) for i, c in snap["counts"].items()}
        h.count = int(snap["count"])
        h.sum = float(snap["sum"])
        h.min = math.inf if snap["min"] is None else float(snap["min"])
        h.max = -math.inf if snap["max"] is None else float(snap["max"])
        return h


def _finite_or_none(value: float) -> float | None:
    return value if math.isfinite(value) else None


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-value instrument that also tracks its min/max/n so a final
    snapshot still shows the excursion, not just the last sample."""

    __slots__ = ("last", "min", "max", "n")

    def __init__(self):
        self.last = math.nan
        self.min = math.inf
        self.max = -math.inf
        self.n = 0

    def set(self, value: float) -> None:
        value = float(value)
        self.last = value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.n += 1

    def snapshot(self) -> dict[str, Any]:
        # non-finite values (a diverged loss is NaN) become null: bare
        # NaN/Infinity tokens are invalid strict JSON and would make the
        # runlog line unparseable outside Python
        return {"last": _finite_or_none(self.last),
                "min": _finite_or_none(self.min),
                "max": _finite_or_none(self.max),
                "n": self.n}


class _Noop:
    """Shared do-nothing instrument: the disabled registry hands this
    out so instrumented code never branches on enablement itself."""

    __slots__ = ()

    def inc(self, n: int | float = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


_NOOP = _Noop()
_NULL_SPAN = contextlib.nullcontext()

# Flight-recorder hookup (harness/trace.py installs itself here via
# trace.configure): when a sink is present, every span begin/end also
# lands as a timestamped event in the ring buffer — the histograms say
# HOW LONG a phase takes, the recorder says WHEN each instance ran.
# None (the default) keeps span() on the no-op fast path: the check is
# one module-global read, no import of trace.py, still torch-free.
_trace_sink = None


class Metrics:
    """One registry per process (installed by :func:`configure`).

    ``enabled=False`` is the no-op fast path: instruments are the
    shared no-op singleton, ``span()`` is a reusable nullcontext, and
    ``snapshot()`` is empty — zero records, zero timing overhead.
    ``mirror_traces`` makes spans annotate the active ``torch.profiler``
    trace even when recording is off (profiling without --metrics).
    """

    def __init__(self, *, enabled: bool = True,
                 mirror_traces: bool = False):
        self.enabled = enabled
        self.mirror_traces = mirror_traces
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- instruments -------------------------------------------------------

    def _get(self, table: dict, name: str, factory):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, factory())
        return inst

    def counter(self, name: str) -> Counter | _Noop:
        if not self.enabled:
            return _NOOP
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge | _Noop:
        if not self.enabled:
            return _NOOP
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram | _Noop:
        if not self.enabled:
            return _NOOP
        return self._get(self._histograms, name, Histogram)

    # -- spans -------------------------------------------------------------

    def span(self, name: str, **attrs: Any):
        """Context manager timing a named phase. Nested spans build a
        ``/``-joined path per thread; the elapsed wall time lands in
        the ``span.<path>`` histogram. With ``mirror_traces``, the
        span body also runs under a ``torch.profiler.record_function``
        of the same name, so a profiler trace shows the identical phase
        tree.
        With a flight recorder installed (``--trace``), begin/end also
        land as ring-buffer events carrying the same path."""
        if not (self.enabled or self.mirror_traces
                or _trace_sink is not None):
            return _NULL_SPAN
        return self._span(name, attrs)

    @contextlib.contextmanager
    def _span(self, name: str, attrs: dict[str, Any]) -> Iterator[None]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(name)
        path = "/".join(stack)
        annotation = _NULL_SPAN
        if self.mirror_traces:
            try:
                from torch.profiler import record_function

                # record_function takes one string argument: the attrs
                # ride along in it (the JAX mirror passes them as kwargs)
                annotation = record_function(
                    path, ",".join(f"{k}={v}" for k, v in attrs.items())
                    or None)
            except Exception:  # noqa: BLE001 — tracing is best-effort
                pass
        sink = _trace_sink
        t0 = time.perf_counter()
        if sink is not None:
            sink.span_begin(path, attrs, t0)
        try:
            with annotation:
                yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            if sink is not None:
                sink.span_end(path, t1)
            if self.enabled:
                self._get(self._histograms, f"span.{path}",
                          Histogram).observe(t1 - t0)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """JSON-able registry state — the payload of the
        ``kind=metrics`` RunLog record. Empty sections are included so
        consumers never branch on key presence."""
        return {
            "counters": {k: v.value for k, v in
                         sorted(self._counters.items())},
            "gauges": {k: v.snapshot() for k, v in
                       sorted(self._gauges.items())},
            "histograms": {k: v.snapshot() for k, v in
                           sorted(self._histograms.items())},
            "bucket_layout": dict(BUCKET_LAYOUT),
        }


# the process-wide registry; disabled until an app (or test) configures
_registry = Metrics(enabled=False)


def get_metrics() -> Metrics:
    return _registry


def configure(*, enabled: bool = False,
              mirror_traces: bool = False) -> Metrics:
    """Install a FRESH process-wide registry (apps call this once per
    run, so repeated in-process main() invocations — the test suite's
    CTest analog — never leak metrics across runs)."""
    global _registry
    _registry = Metrics(enabled=enabled, mirror_traces=mirror_traces)
    return _registry


def span(name: str, **attrs: Any):
    """Module-level convenience: a span on the current registry."""
    return _registry.span(name, **attrs)
