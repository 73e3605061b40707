"""Profiler hookup behind ``--enable_profiling`` — the counterpart of
``hpc_patterns_tpu/harness/profiling.py`` over ``torch.profiler``.

The reference sets the SYCL queue profiling property and never reads it
(sycl_con.cpp:47-52, run.sh:10-12: the flag checks that overlap
survives profiling overhead). Here the traced region also leaves an
artifact: a Chrome trace (``trace.json``) in the trace directory.
"""

from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path

import torch


@contextlib.contextmanager
def maybe_trace(enabled: bool, logdir: str | None = None):
    """Trace the enclosed region with ``torch.profiler`` (CPU, plus CUDA
    where a card is present) when ``enabled``; yields the trace directory,
    or None when disabled. Inside the region metric spans mirror into
    ``torch.profiler.record_function`` whether or not the registry
    records, so the profiler's timeline and the run log name the same
    phases; with a flight recorder the region is a ``profiler.trace``
    window on its device track."""
    if not enabled:
        yield None
        return
    from hpc_patterns_tpu_torch.harness import metrics, trace

    logdir = logdir or tempfile.mkdtemp(prefix="hpcpat_trace_")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    m = metrics.get_metrics()
    prev = m.mirror_traces
    m.mirror_traces = True
    rec = trace.active()
    t0 = rec.mark_dispatch("profiler.trace",
                           {"logdir": logdir}) if rec else 0.0
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield logdir
        Path(logdir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
    finally:
        # restored on the captured registry even when the region raises
        m.mirror_traces = prev
        if rec:
            rec.mark_complete("profiler.trace", t0, {"logdir": logdir})


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_profile(fn, *, top: int = 5) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` (CPU + CUDA) and
    synchronize: its host wall, the device's busy time and share (the
    union of kernel intervals over that wall), the kernel count, and the
    ``top`` kernels by device time. Needs a card."""
    import time

    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    busy = union_us((e.time_range.start, e.time_range.end)
                     for e in kernels) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_frac": busy / wall if wall > 0 else None,
            "device_kernels": len(kernels),
            "top_kernels": [{"name": n[:120], "s": us / 1e6, "count": c}
                            for n, (us, c) in ranked]}
