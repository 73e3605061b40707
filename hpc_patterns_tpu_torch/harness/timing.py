"""Timing protocol: warm-up + min-over-repetitions wall clock — the
counterpart of ``hpc_patterns_tpu/harness/timing.py``.

- min over N repetitions (sycl_con.cpp:114, default 10 at :182) is the
  noise-control estimator;
- "best theoretical serial" = sum of per-command minima
  (sycl_con.cpp:117-119);
- PyTorch returns before the card finishes, so a timed call must end in
  a completion barrier: :func:`measure_forced` reads the result back to
  the host, and :func:`amortized_seconds` differences two pass counts so
  launch and readback latency cancel;
- :func:`blocking` wraps a call so that it ends in
  ``torch.cuda.synchronize``; :func:`max_across_processes` is the
  distributed MAX of a time (allreduce-mpi-sycl.cpp:188-190) over the
  launched processes' gloo group, the identity in one process.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import metrics as metricslib


@dataclasses.dataclass(frozen=True)
class TimingResult:
    times_s: tuple[float, ...]

    @property
    def min_s(self) -> float:
        return min(self.times_s)

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    @property
    def max_s(self) -> float:
        return max(self.times_s)

    def bandwidth_gbps(self, nbytes: int) -> float:
        return bandwidth_gbps(nbytes, self.min_s)


def bandwidth_gbps(nbytes: int, seconds: float) -> float:
    if seconds <= 0:
        return float("inf")
    return nbytes / seconds / 1e9


def measure(fn: Callable[[], object], *, repetitions: int = 10,
            warmup: int = 1, label: str = "measure") -> TimingResult:
    """Time ``fn`` with the reference's protocol: ``warmup`` untimed calls
    (kernel build, allocator, library init), then ``repetitions`` timed
    calls; the caller consumes :attr:`TimingResult.min_s`. ``fn`` must
    block until its device work completes.

    With the metrics registry enabled (``--metrics``), the warmup and
    timed phases become ``<label>.warmup`` / ``<label>.timed`` spans and
    every repetition lands in the ``<label>.rep_s`` histogram. With a
    flight recorder installed (``--trace``), each timed repetition is
    also fingerprinted into the schedule chain and lands as a ``<label>``
    device window carrying its ``seq`` (CUDA events around the
    repetition on a card). Disabled (the default), this is the same code
    path as always: no spans, no records, no extra work.

    Chaos (``harness/chaos.py``): each timed repetition probes the
    ``collective`` site at its ``seq`` before it starts — the timed rep
    IS the collective loop of the launched benchmarks, so a seeded
    straggler rank is late in exactly the windows the cross-rank merge
    measures — and claims the site while it runs, so an eager
    collective inside it does not inject the same fault twice. One
    cached-config read a rep with no chaos."""
    if repetitions < 1:
        raise ValueError("repetitions must be >= 1")
    chaos_on = chaoslib.active() is not None
    m = metricslib.get_metrics()
    if not (m.enabled or m.mirror_traces
            or metricslib._trace_sink is not None):
        for _ in range(warmup):
            fn()
        times = []
        for seq in range(repetitions):
            if chaos_on:
                chaoslib.maybe_inject("collective", seq)
                with chaoslib.suppress("collective"):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
            else:
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
        return TimingResult(tuple(times))
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    rec = tracelib.active()
    device = _timed_device() if rec is not None else None
    with m.span(f"{label}.warmup", repetitions=warmup):
        for _ in range(warmup):
            fn()
    hist = m.histogram(f"{label}.rep_s")
    times = []
    with m.span(f"{label}.timed", repetitions=repetitions):
        for seq in range(repetitions):
            if chaos_on:
                # before the window opens: the delayed rank's window
                # STARTS late, the shape a slow rank has in the skew fan
                chaoslib.maybe_inject("collective", seq)
            if rec is not None:
                tracelib.record_collective(label, seq)
                win = rec.open_window(device)
            t0 = time.perf_counter()
            if chaos_on:
                with chaoslib.suppress("collective"):
                    fn()
            else:
                fn()  # blocking by contract: completion, not dispatch
            dt = time.perf_counter() - t0
            if rec is not None:
                rec.mark_dispatch(label, {"seq": seq}, window=win)
                rec.wait_window(win)
                rec.mark_complete(label, win, args={"seq": seq})
            hist.observe(dt)
            times.append(dt)
    return TimingResult(tuple(times))


def _timed_device():
    """The card a traced repetition's window times: the current CUDA
    device once CUDA is initialized, else None (a host-clock window)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def blocking(fn: Callable[..., object], *args, **kwargs
             ) -> Callable[[], object]:
    """A zero-argument thunk for :func:`measure`: ``fn(*args, **kwargs)``,
    then a synchronize of the card when CUDA is in use (a no-op cost on
    the CPU path)."""
    import torch

    def thunk():
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    return thunk


def max_across_processes(seconds: float) -> float:
    """Cross-process MAX of a local elapsed time, the distributed timing
    convention of allreduce-mpi-sycl.cpp:188-190 (MPI_Allreduce(MAX)),
    over the launched processes' gloo group; the input in one process."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() \
            or not dist.is_initialized() or dist.get_world_size() < 2:
        return seconds
    from hpc_patterns_tpu_torch.comm import processes

    return max(processes.host_values(seconds))


def measure_forced(fn: Callable[[], object], *, repetitions: int = 5,
                   warmup: int = 1,
                   label: str = "measure_forced") -> TimingResult:
    """Like :func:`measure`, but forces completion by reading the tensor
    ``fn`` returns back to the host: the readback waits for every kernel
    the result depends on. ``fn`` must return a tensor whose value
    depends on all timed work."""

    def forced():
        fn().cpu()

    return measure(forced, repetitions=repetitions, warmup=warmup,
                   label=label)


def amortized_seconds(run_with_iters: Callable[[int], object], *,
                      iters: int = 64, repetitions: int = 5,
                      warmup: int = 1, base_iters: int = 1,
                      label: str = "amortized") -> float:
    """Per-iteration device time via differencing: run the workload with
    ``iters`` internal repetitions and with ``base_iters``, both
    completion-forced, and return ``(t_iters - t_base) / (iters - base)``
    clamped at 0. Launch and readback latency and any per-call constant
    cancel. ``run_with_iters(n)`` must return a tensor depending on all
    ``n`` iterations (a kernel looping ``n`` passes internally). Pick a
    large ``base_iters`` (e.g. ``iters // 2``) when host jitter rivals
    the difference, so both calls are dominated by device time."""
    if iters < 2:
        raise ValueError("iters must be >= 2")
    if not 1 <= base_iters < iters:
        raise ValueError(f"need 1 <= base_iters < iters, got {base_iters}")
    t_many = measure_forced(lambda: run_with_iters(iters),
                            repetitions=repetitions, warmup=warmup,
                            label=f"{label}.many").min_s
    t_base = measure_forced(lambda: run_with_iters(base_iters),
                            repetitions=repetitions, warmup=warmup,
                            label=f"{label}.base").min_s
    return max(t_many - t_base, 0.0) / (iters - base_iters)
