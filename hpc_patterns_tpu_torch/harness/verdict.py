"""The SUCCESS/FAILURE rules the apps print — a copy of
``hpc_patterns_tpu/harness/verdict.py`` (the reference's binaries are
their own tests: they check their claim and exit 0/1).

- SYCL rule (sycl_con.cpp:279-296): theoretical max speedup =
  serial_total / max_single_command; PASS iff achieved speedup >
  theoretical / 1.3; WARN (unbalanced commands) if theoretical <= 1.5.
- OMP rule (omp_con.cpp:223-244): PASS iff concurrent_total <=
  1.3 * max_single_command; WARN if theoretical <= 1.3.
- the allreduce oracle (allreduce-mpi-sycl.cpp:192-204): every element
  equals the closed-form value, per rank (:func:`correctness_verdict`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

TOLERANCE = 1.3  # the reference's universal slack factor


@dataclasses.dataclass(frozen=True)
class Verdict:
    success: bool
    messages: tuple[str, ...]
    speedup: float | None = None
    max_theoretical_speedup: float | None = None
    warned_unbalanced: bool = False

    @property
    def exit_code(self) -> int:
        return 0 if self.success else 1

    def summary_line(self) -> str:
        return "SUCCESS" if self.success else "FAILURE"


def concurrency_verdict(
    serial_command_times_s: Sequence[float],
    concurrent_total_s: float,
    *,
    tolerance: float = TOLERANCE,
    rule: str = "sycl",
    resources: Sequence[str] | None = None,
) -> Verdict:
    """Overlap acceptance for the concurrency suite.

    ``rule="sycl"``: speedup-based (sycl_con.cpp:279-296).
    ``rule="omp"``: absolute-time-based (omp_con.cpp:238-244).

    ``resources`` (optional, aligned with the serial times): the hardware
    resource each command occupies. Commands sharing a resource cannot
    overlap (two FMA chains on the same SMs, two copies sharing memory
    bandwidth), so the concurrent floor is the largest per-resource sum
    of command times rather than the reference's max single command.
    With one command per resource the two are identical.
    """
    serial_times = [float(t) for t in serial_command_times_s]
    if not serial_times or concurrent_total_s <= 0 or min(serial_times) <= 0:
        raise ValueError(
            "need positive serial per-command times and a positive "
            "concurrent total")
    if resources is not None and len(resources) != len(serial_times):
        raise ValueError("resources must align with serial_command_times_s")
    serial_total = sum(serial_times)
    if resources is None:
        floor = max(serial_times)
    else:
        by_resource: dict[str, float] = {}
        for r, t in zip(resources, serial_times):
            by_resource[r] = by_resource.get(r, 0.0) + t
        floor = max(by_resource.values())
    max_theoretical = serial_total / floor
    speedup = serial_total / concurrent_total_s
    msgs = [
        f"serial_total={serial_total:.6f}s max_single={floor:.6f}s",
        f"speedup={speedup:.3f} max_theoretical={max_theoretical:.3f}",
    ]
    warn_threshold = 1.5 if rule == "sycl" else tolerance
    warned = max_theoretical <= warn_threshold
    if warned:
        msgs.append(
            "WARNING: commands are unbalanced; overlap barely measurable "
            f"(max theoretical speedup {max_theoretical:.3f} <= "
            f"{warn_threshold})")
    if rule == "sycl":
        ok = speedup > max_theoretical / tolerance
    elif rule == "omp":
        ok = concurrent_total_s <= tolerance * floor
    else:
        raise ValueError(f"unknown rule {rule!r}")
    msgs.append("SUCCESS" if ok else "FAILURE")
    return Verdict(success=ok, messages=tuple(msgs), speedup=speedup,
                   max_theoretical_speedup=max_theoretical,
                   warned_unbalanced=warned)


def correctness_verdict(result, expected_scalar: float, *, dtype=None,
                        rank: int = 0) -> Verdict:
    """Analytic-oracle elementwise validation (allreduce-mpi-sycl.cpp:
    192-204). ``result``: a numpy array or a CPU tensor; ``dtype``: a
    registry name or torch dtype (default: the result's own)."""
    import numpy as np
    import torch

    from hpc_patterns_tpu_torch.dtypes import get_traits, validate_allreduce

    if torch.is_tensor(result):
        dt = dtype if dtype is not None else result.dtype
        arr = (result.float() if result.dtype == torch.bfloat16
               else result).numpy()
    else:
        arr = np.asarray(result)
        dt = dtype if dtype is not None else torch.from_numpy(arr[:0]).dtype
    ok = validate_allreduce(arr, expected_scalar, dt)
    if ok:
        msgs = (f"Passed {rank}", "SUCCESS")
    else:
        traits = get_traits(dt)
        atol = traits.tolerance if not traits.exact_sum else 0.0
        bad = np.flatnonzero(~np.isclose(arr.astype(np.float64),
                                         float(expected_scalar), atol=atol,
                                         rtol=1e-6))
        first = int(bad[0]) if bad.size else -1
        msgs = (f"rank {rank}: {bad.size}/{arr.size} elements wrong, "
                f"first at [{first}] = "
                f"{arr.flat[first] if first >= 0 else '?'} "
                f"expected {expected_scalar}", "FAILURE")
    return Verdict(success=ok, messages=msgs)
