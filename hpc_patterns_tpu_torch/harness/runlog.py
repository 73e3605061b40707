"""Structured run log — a copy of ``hpc_patterns_tpu/harness/runlog.py``.

The reference's only artifact is a tee'd text log grepped for
SUCCESS/FAILURE (concurency/run.sh:15-18). This keeps that grep-able
stdout contract and additionally writes one JSON object per record, so
sweeps are machine-readable.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import IO, Any

#: Record kinds written for the FORENSIC stream — the raw per-event log a
#: human (or replay tooling) greps after a bad run — and deliberately not
#: string-dispatched by report/collect/autofit/explain (JAX's list, plus
#: the engine's shed/finish events and serve_app's static comparison,
#: which the port's harness reads as a stream, never by kind).
#: contractlint's ``record-kind-drift`` treats membership here as
#: consumption-by-declaration: a kind belongs on this list only if
#: nothing *should* dispatch on it.
FORENSIC_KINDS = (
    # serving-engine lifecycle events (models/serving.py): the per-seq
    # audit trail behind the aggregated windows autofit dispatches on
    "serve_migrate_out",
    "serve_migrate_in",
    "serve_swap_in",
    "serve_shed",
    "serve_finish",
    # serving-plane round events (serving_plane/): the elastic plane's
    # decision journal
    "plane_migrate",
    "plane_route",
    "plane_shed",
    "plane_resume",
    "plane_transport_fallback",
    "plane_replica_death",
    "plane_spinup",
    "plane_drain",
    "plane_retire",
    # per-step training journal (apps/train_app.py)
    "step",
    # the versioned --rollup-out artifact envelope (harness/collect.py):
    # consumers take the whole document
    "trace_rollup",
    # kernel autotune outcomes: cache-warm evidence
    "autotune",
    # serve_app --static-compare's one line beside the engine's
    "static_compare",
)


class RunLog:
    def __init__(self, path: str | Path | None = None,
                 stream: IO[str] | None = None, *, truncate: bool = True):
        self.path = Path(path) if path else None
        self.stream = stream if stream is not None else sys.stdout
        self.records: list[dict[str, Any]] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if truncate:
                # one log per run, like run.sh's tee; apps invoked by a
                # harness pass truncate=False (--log-append) to share it
                self.path.write_text("")

    def emit(self, **record: Any) -> dict[str, Any]:
        record.setdefault("ts", time.time())
        self.records.append(record)
        line = json.dumps(record, default=str)
        if self.path:
            with self.path.open("a") as f:
                f.write(line + "\n")
        return record

    def print(self, text: str) -> None:
        """Human/grep-able line to stdout (run.sh:17-18 contract)."""
        print(text, file=self.stream)

    def result(self, name: str, verdict, **extra: Any) -> None:
        self.emit(kind="result", name=name, success=verdict.success,
                  speedup=verdict.speedup,
                  max_theoretical_speedup=verdict.max_theoretical_speedup,
                  **extra)
        for m in verdict.messages:
            self.print(f"[{name}] {m}")

    def summary(self) -> tuple[int, int]:
        """(n_success, n_failure) over result records; prints the grep
        summary exactly once, like run.sh:17-18."""
        results = [r for r in self.records if r.get("kind") == "result"]
        ok = sum(1 for r in results if r.get("success"))
        bad = len(results) - ok
        self.print(f"SUCCESS count: {ok}")
        self.print(f"FAILURE count: {bad}")
        return ok, bad
