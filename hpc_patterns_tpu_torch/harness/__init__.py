"""Harness pieces of the port: the verdict rules, the timing protocol,
the run log, the shared CLI, the profiler hookup, the observability
layer (the metrics registry, the flight recorder, request tracing and
the run-log report) and its control half (tail attribution, segment
budgets, the cross-rank merge, the bench gate and autofit)."""
