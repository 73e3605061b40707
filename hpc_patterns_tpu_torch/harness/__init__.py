"""Harness pieces of the port: the verdict rules, the timing protocol,
the run log, the shared CLI, the profiler hookup, and the observability
layer (the metrics registry, the flight recorder, request tracing and
the run-log report)."""
