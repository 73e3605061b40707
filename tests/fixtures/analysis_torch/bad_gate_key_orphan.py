"""Known-bad: orphaned gate keys and string-consumed metric names —
the minimized replica of "a gated key whose emitter was deleted". The
gate table still lists ``detail.engine_bubble_frac``, but the bench
detail dict below stopped emitting it (the gate's runtime coverage-loss
warning fired one bench run too late; contractlint flags the
surviving consumer row at review time). Same shape for a metric name
read by string with no gauge producer, and a device-window span name
nothing dispatches."""


class MetricSpec:
    def __init__(self, path, direction, gated=True, abs_slack=0.0):
        self.path, self.direction = path, direction
        self.gated, self.abs_slack = gated, abs_slack


SPECS = (
    MetricSpec("value", "higher"),
    MetricSpec("detail.engine_tok_s", "higher"),
    # the emitter below used to write this key; it was deleted in a
    # "cleanup" and the gate row survived
    MetricSpec("detail.engine_bubble_frac", "lower"),  # EXPECT: gate-key-orphan
)


def bench_detail(engine_result):
    """The bench child's detail dict — engine_bubble_frac is gone."""
    return {
        "value": engine_result["speedup"],
        "engine_tok_s": round(engine_result["tok_s"], 1),
    }


def fit_engine(gauges, records):
    """An autofit-style consumer reading metric names by string."""
    # the gauge was renamed to engine.tok_s; this read kept the old name
    tok_s = gauges.get("engine.tokens_per_s")  # EXPECT: gate-key-orphan
    chunks = _windows(records, "engine.chunk")  # EXPECT: gate-key-orphan
    return tok_s, chunks


def _windows(records, name):
    return [r for r in records if r[0] == name]


def emit(metrics, engine_result):
    metrics.gauge("engine.tok_s", engine_result["tok_s"])
