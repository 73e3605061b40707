"""Known-clean: every gate key, metric name, and span name consumed
here has a live producer in the same tree. Zero findings expected."""


class MetricSpec:
    def __init__(self, path, direction, gated=True, abs_slack=0.0):
        self.path, self.direction = path, direction
        self.gated, self.abs_slack = gated, abs_slack


SPECS = (
    MetricSpec("value", "higher"),
    MetricSpec("detail.engine_tok_s", "higher"),
    MetricSpec("detail.engine_bubble_frac", "lower", abs_slack=0.05),
)


def bench_detail(engine_result):
    """The bench child's detail dict — emits every gated key."""
    return {
        "value": engine_result["speedup"],
        "engine_tok_s": round(engine_result["tok_s"], 1),
        "engine_bubble_frac": round(engine_result["bubble_frac"], 4),
    }


def fit_engine(gauges, records):
    """An autofit-style consumer reading metric names by string."""
    tok_s = gauges.get("engine.tok_s")
    chunks = _windows(records, "engine.chunk")
    return tok_s, chunks


def _windows(records, name):
    return [r for r in records if r[0] == name]


def emit(metrics, rec, engine_result, t0, t1):
    metrics.gauge("engine.tok_s", engine_result["tok_s"])
    rec.mark_dispatch("engine.chunk", t0)
    rec.mark_complete("engine.chunk", t1)
