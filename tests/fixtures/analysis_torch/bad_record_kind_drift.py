"""Known-bad: RunLog record-kind drift in both directions. A producer
writes ``engine_round`` records that no report/autofit path ever
dispatches on (and the kind is not declared forensic), and a consumer
dispatches on ``round_stats`` — the kind's old name — which nothing
writes anymore."""

FORENSIC_KINDS = ("engine_debug",)


def run_round(log, stats):
    # written every round, dispatched by nothing, not declared forensic
    log.emit(kind="engine_round", tok_s=stats["tok_s"])  # EXPECT: record-kind-drift
    log.emit(kind="engine_debug", raw=stats)


def summarize(records):
    # the producer renamed this kind to engine_round; the dispatch kept
    # the old name and now matches nothing
    rounds = [
        r
        for r in records
        if r.get("kind") == "round_stats"  # EXPECT: record-kind-drift
    ]
    return len(rounds)
