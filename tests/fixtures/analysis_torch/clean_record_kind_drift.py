"""Known-clean: every written RunLog kind is either dispatched by a
consumer or declared write-only in FORENSIC_KINDS, and every dispatch
matches a live producer. Zero findings expected."""

FORENSIC_KINDS = ("engine_debug",)


def run_round(log, stats):
    log.emit(kind="engine_round", tok_s=stats["tok_s"])
    # forensic: raw per-round journal for post-mortem grep only
    log.emit(kind="engine_debug", raw=stats)


def summarize(records):
    rounds = [r for r in records if r.get("kind") == "engine_round"]
    return len(rounds)
