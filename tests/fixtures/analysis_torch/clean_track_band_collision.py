"""Known-clean: non-overlapping TRACK_BANDS registry, every module
unpacks its base/width via ``track_band()``, and the one literal
``track=`` argument sits inside a declared band. Zero findings
expected."""

TRACK_BANDS: dict[str, tuple[int, int]] = {
    "decode": (0, 1),
    "migration": (64, 8),
    "spinup": (72, 8),
}


def track_band(name):
    return TRACK_BANDS[name]


MIG_TRACK_BASE, MIG_TRACKS = track_band("migration")


def mark(rec, slot, t0):
    rec.mark_dispatch("decode", t0, track=0)
    rec.mark_dispatch("migrate", t0, track=MIG_TRACK_BASE + slot)
