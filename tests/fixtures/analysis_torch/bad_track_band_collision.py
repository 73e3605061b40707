"""Known-bad: Perfetto device-subtrack allocation drift. Two
TRACK_BANDS entries overlap (spinup starts inside migration's
width), a module hand-picks a track base integer instead of going
through the registry, a ``track_band()`` reference names a band the
registry never declared, and a literal ``track=`` argument lands
outside every declared band."""

TRACK_BANDS: dict[str, tuple[int, int]] = {
    "decode": (0, 1),
    "migration": (64, 8),  # EXPECT: track-band-collision
    "spinup": (70, 8),  # EXPECT: track-band-collision
}


def track_band(name):
    return TRACK_BANDS[name]


# the pre-registry idiom: a hand-picked base that collides the day
# someone widens a neighbouring band
MIG_TRACK_BASE = 90  # EXPECT: track-band-collision

MEM_TRACK_BASE, MEM_TRACKS = track_band("residency")  # EXPECT: track-band-collision


def mark(rec, t0):
    rec.mark_dispatch("migrate", t0, track=200)  # EXPECT: track-band-collision
