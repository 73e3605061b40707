"""Known-clean: wire codec where both directions agree. Mandatory
fields are declared in REQUIRED_WIRE_FIELDS and may be indexed
directly; every other read is absent-tolerant (``.get`` or an
``in``-guard); every written field is read and vice versa. Zero
findings expected."""

REQUIRED_WIRE_FIELDS = ("seq_id", "pos")


def bundle_to_wire(seq):
    return {
        "seq_id": seq.seq_id,
        "pos": seq.pos,
        "deadline_s": seq.deadline_s,
        "segments": [list(s) for s in seq.segments],
    }


def bundle_from_wire(wire):
    seq_id = wire["seq_id"]
    pos = wire["pos"]
    deadline_s = wire.get("deadline_s", 0.0)
    segments = wire["segments"] if "segments" in wire else []
    return seq_id, pos, deadline_s, segments
