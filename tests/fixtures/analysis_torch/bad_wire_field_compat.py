"""Known-bad: wire-codec field drift across the to_wire/from_wire
pair. The reader indexes ``deadline_s`` without a guard even though
the field is not in REQUIRED_WIRE_FIELDS (an old-format peer kills
the resume), the writer ships a ``scratch`` field the reader never
looks at, and the reader still probes ``resume_from`` — a field the
writer stopped emitting."""

REQUIRED_WIRE_FIELDS = ("seq_id", "pos")


def bundle_to_wire(seq):
    return {
        "seq_id": seq.seq_id,
        "pos": seq.pos,
        "deadline_s": seq.deadline_s,
        "scratch": list(seq.scratch),  # EXPECT: wire-field-compat
    }


def bundle_from_wire(wire):
    seq_id = wire["seq_id"]
    pos = wire["pos"]
    # optional field read as if mandatory: raises KeyError on wires
    # sent by a peer from before the field existed
    deadline_s = wire["deadline_s"]  # EXPECT: wire-field-compat
    resume_from = wire.get("resume_from")  # EXPECT: wire-field-compat
    return seq_id, pos, deadline_s, resume_from
