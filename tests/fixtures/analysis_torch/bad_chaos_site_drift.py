"""Known-bad: chaos site/kind names that drifted from the
declarations. A typo'd site name injects nothing (the soak silently
stops covering the collective path), a recorded injection claims a
fault kind KINDS never declared, and a spec string's kind prefix
dies at parse time in the one run least equipped to debug it."""

KINDS = ("straggler", "drop", "stall")
SITES = ("collective", "host_transfer")


def soak(chaos, i):
    # "colective": the typo'd site matches no maybe_inject caller
    if chaos.maybe_inject("colective", i):  # EXPECT: chaos-site-drift
        return True
    chaos.record_injection("collective", i, "meteor")  # EXPECT: chaos-site-drift
    return False


def configure_soak(chaos):
    chaos.configure("stal:at=3,delay_ms=5")  # EXPECT: chaos-site-drift
