"""Known-clean: every chaos site claim, recorded injection kind,
default-site mapping, and spec-string kind prefix spells a name the
KINDS/SITES declarations carry. Zero findings expected."""

KINDS = ("straggler", "drop", "stall")
SITES = ("collective", "host_transfer")

_DEFAULT_SITE = {"straggler": "collective", "drop": "host_transfer"}


def soak(chaos, i):
    if chaos.maybe_inject("collective", i):
        chaos.record_injection("collective", i, "straggler")
        return True
    return False


def configure_soak(chaos):
    chaos.configure("stall:at=3,delay_ms=5;drop:at=7,frac=0.1")
