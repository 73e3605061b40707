"""Device resolution — the counterpart of device discovery in
``hpc_patterns_tpu/topology.py``.

The port runs on the card. A caller that wants the CPU (the tests, the
plain reference paths) says so explicitly; without a GPU and without
that request every entry point raises instead of silently running on
the host, so no CPU number can pass for a device one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); ``"cpu"``/``"cuda"``/
    ``"cuda:N"``/``torch.device`` -> that device, a CUDA one checked
    for availability."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


@dataclass(frozen=True)
class LogicalDevice:
    """One logical endpoint on a physical device: the serving plane's
    replica placement. JAX places replicas on distinct chips; the port
    has one card, so two replicas there are two *ranks* on the same
    ``device`` (the stand-in the ring kernels also use), and a pair of
    endpoints that differ in rank is a real source/destination pair for
    the migration exchange (``comm/migration_dma.py``). ``device`` is
    resolved like every entry point's (``cuda`` raises without a GPU)."""

    device: torch.device
    rank: int = 0

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.rank < 0:
            raise ValueError(f"rank must be >= 0, got {self.rank}")

    @property
    def type(self) -> str:
        return self.device.type

    def __str__(self) -> str:
        return f"{self.device}/rank{self.rank}"
