"""Device resolution — the counterpart of device discovery in
``hpc_patterns_tpu/topology.py``.

The port runs on the card. A caller that wants the CPU (the tests, the
plain reference paths) says so explicitly; without a GPU and without
that request every entry point raises instead of silently running on
the host, so no CPU number can pass for a device one.
"""

from __future__ import annotations

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
