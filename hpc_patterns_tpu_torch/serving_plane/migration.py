"""KV-page migration between two engines: the serving plane's handoff
wire — the counterpart of ``hpc_patterns_tpu/serving_plane/migration.py``.

The bundle (cursors, KV pages) is built by :meth:`~hpc_patterns_tpu_torch.
models.serving.EngineCore.export_migration` and consumed by
:meth:`~hpc_patterns_tpu_torch.models.serving.EngineCore.
install_migration`; this module owns what happens between the two:

- :func:`migrate_pages` — the in-process copy: every payload tensor
  ``.to`` the destination endpoint's device (on one card a no-op; the
  install then copies straight from the gathered pages), or a
  passthrough (``"local"``) for a replica with no device;
- :func:`bundle_to_wire` / :func:`bundle_from_wire` — the byte codec of
  the cross-process plane: raw little-endian buffers base64-wrapped in
  JSON with their shape and dtype name, the same keys, names and bytes
  as the JAX package's, so a bundle encoded by either decodes in the
  other. numpy has no bfloat16 or float8 without ``ml_dtypes`` (which
  the card's machine lacks), so those payloads cross through integer
  views of the same width, as ``models/convert.py`` does, and decode to
  CPU tensors.
"""

from __future__ import annotations

import base64
from dataclasses import replace

import numpy as np
import torch

from hpc_patterns_tpu_torch.models.serving import MigrationBundle
from hpc_patterns_tpu_torch.topology import LogicalDevice

#: ``reqtrace.LEGACY_SEGMENTS`` of the JAX package: what an artifact
#: without a ``segments`` key decodes to (one untracked segment)
LEGACY_SEGMENTS = (("untracked", None, None),)

#: the fields a wire dict MUST carry (read with ``wire[k]``); every
#: other field is read absent-tolerantly. The last three are the
#: per-array envelope.
REQUIRED_WIRE_FIELDS = (
    "seq_id", "prompt", "out", "prefix", "budget", "pos", "limit",
    "token", "key", "temp", "priority", "t_submit", "n_pages",
    "page_size", "payload",
    "shape", "dtype", "b64",
)

#: wire dtype name -> (numpy integer view, torch dtype) for the dtypes
#: numpy cannot name itself
_VIA_INT = {"bfloat16": (np.int16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
_TORCH_NAMES = {torch.bfloat16: "bfloat16",
                torch.float8_e4m3fn: "float8_e4m3fn"}


def migrate_pages(bundle: MigrationBundle, device=None) -> MigrationBundle:
    """The payload toward the destination replica: with ``device`` (a
    :class:`LogicalDevice` or a device) every payload tensor ``.to`` its
    physical device, ``transport="device_put"``; ``device=None`` passes
    the bundle through (``"local"``)."""
    if device is None:
        return bundle
    dev = device.device if isinstance(device, LogicalDevice) \
        else torch.device(device)
    payload = {name: tuple(a.to(dev) for a in arrs)
               for name, arrs in bundle.pages_payload.items()}
    return replace(bundle, pages_payload=payload, transport="device_put")


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def _arr_to_wire(a) -> dict:
    if torch.is_tensor(a):
        t = a.detach().contiguous().cpu()
        name = _TORCH_NAMES.get(t.dtype)
        if name is not None:
            np_int, _ = _VIA_INT[name]
            arr = t.view({np.int16: torch.int16,
                          np.uint8: torch.uint8}[np_int]).numpy()
        else:
            arr = t.numpy()
            name = str(arr.dtype)
    else:
        arr = np.ascontiguousarray(a)
        name = str(arr.dtype)
    return {"shape": list(arr.shape), "dtype": name,
            "b64": base64.b64encode(arr.tobytes()).decode("ascii")}


def _np_from_wire(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]),
                         dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def _tensor_from_wire(d) -> torch.Tensor:
    via = _VIA_INT.get(d["dtype"])
    raw = base64.b64decode(d["b64"])
    if via is None:
        return torch.from_numpy(np.frombuffer(
            raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy())
    np_int, torch_dt = via
    a = np.frombuffer(raw, dtype=np_int).reshape(d["shape"]).copy()
    return torch.from_numpy(a).view(torch_dt)


def bundle_to_wire(bundle: MigrationBundle) -> dict:
    """JSON-able dict for the socket plane; device payloads are read back
    here (the wire path is the host-staged one)."""
    return {
        "seq_id": int(bundle.seq_id),
        "prompt": _arr_to_wire(np.asarray(bundle.prompt)),
        "out": [int(t) for t in bundle.out],
        "prefix": [int(t) for t in bundle.prefix],
        "budget": int(bundle.budget),
        "pos": int(bundle.pos), "limit": int(bundle.limit),
        "token": int(bundle.token),
        "key": _arr_to_wire(np.asarray(bundle.key)),
        "temp": float(bundle.temp),
        "temp_override": bundle.temp_override,
        "priority": int(bundle.priority),
        "deadline_s": bundle.deadline_s,
        "t_submit": float(bundle.t_submit),
        "t_first": bundle.t_first,
        "preemptions": int(bundle.preemptions),
        "n_pages": int(bundle.n_pages),
        "page_size": int(bundle.page_size),
        "payload": {name: [_arr_to_wire(a) for a in arrs]
                    for name, arrs in bundle.pages_payload.items()},
        "seq": int(bundle.seq),
        "rung": int(bundle.rung),
        "prefix_len": int(bundle.prefix_len),
        "transport": str(bundle.transport),
        # always written (null when the donor traced nothing), so an
        # absent key means a legacy artifact
        "segments": ([list(s) for s in bundle.segments]
                     if bundle.segments is not None else None),
    }


def bundle_from_wire(wire: dict) -> MigrationBundle:
    """Reconstruct a bundle bit-identically from its wire dict (payload
    as CPU tensors; the install moves them to the engine's device)."""
    return MigrationBundle(
        seq_id=int(wire["seq_id"]),
        prompt=_np_from_wire(wire["prompt"]),
        out=list(wire["out"]), prefix=list(wire["prefix"]),
        budget=int(wire["budget"]),
        pos=int(wire["pos"]), limit=int(wire["limit"]),
        token=int(wire["token"]),
        key=_np_from_wire(wire["key"]),
        temp=float(wire["temp"]),
        temp_override=wire.get("temp_override"),
        priority=int(wire["priority"]),
        deadline_s=wire.get("deadline_s"),
        t_submit=float(wire["t_submit"]),
        t_first=wire.get("t_first"),
        preemptions=int(wire.get("preemptions") or 0),
        n_pages=int(wire["n_pages"]),
        page_size=int(wire["page_size"]),
        pages_payload={name: tuple(_tensor_from_wire(a) for a in arrs)
                       for name, arrs in wire["payload"].items()},
        seq=int(wire.get("seq", -1)),
        rung=int(wire.get("rung", 0)),
        prefix_len=int(wire.get("prefix_len", 0)),
        # an artifact from before the field crossed a socket by definition
        transport=str(wire.get("transport", "wire")),
        segments=(tuple(tuple(s) for s in wire["segments"])
                  if wire.get("segments") is not None
                  else None if "segments" in wire else LEGACY_SEGMENTS),
    )
