"""Memory-kind probes and placements — the counterpart of
``hpc_patterns_tpu/memory/kinds.py``, rewritten for torch (the JAX module
is built on ``jax.sharding``).

Two kinds, as on the TPU:

- ``"device"``: the card's memory (on the CPU, the host's: the tiers
  collapse onto one memory);
- ``"pinned_host"``: page-locked host memory (``pin_memory=True``), the
  only host memory a ``copy_(non_blocking=True)`` moves asynchronously.
  It needs CUDA's page-locked allocator, which the CPU-only build of
  torch lacks. ``"unpinned_host"`` is plain pageable host memory.

The three questions, each a probe:

- :func:`supports_memory_kind` — is the kind ADVERTISED for the device
  (cheap; placement may still fail)?
- :func:`memory_kind_placement_works` — does a placement into the kind
  succeed (what ``models/train.offload_opt_state`` needs)?
- :func:`memory_kind_transfers_work` — does a pinned-host -> device round
  trip execute (what the concurrency copy commands and the residency
  manager's host tier need)?

Each probe runs once per (device type, kind) and is memoized; it runs the
SAME cached transfer callable (:func:`move_to_kind`) the real transfers
use, so it proves the path that ships. On this repo's CPU test host the
answers are JAX's there for the advertise and transfer questions (kinds
advertised, round trip refused), and the placement probe says no for
``pinned_host`` where JAX's says yes: JAX places into a host memory that
is not page-locked, torch has none to place into. Consumers then take
JAX's degraded mode (the residency manager's host tier becomes a plain
CPU clone, ``offload_opt_state`` leaves the state in place).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: the kinds this module knows; "device" and "pinned_host" are the two
#: tiers, "unpinned_host" the pageable host memory JAX also advertises
KINDS = ("device", "pinned_host", "unpinned_host")


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _card(device) -> torch.device:
    """The device a placement is relative to: ``device`` resolved (a bare
    ``cuda`` pinned to the current index so cache keys are stable)."""
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class KindPlacement:
    """Where a tensor lives: a memory ``kind`` relative to a ``device``
    (the card, or the CPU) — what :func:`move_to_kind` and the training
    path take where JAX takes a ``SingleDeviceSharding(device,
    memory_kind=kind)``."""

    device: torch.device
    kind: str

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"memory kind {self.kind!r} not in {KINDS}")

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """A copy of ``x`` in this placement, dispatched on the current
        stream without a host sync (a device-to-pinned copy completes
        asynchronously; its reader must wait on the stream). On the CPU
        every kind is a plain clone."""
        if self.device.type != "cuda":
            if self.kind == "pinned_host":
                raise RuntimeError(
                    "pinned_host memory needs a CUDA device: the CPU has "
                    "no page-locked allocator")
            return x.detach().to("cpu").clone()
        if self.kind == "device":
            return x.detach().to(self.device, non_blocking=True)
        out = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                          pin_memory=self.kind == "pinned_host")
        out.copy_(x.detach(), non_blocking=self.kind == "pinned_host")
        return out


def kind_sharding(device, kind: str) -> KindPlacement:
    """The placement of ``kind`` on ``device`` — the allocator axis as a
    placement (SURVEY.md §2, ``-H/-D``)."""
    return KindPlacement(_card(device), kind)


def _leaf_card(x: torch.Tensor) -> torch.device:
    if x.device.type == "cuda":
        return x.device
    return _card(None) if x.is_pinned() else x.device


def memory_kind_shardings(tree, kind: str):
    """The placements of ``tree``'s tensor leaves retargeted to ``kind``
    (each leaf keeps its card; a pinned host leaf's card is the current
    one) — the L2 allocator axis applied to a whole state tree."""
    return tree_map(lambda x: KindPlacement(_leaf_card(x), kind), tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, tuples and lists of
    one structure; other leaves (an optimizer's step count) pass through
    ``fn`` too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_tensors(tree) -> list:
    """The tensor leaves of ``tree`` (dicts in key order)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_tensors(t)]
    return [tree] if torch.is_tensor(tree) else []


_MOVE_CACHE: dict[tuple, object] = {}


def move_to_kind(device, kind: str):
    """The cached transfer callable targeting ``kind`` on ``device``:
    every copy of one direction shares one callable, and the probes run
    it too."""
    placement = kind_sharding(device, kind)
    key = (placement.device, kind)
    if key not in _MOVE_CACHE:
        _MOVE_CACHE[key] = placement.place
    return _MOVE_CACHE[key]


def supports_memory_kind(kind: str, device=None) -> bool:
    """Whether ``kind`` is advertised for ``device`` (default: the card if
    there is one, else the CPU). Advertise-level only — placement can
    still fail; see :func:`memory_kind_placement_works`."""
    try:
        dev = _card(device)
    except Exception:  # noqa: BLE001 — a device that cannot resolve
        return False
    return kind in KINDS and dev.type in ("cuda", "cpu")


_PLACEMENT_PROBE: dict[tuple[str, str], bool] = {}


def memory_kind_placement_works(device=None,
                                kind: str = "pinned_host") -> bool:
    """Whether a placement INTO ``kind`` succeeds on ``device`` — the gate
    for one-way offloads (``offload_opt_state``). Memoized per (device
    type, kind)."""
    dev = _card(device)
    key = (dev.type, kind)
    if key not in _PLACEMENT_PROBE:
        try:
            if not supports_memory_kind(kind, dev):
                raise ValueError(f"no {kind} memory")
            tiny = move_to_kind(dev, kind)(torch.zeros(8))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if kind == "pinned_host" and not tiny.is_pinned():
                raise RuntimeError("placement is not page-locked")
            _PLACEMENT_PROBE[key] = True
        except Exception:  # noqa: BLE001 — any refusal is the answer
            _PLACEMENT_PROBE[key] = False
    return _PLACEMENT_PROBE[key]


_TRANSFER_PROBE: dict[str, bool] = {}


def memory_kind_transfers_work(device=None) -> bool:
    """Whether pinned-host <-> device transfers EXECUTE on ``device``: one
    tiny round trip through the cached transfer callables, memoized per
    device type."""
    dev = _card(device)
    key = dev.type
    if key not in _TRANSFER_PROBE:
        try:
            if not supports_memory_kind("pinned_host", dev):
                raise ValueError("no pinned_host memory")
            src = torch.arange(8, dtype=torch.float32)
            host = move_to_kind(dev, "pinned_host")(src)
            back = move_to_kind(dev, "device")(host)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ok = host.is_pinned() and back.device.type == "cuda" \
                and bool(torch.equal(back.cpu(), src))
            _TRANSFER_PROBE[key] = ok
        except Exception:  # noqa: BLE001 — any refusal is the answer
            _TRANSFER_PROBE[key] = False
    return _TRANSFER_PROBE[key]
