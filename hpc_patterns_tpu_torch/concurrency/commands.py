"""Device commands: the units of work whose overlap is measured — the
counterpart of ``hpc_patterns_tpu/concurrency/commands.py``.

The reference's three command kinds (sycl_con.cpp:84-99):

- ``C``   — compute kernel (``Q.parallel_for`` of ``busy_wait``)
- ``M2D`` — host -> device copy (``Q.copy(host, dev)``)
- ``D2M`` — device -> host copy (``Q.copy(dev, host)``)

A command owns its buffers (like each reference command owning its USM
allocation, sycl_con.cpp:64-73) and, on a card, its own CUDA stream: the
counterpart of one queue of the out-of-order pool, so independent
commands share no dependencies and the card is free to overlap them
(copy engines beside the SMs). :meth:`Command.submit` enqueues the work
on the command's stream and records an event; it never synchronizes.
:meth:`Command.block` waits on that event (``Q.wait()``). ``submit`` and
every ``_enqueue`` carry ``@dispatch_critical``: torchlint's
``host-sync-in-dispatch`` audits them, and ``analysis.runtime
.strict_dispatch`` runs them under the sync debug mode's "error" on the
card.

The copies go between pinned host memory and the card: a pageable host
buffer would turn ``copy_(non_blocking=True)`` into a synchronous copy
and end the experiment. Whether the host side is pinned is the memoized
answer of ``memory/kinds.memory_kind_transfers_work`` (one probe home, as
in JAX; the old private names stay as aliases). With ``device="cpu"`` the
same classes run plain copies and the plain ``busy_wait``, with no
streams.
"""

from __future__ import annotations

import torch

from hpc_patterns_tpu_torch.analysis import dispatch_critical
from hpc_patterns_tpu_torch.concurrency import kernels
from hpc_patterns_tpu_torch.memory.kinds import (  # noqa: F401
    kind_sharding as _kind_sharding,
    memory_kind_transfers_work as _memory_kind_transfers_work,
    move_to_kind as _move_to_kind,
)
from hpc_patterns_tpu_torch.topology import resolve_device


class Command:
    """Base: one unit of asynchronously-submittable device work."""

    name = "?"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self._event = None

    def _enqueue(self) -> None:
        raise NotImplementedError

    @dispatch_critical
    def submit(self) -> None:
        if not self.on_card:
            self._enqueue()
            return
        with torch.cuda.stream(self.stream):
            self._enqueue()
            self._event = torch.cuda.Event()
            self._event.record(self.stream)

    def block(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def run_blocking(self) -> None:
        self.submit()
        self.block()

    def _ready(self) -> None:
        # buffers were made on the default stream; the command's own
        # stream must not run ahead of them
        if self.on_card:
            torch.cuda.synchronize(self.device)

    @property
    def nbytes(self) -> int:
        return 0


class ComputeCommand(Command):
    """``C``: the busy-wait FMA chain on a device buffer
    (sycl_con.cpp:92-95). ``tripcount`` is mutable so the autotuner can
    re-balance a built command."""

    name = "C"

    def __init__(self, n_elements: int = 8 * 128, tripcount: int = 1000,
                 device=None):
        super().__init__(device)
        self.x = kernels.compute_buffer(n_elements, self.device)
        self.tripcount = int(tripcount)
        self._pending = None
        self._ready()

    @dispatch_critical
    def _enqueue(self) -> None:
        self._pending = kernels.busy_wait(self.x, self.tripcount)

    @property
    def nbytes(self) -> int:
        return self.x.numel() * 4


class CopyM2DCommand(Command):
    """``M2D``: pinned host memory -> device memory (sycl_con.cpp:96-99
    with a host source)."""

    name = "M2D"

    def __init__(self, n_elements: int, device=None,
                 dtype=torch.float32):
        super().__init__(device)
        self.n_elements = int(n_elements)
        self._host = torch.zeros(self.n_elements, dtype=dtype,
                                 pin_memory=_memory_kind_transfers_work(
                                     self.device))
        self._dev = torch.empty(self.n_elements, dtype=dtype,
                                device=self.device)
        self._ready()

    @dispatch_critical
    def _enqueue(self) -> None:
        self._dev.copy_(self._host, non_blocking=True)

    @property
    def nbytes(self) -> int:
        return self._host.numel() * self._host.element_size()


class CopyD2MCommand(Command):
    """``D2M``: device memory -> pinned host memory (sycl_con.cpp:96-99
    with a host destination)."""

    name = "D2M"

    def __init__(self, n_elements: int, device=None,
                 dtype=torch.float32):
        super().__init__(device)
        self.n_elements = int(n_elements)
        self._dev = torch.zeros(self.n_elements, dtype=dtype,
                                device=self.device)
        self._host = torch.empty(self.n_elements, dtype=dtype,
                                 pin_memory=_memory_kind_transfers_work(
                                     self.device))
        self._ready()

    @dispatch_critical
    def _enqueue(self) -> None:
        self._host.copy_(self._dev, non_blocking=True)

    @property
    def nbytes(self) -> int:
        return self._host.numel() * self._host.element_size()


_KINDS = {
    "C": ComputeCommand,
    "M2D": CopyM2DCommand,
    "D2M": CopyD2MCommand,
}


def make_command(kind: str, *, device=None, copy_elements: int = 1 << 20,
                 compute_elements: int = 8 * 128,
                 tripcount: int = 1000) -> Command:
    """Build a command from its reference CLI name (the positional command
    list of sycl_con.cpp:184-232)."""
    kind = kind.upper()
    if kind == "C":
        return ComputeCommand(compute_elements, tripcount, device)
    if kind in ("M2D", "D2M"):
        return _KINDS[kind](copy_elements, device)
    raise ValueError(
        f"unknown command {kind!r}; expected one of {sorted(_KINDS)}")
