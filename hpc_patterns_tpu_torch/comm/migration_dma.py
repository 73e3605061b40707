"""Device-side KV migration: the serving plane's handoff through kernel
13 — the counterpart of ``hpc_patterns_tpu/comm/migration_dma.py``.

The plane's other two transports go through the host or a plain copy
(``serving_plane/migration.py``: ``migrate_pages``' ``.to(device)``, the
wire codec). This one moves a bundle's payload with a kernel: on a TPU a
Pallas SPMD program over ``[src, dst]`` remote-DMAs the pages chunk by
chunk into the destination chip; on one H100 the two replicas are two
*logical ranks* of one card (:class:`~hpc_patterns_tpu_torch.topology.
LogicalDevice`), and ``csrc/migration_dma.cu`` runs both as one
ordinary launch — sender CTAs copy each chunk into the destination's
landing tensor and arrive on that chunk's counter, and the sender whose
arrival completes the last chunk acquires every arrival and counts the
launch as landed; no CTA waits on another. The TPU kernel's byte-inert
back-copy (dst -> src) is skipped.

- :func:`migration_exchange` — the kernel's wrapper: an ``(n_pages,
  row)`` slab in, a new landing slab out, byte for byte. CUDA tensors
  launch the kernel or raise; CPU tensors run the plain version
  :func:`migration_exchange_reference` (a chunk-by-chunk copy into a
  fresh tensor). Each launch adds one to :data:`launches`.
- :func:`send_migration` — every payload array of a bundle through the
  exchange, the bundle re-homed with ``transport="dma"``;
  :func:`recv_migration` — the install-side acceptance check.

Fallback signals (:class:`MigrationDmaError`, which the router's
transport ladder catches): :func:`dma_reachable`'s refusal and the byte
budget, both checked before any launch. A kernel fault — a failed
build, a refused launch, a launch that never landed (:func:`synchronize`
reads the landed count) — raises a plain ``RuntimeError``, which the
ladder does not catch: a broken kernel must not turn into a quiet
``device_put``.

The byte budget is the port's own (the TPU's was the VMEM that held the
slab and its output). The exchange allocates each slab's landing tensor
whole before its launch, beside the source slab that the export gathered
and the pools both will be copied to and from: an install briefly holds
its payload twice. :data:`LANDING_LIMIT` caps one slab at 256 MiB — a
512-page row of bf16 K at the chip model's 8 kv heads x 128 dims, page
256, far past any row the serving configurations hold (2 pages, 1 MiB an
array, at the plane benchmark's shape) — so a transient stays a small,
bounded share of the card's 80 GB, and a slab past it goes by the ladder
to a transport that moves it without a second whole copy in flight.

Counters and streams: one counter buffer per device serves one launch
in flight — every exchange runs on the current stream, in order, so the
install that consumes a landing tensor is ordered behind the launch that
wrote it, and a launch's counters are zeroed by the launch before it.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import replace

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.ops.flash_decode import raw
from hpc_patterns_tpu_torch.topology import LogicalDevice

#: pages per chunk (the TPU kernel's DMA unit): each chunk has its own
#: arrival counter, which its senders release as they finish their share
PAGE_CHUNK = 4

#: one slab's byte budget (see the module docstring)
LANDING_LIMIT = 256 * 1024 * 1024

#: kernel launches in this process (the main-path witness)
launches = {"migration_exchange": 0}

_THREADS = 256

# per device: the two counter sets (grown, never shrunk), the landed
# count the kernel keeps, the epoch and the launches the host made
_scratch: dict = {}
# SMs per device
_sms: dict = {}
# what each exchange landed where: id(tensor) -> (weakref, LogicalDevice);
# on one card every tensor is "on cuda:0", so the logical destination
# rank can only come from this record
_LANDED: dict = {}


class MigrationDmaError(RuntimeError):
    """The DMA transport cannot serve this (src, dst, payload): the pair
    is not reachable or a slab is past the byte budget — the router's
    fallback ladder catches exactly this type and drops to
    ``device_put`` (then wire)."""


def endpoint(d) -> tuple[torch.device, int]:
    """(physical device, logical rank) of a LogicalDevice or a plain
    device (rank 0); a CUDA device without an index names the current
    one."""
    dev, rank = (d.device, d.rank) if isinstance(d, LogicalDevice) \
        else (torch.device(d), 0)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev, rank


def dma_reachable(src_device, dst_device) -> tuple[bool, str]:
    """(ok, reason): can the exchange run between these endpoints? It
    needs two DISTINCT endpoints of one platform on one card — two
    logical ranks of the card (:class:`LogicalDevice`), as the ring
    kernels' ranks are. Device-less (host-shared) replicas, a shared
    endpoint, cross-platform pairs and pairs on two cards fall back. A
    True verdict still leaves the per-slab byte budget of
    :func:`send_migration`."""
    if src_device is None or dst_device is None:
        return False, "replica has no committed device (host-shared)"
    (sd, sr), (dd, dr) = endpoint(src_device), endpoint(dst_device)
    if (sd, sr) == (dd, dr):
        return False, "src and dst share one device (colocated)"
    if sd.type != dd.type:
        return False, f"cross-platform pair ({sd.type} -> {dd.type})"
    if sd != dd:
        return False, (f"pair spans two cards ({sd} -> {dd}): the "
                       "exchange runs within one card's memory")
    return True, ""


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def _check_slab(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"the exchange takes an (n_pages, row) slab, got "
                         f"{tuple(x.shape)}")
    if x.nbytes > LANDING_LIMIT:
        raise MigrationDmaError(
            f"payload slab {x.nbytes} B past the exchange's landing "
            f"budget of {LANDING_LIMIT} B")


def migration_exchange_reference(x: torch.Tensor,
                                 page_chunk: int = PAGE_CHUNK
                                 ) -> torch.Tensor:
    """The plain version: ``x`` (n_pages, row) copied chunk by chunk,
    ``page_chunk`` pages a chunk (the last one ragged), into a fresh
    landing tensor. float8 moves through its byte view."""
    if page_chunk < 1:
        raise ValueError(f"page_chunk must be >= 1, got {page_chunk}")
    out = torch.empty_like(x)
    src, dst = raw(x), raw(out)
    for lo in range(0, x.shape[0], page_chunk):
        dst[lo:lo + page_chunk].copy_(src[lo:lo + page_chunk])
    return out


def _lib():
    lib = _build.load("migration_dma")
    if not getattr(lib, "_migration_dma_ready", False):
        vp, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_uint)
        lib.migration_exchange.argtypes = [vp, vp, vp, vp, u, ll, ll, i, i,
                                           i, i, vp]
        lib.migration_exchange.restype = i
        lib._migration_dma_ready = True
    return lib


def _cuda_device(device=None) -> torch.device:
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def synchronize(device=None) -> None:
    """Wait for the card, then raise ``RuntimeError`` if an exchange
    launched on it since the last check never landed (a sender CTA never
    arrived). The check re-bases the count and zeroes the counters, so the
    next launch is judged afresh."""
    dev = _cuda_device(device)
    torch.cuda.synchronize(dev)
    s = _scratch.get(dev)
    if s is None:
        return
    landed = int(s["landed"].item()) & 0xFFFFFFFF
    missing = (s["launched"] - landed) & 0xFFFFFFFF
    if missing:
        s["launched"] = landed
        s["counters"].zero_()
        raise RuntimeError(
            f"migration exchange kernel: {missing} launch(es) never landed "
            "(a sender CTA never arrived on its chunk counter)")


def sender_plan(chunk_bytes: int, sms: int) -> int:
    """Sender CTAs of one exchange: one 16-byte vector a thread or more,
    at most one CTA an SM (each thread then has all its vectors in
    flight at once)."""
    return max(1, min(sms, math.ceil(chunk_bytes / (16 * _THREADS))))


def _senders(device: torch.device, chunk_bytes: int) -> int:
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sender_plan(chunk_bytes, sms)


def _counters(device: torch.device, chunks: int) -> dict:
    """The device's scratch with room for ``chunks`` counters a set, its
    epoch advanced for one launch."""
    s = _scratch.get(device)
    if s is None:
        s = _scratch[device] = {
            "landed": torch.zeros(1, dtype=torch.int32, device=device),
            "counters": None, "set_words": 0, "epoch": 0, "launched": 0}
    if s["set_words"] < chunks:
        s["set_words"] = max(chunks, 2 * s["set_words"])
        s["counters"] = torch.zeros(2 * s["set_words"], dtype=torch.int32,
                                    device=device)
    s["epoch"] = (s["epoch"] + 1) & 0xFFFFFFFF
    return s


def migration_exchange(x: torch.Tensor, page_chunk: int = PAGE_CHUNK, *,
                       senders_launched: int | None = None) -> torch.Tensor:
    """Kernel 13: the ``(n_pages, row)`` slab ``x`` copied chunk by chunk
    into a new landing slab of the same shape and dtype, byte for byte.
    CUDA: the kernel (any dtype; raises :class:`MigrationDmaError` past
    :data:`LANDING_LIMIT` before launching, ``RuntimeError`` if the launch
    fails; :func:`synchronize` raises ``RuntimeError`` for a launch that
    never landed). CPU: :func:`migration_exchange_reference`.
    ``senders_launched`` (card tests only) launches fewer sender CTAs
    than each chunk waits for, to prove a missing sender is caught."""
    _check_slab(x)
    if x.device.type == "cpu":
        return migration_exchange_reference(x, page_chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if page_chunk < 1:
        raise ValueError(f"page_chunk must be >= 1, got {page_chunk}")
    lib = _lib()
    x = x.contiguous()
    n_pages = x.shape[0]
    row_bytes = x.shape[1] * x.element_size()
    landing = torch.empty_like(x)
    if x.numel() == 0:
        return landing
    chunks = -(-n_pages // page_chunk)
    G = _senders(x.device, min(page_chunk, n_pages) * row_bytes)
    launched = G if senders_launched is None else int(senders_launched)
    s = _counters(x.device, chunks)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.migration_exchange(
            x.data_ptr(), landing.data_ptr(), s["counters"].data_ptr(),
            s["landed"].data_ptr(), s["epoch"], n_pages, row_bytes,
            page_chunk, s["set_words"], G, launched, stream)
    _build.check(rc, "migration_exchange")
    s["launched"] = (s["launched"] + 1) & 0xFFFFFFFF
    launches["migration_exchange"] += 1
    return landing


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------


def _record(t: torch.Tensor, dst: LogicalDevice) -> None:
    key = id(t)
    _LANDED[key] = (weakref.ref(t), dst)
    weakref.finalize(t, _LANDED.pop, key, None)


def landed_on(t) -> LogicalDevice | None:
    """The endpoint an exchange landed ``t`` on (None: not a landing
    tensor of this process's exchanges)."""
    hit = _LANDED.get(id(t))
    return hit[1] if hit is not None and hit[0]() is t else None


def _as_logical(d) -> LogicalDevice:
    return LogicalDevice(*endpoint(d))


def _transfer_array(arr: torch.Tensor, src_device, dst_device, *,
                    page_chunk: int = PAGE_CHUNK) -> torch.Tensor:
    """One payload array (leading dim = pages) through the exchange;
    returns the landing copy with the original shape, recorded as landed
    on ``dst_device``."""
    shape = tuple(arr.shape)
    n_pages = shape[0] if shape else 1
    row = math.prod(shape[1:]) if len(shape) > 1 else 1
    x = arr.reshape(n_pages, row)
    _check_slab(x)
    src_dev, _ = endpoint(src_device)
    if arr.device != src_dev:
        raise ValueError(f"payload on {arr.device}, not on the source "
                         f"endpoint's device {src_dev}")
    out = migration_exchange(x, page_chunk).reshape(shape)
    _record(out, _as_logical(dst_device))
    return out


def send_migration(bundle, src_device, dst_device, *,
                   page_chunk: int = PAGE_CHUNK):
    """Every payload array of ``bundle`` (the K/V pools and, for a
    quantized cache, their scale pools) from ``src_device`` to
    ``dst_device`` through the exchange; returns the bundle re-homed
    with ``transport="dma"``. Raises :class:`MigrationDmaError` before
    any launch when the pair is not DMA-reachable or any slab is past the
    byte budget — the router's fallback signal."""
    ok, reason = dma_reachable(src_device, dst_device)
    if not ok:
        raise MigrationDmaError(f"not DMA-reachable: {reason}")
    for arrs in bundle.pages_payload.values():
        for a in arrs:
            if a.nbytes > LANDING_LIMIT:
                raise MigrationDmaError(
                    f"payload slab {a.nbytes} B past the exchange's "
                    f"landing budget of {LANDING_LIMIT} B")
    payload = {name: tuple(_transfer_array(a, src_device, dst_device,
                                           page_chunk=page_chunk)
                           for a in arrs)
               for name, arrs in bundle.pages_payload.items()}
    return replace(bundle, pages_payload=payload, transport="dma")


def recv_migration(bundle, device):
    """Install-side acceptance check: the bundle must have crossed the
    DMA transport, and every payload array must have been landed by an
    exchange on the installing replica's endpoint — its physical device
    AND its logical rank (on one card the device alone proves nothing).
    Metadata only: no readback (an exchange that never landed raises
    ``RuntimeError`` from :func:`synchronize`)."""
    if bundle.transport != "dma":
        raise MigrationDmaError(
            f"bundle seq {bundle.seq} arrived with "
            f"transport={bundle.transport!r}, expected 'dma'")
    if device is None:
        raise MigrationDmaError(
            "installing replica has no committed device")
    dst = _as_logical(device)
    phys, _ = endpoint(dst)
    for name, arrs in bundle.pages_payload.items():
        for i, a in enumerate(arrs):
            if not torch.is_tensor(a) or a.device != phys \
                    or landed_on(a) != dst:
                raise MigrationDmaError(
                    f"payload {name}[{i}] of bundle seq {bundle.seq} "
                    f"not resident on installing device {dst}")
    return bundle
