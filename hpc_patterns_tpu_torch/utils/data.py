"""Async host -> card data pipeline: the counterpart of
``hpc_patterns_tpu/utils/data.py``.

A background thread stages the next batch(es) while the current step
runs (the concurrency suite's copy/compute overlap applied to input
data). On a card the placer copies each batch from its own pinned host
buffer with ``non_blocking=True`` on the current stream, so the step
that reads it is ordered after the copy by the stream itself. A pinned
buffer is never reused by the loader while its copy may be in flight:
every batch gets a fresh one, and PyTorch's caching host allocator
recycles a freed pinned block only after the copy's recorded event.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from hpc_patterns_tpu_torch.topology import resolve_device

_STOP = object()

TOKEN_FILE_DTYPES = ("uint16", "uint32", "int32")


def device_placer(device=None) -> Callable:
    """numpy batch -> tensor on ``device`` (default ``cuda``): a fresh
    pinned host copy, then a non-blocking copy to the card; on the CPU
    the batch's own memory as a tensor."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.from_numpy

    def place(batch):
        host = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
        return host.to(dev, non_blocking=True)

    return place


class PrefetchLoader:
    """Wrap a host-batch iterable; yield device-resident batches with
    ``depth`` transfers in flight (double buffering at depth 2).
    ``place`` maps a host batch to the device (default
    :func:`device_placer` for ``cuda``)."""

    def __init__(self, batches: Iterable, *, depth: int = 2,
                 place: Callable | None = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._batches = batches
        self._depth = depth
        self._place = place or device_placer()

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        error: list[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer is gone, so an
            # early consumer exit never wedges the worker on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches:
                    if stop.is_set():
                        return
                    # placed here, on the worker thread: the copy is in
                    # flight while the consumer computes
                    if not put(self._place(b)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised on main
                error.append(e)
            finally:
                put(_STOP)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
            while True:  # unblock a worker mid-put and drop staged refs
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)


def synthetic_tokens(seed: int, *, batch: int, seq: int, vocab: int,
                     steps: int):
    """Host-side synthetic token batches (the trainer's fuel), one
    (batch, seq) int32 numpy array per step, from ``seed``."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield rng.integers(0, vocab, size=(batch, seq), dtype="int32")


def write_token_file(path, tokens, dtype: str = "uint16") -> None:
    """Write a flat token stream as a raw binary file (one dtype, no
    header). uint16 covers vocabs to 65535 at half the bytes of int32."""
    if dtype not in TOKEN_FILE_DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {TOKEN_FILE_DTYPES}")
    arr = np.asarray(tokens).reshape(-1)
    if arr.size == 0:
        raise ValueError("empty token stream (nothing to write)")
    info = np.iinfo(dtype)
    if arr.min() < info.min or arr.max() > info.max:
        raise ValueError(f"token values outside {dtype} range")
    arr.astype(dtype).tofile(path)


def memmap_tokens(path, *, batch: int, seq: int, dtype: str = "uint16",
                  steps: int | None = None, seed: int = 0,
                  sequential: bool = False, vocab: int | None = None):
    """Batches of (batch, seq) int32 windows from a raw binary token
    file through ``np.memmap`` (paged in on demand): random windows by
    default, the file in order with ``sequential`` (eval). ``steps=None``
    iterates forever; ``vocab`` checks every id. The same windows as the
    JAX module's for the same file and seed."""
    if dtype not in TOKEN_FILE_DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {TOKEN_FILE_DTYPES}")
    data = np.memmap(path, dtype=dtype, mode="r")
    n = data.shape[0]
    if n < seq:
        raise ValueError(f"token file has {n} tokens < seq = {seq}")
    n_starts = n - seq + 1  # start n-seq (the last full window) included
    rng = np.random.default_rng(seed)
    pos = 0
    i = 0
    while steps is None or i < steps:
        if sequential:
            # wrap at a whole-window stride: the tail remainder < seq
            # tokens is dropped, never a misaligned window
            wrap = (n // seq) * seq
            starts = (pos + np.arange(batch) * seq) % wrap
            pos = (pos + batch * seq) % wrap
        else:
            starts = rng.integers(0, n_starts, size=batch)
        out = np.stack([data[s:s + seq] for s in starts])
        if vocab is not None and out.max() >= vocab:
            raise ValueError(
                f"token id {int(out.max())} >= vocab {vocab} in {path} "
                "(wrong --vocab or wrong --data-dtype?)")
        yield out.astype("int32")
        i += 1
