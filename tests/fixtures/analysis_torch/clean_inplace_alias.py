"""Known-clean: snapshots that are copies (``.clone()``, ``.copy()``,
``.tolist()``), and host views read before any in-place write."""

import numpy as np
import torch


def _chunk_step(cache, pos):
    """One decode step over ``pos``; the cache is updated in place."""
    cache.add_(1)
    return pos + 1


class Engine:
    def dispatch(self, rows):
        pos_start = self.pos.clone()  # a device copy, read back later
        self.pos[rows] = 0
        return pos_start

    def step(self):
        kv = self.cache.numpy().copy()
        self.pos = _chunk_step(self.cache, self.pos)
        return kv.sum()


def accumulate(buf, parts):
    for p in parts:
        seen = buf.tolist()
        torch.add(buf, p, out=buf)
        print(seen[0])


def read_first(buf):
    view = np.asarray(buf)
    total = view.sum()  # every read of the view precedes the write
    buf.zero_()
    return total
