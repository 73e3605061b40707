"""Known-bad: the poisoned-cache class in torch's form. On the CPU
``t.numpy()`` (through ``.cpu()``, a no-op there) and ``np.asarray(t)``
are zero-copy host views of ``t``'s storage; a later in-place write to
``t`` changes the "snapshot" under the host's feet.

Lines carrying ``EXPECT: <rule>`` markers are the golden findings
tests/test_torch_analysis.py asserts, line-exact."""

import numpy as np
import torch


def _chunk_step(cache, pos):
    """One decode step over ``pos``; the cache is updated in place."""
    cache.add_(1)
    return pos + 1


class Engine:
    def dispatch(self, rows):
        pos_start = self.pos.cpu().numpy()  # EXPECT: inplace-alias
        self.pos[rows] = 0  # an install writes the cursors in place
        return pos_start.max()

    def step(self):
        kv = self.cache.numpy()  # EXPECT: inplace-alias
        self.pos = _chunk_step(self.cache, self.pos)
        return kv.sum()


def accumulate(buf, parts):
    for p in parts:
        seen = np.asarray(buf)  # EXPECT: inplace-alias
        torch.add(buf, p, out=buf)
        print(seen[0])
