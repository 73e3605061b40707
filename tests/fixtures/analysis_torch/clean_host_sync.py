"""Known-clean: the dispatch/collect split the serving engine uses —
dispatch functions only ENQUEUE; readbacks live at the sync point."""

import numpy as np

from hpc_patterns_tpu_torch.analysis import dispatch_critical


def _dispatch_chunk(engine):
    # dispatch-only: device ops enqueue, handles returned, no readback
    engine.pending = engine.step()
    count = int(engine.chunk)  # host-side bookkeeping: not a readback
    return engine.pending, count


@dispatch_critical
def enqueue_next(engine):
    engine.pending = engine.step()


def collect(engine):
    # NOT dispatch-critical: the readback is this function's whole job
    return engine.pending.cpu().numpy()
