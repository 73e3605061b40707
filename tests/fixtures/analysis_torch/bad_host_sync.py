"""Known-bad: host readbacks inside dispatch-critical functions —
both the configured-name form (``_dispatch_chunk``) and the
``@dispatch_critical`` marker form."""

import torch
import numpy as np

from hpc_patterns_tpu_torch.analysis import dispatch_critical


def _dispatch_chunk(engine):
    out = engine.step()
    torch.cuda.synchronize()  # EXPECT: host-sync-in-dispatch
    val = out.item()  # EXPECT: host-sync-in-dispatch
    snap = engine.pos.cpu()  # EXPECT: host-sync-in-dispatch
    return val, snap


@dispatch_critical
def enqueue_next(engine):
    return float(engine.step())  # EXPECT: host-sync-in-dispatch


def _admit(engine, req):
    got = engine.logits.tolist()  # EXPECT: host-sync-in-dispatch
    engine.table = np.array(engine.table.cpu())  # EXPECT: host-sync-in-dispatch
    return got
