"""Known-clean: sibling paths that agree on collective order, and an
algorithm switch (different ops entirely — a uniform config choice,
not a reordering of one shared multiset)."""

from hpc_patterns_tpu_torch.comm import collectives, ring


def same_order_both_arms(comm, x, big):
    if x.shape[0] > big:
        g = comm.all_gather(x * 2)
        s = comm.reduce_scatter(x * 2)
    else:
        g = comm.all_gather(x)
        s = comm.reduce_scatter(x)
    return g, s


def algorithm_switch(x, use_library):
    # WHICH op runs changes, not the order of a shared multiset
    if use_library:
        return collectives.allreduce(x, "x", "sum")
    return ring.ring_allreduce(x, "x")
