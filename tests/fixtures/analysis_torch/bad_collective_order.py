"""Known-bad: two code paths reach the same communicator with the same
collectives in different orders. If the predicate ever disagrees
across ranks — a config drift, a data-dependent threshold — rank A's
all_gather pairs with rank B's reduce_scatter: the mis-ordered
``MPI_Send/Recv`` cross."""


def gather_then_scatter_or_swapped(comm, x, big):
    if x.shape[0] > big:  # EXPECT: collective-order
        g = comm.all_gather(x)
        s = comm.reduce_scatter(x)
    else:
        s = comm.reduce_scatter(x)
        g = comm.all_gather(x)
    return g, s
