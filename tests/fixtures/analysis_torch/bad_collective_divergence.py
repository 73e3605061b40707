"""Known-bad: the rank-branched-collective deadlock, minimized.

The reference suite's silent failure mode: SPMD ranks disagreeing on
which collective comes next. Rank 0 enters the allreduce while every
other rank enters the ring shift — each side waits forever for peers
that went elsewhere, and the job hangs with no error (the mis-ordered
``MPI_Send/Recv`` deadlock, statically visible).

Lines carrying ``EXPECT: <rule>`` markers are the golden findings
tests/test_torch_analysis.py asserts, line-exact.
"""

import os
import torch.distributed as dist


def rank_branched_deadlock(comm, x):
    if dist.get_rank() == 0:  # EXPECT: collective-divergence
        y = comm.allreduce(x)
    else:
        y = comm.sendrecv_ring(x)
    return y


def early_return_skips(comm, x):
    me = comm.rank
    if me == 0:  # EXPECT: collective-divergence
        return x
    return dist.all_reduce(x)


def loop_count_diverges(comm, x):
    r = int(os.environ["HPCPAT_PROCESS_ID"])
    for _ in range(r):  # EXPECT: collective-divergence
        x = comm.sendrecv_ring(x)
    return x
