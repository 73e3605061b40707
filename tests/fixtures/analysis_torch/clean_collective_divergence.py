"""Known-clean: the blessed rank-dependent shapes — branch on rank for
DATA or host I/O, never for which collective comes next; uniform
config flags may pick the algorithm because every rank sees the same
flag (the SPMD same-command-line invariant)."""

import torch
import torch.distributed as dist
from hpc_patterns_tpu_torch.comm import processes


def uniform_algorithm_switch(comm, x, use_ring):
    # the flag is per-RUN config, identical on every rank: whichever
    # arm is taken, all ranks take it together
    if use_ring:
        return comm.allreduce(x, algorithm="ring")
    return comm.allreduce(x)


def rank_dependent_data_not_schedule(comm, x):
    me = dist.get_rank()
    y = torch.where(me == 0, x, -x)  # data diverges; the schedule doesn't
    return comm.allreduce(y)


def same_sequence_both_arms(comm, x):
    if comm.rank == 0:
        y = comm.allreduce(x)  # both arms issue the identical op
    else:
        y = comm.allreduce(-x)  # sequence: every rank is at allreduce#k
    return y


def rank_guarded_host_io(comm, x):
    y = comm.allreduce(x)
    if comm.rank == 0:
        print("sum ready")  # host-side logging under a rank guard is
    return y  # the sanctioned pattern — no collectives in the arm
