"""Known-clean: every pair list is bound to a name and sanitized by
``check_permutation`` before reaching the raw C entry, and the checking
entry ``comm.fused.fused_permute`` takes a list as it is (its own check)."""

from hpc_patterns_tpu_torch.comm.fused import fused_permute
from hpc_patterns_tpu_torch.comm.ring import check_permutation
from hpc_patterns_tpu_torch.ops import _build


def rotate_checked(x, out, size):
    pairs = [(i, (i + 2) % size) for i in range(size)]
    check_permutation(pairs, size)
    return _build.load("fused_ring").fused_permute(x, out, pairs)


def through_the_checking_entry(x, size):
    pairs = [(i, i ^ 1) for i in range(size)]
    # no check here: fused_permute runs _dst_table on the list itself
    return fused_permute(x, pairs)
