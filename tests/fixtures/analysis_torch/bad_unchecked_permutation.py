"""Known-bad: pair lists that reach the kernel's raw C entry
(``lib.fused_permute``) without ``comm.ring.check_permutation``: the
checking entry ``comm.fused.fused_permute`` bypassed, a malformed table
strands the device-initiated permute on a flag that never arrives."""

from hpc_patterns_tpu_torch.ops import _build


def rotate_unchecked(x, out, size):
    pairs = [(i, (i + 2) % size) for i in range(size)]
    return _build.load("fused_ring").fused_permute(x, out, pairs)  # EXPECT: unchecked-permutation


def inline_pairs(x, out, size):
    return _build.load("fused_ring").fused_permute(x, out, [(i, i ^ 1) for i in range(size)])  # EXPECT: unchecked-permutation
