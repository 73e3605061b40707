"""Known-clean: compiled once at module level, a library loaded once and
kept, the package's memoized loader (ops/_build.load) per call."""

import ctypes

import torch

from hpc_patterns_tpu_torch.ops import _build


@torch.compile
def double(v):
    return v * 2


_LIB = None


def lib(path):
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(path)
    return _LIB


def per_call(x):
    return _build.load("busy_wait"), double(x)
