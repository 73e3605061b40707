"""Known-bad: a kernel library loaded, or a function compiled, per call
or per loop iteration — every call pays the build again.

Lines carrying ``EXPECT: <rule>`` markers are the golden findings
tests/test_torch_analysis.py asserts, line-exact."""

import ctypes

import torch


def per_call(x):
    return torch.compile(lambda v: v + 1)(x)  # EXPECT: rebuild-hazard


def load_each(paths):
    libs = []
    for p in paths:
        libs.append(ctypes.CDLL(p))  # EXPECT: rebuild-hazard
    return libs


def nested(x):
    @torch.compile  # EXPECT: rebuild-hazard
    def double(v):
        return v * 2
    return double(x)
