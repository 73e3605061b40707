"""Shared CLI layer — the counterpart of ``hpc_patterns_tpu/harness/cli.py``
(``--device`` in place of ``--backend``).

Kept semantics: ``-1`` means auto/autotune wherever a size is accepted;
``--repetitions`` defaults to 10 (sycl_con.cpp:182).
"""

from __future__ import annotations

import argparse

AUTO = -1


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu (the "
                        "plain PyTorch path)")
    p.add_argument("--repetitions", type=int, default=10,
                   help="timing repetitions; result is the min (sycl_con.cpp "
                        "protocol)")
    p.add_argument("--warmup", type=int, default=2,
                   help="untimed warm-up calls (kernel build, allocator)")
    p.add_argument("--log", default=None,
                   help="write JSONL run log here (run.log analog)")
    p.add_argument("--log-append", action="store_true",
                   help="append to --log instead of truncating (for "
                        "harness-invoked runs)")
    return p


def add_msg_size_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-p", "--log2-elements", type=int, default=25,
                   help="message size = 2**p elements per rank (default 25, "
                        "~128 MiB float32)")
    p.add_argument("--dtype", default="float32",
                   help="element dtype (dtypes.REGISTRY key)")


def _nonneg_int(s: str) -> int:
    v = int(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {v}")
    return v


def add_sweep_args(p: argparse.ArgumentParser, default_min_p: int = 3) -> None:
    """The size-sweep start flag shared by the sweeping apps (pingpong,
    allreduce --sweep): sizes run 2**min_p .. 2**p."""
    p.add_argument("--min-p", type=_nonneg_int, default=default_min_p,
                   help=f"sweep start: 2**min_p elements (default "
                        f"{default_min_p})")


def add_memory_kind_args(p: argparse.ArgumentParser) -> None:
    """The reference's allocator axis (-H/-D/-S, allreduce-mpi-sycl.cpp:
    104-131). ``--device`` already names the card, so ``-D``'s long name
    is ``--device-memory``. ``-S`` (shared USM) runs in device memory, as
    the JAX package treats it; ``-H`` (pinned host) is recorded and
    refused by the apps until ``memory/kinds.py`` is ported."""
    g = p.add_mutually_exclusive_group()
    g.add_argument("-H", "--host", dest="memory_kind", action="store_const",
                   const="pinned_host",
                   help="buffers in pinned host memory (reference -H, host "
                        "USM); not yet ported")
    g.add_argument("-D", "--device-memory", dest="memory_kind",
                   action="store_const", const="device",
                   help="buffers in device memory (reference -D, device "
                        "USM; default)")
    g.add_argument("-S", "--shared", dest="memory_kind", action="store_const",
                   const="device",
                   help="reference -S shared USM; runs in device memory")
    p.set_defaults(memory_kind="device")
