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
    p.add_argument("--metrics", action="store_true",
                   help="enable the metrics/span registry "
                        "(harness/metrics.py); with --log, one final "
                        "kind=metrics snapshot record is appended — "
                        "aggregate with `python -m "
                        "hpc_patterns_tpu_torch.harness.report`")
    p.add_argument("--trace", action="store_true",
                   help="enable the flight recorder (harness/trace.py): "
                        "spans, device windows (CUDA events on a card), "
                        "kernel builds and memory samples land in a "
                        "bounded ring buffer; with --log, one kind=trace "
                        "snapshot record is appended — export to "
                        "Chrome-trace JSON with `python -m "
                        "hpc_patterns_tpu_torch.harness.trace <log>`")
    p.add_argument("--trace-capacity", type=int, default=None, metavar="N",
                   help="flight-recorder ring size in events (default "
                        "16384; oldest events evicted beyond it)")
    return p


def add_reqtrace_arg(p: argparse.ArgumentParser) -> None:
    """The serving ``--reqtrace`` flag: request-scoped lifecycle segments
    (harness/reqtrace.py) for the measured run; with --log, one
    kind=reqtrace record is appended. ``--explain`` records the same and
    also prints the attribution table (:func:`add_explain_args`)."""
    p.add_argument("--reqtrace", action="store_true",
                   help="trace request lifecycle segments (queued/"
                        "admit_wait/prefill/decode/preempted/migrating/"
                        "shed) of the "
                        "measured run; with --log, a kind=reqtrace record "
                        "with each request's segments and the run's "
                        "attribution coverage is appended")


def add_serving_args(p: argparse.ArgumentParser) -> None:
    """The serving-engine knobs shared by the serving surfaces (serve_app;
    bench_serving takes the same flags): the prompt-length bucket ladder,
    the sampling mode and the admission-overlap toggle (JAX
    ``harness/cli.py::add_serving_args``)."""
    p.add_argument("--prompt-buckets", default="auto",
                   help="prompt-length bucket ladder: 'auto' (power-of-"
                        "two-ish ladder over the max prompt length, "
                        "serving.bucket_ladder), 'none' (exact lengths), "
                        "or comma-separated rungs, e.g. '16,32,64'")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy; > 0 samples "
                        "per-row key streams that stay standalone-exact)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling truncation (0 = off)")
    p.add_argument("--seed", type=int, default=0,
                   help="base seed of the per-request sampling keys")
    p.add_argument("--no-overlap", action="store_true",
                   help="disable overlapped admission (prefills serialize "
                        "with decode chunks — the admission-bubble "
                        "baseline)")


def parse_buckets(spec: str, max_prompt_len: int):
    """Resolve an ``--prompt-buckets`` value into a ladder tuple or None:
    'none' disables bucketing, 'auto' builds the default ladder over
    ``max_prompt_len``, anything else is comma-separated rungs."""
    spec = (spec or "none").strip().lower()
    if spec == "none":
        return None
    if spec == "auto":
        from hpc_patterns_tpu_torch.models.serving import bucket_ladder

        return bucket_ladder(max_prompt_len)
    try:
        return tuple(int(tok) for tok in spec.split(",") if tok.strip())
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"--prompt-buckets must be 'auto', 'none', or comma-separated "
            f"ints, got {spec!r}") from e


def add_autofit_arg(p: argparse.ArgumentParser) -> None:
    """The shared ``--autofit`` flag: every serving surface that consumes
    a FittedConfig ingests it through :func:`load_autofit`, so a config
    fitted once applies identically everywhere."""
    p.add_argument(
        "--autofit", default=None, metavar="CONFIG",
        help="apply a FittedConfig JSON emitted by `python -m "
             "hpc_patterns_tpu_torch.harness.autofit run.jsonl --emit "
             "CONFIG` (either package's): the fitted prompt ladder "
             "replaces the default 'auto' ladder; an explicit "
             "--prompt-buckets still wins")


def add_explain_args(p: argparse.ArgumentParser) -> None:
    """The shared ``--explain``/``--explain-out`` pair: request-scoped
    lifecycle tracing (harness/reqtrace.py) and the per-class
    tail-attribution table (harness/explain.py) after the run's row."""
    p.add_argument(
        "--explain", action="store_true",
        help="trace request lifecycle segments (queued/prefill/decode/"
             "admit_wait/preempted/migrating/shed) and print the "
             "per-class tail-attribution table; with --log, a "
             "kind=reqtrace record is appended for `python -m "
             "hpc_patterns_tpu_torch.harness.explain run.jsonl`")
    p.add_argument(
        "--explain-out", default=None, metavar="PATH",
        help="also write the attribution digest as JSON (implies "
             "--explain)")


def explain_enabled(args) -> bool:
    """Did this invocation ask for the attribution table?
    (``--explain-out`` implies ``--explain``.)"""
    return bool(getattr(args, "explain", False)
                or getattr(args, "explain_out", None))


def load_autofit(path):
    """Load and validate an ``--autofit`` value (None passes through):
    the one CLI ingestion point over ``autofit.load_fitted``."""
    if not path:
        return None
    from hpc_patterns_tpu_torch.harness import autofit

    return autofit.load_fitted(path)


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
    the JAX package treats it; ``-H`` (pinned host) keeps the buffers in
    pinned host memory where ``memory/kinds.py`` finds it usable."""
    g = p.add_mutually_exclusive_group()
    g.add_argument("-H", "--host", dest="memory_kind", action="store_const",
                   const="pinned_host",
                   help="buffers in pinned host memory (reference -H, host "
                        "USM); device memory with a note where unusable")
    g.add_argument("-D", "--device-memory", dest="memory_kind",
                   action="store_const", const="device",
                   help="buffers in device memory (reference -D, device "
                        "USM; default)")
    g.add_argument("-S", "--shared", dest="memory_kind", action="store_const",
                   const="device",
                   help="reference -S shared USM; runs in device memory")
    p.set_defaults(memory_kind="device")


#: the serving precision knob's legal values (the JAX package's
#: ``harness/cli.py::KV_DTYPE_CHOICES``, copied: the port imports nothing
#: of it)
KV_DTYPE_CHOICES = ("f32", "bf16", "int8", "fp8")

#: --kv-dtype value -> (compute dtype override or None, kv_cache_dtype)
_KV_DTYPE_MAP = {
    "f32": ("float32", "compute"),
    "bf16": ("bfloat16", "compute"),
    "int8": (None, "int8"),
    "fp8": (None, "fp8"),
}


def add_kv_dtype_arg(p: argparse.ArgumentParser,
                     default: str | None = "f32") -> None:
    """The ``--kv-dtype`` serving-precision flag."""
    p.add_argument(
        "--kv-dtype",
        default=default,
        choices=list(KV_DTYPE_CHOICES),
        help="KV-cache precision: f32/bf16 store the compute dtype "
             "(scale-free) and set it; int8/fp8 store one byte per "
             "element with per-row f32 dequant scales (half the pool "
             "bytes of bf16) and keep the compute dtype. fp8 degrades "
             "to int8 with a note where dtypes.supports_fp8() fails",
    )


def resolve_kv_cache_dtype(spec: str, *, note=print, device=None):
    """Resolve a ``--kv-dtype`` value into ``(compute_dtype_override,
    kv_cache_dtype)``; an override of None keeps the config's dtype.
    The one degrade point: ``fp8`` where ``device`` cannot run the fp8
    pipeline becomes ``int8`` with a loud note."""
    spec = (spec or "f32").strip().lower()
    if spec not in _KV_DTYPE_MAP:
        raise argparse.ArgumentTypeError(
            f"--kv-dtype must be one of {KV_DTYPE_CHOICES}, got "
            f"{spec!r}")
    compute, kv = _KV_DTYPE_MAP[spec]
    if kv == "fp8":
        from hpc_patterns_tpu_torch import dtypes

        if not dtypes.supports_fp8(device):
            note("NOTE: device cannot run float8_e4m3fn "
                 "(dtypes.supports_fp8 probe failed) - degrading "
                 "--kv-dtype fp8 to int8 (same pool bytes, integer "
                 "grid instead of a floating one)")
            kv = "int8"
    return compute, kv
