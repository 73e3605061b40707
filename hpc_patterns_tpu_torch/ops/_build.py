"""Lazy build and load of the package's CUDA sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``build/`` at the repository root, and is
loaded with ``ctypes``. Nothing builds at import: the first kernel call
in a process builds every source at once — one ``nvcc`` per source, all
started together — and later calls reuse the loaded libraries. A
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header never
loads a stale binary. A failed build raises with
``nvcc``'s output. With a flight recorder active (``--trace``), each
source compiled here lands as one compile event (``nvcc.<name>``, the
seconds until its ``nvcc`` returned); a cached library is no build.
:func:`build_variant` builds a source with extra macros (the ledger build
of ``analysis/runtime.py``) into a directory of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

#: every kernel source of the package; all build together
SOURCES = ("flash_prefill", "flash_attention_bwd", "paged_decode",
           "flash_decode", "paged_attention", "busy_wait",
           "overlap_pipeline", "fused_ring", "alias_inplace", "fused_mlp",
           "migration_dma")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: one lock for each build directory: a variant compiles beside build_all
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: builds of a source with extra macros (the ledger build), by macros,
#: each in a directory of its own, never in place of the timed library
_variants: dict[tuple[str, ...], dict[str, ctypes.CDLL]] = {}
#: name -> library that load() returns instead of the timed one, while a
#: caller routes the wrappers to a variant (analysis.runtime)
_override: dict[str, ctypes.CDLL] = {}
#: ``{name: {"seconds": wall, "log": ptxas report, "cached": bool}}``
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build on first use on a machine with the toolkit")


def _target(name: str, defines: tuple[str, ...] = (),
            subdir: str = "") -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    tag = hashlib.sha1(src + flags.encode()).hexdigest()[:12]
    return (BUILD_DIR / subdir if subdir else BUILD_DIR) / f"lib{name}-{tag}.so"


def _compile(names, defines: tuple[str, ...] = (), subdir: str = "",
             cache: dict[str, ctypes.CDLL] = _libs) -> dict[str, dict]:
    """Build ``csrc/<name>.cu`` for each of ``names`` not yet in ``cache``
    (one ``nvcc`` a source, all started together) with ``-D<define>``
    each into ``build/<subdir>/``, and load it into ``cache``. Returns
    :data:`build_info` (keyed ``<subdir>/<name>`` for a subdirectory)."""
    import time

    with _locks.setdefault(subdir, threading.Lock()):
        todo = [n for n in names if n not in cache]
        if not todo:
            return build_info
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            if name not in SOURCES:
                raise KeyError(f"unknown kernel source {name!r}")
            key = f"{subdir}/{name}" if subdir else name
            out = _target(name, defines, subdir)
            if out.is_file():
                build_info[key] = {"seconds": 0.0, "log": "", "cached": True}
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[key] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for key, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_info[key] = {"seconds": time.perf_counter() - t0,
                               "log": log, "cached": False}
            if proc.returncode != 0:
                flags = "".join(f"-D{d} " for d in defines)
                failed.append(f"--- nvcc {flags}{key}.cu "
                              f"(rc={proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for name in todo:
            # torchlint: disable=rebuild-hazard — each library loads once,
            # under the lock, into its process-wide cache
            cache[name] = ctypes.CDLL(str(_target(name, defines, subdir)))
        _stamp_builds(procs, t0)
        return build_info


def build_all() -> dict[str, dict]:
    """Build every source not yet built (in parallel) and load it.
    Returns :data:`build_info`. Idempotent within a process."""
    return _compile(SOURCES)


def build_variant(names, defines: tuple[str, ...],
                  subdir: str) -> dict[str, ctypes.CDLL]:
    """:func:`build_all` of ``names`` with ``-D<define>`` each, into
    ``build/<subdir>/``. The timed library of the same source is
    untouched: :func:`load` keeps returning it. Returns ``{name:
    library}``; builds once per process."""
    cache = _variants.setdefault(tuple(defines), {})
    _compile(names, tuple(defines), subdir, cache)
    return {n: cache[n] for n in names}


def _stamp_builds(compiled, t0: float) -> None:
    """One compile event per source compiled in this call, on the flight
    recorder when one is active."""
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    rec = tracelib.active()
    if rec is None:
        return
    for key in compiled:
        secs = build_info[key]["seconds"]
        rec.compile_event(f"nvcc.{key}", secs, t_end=t0 + secs,
                          args={"source": f"csrc/{key.rsplit('/', 1)[-1]}.cu"})


def loaded_count() -> int:
    """Kernel libraries built or loaded in this process — what
    ``harness.trace.compile_watch`` diffs around a call."""
    return len(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (building all sources
    on the first call in this process)."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {SOURCES}")
    lib = _override.get(name)
    if lib is not None:
        return lib
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def is_loaded(name: str) -> bool:
    """Whether ``csrc/<name>.cu`` is built and loaded in this process."""
    return name in _libs


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero
    ``cudaGetLastError()`` (a refused launch never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
