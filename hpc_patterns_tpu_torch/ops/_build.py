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

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> dict[str, dict]:
    """Build every source not yet built (in parallel) and load it.
    Returns :data:`build_info`. Idempotent within a process."""
    import time

    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        if not todo:
            return build_info
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            out = _target(name)
            if out.is_file():
                build_info[name] = {"seconds": 0.0, "log": "",
                                    "cached": True}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": log, "cached": False}
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc={proc.returncode})"
                              f" ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        _stamp_builds(procs, t0)
        return build_info


def _stamp_builds(compiled, t0: float) -> None:
    """One compile event per source compiled in this call, on the flight
    recorder when one is active."""
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    rec = tracelib.active()
    if rec is None:
        return
    for name in compiled:
        secs = build_info[name]["seconds"]
        rec.compile_event(f"nvcc.{name}", secs, t_end=t0 + secs,
                          args={"source": f"csrc/{name}.cu"})


def loaded_count() -> int:
    """Kernel libraries built or loaded in this process — what
    ``harness.trace.compile_watch`` diffs around a call."""
    return len(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (building all sources
    on the first call in this process)."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {SOURCES}")
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
