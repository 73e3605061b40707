"""Kernels 8 and 9, the fused MLP (``csrc/fused_mlp.cu``), on one card:
this tree's entry points against the same C entry points built from
another checkout, and optionally the fused training step of both.

    python -m hpc_patterns_tpu_torch.bench_mlp [--other DIR] [--train]

At the training layer's shape (N 16384 tokens, d_model 1024, d_ff 4096)
and a serving-sized one (N 512), each timed with CUDA events over
back-to-back calls on inputs cycled past the 50 MB L2: the forward, the
save-a forward, the backward's dx and dW kernels and the whole kernel
backward (both kernels and the dW casts), beside the library chain
``gelu(x @ w1, tanh) @ w2`` (the forward) and its autograd backward
(fwd+bwd less fwd; the yardstick only), and with ``--other`` the other
checkout's ``fused_mlp_fwd``, ``fused_mlp_bwd_dx`` and ``fused_mlp_bwd_dw``
(same signatures), compiled with this tree's nvcc flags. Every output is
held against the plain version first. The timings run in turns — other,
this, this, other. Each row carries this tree's launch plan (CTAs a
cluster, tiles, ring slots, grid, ``cudaOccupancyMaxActiveClusters`` and
the waves). ``--train`` runs ``train_app --mlp-impl fused`` at the
training benchmark's chip model (8 steps; 5 under ``--remat`` with the
``split`` and ``nothing`` policies) in each checkout, in the same turns,
and reads each run's step time, tokens/s and peak device memory. Prints
one JSON line per shape, one per training run, and the card's name and
power limit. Needs a card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.ops import fused_mlp as fm

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# (name, N, D, F)
SHAPES = (("training", 16384, 1024, 4096), ("serving", 512, 1024, 4096))
RTOL, DW_RTOL = 2e-2, 1e-3  # chip_smoke.py's MLP_RTOL and MLP_DW_RTOL
KERNELS = ("fwd", "fwd_save_a", "bwd_dx", "bwd_dw")
#: fused_mlp_plan's kernel indices (the dx entry point launches two
#: kernels: g and da, then dx) and what its eight numbers are
PLAN_KERNEL = {"fwd": (0,), "fwd_save_a": (1,), "bwd_dx": (2, 4),
               "bwd_dw": (3,)}
PLAN_KEYS = ("cluster", "tile_rows", "tile_cols", "panel", "stages", "grid",
             "smem_bytes", "max_active_clusters")
TRAIN_BASE = ["--batch", "8", "--seq", "2048", "--d-model", "1024",
              "--n-layers", "8", "--n-heads", "8", "--vocab", "32768",
              "--attention", "flash", "--device", "cuda", "--mlp-impl",
              "fused"]
TRAIN_RUNS = {"fused": ["--steps", "8"],
              "fused_remat_split": ["--steps", "5", "--remat",
                                    "--remat-policy", "split"],
              "fused_remat_nothing": ["--steps", "5", "--remat",
                                      "--remat-policy", "nothing"]}
# train_app in a checkout's own package, with the peak device memory
# from a reset just before, printed as the last line
_TRAIN_CODE = """
import json, sys, torch
from hpc_patterns_tpu_torch.apps import train_app
torch.cuda.reset_peak_memory_stats()
rc = train_app.main(sys.argv[1:])
print(json.dumps({"rc": rc, "peak_bytes": torch.cuda.max_memory_allocated()}))
"""


def plan(kernel: str, N: int, D: int, F: int) -> list:
    """The launches this tree's ``fused_mlp`` entry point makes at
    (N, D, F), one dict each: cluster size, tiles, ring slots, grid,
    shared memory and ``cudaOccupancyMaxActiveClusters``, with the waves
    they come to (clusters over resident clusters). Raises as the entry
    points do (a card that holds no cluster of the launch included)."""
    fn = _build.load("fused_mlp").fused_mlp_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = []
    for k in PLAN_KERNEL[kernel]:
        out = (ctypes.c_int * len(PLAN_KEYS))()
        _build.check(fn(k, N, D, F, ctypes.addressof(out)),
                     f"fused_mlp_plan {kernel}")
        row = dict(zip(PLAN_KEYS, out))
        row["waves"] = (row["grid"] / row["cluster"]
                        / row["max_active_clusters"])
        rows.append(row)
    return rows


def _other_lib(csrc: Path) -> ctypes.CDLL:
    """The other checkout's ``fused_mlp.cu``, built with this tree's nvcc
    flags (its own headers beside it)."""
    src = csrc / "fused_mlp.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    out = (_build.BUILD_DIR
           / f"libother_fused_mlp-{hashlib.sha1(text).hexdigest()[:12]}.so")
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _other_entries(lib):
    """The other library's three entry points, allocating their outputs
    as this tree's wrappers do."""
    fwd = fm._fn(lib, "fused_mlp_fwd", 5, 3)
    dx_fn = fm._fn(lib, "fused_mlp_bwd_dx", 7, 3)
    dw_fn = fm._fn(lib, "fused_mlp_bwd_dw", 6, 3)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def forward(x, w1, w2, save_a=False):
        N, D = x.shape
        F = w1.shape[1]
        y = torch.empty_like(x)
        a = torch.empty(N, F, dtype=x.dtype, device=x.device) \
            if save_a else None
        _build.check(fwd(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                         y.data_ptr(), a.data_ptr() if save_a else None, N,
                         D, F, stream()), "other fused_mlp_fwd")
        return (y, a) if save_a else y

    def bwd_dx(x, w1, w2, dy):
        N, D = x.shape
        F = w1.shape[1]
        dx = torch.empty_like(x)
        g = torch.empty(N, F, dtype=x.dtype, device=x.device)
        da = torch.empty_like(g)
        _build.check(dx_fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                           dy.data_ptr(), dx.data_ptr(), g.data_ptr(),
                           da.data_ptr(), N, D, F, stream()),
                     "other fused_mlp_bwd_dx")
        return dx, g, da

    def bwd_dw(x, g, da, dy):
        N, D = x.shape
        F = g.shape[1]
        dw1 = torch.empty(D, F, dtype=torch.float32, device=x.device)
        dw2 = torch.empty(F, D, dtype=torch.float32, device=x.device)
        _build.check(dw_fn(x.data_ptr(), g.data_ptr(), da.data_ptr(),
                           dy.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), N,
                           D, F, stream()), "other fused_mlp_bwd_dw")
        return dw1, dw2

    return forward, bwd_dx, bwd_dw


def _this_entries():
    return fm.fused_mlp_forward, fm.fused_mlp_bwd_dx, fm.fused_mlp_bwd_dw


def _device_ms(fn, sets, n=20):
    for a in sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host enqueues all n calls first
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _check(name, who, entries, x, w1, w2, dy) -> dict:
    """Each entry point's outputs against the plain versions: the worst
    max abs error over max|plain| of each kernel's outputs."""
    forward, bwd_dx, bwd_dw = entries
    want_y, want_a = fm.fused_mlp_forward_reference(x, w1, w2, save_a=True)
    y = forward(x, w1, w2)
    ys, a = forward(x, w1, w2, save_a=True)
    dx, g, da = bwd_dx(x, w1, w2, dy)
    want = fm.fused_mlp_bwd_dx_reference(x, w1, w2, dy)
    errs = {"fwd": _rel(y, want_y),
            "fwd_save_a": max(_rel(ys, want_y), _rel(a, want_a)),
            "bwd_dx": max(_rel(p, q) for p, q in zip((dx, g, da), want))}
    dws = bwd_dw(x, g, da, dy)
    errs["bwd_dw"] = max(_rel(p, q) for p, q in zip(
        dws, fm.fused_mlp_bwd_dw_reference(x, g, da, dy)))
    for k, e in errs.items():
        if e > (DW_RTOL if k == "bwd_dw" else RTOL):
            raise RuntimeError(f"{name} {who} {k}: max err / max|plain| {e}")
    return errs


def _timed(entries):
    forward, bwd_dx, bwd_dw = entries

    def route(x, w1, w2, dy, g, da):
        dx, g2, da2 = bwd_dx(x, w1, w2, dy)
        dw1, dw2 = bwd_dw(x, g2, da2, dy)
        return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)

    return {"fwd": lambda x, w1, w2, dy, g, da: forward(x, w1, w2),
            "fwd_save_a": lambda x, w1, w2, dy, g, da:
            forward(x, w1, w2, save_a=True),
            "bwd_dx": lambda x, w1, w2, dy, g, da: bwd_dx(x, w1, w2, dy),
            "bwd_dw": lambda x, w1, w2, dy, g, da: bwd_dw(x, g, da, dy),
            "bwd_route": route}


def _shape_row(name, N, D, F, other):
    gen = torch.Generator(device="cuda").manual_seed(0)
    nd, df = N * D * 2, D * F * 2
    sets = []
    for _ in range(max(2, min(32, math.ceil(150e6 / (2 * nd + 2 * df))))):
        x = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
        w1 = (torch.randn(D, F, generator=gen, device="cuda")
              * D ** -0.5).bfloat16()
        w2 = (torch.randn(F, D, generator=gen, device="cuda")
              * F ** -0.5).bfloat16()
        dy = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
        sets.append((x, w1, w2, dy))
    who = {"this": _this_entries()}
    if other is not None:
        who["other"] = other
    errs = {k: _check(name, k, e, *sets[0]) for k, e in who.items()}
    args = [(*s, *fm.fused_mlp_bwd_dx(*s)[1:]) for s in sets]
    order = (["other"] if other is not None else []) + ["this"]
    order += order[::-1]  # in turns: other, this, this, other
    times = {k: {w: [] for w in who} for k in (*KERNELS, "bwd_route")}
    for w in order:
        for k, fn in _timed(who[w]).items():
            times[k][w].append(_device_ms(fn, args))
    del args
    gelu = torch.nn.functional.gelu
    lib_sets = [tuple(t.clone().requires_grad_() for t in s[:3]) + s[3:]
                for s in sets]
    lib_fwd = _device_ms(lambda x, w1, w2, dy: gelu(
        x @ w1, approximate="tanh") @ w2, lib_sets)
    lib_fb = _device_ms(lambda x, w1, w2, dy: torch.autograd.grad(
        gelu(x @ w1, approximate="tanh") @ w2, (x, w1, w2), dy), lib_sets)
    prod = 2 * N * D * F
    work = {"fwd": (2 * prod, 2 * nd + 2 * df),
            "fwd_save_a": (2 * prod, 2 * nd + 2 * df + N * F * 2),
            "bwd_dx": (3 * prod, 4 * nd + 2 * df + 2 * N * F * 2),
            "bwd_dw": (2 * prod, 2 * nd + 2 * N * F * 2 + 4 * df),
            "bwd_route": (5 * prod, 3 * nd + 4 * df)}
    bound = {k: max(b / HBM_BYTES_PER_S, f / BF16_FLOPS_PER_S) * 1e3
             for k, (f, b) in work.items()}
    row = {"shape": name, "N": N, "D": D, "F": F, "ms": times,
           "max_rel_err": errs, "bound_ms": bound,
           "library_ms": {"fwd": lib_fwd, "bwd": lib_fb - lib_fwd},
           "tflops": {k: {w: work[k][0] / (min(v) * 1e-3) / 1e12
                          for w, v in t.items()} for k, t in times.items()},
           "plan": {k: plan(k, N, D, F) for k in KERNELS}}
    print(json.dumps(row), flush=True)
    return row


def _train(cwd: Path, label: str, run: str) -> dict:
    cwd = cwd.resolve()
    log = cwd / "build" / f"bench_mlp_{run}.jsonl"
    log.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_CODE, *TRAIN_BASE, *TRAIN_RUNS[run],
         "--log", str(log)], cwd=cwd, capture_output=True, text=True)
    recs = [json.loads(ln) for ln in log.read_text().splitlines()] \
        if log.is_file() else []
    res = [r for r in recs if r.get("kind") == "result"]
    if proc.returncode != 0 or not res:
        raise RuntimeError(f"train_app in {cwd} failed (rc "
                           f"{proc.returncode}): {proc.stdout[-2000:]}"
                           f"{proc.stderr[-2000:]}")
    tail = json.loads(proc.stdout.strip().splitlines()[-1])
    row = {"train": label, "run": run, "step_ms": res[0]["step_time_s"] * 1e3,
           "tokens_per_s": res[0]["tokens_per_s"],
           "peak_bytes": tail["peak_bytes"],
           "steps_ms": [r["dt_s"] * 1e3 for r in recs
                        if r.get("kind") == "step"]}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout of the repository to compare")
    ap.add_argument("--train", action="store_true",
                    help="also run the fused training step in both "
                         "checkouts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_mlp: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    other = None
    if args.other is not None:
        other = _other_entries(_other_lib(
            args.other / "hpc_patterns_tpu_torch" / "csrc"))
    for shape in SHAPES:
        _shape_row(*shape, other)
    if args.train:
        here = Path(__file__).resolve().parents[1]
        sides = [(args.other, "other")] if args.other is not None else []
        sides += [(here, "this")]
        for run in TRAIN_RUNS:
            for cwd, label in sides + sides[::-1]:
                _train(cwd, label, run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
