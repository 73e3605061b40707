"""Kernel 1, the flash-attention forward (``csrc/flash_prefill.cu``), on
one card: this tree's kernel at each of its CTA tiles against the same
C entry point built from another checkout, and optionally the training
step of both checkouts.

    python -m hpc_patterns_tpu_torch.bench_flash [--other DIR] [--train]

At the training shape (B 8, T 2048, H 8, D 128, causal, with lse) and the
serving prefill's (B 1, T 512, H 8, D 128, causal, no lse), each timed
with CUDA events over back-to-back calls on inputs cycled past the 50 MB
L2: the kernel through its shape rule and at 64 and 128 query rows a CTA,
SDPA (``is_causal``; the yardstick only), and with ``--other`` the other
checkout's ``flash_attention_fwd`` (same signature), compiled with the
same flags. The timings run in turns — other, this, this, other — and
each output is held against the plain version first. ``--train`` runs
``train_app`` at the training benchmark's chip model (8 steps, dense,
flash) in each checkout, in the same turns, and reads each run's step
time and tokens/s. Prints one JSON line per shape, one per training run,
and the card's name and power limit. Needs a card: without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.ops import _build
from hpc_patterns_tpu_torch.ops import flash_attention as fa

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# (name, B, T, H, D, with_lse)
SHAPES = (("training", 8, 2048, 8, 128, True),
          ("serving", 1, 512, 8, 128, False))
ATOL, LSE_ATOL = 2e-2, 1e-3  # chip_smoke.py's PREFILL_ATOL and LSE_ATOL
TRAIN_ARGV = ["--steps", "8", "--batch", "8", "--seq", "2048",
              "--d-model", "1024", "--n-layers", "8", "--n-heads", "8",
              "--vocab", "32768", "--attention", "flash", "--device",
              "cuda"]


def _other_forward(src: Path):
    """The other checkout's ``flash_attention_fwd``, built from ``src``
    with this tree's nvcc flags."""
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = _build.BUILD_DIR / f"libother_flash_prefill-{tag}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    return fa._fn(ctypes.CDLL(str(out)), "flash_attention_fwd", 5, 6, 3)


def _device_ms(fn, sets, n=30):
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


def _shape_row(name, B, T, H, D, with_lse, other):
    gen = torch.Generator(device="cuda").manual_seed(0)
    per = 4 * B * T * H * D * 2
    sets = [tuple(torch.randn(B, T, H, D, generator=gen, device="cuda")
                  .bfloat16() for _ in range(3))
            for _ in range(max(2, min(32, math.ceil(150e6 / per))))]
    scale = 1.0 / math.sqrt(D)

    def this(rows):
        return lambda q, k, v: fa._launch_forward(q, k, v, 0, 0, True, None,
                                                  with_lse, rows=rows)

    def theirs(q, k, v):
        out = torch.empty_like(q)
        lse = (torch.empty(B, H, T, device="cuda") if with_lse else None)
        rc = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if with_lse else None, B, T, T, H, H, D,
                   scale, 1, 0, 0, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "other flash_attention_fwd")
        return out, lse

    want, want_lse = fa.flash_attention_reference(*sets[0], True,
                                                  with_lse=True)
    fns = {"rule": this(0), "rows64": this(64), "rows128": this(128)}
    if other is not None:
        fns["other"] = theirs
    errs = {}
    for key, fn in fns.items():
        out, lse = fn(*sets[0])
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item() if with_lse else 0.0
        if not (err <= ATOL and lse_err <= LSE_ATOL):
            raise RuntimeError(f"{name} {key}: max err {err}, lse {lse_err}")
        errs[key] = err
    del want, want_lse
    order = (["other"] if other is not None else []) + ["rule", "rows64",
                                                        "rows128"]
    order += order[::-1]  # in turns: other, this ..., this ..., other
    times = {k: [] for k in fns}
    for key in order:
        times[key].append(_device_ms(fns[key], sets))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = _device_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True),
                     [tuple(x.transpose(1, 2).contiguous() for x in s)
                      for s in sets])
    flops = 4.0 * B * H * D * T * (T + 1) / 2
    nbytes = per + (B * H * T * 4 if with_lse else 0)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    row = {"shape": name, "B": B, "T": T, "H": H, "D": D, "lse": with_lse,
           "ms": times, "max_abs_err": errs, "sdpa_ms": lib,
           "bound_ms": bound, "flops": flops,
           "tflops": {k: flops / (min(v) * 1e-3) / 1e12
                      for k, v in times.items()}}
    print(json.dumps(row), flush=True)
    return row


def _train(cwd: Path, label: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "train.jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", "hpc_patterns_tpu_torch.apps.train_app",
             *TRAIN_ARGV, "--log", str(log)], cwd=cwd, capture_output=True,
            text=True)
        recs = [json.loads(ln) for ln in log.read_text().splitlines()] \
            if log.is_file() else []
    res = [r for r in recs if r.get("kind") == "result"]
    if proc.returncode != 0 or not res:
        raise RuntimeError(f"train_app in {cwd} failed (rc "
                           f"{proc.returncode}): {proc.stdout[-2000:]}"
                           f"{proc.stderr[-2000:]}")
    row = {"train": label, "step_ms": res[0]["step_time_s"] * 1e3,
           "tokens_per_s": res[0]["tokens_per_s"],
           "steps_ms": [r["dt_s"] * 1e3 for r in recs
                        if r.get("kind") == "step"]}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout of the repository to compare")
    ap.add_argument("--train", action="store_true",
                    help="also run the training step in both checkouts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    other = None
    if args.other is not None:
        other = _other_forward(args.other / "hpc_patterns_tpu_torch"
                               / "csrc" / "flash_prefill.cu")
    for shape in SHAPES:
        _shape_row(*shape, other)
    if args.train:
        here = Path(__file__).resolve().parents[1]
        runs = [(args.other, "other")] if args.other is not None else []
        runs += [(here, "this")]
        for cwd, label in runs + runs[::-1]:
            _train(cwd, label)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
