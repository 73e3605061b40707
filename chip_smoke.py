#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``hpc_patterns_tpu_torch``) on
one NVIDIA card — the quickest proof that the port still starts there.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every kernel source under
             ``hpc_patterns_tpu_torch/csrc/`` with nvcc for sm_90a into
             ``build/`` (all sources in parallel) and load them;
2. kernel  — each kernel's wrapper on card tensors at the serving path's
             shapes, held against its plain PyTorch version on the same
             inputs (stated tolerance), with the kernel's, the plain
             version's and one library call's device time (yardstick
             only; the port never calls it) beside the kernel's bound;
3. serve   — the serving benchmark's chip model at full width (vocab
             32768, d_model 1024, 8 heads of 128, 8 layers, d_ff 4096,
             bf16, page 256, 8 slots, chunk 16, prompts up to 512,
             budgets up to 512; random weights from a seeded
             ``torch.Generator``) through ``ContinuousBatcher``: launch
             counts read around the run, every sequence held against the
             standalone ``paged_generate`` with a tie-aware oracle, and
             two sequences against the all-plain route;
4. the ``{"kernels": [...]}`` line, the card's name and power limit
   (``nvidia-smi``), and last ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero and prints no
``ok`` line. Without CUDA, or run from a directory that does not hold the
repository, it exits non-zero before printing any result. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "hpc_patterns_tpu_torch"

# NVIDIA H100 SXM published peaks (data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores

# tolerances of the kernel-vs-plain phase (max abs error):
# prefill — bf16 in/out; the kernel rounds p to bf16 before p.v (as the
#   TPU kernel does) and the output to bf16, each ~2^-8 relative on
#   values of order 1;
# decode  — f32 math on both sides over the same pool values; only the
#   summation order differs (online softmax page by page vs one softmax).
PREFILL_ATOL = 2e-2
DECODE_ATOL = 1e-4
# the serving benchmark's chip stream, cut from 32 requests to 16
N_REQUESTS = 16
SERVE_CUTS = {"requests": "32 -> 16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, arg_sets, n: int = 30) -> float:
    """Mean device time of one ``fn(*args)`` call: the stream is first
    held by a ``torch.cuda._sleep`` so the host enqueues all ``n`` calls
    before the start event runs, then the events bracket back-to-back
    work (no host gaps). Calls cycle over ``arg_sets`` so that repeated
    calls do not find their inputs in the 50 MB L2."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def n_sets(bytes_per_set: int) -> int:
    """Input copies to cycle through so that they exceed the L2 3x."""
    return max(2, min(32, math.ceil(150e6 / bytes_per_set)))


def bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def phase_build():
    from hpc_patterns_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs,
          "sources": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
                      for k, v in info.items()}})


def prefill_case(gen, B, T, H, Hkv, D):
    from hpc_patterns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    per = (2 * B * T * H * D + 2 * B * T * Hkv * D) * 2
    sets = []
    for _ in range(n_sets(per)):
        q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        sets.append((q, k, v))
    q, k, v = sets[0]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()), "prefill output finite")
    check(err <= PREFILL_ATOL,
          f"prefill {B, T, H, Hkv, D}: max err {err} > {PREFILL_ATOL}")
    g = H // Hkv

    def lib_args(q, k, v):  # SDPA's layout, made outside the timing
        return (q.transpose(1, 2).contiguous(),
                k.repeat_interleave(g, 2).transpose(1, 2).contiguous(),
                v.repeat_interleave(g, 2).transpose(1, 2).contiguous())

    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda *a: fa.flash_attention(*a, causal=True), sets)
    plain = device_ms(
        lambda *a: fa.flash_attention_reference(*a, causal=True), sets)
    lib = device_ms(lambda *a: sdpa(*a, is_causal=True),
                    [lib_args(*s) for s in sets])
    flops = 4.0 * B * H * D * T * (T + 1) / 2  # causal q.k and p.v
    b_ms, b_by = bound(per, flops, BF16_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "flash_prefill",
           "shape": {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D,
                     "dtype": "bfloat16"},
           "max_abs_err": err, "tol": PREFILL_ATOL, "ms": ms,
           "plain_ms": plain, "library_ms": lib, "library": "sdpa",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": per,
           "flops": flops, "input_sets": len(sets)}
    emit(row)
    return row


def decode_case(gen, B, H, Hkv, D, P, pages, dtype):
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    n_pool = B * pages + 1
    esz = torch.tensor([], dtype=dtype).element_size()
    # ragged fills: 0, a page's last row, the next page's first, the top,
    # the rest drawn
    pos = torch.randint(0, pages * P, (B,), generator=gen, device=dev)
    fixed = [0, P - 1, P, pages * P - 1]
    pos[:min(B, 4)] = torch.tensor(fixed[:min(B, 4)], device=dev)
    pos = pos.to(torch.int32)
    table = torch.randperm(n_pool, generator=gen, device=dev)[:B * pages]
    table = table.to(torch.int32).reshape(B, pages).contiguous()
    pool_bytes = 2 * n_pool * Hkv * P * D * esz
    sets = []
    for _ in range(n_sets(pool_bytes)):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
        kp = torch.randn(n_pool, Hkv, P, D, generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn(n_pool, Hkv, P, D, generator=gen,
                         device=dev).to(dtype)
        sets.append((q, kp, vp, table, pos))
    got = fd.flash_decode_paged(*sets[0])
    want = fd.flash_decode_paged_reference(*sets[0])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), "decode output finite")
    check(err <= DECODE_ATOL,
          f"decode {B, H, Hkv, D, P, pages, dtype}: max err {err} > "
          f"{DECODE_ATOL}")
    ms = device_ms(fd.flash_decode_paged, sets)
    plain = device_ms(fd.flash_decode_paged_reference, sets)
    live = int((pos.long() + 1).sum())  # rows this run's fills need
    nbytes = (2 * live * Hkv * D * esz + B * H * D * esz + B * H * D * 4
              + table.numel() * 4 + B * 4)
    flops = 4.0 * H * D * live
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "paged_decode",
           "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "P": P,
                     "pages": pages, "dtype": str(dtype).split(".")[-1],
                     "pos": pos.tolist()},
           "max_abs_err": err, "tol": DECODE_ATOL, "ms": ms,
           "plain_ms": plain, "library_ms": None, "library": None,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "input_sets": len(sets)}
    emit(row)
    return row


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1)
    # the serving path's shapes first (those feed the kernels line)
    pre = prefill_case(gen, 1, 512, 8, 8, 128)
    prefill_case(gen, 1, 256, 8, 8, 128)
    prefill_case(gen, 1, 512, 8, 2, 128)  # GQA
    dec = decode_case(gen, 8, 8, 8, 128, 256, 4, torch.bfloat16)
    decode_case(gen, 8, 8, 2, 128, 256, 4, torch.bfloat16)  # GQA
    decode_case(gen, 4, 8, 8, 64, 16, 6, torch.float32)
    return pre, dec


def phase_serve():
    import dataclasses

    from hpc_patterns_tpu_torch.apps.serve_app import (
        CHIP_MODEL,
        CHIP_SERVE,
        TIE_TOL,
        bench_stream,
        engine_geometry,
    )
    from hpc_patterns_tpu_torch.models.decode import paged_generate
    from hpc_patterns_tpu_torch.models.serving import (
        ContinuousBatcher,
        pad_to_bucket,
        tie_aware_compare,
    )
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    s = CHIP_SERVE
    tie_tol = TIE_TOL[CHIP_MODEL["dtype"]]
    dev = torch.device("cuda")
    cfg = TransformerConfig(**CHIP_MODEL,
                            max_seq=s["prompt_len"] + s["max_budget"],
                            decode_attn="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev,
                         dtype=torch.bfloat16)
    reqs = bench_stream(N_REQUESTS, s["prompt_len"], s["max_budget"],
                        cfg.vocab)
    geom = engine_geometry(reqs, **s)
    buckets, pool_pages = geom["prompt_buckets"], geom["pool_pages"]

    def engine():
        return ContinuousBatcher(params, cfg, **geom, device=dev)

    warm = engine()  # library init and allocator, outside the count
    for p, b in reqs[:2]:
        warm.submit(p, 8)
    warm.run()
    torch.cuda.synchronize()

    eng = engine()
    fa.launches = 0
    fd.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_prefill": fa.launches, "paged_decode": fd.launches}
    out = {i: got[sid] for i, sid in enumerate(ids)}
    served = sum(len(v) for v in out.values())

    flash_admits = sum(pad_to_bucket(buckets, len(p)) % 128 == 0
                       for p, _ in reqs)
    check(launches["flash_prefill"] > 0 and launches["paged_decode"] > 0,
          f"both kernels launched on the main path: {launches}")
    check(launches["flash_prefill"] == cfg.n_layers * flash_admits,
          f"prefill launches {launches['flash_prefill']} == n_layers x "
          f"{flash_admits} flash admissions")
    check(launches["paged_decode"] == cfg.n_layers * eng.decode_steps,
          f"decode launches {launches['paged_decode']} == n_layers x "
          f"{eng.decode_steps} decode steps")
    check(eng.free_page_count == pool_pages,
          f"all {pool_pages} pages back on the free list "
          f"({eng.free_page_count})")
    for i, (p, b) in enumerate(reqs):
        check(out[i].shape == (b,) and out[i].min() >= 0
              and out[i].max() < cfg.vocab,
              f"seq {i}: {b} tokens in [0, vocab)")

    counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
    detail = []
    standalone = {}
    for i, (p, b) in enumerate(reqs):
        want, margins = paged_generate(
            params, torch.from_numpy(p)[None, :], cfg, b,
            page_size=s["page_size"], device=dev, with_margins=True)
        want, margins = want[0].cpu().numpy(), margins[0].cpu().numpy()
        standalone[i] = want
        v = tie_aware_compare(out[i], want, margins, tie_tol)
        counts[v] += 1
        if v != "exact":
            j = int(np.nonzero(out[i] != want)[0][0])
            detail.append({"seq": i, "verdict": v, "step": j,
                           "gap": float(margins[j])})
    # the whole path against its plain route (dense prefill attention,
    # gather decode) on the two longest-budget sequences
    plain_cfg = dataclasses.replace(cfg, decode_attn="gather")
    plain_counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
    for i in sorted(range(len(reqs)), key=lambda i: -reqs[i][1])[:2]:
        p, b = reqs[i]
        pw, pm = paged_generate(
            params, torch.from_numpy(p)[None, :], plain_cfg, b,
            page_size=s["page_size"], device=dev, with_margins=True)
        pw, pm = pw[0].cpu().numpy(), pm[0].cpu().numpy()
        v = tie_aware_compare(standalone[i], pw, pm, tie_tol)
        plain_counts[v] += 1
        if v != "exact":
            j = int(np.nonzero(standalone[i] != pw)[0][0])
            detail.append({"seq": i, "route": "plain", "verdict": v,
                           "step": j, "gap": float(pm[j])})
    emit({"phase": "serve",
          "config": {"vocab": cfg.vocab, "d_model": cfg.d_model,
                     "n_heads": cfg.n_heads, "n_layers": cfg.n_layers,
                     "d_ff": cfg.d_ff, "dtype": cfg.dtype, **s,
                     "requests": N_REQUESTS, "pool_pages": pool_pages,
                     "pages_per_seq": geom["pages_per_seq"],
                     "buckets": list(buckets)},
          "cuts": SERVE_CUTS, "served_tokens": served, "seconds": dt,
          "tokens_per_s": served / dt, "admissions": eng.admissions,
          "decode_steps": eng.decode_steps, "launches": launches,
          "oracle": counts, "tie_tol": tie_tol, "divergences": detail,
          "plain_route": plain_counts})
    check(counts["mismatch"] == 0,
          f"engine vs standalone: {counts} {detail}")
    check(plain_counts["mismatch"] == 0,
          f"kernel route vs plain route: {plain_counts}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside {Path(__file__).name};"
              " run it from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    pre, dec = phase_kernels()
    launches = phase_serve()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": f"{PKG}/csrc/flash_prefill.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_attention.py:125",
         "launches": launches["flash_prefill"],
         **{k: pre[k] for k in keys}},
        {"name": "paged_decode", "route": "cuda",
         "source": f"{PKG}/csrc/paged_decode.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_decode.py:216",
         "launches": launches["paged_decode"],
         **{k: dec[k] for k in keys}},
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
