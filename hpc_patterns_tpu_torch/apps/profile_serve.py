"""Where a serving run's time goes on the card: the serving benchmark's
chip shape (``serve_app.CHIP_MODEL``/``CHIP_SERVE``, the stream of
``chip_smoke.py``) through ``ContinuousBatcher``, once without and once
under ``torch.profiler``. Prints one JSON line: the wall time of both
runs, the device's busy share (union of kernel intervals over the
profiled wall), device kernels per decode step, and device time by
kernel class (the ported kernels, library GEMMs, the rest) and by kernel
name. ``--kv-dtype`` as ``serve_app``'s.

    python -m hpc_patterns_tpu_torch.apps.profile_serve \\
        [--requests 16] [--kv-dtype int8] \\
        [--trace serve_trace.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from hpc_patterns_tpu_torch.apps.serve_app import (
    CHIP_MODEL,
    CHIP_SERVE,
    bench_stream,
    engine_geometry,
)
from hpc_patterns_tpu_torch.harness.cli import (
    add_kv_dtype_arg,
    resolve_kv_cache_dtype,
)
from hpc_patterns_tpu_torch.harness.profiling import union_us
from hpc_patterns_tpu_torch.models.serving import ContinuousBatcher
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from hpc_patterns_tpu_torch.topology import resolve_device

#: kernel-name fragments of each class (first match wins)
CLASSES = (("paged_decode", ("paged_decode",)),
           ("paged_attention", ("paged_attention",)),
           ("flash_decode", ("flash_decode",)),
           ("flash_prefill", ("flash_prefill",)),
           ("gemm", ("gemm", "gemv", "xmma", "cutlass", "nvjet")))


def _classify(name: str) -> str:
    for cls, frags in CLASSES:
        if any(f in name for f in frags):
            return cls
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--trace", default=None,
                   help="also write the Chrome trace here")
    add_kv_dtype_arg(p, default=None)
    args = p.parse_args(argv)
    dev = resolve_device(None)
    s = CHIP_SERVE
    model = dict(CHIP_MODEL)
    kv = "compute"
    if args.kv_dtype is not None:
        compute, kv = resolve_kv_cache_dtype(args.kv_dtype, device=dev)
        model["dtype"] = compute or model["dtype"]
    cfg = TransformerConfig(**model,
                            max_seq=s["prompt_len"] + s["max_budget"],
                            decode_attn="flash", kv_cache_dtype=kv)
    params = init_params(cfg,
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=getattr(torch, cfg.dtype))
    reqs = bench_stream(args.requests, s["prompt_len"], s["max_budget"],
                        cfg.vocab)
    geom = engine_geometry(reqs, **s)

    steps = {}

    def serve() -> tuple[int, float]:
        eng = ContinuousBatcher(params, cfg, **geom, device=dev)
        t0 = time.perf_counter()
        for prompt, budget in reqs:
            eng.submit(prompt, budget)
        got = eng.run()
        torch.cuda.synchronize(dev)
        steps["decode"] = eng.decode_steps
        return sum(len(v) for v in got.values()), time.perf_counter() - t0

    serve()  # warm-up: kernel build, library init, allocator
    tokens, wall = serve()
    from torch.profiler import DeviceType, ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = serve()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    by_class: dict[str, float] = {}
    for name, (us, _) in by_name.items():
        cls = _classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_us = union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "phase": "profile_serve", "device": torch.cuda.get_device_name(dev),
        "requests": args.requests, "dtype": cfg.dtype,
        "kv_cache_dtype": cfg.kv_cache_dtype, "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "profiled_wall_s": wall_prof,
        "device_kernels": len(kernels),
        "decode_steps": steps["decode"],
        "device_kernels_per_decode_step": len(kernels) / steps["decode"],
        "device_busy_s": busy_us / 1e6 if kernels else None,
        "device_busy_frac": (busy_us / 1e6 / wall_prof) if kernels
        else None,
        "device_s_by_class": {k: v / 1e6 for k, v in by_class.items()},
        "top_kernels": [{"name": n[:120], "s": us / 1e6, "count": c}
                        for n, (us, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
