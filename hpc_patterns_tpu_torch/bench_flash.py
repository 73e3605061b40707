"""The flash-attention kernels on one card: kernel 1, the forward
(``csrc/flash_prefill.cu``), at each of its CTA tiles; kernels 2, 3 and
4, the fused backward, the dQ pass and the dK/dV pass
(``csrc/flash_attention_bwd.cu``), with both backward routes around them;
kernel 5, the linear-cache decode (``csrc/flash_decode.cu``), kernel 6,
the paged decode (``csrc/paged_decode.cu``), and kernel 7, the
exact-softmax paged decode (``csrc/paged_attention.cu``), each against the
same C entry points built from another checkout; optionally the training
step of both checkouts (``--train``), or only the decode kernels
(``--decode``).

    python -m hpc_patterns_tpu_torch.bench_flash [--other DIR] [--train]
        [--decode]

At the training shape (B 8, T 2048, H 8, D 128, causal, with lse) and
the serving prefill's (B 1, T 512, H 8, D 128, causal, no lse), each
timed with CUDA events over back-to-back calls on inputs cycled past the
50 MB L2: the kernel through its shape rule and at 64 and 128 query rows
a CTA, SDPA (``is_causal``; the yardstick only), and with ``--other``
the other checkout's ``flash_attention_fwd`` (same signature), compiled
with the same flags. The backward at the training shape: this tree's
``flash_attention_fused_bwd``, ``flash_attention_dq`` and
``flash_attention_dkv`` against the other checkout's (same C signatures;
its slab sized by the keys a slot that its ``ops/flash_attention.py``
names, 64 before the 128-key redesign); the fused route (Delta, kernel
2, the never-written slab rows zeroed, the f32 slab sum, the dk/dv
casts) of each: this tree's ``_backward``, the other's as the route ran
before the 128-key redesign, on its slab; and the split route (Delta,
then the dQ and dK/dV passes) of each; SDPA's backward (fwd+bwd less
fwd) as the yardstick. Kernel 5 at the precision law's shape (B 4, H 8,
D 128, S 520, pos 519) on bf16, int8 and fp8 caches and on int8 with 2
kv heads, and at two shapes this tree runs in one chunk (pos 63; B 33,
264 kv rows) on bf16 and int8: this tree's ``flash_decode_attention``
(the split it plans is in the row) against the other checkout's
``flash_decode_split`` on the same plan, or, in a checkout from before
the split, its one-CTA-per-(sequence, kv head) ``flash_decode``; SDPA
(``enable_gqa``, a boolean mask, on a bf16 cache of the same values) as
the yardstick. Kernels 6 and 7, the paged decodes, at the serving shape
(B 8, H 8, Hkv 8, D 128, page 256, 4 pages a sequence, ragged fills up
to 1023) on bf16, int8 and fp8 pools and on int8 with 2 kv heads: this
tree's ``flash_decode_paged`` and ``paged_attention_decode`` (the chunk
:func:`paged_decode_plan` sets) against the other checkout's
``paged_decode_split`` and ``paged_attention`` on this tree's plan where
they take one, else its one-CTA-per-(sequence, kv head) ``paged_decode``
and ``paged_attention``; SDPA (``enable_gqa``, a boolean mask past each
fill) on the live rows gathered into a linear bf16 cache outside the
timing as the yardstick. The timings run in turns — other, this, this,
other — and each output is held against the plain version first.
``--train`` runs ``train_app`` at the training benchmark's chip model (8
steps, dense, flash) in each checkout, in the same turns, and reads each
run's step time and tokens/s. Prints one JSON line per shape, one per
training run, and the card's name and power limit. Needs a card: without
one it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
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
# the backward's shape (B, T, H, D: one layer of the training step, causal)
# and chip_smoke.py's BWD_RTOL (max abs error over max |plain|)
BWD_SHAPE = (8, 2048, 8, 128)
BWD_RTOL = 2e-2
# kernel 5 at the precision law's shape (chip_smoke.py: LAW_PROMPTS
# prompts of LAW_PROMPT_LEN + LAW_STEPS rows, 8 heads of 128, the last
# row's step): (H, D, S), then (cache dtype, B, kv heads, pos) per row, q
# bf16; the last four rows take one chunk on an H100 (132 SMs): few live
# rows (pos 63), and B * Hkv = 264 kv rows, two CTAs an SM already;
# chip_smoke.py's DECODE_ATOL
DECODE_SHAPE = (8, 128, 520)
DECODE_CASES = (("bfloat16", 4, 8, 519), ("int8", 4, 8, 519),
                ("fp8", 4, 8, 519), ("int8", 4, 2, 519),
                ("bfloat16", 4, 8, 63), ("int8", 4, 8, 63),
                ("bfloat16", 33, 8, 519), ("int8", 33, 8, 519))
DECODE_ATOL = 1e-4
# kernels 6 and 7 at the serving shape (chip_smoke.py's decode_case): B,
# H, D, page rows, pages a sequence; (pool dtype, kv heads) per row
PAGED_SHAPE = (8, 8, 128, 256, 4)
PAGED_CASES = (("bfloat16", 8), ("int8", 8), ("fp8", 8), ("int8", 2))
#: the paged kernels: this tree's wrapper and the other checkout's split
#: and one-CTA C entries
PAGED_KERNELS = {"paged_decode": ("paged_decode_split", "paged_decode"),
                 "paged_attention": ("paged_attention", "paged_attention")}
TRAIN_ARGV = ["--steps", "8", "--batch", "8", "--seq", "2048",
              "--d-model", "1024", "--n-layers", "8", "--n-heads", "8",
              "--vocab", "32768", "--attention", "flash", "--device",
              "cuda"]


def _other_lib(other: Path, name: str) -> ctypes.CDLL:
    """The other checkout's ``csrc/<name>.cu``, built with this tree's
    nvcc flags (its own headers beside it)."""
    csrc = other / "hpc_patterns_tpu_torch" / "csrc"
    src = (csrc / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    tag = hashlib.sha1(src).hexdigest()[:12]
    out = _build.BUILD_DIR / f"libother_{name}-{tag}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(csrc / f"{name}.cu")], check=True)
    return ctypes.CDLL(str(out))


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


def _kv_tile(other: Path) -> int:
    """The keys a slab slot in the other checkout's fused backward: its
    ``BWD_BLOCK_K``."""
    src = (other / "hpc_patterns_tpu_torch" / "ops"
           / "flash_attention.py").read_text()
    return int(re.search(r"^BWD_BLOCK_K = (\d+)$", src, re.M).group(1))


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _fused_route(fused, q, k, v, do, lse, out, block_k):
    """The fused route as ``fa._backward`` ran it before the 128-key
    redesign (unchunked, causal, offsets 0: Delta from f32 copies of both
    operands, the kernel, the never-written slab rows zeroed, the f32 slab
    sum, dk and dv through f32) around the kernel ``fused`` whose slab has
    ``block_k`` keys a slot: (dq, dk, dv)."""
    B, T, H, D = q.shape
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv, slab = fused(q, k, v, do, lse, delta)
    for j, r in enumerate(fa._unwritten_rows(T, T, 0, 0, True, block_k)):
        if r:
            slab[j, :, :r] = 0
    dq = slab.sum(0, dtype=torch.float32).to(q.dtype)
    return (dq.reshape(B, H, T, D).permute(0, 2, 1, 3),
            dk.float().to(k.dtype), dv.float().to(v.dtype))


def _backward_row(other, other_kv_tile):
    """Kernels 2 and 4 and the fused route at the training shape, this
    tree's against the other checkout's (``other``: its library or None),
    in turns, each output held against the plain versions first."""
    B, T, H, D = BWD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    per = 4 * B * T * H * D * 2 + 2 * B * H * T * 4
    sets = []
    for _ in range(max(2, min(32, math.ceil(150e6 / per)))):
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                       .bfloat16() for _ in range(4))
        out, lse = fa._launch_forward(q, k, v, 0, 0, True, None, True)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
        sets.append((q, k, v, do, lse, delta.contiguous(), out))
    scale = 1.0 / math.sqrt(D)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def this_fused(q, k, v, do, lse, delta, *_):
        return fa.flash_attention_fused_bwd(q, k, v, do, lse, delta)

    def this_dkv(q, k, v, do, lse, delta, *_):
        return fa.flash_attention_dkv(q, k, v, do, lse, delta)

    def this_dq(q, k, v, do, lse, delta, *_):
        return (fa.flash_attention_dq(q, k, v, do, lse, delta),)

    def this_route(q, k, v, do, lse, delta, out, bwd="fused"):
        return fa._backward(q, k, v, out, lse, 0, 0, do, None, causal=True,
                            scale=None, bwd=bwd)

    fns = {"fused_bwd": {"this": this_fused}, "dkv": {"this": this_dkv},
           "dq": {"this": this_dq}, "route_fused": {"this": this_route},
           "route_split": {"this": lambda *a: this_route(*a, bwd="split")}}
    if other is not None:
        o_fused = fa._fn(other, "flash_attention_fused_bwd", 9, 6, 3)
        o_dkv = fa._fn(other, "flash_attention_dkv", 8, 6, 3)
        o_dq = fa._fn(other, "flash_attention_dq", 7, 6, 3)

        def theirs_fused(q, k, v, do, lse, delta, *_):
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            slab = torch.empty(fa._n_kv(T, other_kv_tile), B * H, T, D,
                               dtype=q.dtype, device=q.device)
            _build.check(o_fused(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), slab.data_ptr(), B, T, T, H, H, D, scale, 1,
                0, 0, stream()), "other flash_attention_fused_bwd")
            return dk, dv, slab

        def theirs_dkv(q, k, v, do, lse, delta, *_):
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            _build.check(o_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, T, T, H, H, D, scale, 1, 0, 0, stream()),
                "other flash_attention_dkv")
            return dk, dv

        def theirs_dq(q, k, v, do, lse, delta, *_):
            dq = torch.empty_like(q)
            _build.check(o_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, T, T, H,
                H, D, scale, 1, 0, 0, stream()), "other flash_attention_dq")
            return (dq,)

        def theirs_route(q, k, v, do, lse, delta, out):
            return _fused_route(theirs_fused, q, k, v, do, lse, out,
                                other_kv_tile)

        def theirs_split(q, k, v, do, lse, delta, out):
            # the split route as _backward runs it: Delta, then dq and dkv
            delta = (do.float() * out).sum(-1).permute(0, 2, 1).contiguous()
            return (*theirs_dq(q, k, v, do, lse, delta),
                    *theirs_dkv(q, k, v, do, lse, delta))

        fns["fused_bwd"]["other"] = theirs_fused
        fns["dkv"]["other"] = theirs_dkv
        fns["dq"]["other"] = theirs_dq
        fns["route_fused"]["other"] = theirs_route
        fns["route_split"]["other"] = theirs_split

    # every output against the plain versions (dq through its slab: masked
    # and summed, as the route does)
    q, k, v, do, lse, delta, out = sets[0]
    w_dk, w_dv = fa.flash_attention_dkv_reference(q, k, v, do, lse, delta)
    w_dq = fa.flash_attention_dq_reference(q, k, v, do, lse, delta)
    errs = {}
    for name, by in fns.items():
        for who, fn in by.items():
            got = fn(*sets[0])
            if name == "fused_bwd":
                tile = fa.BWD_BLOCK_K if who == "this" else other_kv_tile
                rows = fa._unwritten_rows(T, T, 0, 0, True, tile)
                slab = got[2]
                for j, r in enumerate(rows):
                    slab[j, :, :r] = 0
                dq = slab.sum(0, dtype=torch.float32).to(q.dtype)
                got = (dq.reshape(B, H, T, D).permute(0, 2, 1, 3), *got[:2])
            want = {"dkv": (w_dk, w_dv), "dq": (w_dq,)}.get(
                name, (w_dq, w_dk, w_dv))
            e = max(_rel(a, b) for a, b in zip(got, want))
            if not e <= BWD_RTOL:
                raise RuntimeError(f"backward {name} {who}: max err / max "
                                   f"|plain| {e} > {BWD_RTOL}")
            errs.setdefault(name, {})[who] = e
    del w_dk, w_dv, w_dq
    times = {name: {who: [] for who in by} for name, by in fns.items()}
    for name, by in fns.items():
        order = (["other"] if "other" in by else []) + ["this"]
        for who in order + order[::-1]:
            times[name][who].append(_device_ms(by[who], sets))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(x.transpose(1, 2).contiguous().requires_grad_()
                      for x in s[:3]) + (s[3].transpose(1, 2).contiguous(),)
                for s in sets]
    lib_fwd = _device_ms(lambda q, k, v, g: sdpa(q, k, v, is_causal=True),
                         lib_sets)
    lib_fb = _device_ms(lambda q, k, v, g: torch.autograd.grad(
        sdpa(q, k, v, is_causal=True), (q, k, v), g), lib_sets)
    # chip_smoke.py's bounds: inputs read once, outputs written once (of
    # the slab only the visible pairs' slots)
    tri = B * H * D * T * (T + 1) / 2
    io = 4 * B * T * H * D * 2 + 2 * B * H * T * 4
    slab = sum(T - r for r in fa._unwritten_rows(T, T, 0, 0, True)) \
        * B * H * D * 2
    bounds = {
        "fused_bwd": max((io + 2 * B * T * H * D * 2 + slab)
                         / HBM_BYTES_PER_S, 10 * tri / BF16_FLOPS_PER_S),
        "dkv": max((io + 2 * B * T * H * D * 2) / HBM_BYTES_PER_S,
                   8 * tri / BF16_FLOPS_PER_S),
        "dq": max((io + B * T * H * D * 2) / HBM_BYTES_PER_S,
                  6 * tri / BF16_FLOPS_PER_S)}
    row = {"shape": "backward", "B": B, "T": T, "H": H, "D": D,
           "ms": times, "max_rel_err": errs,
           "tflops": {n: {w: f * tri / (min(t) * 1e-3) / 1e12
                          for w, t in times[n].items()}
                      for n, f in (("fused_bwd", 10), ("dkv", 8), ("dq", 6))},
           "sdpa_bwd_ms": lib_fb - lib_fwd,
           "bound_ms": {k: v * 1e3 for k, v in bounds.items()},
           "kv_tile": {"this": fa.BWD_BLOCK_K, "other": other_kv_tile}}
    print(json.dumps(row), flush=True)
    return row


def _decode_rows(other):
    """Kernel 5 (``flash_decode_attention`` on the linear cache) at each
    of :data:`DECODE_CASES`, against the other checkout's kernel
    (``other``: its library or None; its ``flash_decode_split`` on this
    tree's plan where it has one, else the one-CTA-per-(sequence, kv head)
    ``flash_decode`` that came before the split), in turns, each output
    held against the plain version first; SDPA (``enable_gqa``, a boolean
    mask past pos, on a compute-dtype cache of the same values,
    dequantized outside the timing) as the yardstick."""
    from hpc_patterns_tpu_torch.models.decode import _quantize_rows
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    H, D, S = DECODE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sms = fd._sm_count(torch.device("cuda"))
    o_fd, split = None, False
    if other is not None:
        o_fd = getattr(other, "flash_decode_split", None)
        split = o_fd is not None
        if split:
            o_fd.argtypes = fd._SPLIT_ARGS
        else:
            o_fd = other.flash_decode
            # q, k, v, ks, vs, pos, out, B, H, Hkv, D, S, scale, q code,
            # kv code, stream
            o_fd.argtypes = ([ctypes.c_void_p] * 5
                             + [ctypes.c_int, ctypes.c_void_p]
                             + [ctypes.c_int] * 5
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p])
        o_fd.restype = ctypes.c_int
    rows = []
    for kv, B, Hkv, pos in DECODE_CASES:
        quant = kv in ("int8", "fp8")
        esz = 1 if quant else 2
        per = 2 * B * Hkv * S * (D * esz + 4 * quant)
        mask = (torch.arange(S, device="cuda") <= pos)[None, None, None, :]
        n_chunks, chunk = fd.decode_chunks(pos, B * Hkv, sms)
        sets, lib_sets = [], []
        for _ in range(max(2, min(32, math.ceil(150e6 / per)))):
            q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
            kc, vc = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
                      for _ in range(2))
            if quant:
                (kc, ks), (vc, vs) = (_quantize_rows(kc, kv),
                                      _quantize_rows(vc, kv))
                kd, vd = fd.dequant(kc, ks), fd.dequant(vc, vs)
            else:
                kc, vc, ks, vs = kc.bfloat16(), vc.bfloat16(), None, None
                kd, vd = kc, vc
            sets.append((q, kc, vc, ks, vs))
            lib_sets.append((q[:, :, None, :], kd.bfloat16(), vd.bfloat16()))

        def this(q, kc, vc, ks, vs):
            return fd.flash_decode_attention(q, kc, vc, pos, k_scale=ks,
                                             v_scale=vs)

        def theirs(q, kc, vc, ks, vs):
            out = torch.empty(B, H, D, device="cuda")
            head = [q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    None if ks is None else ks.data_ptr(),
                    None if vs is None else vs.data_ptr(), pos,
                    out.data_ptr()]
            if split:
                part = torch.empty(B * H * n_chunks * (D + 2),
                                   device="cuda")
                head += [part.data_ptr(), n_chunks, chunk]
            _build.check(o_fd(*head, B, H, Hkv, D, S, 1.0 / math.sqrt(D), 1,
                              fd.KV_CODES[kc.dtype], stream()),
                         "other flash_decode")
            return out

        fns = {"this": this}
        if other is not None:
            fns["other"] = theirs
        want = fd.flash_decode_attention_reference(
            *sets[0][:3], pos, k_scale=sets[0][3], v_scale=sets[0][4])
        errs = {}
        for who, fn in fns.items():
            got = fn(*sets[0])
            e = (got - want).abs().max().item()
            if not e <= DECODE_ATOL:
                raise RuntimeError(f"decode {kv} B {B} Hkv {Hkv} pos {pos} "
                                   f"{who}: max err {e} > {DECODE_ATOL}")
            errs[who] = e
        order = (["other"] if other is not None else []) + ["this"]
        times = {who: [] for who in fns}
        for who in order + order[::-1]:
            times[who].append(_device_ms(fns[who], sets))
        lib = _device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                              enable_gqa=True), lib_sets)
        nbytes = (2 * B * (pos + 1) * Hkv * (D * esz + 4 * quant)
                  + B * H * D * 2 + B * H * D * 4)
        row = {"shape": "decode", "kv": kv, "B": B, "H": H, "Hkv": Hkv,
               "D": D, "S": S, "pos": pos, "n_chunks": n_chunks,
               "chunk": chunk, "ms": times, "max_abs_err": errs,
               "sdpa_ms": lib, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bytes": nbytes}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _other_split(other: Path, kernel: str) -> bool:
    """Whether the other checkout's paged ``kernel`` is split over chunks
    (its C entry takes the plan and a workspace)."""
    src = other / "hpc_patterns_tpu_torch" / "csrc" / f"{kernel}.cu"
    return b"n_chunks" in src.read_bytes()


def _paged_rows(kernel, other, o_split):
    """``kernel`` (``paged_decode``: kernel 6, ``flash_decode_paged``;
    ``paged_attention``: kernel 7, ``paged_attention_decode``) at
    :data:`PAGED_SHAPE` on each case of :data:`PAGED_CASES` against the
    other checkout's kernel (its split C entry on this tree's plan where
    ``o_split``, else its one-CTA entry), in turns, each output held
    against the plain version first; SDPA on the live rows gathered into a
    bf16 cache (the gather made outside the timing) as the yardstick."""
    from hpc_patterns_tpu_torch.models.decode import _quantize_rows
    from hpc_patterns_tpu_torch.ops import flash_decode as fd
    from hpc_patterns_tpu_torch.ops import paged_attention as pa

    B, H, D, P, pages = PAGED_SHAPE
    n_pool = B * pages + 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    wrapper = {"paged_decode": fd.flash_decode_paged,
               "paged_attention": pa.paged_attention_decode}[kernel]
    o_fn = None
    if other is not None:
        o_fn = getattr(other, PAGED_KERNELS[kernel][0 if o_split else 1])
        # the one-CTA entry: q, k, v, ks, vs, table, pos, pos_scalar, out,
        # B, H, Hkv, D, P, pages, n_pool, scale, q code, kv code, stream
        o_fn.argtypes = fd._PAGED_ARGS if o_split else (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        o_fn.restype = ctypes.c_int
    pos = torch.randint(0, pages * P, (B,), generator=gen, device="cuda")
    pos[:4] = torch.tensor([0, P - 1, P, pages * P - 1], device="cuda")
    pos = pos.to(torch.int32)
    table = torch.randperm(n_pool, generator=gen, device="cuda")[:B * pages]
    table = table.to(torch.int32).reshape(B, pages).contiguous()
    S = pages * P
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    rows = []
    for kv, Hkv in PAGED_CASES:
        quant = kv in ("int8", "fp8")
        esz = 1 if quant else 2
        per = 2 * n_pool * Hkv * P * (D * esz + 4 * quant)
        sets, lib_sets = [], []
        for _ in range(max(2, min(32, math.ceil(150e6 / per)))):
            q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
            kp, vp = (torch.randn(n_pool, Hkv, P, D, generator=gen,
                                  device="cuda") for _ in range(2))
            if quant:
                (kp, ks), (vp, vs) = (_quantize_rows(kp, kv),
                                      _quantize_rows(vp, kv))
                ks, vs = (ks[:, :, None, :].contiguous(),
                          vs[:, :, None, :].contiguous())
                kd = fd._gather_pages(kp, table.long()).float() \
                    * fd._gather_pages(ks.transpose(2, 3), table.long())
                vd = fd._gather_pages(vp, table.long()).float() \
                    * fd._gather_pages(vs.transpose(2, 3), table.long())
            else:
                kp, vp, ks, vs = kp.bfloat16(), vp.bfloat16(), None, None
                kd = fd._gather_pages(kp, table.long())
                vd = fd._gather_pages(vp, table.long())
            sets.append((q, kp, vp, ks, vs))
            lib_sets.append((q[:, :, None, :], kd.bfloat16(), vd.bfloat16()))
        n_chunks, chunk = fd.paged_decode_plan(pages, P)

        def this(q, kp, vp, ks, vs):
            return wrapper(q, kp, vp, table, pos, k_scale_pool=ks,
                           v_scale_pool=vs)

        def theirs(q, kp, vp, ks, vs):
            out = torch.empty(B, H, D, device="cuda")
            args = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    None if ks is None else ks.data_ptr(),
                    None if vs is None else vs.data_ptr(), table.data_ptr(),
                    pos.data_ptr(), 0, out.data_ptr()]
            if o_split:
                part = torch.empty(B * H * n_chunks * (D + 2), device="cuda")
                args += [part.data_ptr(), n_chunks, chunk]
            _build.check(o_fn(*args, B, H, Hkv, D, P, pages, n_pool,
                              1.0 / math.sqrt(D), 1,
                              fd.KV_CODES[kp.dtype], stream()),
                         f"other {kernel}")
            return out

        fns = {"this": this}
        if other is not None:
            fns["other"] = theirs
        want = fd.flash_decode_paged_reference(
            sets[0][0], sets[0][1], sets[0][2], table, pos,
            k_scale_pool=sets[0][3], v_scale_pool=sets[0][4])
        errs = {}
        for who, fn in fns.items():
            e = (fn(*sets[0]) - want).abs().max().item()
            if not e <= DECODE_ATOL:
                raise RuntimeError(f"{kernel} {kv} Hkv {Hkv} {who}: max err "
                                   f"{e} > {DECODE_ATOL}")
            errs[who] = e
        order = (["other"] if other is not None else []) + ["this"]
        times = {who: [] for who in fns}
        for who in order + order[::-1]:
            times[who].append(_device_ms(fns[who], sets))
        lib = _device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                              enable_gqa=True), lib_sets)
        live = int((pos.long() + 1).sum())
        nbytes = (2 * live * Hkv * (D * esz + 4 * quant) + B * H * D * 2
                  + B * H * D * 4 + table.numel() * 4 + B * 4)
        row = {"shape": kernel, "kv": kv, "B": B, "H": H,
               "Hkv": Hkv, "D": D, "P": P, "pages": pages,
               "pos": pos.tolist(), "n_chunks": n_chunks, "chunk": chunk,
               "other_split": o_split if other is not None else None,
               "ms": times, "max_abs_err": errs,
               "sdpa_ms": lib, "sdpa": "enable_gqa, bool mask; the live rows "
               "gathered into a bf16 cache outside the timing",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


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
    ap.add_argument("--decode", action="store_true",
                    help="only the decode kernels (5, 6 and 7)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    other = other_bwd = other_decode = None
    other_paged = {k: (None, False) for k in PAGED_KERNELS}
    if args.other is not None:
        if not args.decode:
            other = fa._fn(_other_lib(args.other, "flash_prefill"),
                           "flash_attention_fwd", 5, 6, 3)
            other_bwd = _other_lib(args.other, "flash_attention_bwd")
        other_decode = _other_lib(args.other, "flash_decode")
        other_paged = {k: (_other_lib(args.other, k),
                           _other_split(args.other, k))
                       for k in PAGED_KERNELS}
    if not args.decode:
        for shape in SHAPES:
            _shape_row(*shape, other)
        _backward_row(other_bwd, _kv_tile(args.other) if args.other else None)
    _decode_rows(other_decode)
    for kernel, (lib, split) in other_paged.items():
        _paged_rows(kernel, lib, split)
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
