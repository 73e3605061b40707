"""The serving plane's benchmark row — the counterpart of ``run_plane``
(``--plane``) in ``benchmarks/bench_serving.py``.

One seeded open-loop two-class stream through three legs: a single
engine (the baseline), a homogeneous 2-replica plane (least-loaded
placement) and the disaggregated 1-prefill/1-decode plane, whose every
request crosses the KV handoff over ``--migration dma|device_put|wire``.
Every leg's sequences are held against the standalone
``paged_generate`` before any number is believed (exact in f32; on the
card in bf16 a divergence passes only at a top-1/top-2 gap below
``serve_app.TIE_TOL``), and the bucket ladder is FIT to the stream's
prompt lengths and must pad no worse than the default ladder.

On one card, ``--migration dma`` puts the two replicas on two logical
ranks of it (:class:`~hpc_patterns_tpu_torch.topology.LogicalDevice`),
sharing the weights: the handoff is kernel 13's copy within the card's
memory, not a transfer between cards, and the row says so.

    python -m hpc_patterns_tpu_torch.bench_serving --plane --migration dma
    python -m hpc_patterns_tpu_torch.bench_serving --plane --migration dma \\
        --device cpu [--smoke] [--kv-dtype int8]

The rest of the JAX benchmark's rows wait for the engine's later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.harness import loadgen
from hpc_patterns_tpu_torch.harness import slo
from hpc_patterns_tpu_torch.harness.cli import (
    add_kv_dtype_arg,
    resolve_kv_cache_dtype,
)
from hpc_patterns_tpu_torch.models.decode import paged_generate
from hpc_patterns_tpu_torch.models.serving import (
    ContinuousBatcher,
    EngineCore,
    bucket_ladder,
    expected_padding,
    fit_bucket_ladder,
    pad_to_bucket,
    tie_aware_compare,
)
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from hpc_patterns_tpu_torch.serving_plane.router import (
    MIGRATION_TRANSPORTS,
    Replica,
    ServingPlane,
)
from hpc_patterns_tpu_torch.topology import LogicalDevice, resolve_device

#: top-1/top-2 logit gap below which a divergence counts as a near-tie
#: (``apps/serve_app.py``)
TIE_TOL = {"bfloat16": 0.05, "float32": 1e-4}

SCENARIO_CLASSES = (
    # interactive: the SLO-bearing class, sheds if it queues too long
    loadgen.PriorityClass("interactive", 0, weight=0.4,
                          ttft_slo_s=3.0, tpot_slo_s=1.0,
                          deadline_s=30.0),
    # batch: throughput filler, no latency target
    loadgen.PriorityClass("batch", 1, weight=0.6),
)


def _model(device, *, gpu: bool):
    cfg = TransformerConfig(
        vocab=32768 if gpu else 256,
        d_model=1024 if gpu else 256,
        n_heads=8 if gpu else 4,
        n_layers=8 if gpu else 2,
        d_ff=4096 if gpu else 1024,
        max_seq=1024 if gpu else 256,
        dtype="bfloat16" if gpu else "float32",
        decode_attn="flash" if gpu else "gather")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, generator=gen, device=device,
                            dtype=torch_dtype(cfg.dtype))


def plane_smoke_config(device=None):
    """The CI plane shape: the smoke model (vocab 256, d_model 256, 4
    heads, 2 layers, f32, gather) under a 12-request stream at 200 rps."""
    dev = resolve_device(device)
    cfg, params = _model(dev, gpu=False)
    return dict(cfg=cfg, params=params, n=12, slots=3, chunk=8,
                page_size=16, prompt_len=32, max_budget=64,
                rate_rps=200.0, seed=11, device=dev)


def plane_full_config(device=None):
    """The re-grounding shape: on the card the serving benchmark's chip
    model (vocab 32768, d_model 1024, 8 heads of 128, 8 layers, d_ff
    4096, bf16, flash decode), 32 requests at 32 rps, page 256, 8 slots,
    prompts 32/64/128 and budgets 32/128/256; on the CPU the smoke model
    at page 16, 4 slots, prompts up to 32 and budgets up to 128. On the
    card every replica is placed on a logical rank of it."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    cfg, params = _model(dev, gpu=gpu)
    return dict(cfg=cfg, params=params, n=32, slots=8 if gpu else 4,
                chunk=16, page_size=256 if gpu else 16,
                prompt_len=128 if gpu else 32,
                max_budget=256 if gpu else 128, rate_rps=32.0, seed=11,
                place_on_devices=gpu, device=dev)


def with_kv_dtype(conf: dict, kv_dtype: str | None) -> dict:
    """``conf`` with its model serving a ``--kv-dtype`` pool (int8/fp8:
    one-byte pages with f32 scale pools that migrate beside them; f32/bf16
    set the compute dtype, to which the params are cast at use)."""
    if not kv_dtype:
        return conf
    compute, kv = resolve_kv_cache_dtype(kv_dtype, device=conf["device"])
    over = {"kv_cache_dtype": kv}
    if compute:
        over["dtype"] = compute
    return dict(conf, cfg=dataclasses.replace(conf["cfg"], **over))


def plane_stream(*, cfg, n, prompt_len, max_budget, rate_rps, seed,
                 page_size, slots, **_):
    """The row's request stream and engine geometry: the Poisson
    schedule over :data:`SCENARIO_CLASSES` (prompts 1/4, 1/2, 1x of
    ``prompt_len``; budgets 1/8, 1/2, 1x of ``max_budget`` at 0.5/0.3/
    0.2), seeded prompts (``RandomState(13)``), the ladder fit to the
    prompt lengths (asserted to pad no worse than the default ladder),
    and the pool: ``slots`` of the widest request's pages."""
    rng = np.random.RandomState(13)
    schedule = loadgen.make_schedule(
        n, rate_rps=rate_rps, classes=SCENARIO_CLASSES,
        prompt_lens=(prompt_len // 4, prompt_len // 2, prompt_len),
        budgets=(max(1, max_budget // 8), max(1, max_budget // 2),
                 max_budget),
        budget_probs=(0.5, 0.3, 0.2), process="poisson", seed=seed)
    prompts = {r.index: rng.randint(0, cfg.vocab, size=r.prompt_len)
               .astype(np.int32) for r in schedule.requests}
    lengths = [r.prompt_len for r in schedule.requests]
    default_ladder = bucket_ladder(prompt_len)
    buckets = fit_bucket_ladder(lengths, len(default_ladder),
                                max_len=prompt_len)
    pad_fit = expected_padding(buckets, lengths)
    pad_default = expected_padding(default_ladder, lengths)
    assert pad_fit <= pad_default, (
        f"fit ladder {buckets} pads worse than default "
        f"{default_ladder}: {pad_fit:.2f} vs {pad_default:.2f}")
    pages_per_seq = max(
        EngineCore.pages_needed(r.prompt_len, r.max_new, page_size,
                                padded_len=pad_to_bucket(buckets,
                                                         r.prompt_len))
        for r in schedule.requests)
    return dict(schedule=schedule, prompts=prompts, buckets=buckets,
                default_ladder=default_ladder, pad_fit=pad_fit,
                pad_default=pad_default, pages_per_seq=pages_per_seq,
                pool=slots * pages_per_seq)


def make_plane(stream: dict, roles, *, cfg, params, slots, chunk,
               page_size, migration, device, placed: bool,
               slo_targets=None, emit=None) -> ServingPlane:
    """A plane of one replica per role; ``placed``: replica i on logical
    rank i of ``device`` (the weights shared), else host-shared (no
    device, so ``device_put`` degrades to the ``local`` passthrough).
    ``emit``: the plane's record sink (``ServingPlane(emit=)``)."""
    replicas = []
    for i, role in enumerate(roles):
        eng = EngineCore(params, cfg, slots=slots, pool_pages=stream["pool"],
                         pages_per_seq=stream["pages_per_seq"],
                         page_size=page_size, chunk=chunk,
                         prompt_buckets=stream["buckets"], device=device)
        replicas.append(Replica(
            eng, name=f"r{i}", role=role,
            device=LogicalDevice(device, i) if placed else None))
    return ServingPlane(replicas, slo=slo_targets, migration=migration,
                        emit=emit)


class Oracle:
    """Each request's standalone ``paged_generate`` (computed once: it
    depends only on prompt and budget) and the tie-aware verdicts of
    served outputs against it."""

    def __init__(self, stream: dict, *, cfg, params, page_size, device):
        self.stream, self.cfg, self.params = stream, cfg, params
        self.page_size, self.device = page_size, device
        self.tol = TIE_TOL[cfg.dtype]
        self._want: dict = {}

    def want(self, i: int):
        hit = self._want.get(i)
        if hit is None:
            r = self.stream["schedule"].requests[i]
            toks, margins = paged_generate(
                self.params,
                torch.from_numpy(self.stream["prompts"][i])[None, :],
                self.cfg, r.max_new, page_size=self.page_size,
                device=self.device, with_margins=True)
            hit = self._want[i] = (toks[0].cpu().numpy(),
                                   margins[0].cpu().numpy())
        return hit

    def check(self, outs: dict, label: str) -> dict:
        """Verdict counts of ``outs`` ({request index: tokens}; shed
        requests are empty by contract); raises on a mismatch."""
        counts = {"exact": 0, "near_tie": 0, "mismatch": 0, "shed": 0}
        for r in self.stream["schedule"].requests:
            got = outs.get(r.index)
            if got is None or len(got) == 0:
                counts["shed"] += 1
                continue
            want, margins = self.want(r.index)
            counts[tie_aware_compare(got, want, margins, self.tol)] += 1
        if counts["mismatch"]:
            raise AssertionError(f"{label}: engine vs standalone {counts}")
        return counts


def run_plane(*, cfg, params, n, slots, chunk, page_size, prompt_len,
              max_budget, rate_rps, seed=11, place_on_devices=False,
              migration="device_put", device=None, quiet=False,
              oracle: Oracle | None = None, emit=None):
    """The serving-plane row (see the module docstring). ``dma`` forces
    placement on logical ranks (the exchange needs a reachable pair).
    Returns JAX's result keys: the legs' wall times and goodputs,
    ``kv_migration_overlap_frac``, ``dma_migration_overlap_frac``,
    ``migration_bytes_per_round``, the transports, the ladders, and
    ``placement_shares_host`` (True: the replicas are logical ranks of
    one card) — plus the oracle verdicts. ``oracle``: an :class:`Oracle`
    of this stream to reuse (its standalone runs are cached). ``emit``:
    the two plane legs' record sink."""
    if migration not in MIGRATION_TRANSPORTS:
        raise SystemExit(f"--migration {migration!r} not in "
                         f"{'/'.join(MIGRATION_TRANSPORTS)}")
    dev = resolve_device(device)
    out = print if not quiet else (lambda *a, **k: None)
    geom = dict(cfg=cfg, params=params, slots=slots, chunk=chunk,
                page_size=page_size)
    stream = plane_stream(cfg=cfg, n=n, prompt_len=prompt_len,
                          max_budget=max_budget, rate_rps=rate_rps,
                          seed=seed, page_size=page_size, slots=slots)
    targets = slo.targets_from_classes(SCENARIO_CLASSES)
    placed = place_on_devices or migration == "dma"
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def arrivals():
        return [(r.t_arrival_s,
                 dict(prompt=stream["prompts"][r.index], max_new=r.max_new,
                      priority=r.priority, deadline_s=r.deadline_s))
                for r in stream["schedule"].requests]

    def run_single():
        eng = ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=stream["pool"],
            pages_per_seq=stream["pages_per_seq"], page_size=page_size,
            chunk=chunk, prompt_buckets=stream["buckets"], slo=targets,
            device=dev)
        got = eng.run(arrivals=arrivals())
        sync()
        return got, eng

    def run_plane_leg(roles):
        plane = make_plane(stream, roles, **geom, migration=migration,
                           device=dev, placed=placed, slo_targets=targets,
                           emit=emit)
        got = plane.run(arrivals=arrivals())
        sync()
        return got, plane

    run_single()  # warm-up: kernel build, library init, allocator
    t0 = time.perf_counter()
    single_out, single = run_single()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane_out, plane2 = run_plane_leg(["both", "both"])
    t_plane = time.perf_counter() - t0
    t0 = time.perf_counter()
    disagg_out, disagg = run_plane_leg(["prefill", "decode"])
    t_disagg = time.perf_counter() - t0
    if oracle is None:
        oracle = Oracle(stream, cfg=cfg, params=params,
                        page_size=page_size, device=dev)
    verdicts = {"single": oracle.check(single_out, "single"),
                "plane": oracle.check(plane_out, "2-replica"),
                "disagg": oracle.check(disagg_out, "1p/1d")}
    assert disagg.migrations > 0, "disaggregated leg migrated nothing"
    for leg in (plane2, disagg):
        for r in leg.replicas:
            assert r.engine.free_page_count == stream["pool"], (
                f"replica {r.name} leaked "
                f"{stream['pool'] - r.engine.free_page_count} pages")

    tot1 = single.last_slo["total"]
    tot2 = plane2.last_slo["total"]
    totd = disagg.last_slo["total"]
    overlap = disagg.last_kv_migration_overlap_frac or 0.0
    dma_overlap = disagg.last_dma_migration_overlap_frac
    shares_card = placed
    result = {
        "t_single": t_single, "t_plane": t_plane, "t_disagg": t_disagg,
        "single_goodput_tok_s": tot1["goodput_tok_s"]
        * single._serve_s / t_single if t_single > 0 else 0.0,
        "plane_goodput_tok_s": tot2["goodput_tok_s"]
        * plane2._serve_s / t_plane if t_plane > 0 else 0.0,
        "disagg_goodput_tok_s": totd["goodput_tok_s"]
        * disagg._serve_s / t_disagg if t_disagg > 0 else 0.0,
        "single_tok_s": tot1["tokens"] / t_single,
        "plane_tok_s": tot2["tokens"] / t_plane,
        "disagg_tok_s": totd["tokens"] / t_disagg,
        "kv_migration_overlap_frac": overlap,
        "dma_migration_overlap_frac": dma_overlap,
        "migration_bytes_per_round": disagg.migration_bytes_per_round,
        "migration_transport": migration,
        "migration_transports": dict(disagg.migration_transports),
        "placement_shares_host": shares_card,
        "migrations": disagg.migrations,
        "shed": tot2["shed"] + totd["shed"],
        "ladder_fit": list(stream["buckets"]),
        "ladder_default": list(stream["default_ladder"]),
        "expected_padding_fit": stream["pad_fit"],
        "expected_padding_default": stream["pad_default"],
        "schedule": stream["schedule"].spec,
        "oracle": verdicts,
        "device": str(dev),
    }
    out(f"plane[{dev}]: n={n} slots={slots}x chunk={chunk} "
        f"pool={stream['pool']}p ladder fit {stream['buckets']} "
        f"(E[pad] {stream['pad_fit']:.1f} vs default "
        f"{stream['pad_default']:.1f})")
    out(f"  single    : {t_single:.3f}s  "
        f"{result['single_goodput_tok_s']:,.1f} goodput tok/s")
    out(f"  2-replica : {t_plane:.3f}s  "
        f"{result['plane_goodput_tok_s']:,.1f} goodput tok/s  "
        f"(routed {tot2['n']} reqs, shed {tot2['shed']})")
    out(f"  1p/1d     : {t_disagg:.3f}s  "
        f"{result['disagg_goodput_tok_s']:,.1f} goodput tok/s  "
        f"migrations {disagg.migrations}  kv overlap {overlap:.1%}  "
        f"transport {migration} {dict(disagg.migration_transports)}  "
        + (f"dma overlap {dma_overlap:.1%}  "
           if dma_overlap is not None else "")
        + f"{result['migration_bytes_per_round']:,.0f} B/round")
    if shares_card:
        out(f"  NOTE: the replicas are logical ranks 0 and 1 of one "
            f"device ({dev}), sharing its weights: a migration is a copy "
            "within that device's memory, not a transfer between cards")
    out(f"  oracle on all three legs (migrated rows included): "
        f"{verdicts}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plane", action="store_true",
                   help="the serving-plane row (the only row ported)")
    p.add_argument("--migration", default="device_put",
                   choices=list(MIGRATION_TRANSPORTS))
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="the CI shape (12 requests, smoke model)")
    add_kv_dtype_arg(p, default=None)
    args = p.parse_args(argv)
    if not args.plane:
        p.error("only --plane is ported; the other rows wait for the "
                "engine's later slices")
    conf = (plane_smoke_config if args.smoke else plane_full_config)(
        args.device)
    conf = with_kv_dtype(conf, args.kv_dtype)
    result = run_plane(**conf, migration=args.migration)
    print(json.dumps({k: v for k, v in result.items() if k != "schedule"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
