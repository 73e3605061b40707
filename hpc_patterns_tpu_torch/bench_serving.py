"""The serving benchmark's rows — the counterpart of
``benchmarks/bench_serving.py``'s base row (``run_bench``), robustness
row (``run_scenario``, ``--scenario``), serving-plane row
(``run_plane``, ``--plane``), autofit row (``run_fitted``, ``--fit``),
its tiered-memory and quantized rows and the elastic-plane row
(``run_elastic``, ``--elastic``).

- **base**: the mixed-length, long-tail-budget stream through static
  batching (batches of ``slots`` in arrival order, rectangular length
  groups, every row paying its batch's longest budget) and through the
  engine with bucketed, overlapped admission (``--temperature``,
  ``--top-k``, ``--seed``, ``--no-overlap``, ``--prompt-buckets``);
- **scenario**: an open-loop two-class stream (``harness/loadgen.py``)
  under page pressure that forces preemption and resume, with a seeded
  stalled-host chaos fault (``harness/chaos.py``) on the engine loop,
  goodput (SLO-attained tokens/s, ``harness/slo.py``) beside raw
  tokens/s, the preemption and shed counts, the request trace's
  coverage, its p99 queue and stall shares (``harness/explain.py``) and
  the segment-budget breaches (``harness/budget.py``; ``--explain`` /
  ``--explain-out`` print the tables and write the digest); the engine
  runs against clean static batching;
- **plane**: one open-loop two-class stream through a single engine, a
  homogeneous 2-replica plane (least-loaded placement) and the
  disaggregated 1-prefill/1-decode plane, whose every request crosses
  the KV handoff over ``--migration dma|device_put|wire``; then a
  sampled closed-loop 1p/1d leg over the same transport;
- **fit**: a long-tail stream recorded to a RunLog under the default
  ladder, a FittedConfig fitted from it (``harness/autofit.py``), then
  the default engine against ``ContinuousBatcher.from_fitted`` on the
  same pool geometry; the fitted ladder must pad strictly less. Then the
  blame A/B: the ``--slo-budget`` chassis recorded, blame-fitted and
  re-served under the fitted residency (the blamed share must shrink);
- **offload**: the same stream through an all-HBM engine and one whose
  pool is capped below the working set, fronting the residency manager's
  pinned host tier (``memory/``): tiered equals all-HBM, the cap forces
  paging; ``offload_goodput_tok_s``, ``prefetch_overlap_frac``;
- **shared**: a template and conversation-tree stream through private
  pages and the sharing-aware arena (``prefix_cache=True``):
  ``prefill_skip_frac`` > 0.3, ``shared_goodput_tok_s``;
- **slo-budget**: a seeded slow host transfer through a thrashing
  2-resident tier must breach the ``prefetch_wait`` budget and nothing
  else;
- **elastic**: a diurnal ramp under replica-death chaos through a fixed
  2-replica plane and the autoscaled elastic plane (warm spin-up from
  the residency host tier, checkpoint resume, drain by migration): the
  static plane sheds, the elastic one serves everything at strictly
  higher attainment; ``elastic_slo_attainment``,
  ``goodput_per_replica_round``.

Every leg's sequences are held against the standalone ``paged_generate``
(with each request's key when sampled) before any number is believed:
exact in f32; on the card in bf16 a divergence passes only at a
top-1/top-2 gap below ``serve_app.TIE_TOL``. The plane row FITS its
bucket ladder to the stream's prompt lengths and it must pad no worse
than the default ladder.

On one card, ``--migration dma`` puts the two replicas on two logical
ranks of it (:class:`~hpc_patterns_tpu_torch.topology.LogicalDevice`),
sharing the weights: the handoff is kernel 13's copy within the card's
memory, not a transfer between cards, and the row says so.

    python -m hpc_patterns_tpu_torch.bench_serving --device cpu --smoke
    python -m hpc_patterns_tpu_torch.bench_serving --scenario --smoke \\
        --device cpu
    python -m hpc_patterns_tpu_torch.bench_serving --plane --migration dma
    python -m hpc_patterns_tpu_torch.bench_serving --plane --migration dma \\
        --device cpu [--smoke] [--kv-dtype int8]
    python -m hpc_patterns_tpu_torch.bench_serving --fit --smoke \\
        --device cpu [--fit-out fitted.json] [--autofit fitted.json]
    python -m hpc_patterns_tpu_torch.bench_serving --offload [--smoke] \\
        [--device cpu]
    python -m hpc_patterns_tpu_torch.bench_serving --shared [--smoke] \\
        [--device cpu]
    python -m hpc_patterns_tpu_torch.bench_serving --slo-budget \\
        [--device cpu] [--explain]

    python -m hpc_patterns_tpu_torch.bench_serving --quant [--smoke] \
        [--device cpu] [--kv-dtype int8|fp8] [--quant-weights]
    python -m hpc_patterns_tpu_torch.bench_serving --elastic [--smoke] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from hpc_patterns_tpu_torch.apps.serve_app import static_batching
from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.harness import budget as budgetlib
from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import explain as explainlib
from hpc_patterns_tpu_torch.harness import loadgen
from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib
from hpc_patterns_tpu_torch.harness import slo
from hpc_patterns_tpu_torch.harness.cli import (
    add_explain_args,
    add_kv_dtype_arg,
    add_serving_args,
    explain_enabled,
    parse_buckets,
    resolve_kv_cache_dtype,
)
from hpc_patterns_tpu_torch.models.decode import paged_generate, sample_key
from hpc_patterns_tpu_torch.models.serving import (
    ContinuousBatcher,
    EngineCore,
    bucket_ladder,
    expected_padding,
    fit_bucket_ladder,
    pad_to_bucket,
    prefill_ladder,
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


def _model(device, *, gpu: bool, max_seq: int | None = None):
    """The benchmark's model: on the card the chip model (vocab 32768,
    d_model 1024, 8 heads of 128, 8 layers, d_ff 4096, bf16, flash
    decode), on the CPU the smoke model (vocab 256, d_model 256, 4 heads,
    2 layers, d_ff 1024, f32, gather); random weights from seed 0."""
    cfg = TransformerConfig(
        vocab=32768 if gpu else 256,
        d_model=1024 if gpu else 256,
        n_heads=8 if gpu else 4,
        n_layers=8 if gpu else 2,
        d_ff=4096 if gpu else 1024,
        max_seq=max_seq or (1024 if gpu else 256),
        dtype="bfloat16" if gpu else "float32",
        decode_attn="flash" if gpu else "gather")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, generator=gen, device=device,
                            dtype=torch_dtype(cfg.dtype))


def _sync(dev):
    return ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))


def _standalone(params, cfg, prompt, max_new, *, page_size, device,
                key=None, temperature=0.0, top_k=0):
    toks, margins = paged_generate(
        params, torch.from_numpy(prompt)[None, :], cfg, max_new,
        page_size=page_size, device=device, with_margins=True, key=key,
        temperature=temperature, top_k=top_k)
    return toks[0].cpu().numpy(), margins[0].cpu().numpy()


def _held(got, want, margins, tol, label):
    v = tie_aware_compare(got, want, margins, tol)
    if v == "mismatch":
        raise AssertionError(f"{label}: engine {np.asarray(got)[:8]} vs "
                             f"standalone {want[:8]}")
    return v


# ------------------------------------------------------------ base row

def smoke_config(device=None):
    """The CI shape (JAX ``smoke_config``): the smoke model, 16 requests,
    4 slots, chunk 16, page 16, prompts up to 32, budgets up to 192 — big
    enough that static batching's padding and fragmentation outweigh the
    engine's host work; two timed repetitions, min taken (the shield
    against a loaded host)."""
    dev = resolve_device(device)
    cfg, params = _model(dev, gpu=False)
    return dict(n=16, slots=4, chunk=16, page_size=16, prompt_len=32,
                max_budget=192, reps=2, cfg=cfg, params=params, device=dev)


def full_config(device=None):
    """The re-grounding shape: on the card the chip model, 32 requests,
    8 slots, chunk 16, page 256, prompts up to 512, budgets up to 512; on
    the CPU the smoke shape's model at 16 requests."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    prompt_len, max_budget = (512, 512) if gpu else (32, 192)
    cfg, params = _model(dev, gpu=gpu, max_seq=prompt_len + max_budget)
    return dict(n=32 if gpu else 16, slots=8 if gpu else 4, chunk=16,
                page_size=256 if gpu else 16, prompt_len=prompt_len,
                max_budget=max_budget, reps=1, cfg=cfg, params=params,
                device=dev)


def bench_requests(n, prompt_len, max_budget, vocab, mix=True):
    """The base row's stream (``RandomState(7)``): prompt lengths 1/2,
    3/4 or 1x of ``prompt_len`` (``mix``), long-tail budgets 1/8, 1/4 or
    1x of ``max_budget`` at 0.5/0.3/0.2."""
    rng = np.random.RandomState(7)
    lengths = ([prompt_len // 2, (3 * prompt_len) // 4, prompt_len]
               if mix else [prompt_len])
    reqs = []
    for _ in range(n):
        t = int(rng.choice(lengths))
        prompt = rng.randint(0, vocab, size=t).astype(np.int32)
        budget = int(rng.choice([max(1, max_budget // 8),
                                 max(1, max_budget // 4), max_budget],
                                p=[0.5, 0.3, 0.2]))
        reqs.append((prompt, budget))
    return reqs


def run_bench(*, n, slots, chunk, page_size, prompt_len, max_budget, cfg,
              params, mix=True, buckets="auto", overlap=True,
              temperature=0.0, top_k=0, seed=0, reps=1, quiet=False,
              device=None):
    """One engine-vs-static comparison; returns JAX's result keys.
    ``buckets``: 'auto', 'none', comma-separated rungs or a tuple.
    ``reps``: timed repetitions per mode, min taken. The engine's rows are
    held against the standalone (each request's key when sampled), the
    greedy static rows too, and the engine's distinct prefill rungs
    against the ladder, before any number returns."""
    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    if isinstance(buckets, str):
        buckets = parse_buckets(buckets, prompt_len)
    reqs = bench_requests(n, prompt_len, max_budget, cfg.vocab, mix)
    total_tokens = sum(b for _, b in reqs)
    pages_per_seq = max(
        ContinuousBatcher.pages_needed(len(p), b, page_size,
                                       padded_len=pad_to_bucket(buckets,
                                                                len(p)))
        for p, b in reqs)
    sync = _sync(dev)
    skw = dict(slots=slots, page_size=page_size, device=dev,
               temperature=temperature, top_k=top_k, seed=seed)

    def run_engine():
        eng = ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=slots * pages_per_seq,
            pages_per_seq=pages_per_seq, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, overlap=overlap,
            temperature=temperature, top_k=top_k, seed=seed, device=dev)
        ids = [eng.submit(p, b) for p, b in reqs]
        got = eng.run()
        sync()
        return {i: got[sid] for i, sid in enumerate(ids)}, eng

    static_batching(params, cfg, reqs, **skw)  # warm-up
    run_engine()
    t_static = t_engine = float("inf")
    bubble = None
    for _ in range(reps):
        t0 = time.perf_counter()
        static_out = static_batching(params, cfg, reqs, **skw)
        sync()
        t_static = min(t_static, time.perf_counter() - t0)
        t0 = time.perf_counter()
        engine_out, eng = run_engine()
        te = time.perf_counter() - t0
        if te < t_engine:
            # the bubble of the rep whose time is reported
            t_engine, bubble = te, eng.last_bubble_frac

    tol = TIE_TOL[cfg.dtype]
    sampled = temperature > 0
    for i, (p, b) in enumerate(reqs):
        want, margins = _standalone(
            params, cfg, p, b, page_size=page_size, device=dev,
            key=eng.request_key(i) if sampled else None,
            temperature=temperature, top_k=top_k)
        _held(engine_out[i], want, margins, tol, f"engine seq {i}")
        if not sampled:
            k = len(static_out[i])
            _held(static_out[i], want[:k], margins[:k], tol,
                  f"static seq {i}")
    compiles = len(eng.prefill_rungs)
    if buckets is not None:
        assert compiles <= len(buckets), (
            f"{compiles} prefill shapes > ladder size {len(buckets)}")
    distinct = len({len(p) for p, _ in reqs})
    out(f"serving[{'mixed' if mix else 'uniform'}, {dev}]: n={n} "
        f"slots={slots} chunk={chunk} prompt<={prompt_len} ({distinct} "
        f"lengths) budgets<={max_budget} tokens={total_tokens} "
        f"buckets={buckets if buckets else 'off'} "
        f"overlap={'on' if overlap else 'off'}"
        + (f" temperature={temperature} top_k={top_k}" if sampled else ""))
    out(f"  static  : {t_static:.3f}s  "
        f"{total_tokens / t_static:,.1f} tok/s")
    out(f"  engine  : {t_engine:.3f}s  {total_tokens / t_engine:,.1f} "
        f"tok/s  bubble {bubble:.1%}  prefill shapes {compiles}"
        f"{f' (ladder {len(buckets)})' if buckets else ''}")
    out(f"  engine/static speedup: {t_static / t_engine:.3f}x "
        "(every engine row on its standalone)")
    return {
        "t_static": t_static, "t_engine": t_engine,
        "tokens": total_tokens,
        "tokens_per_s_static": total_tokens / t_static,
        "tokens_per_s_engine": total_tokens / t_engine,
        "speedup": t_static / t_engine,
        "bubble_frac": bubble,
        "prefill_compiles": compiles,
        "ladder": len(buckets) if buckets else None,
        "distinct_lengths": distinct,
    }


# ------------------------------------------------------------ scenario row

#: the staged scenario's progress clock: schedule seconds a service
#: round. The smoke engine's unloaded round on an 8-core x86 CPU at one
#: thread took 26-29 ms (44 rounds in 1.1-1.3 s of its engine leg);
#: rounded up, so the interactive wave lands no later in rounds than on
#: that host, where it preempts twice (a clock of 0.025 s would
#: preempt once)
SCENARIO_ROUND_S = 0.03


def scenario_smoke_config(device=None, *, chip: bool = False):
    """The staged chaos scenario (JAX ``scenario_smoke_config``): two long
    batch rows take the pool at t=0, then an interactive wave that cannot
    get pages without evicting a batch row, a third batch row
    interleaved, and two seeded engine stalls. The pool (25 pages of 16:
    the two batch rows' 12 each plus one) forces the preemption whatever
    the host's speed. The arrivals run on the engine's progress clock,
    :data:`SCENARIO_ROUND_S` a service round (JAX's run on the wall
    clock): the same rounds admit, stall and preempt on any host, so a
    loaded host slows the engine leg as it slows static batching and no
    more. ``chip``: the chip model's widths (the schedule, pool, ladder
    and clock unchanged)."""
    dev = resolve_device(device)
    cfg, params = _model(dev, gpu=chip)
    inter, batch = SCENARIO_CLASSES
    schedule = loadgen.staged_schedule([
        (0.00, batch, 32, 160),
        (0.00, batch, 32, 160),
        (0.05, inter, 16, 16),
        (0.10, batch, 32, 160),
        (0.15, inter, 16, 24),
        (0.20, inter, 16, 16),
        (0.25, inter, 16, 24),
        (0.30, inter, 16, 16),
    ], spec={"name": "smoke-chaos"})
    return dict(cfg=cfg, params=params, page_size=16, slots=3, chunk=8,
                schedule=schedule, classes=SCENARIO_CLASSES,
                pool_pages=25, pages_per_seq=12,
                buckets=bucket_ladder(192),
                chaos_spec="stall:at=3,delay_ms=50;stall:at=9,delay_ms=50",
                # off in the smoke: its pool is sized to the page for the
                # preemption trigger, and a reserve would reorder the
                # staged admissions
                admit_highwater=1.0, arrival_round_s=SCENARIO_ROUND_S,
                device=dev)


def scenario_full_config(device=None):
    """The re-grounding shape (JAX ``scenario_full_config``): a seeded
    BURSTY open-loop stream of 32 requests at 16 rps (burst x8, seed 7)
    over the two classes, prompts 1/2 and 1x of the top, budgets 1/8,
    1/2 and 1x at 0.5/0.3/0.2, a pool of 2.5 widest rows, the high-water
    mark at 0.95 and a stall every 12 rounds from round 5. On the card:
    the chip model, page 256, 8 slots, prompts 64/128, budgets
    32/128/256; on the CPU the smoke model, page 16, 4 slots, prompts
    16/32, budgets 16/64/128."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    cfg, params = _model(dev, gpu=gpu)
    prompt_top = 128 if gpu else 32
    budget_top = 256 if gpu else 128
    schedule = loadgen.make_schedule(
        32, rate_rps=16.0, classes=SCENARIO_CLASSES,
        prompt_lens=(prompt_top // 2, prompt_top),
        budgets=(budget_top // 8, budget_top // 2, budget_top),
        budget_probs=(0.5, 0.3, 0.2), process="bursty", seed=7,
        burst_factor=8.0, mean_quiet_s=0.5, mean_burst_s=0.2)
    page = 256 if gpu else 16
    pps = ContinuousBatcher.pages_needed(prompt_top, budget_top, page,
                                         padded_len=prompt_top)
    return dict(cfg=cfg, params=params, page_size=page,
                slots=8 if gpu else 4, chunk=16, schedule=schedule,
                classes=SCENARIO_CLASSES, pool_pages=int(2.5 * pps),
                pages_per_seq=pps,
                buckets=bucket_ladder(prompt_top + budget_top),
                chaos_spec="stall:at=5,delay_ms=80,every=12",
                admit_highwater=0.95, device=dev)


def run_scenario(*, cfg, params, schedule, classes, page_size, slots,
                 chunk, pool_pages, pages_per_seq, buckets,
                 chaos_spec=None, admit_highwater=0.95, quiet=False,
                 explain=False, explain_out=None, arrival_round_s=None,
                 log=None, device=None):
    """One robustness row: the open-loop schedule through (a) clean static
    batching (closed loop, arrival order) and (b) the engine with priority
    admission, preemption and resume, SLO accounting and the seeded chaos
    faults active, under the request trace. Every served sequence,
    preempted-and-resumed ones included, is held against its standalone
    first, and the trace must cover >= 95% of the finished requests'
    wall time. Returns JAX's result keys: the attribution digest's
    ``ttft_p99_queue_share`` and ``tpot_p99_stall_share``
    (``harness/explain.py``) and the count of segment-budget breaches
    (``harness/budget.py``) among them. ``explain``: also print the
    attribution table and the budget section; ``explain_out``: write the
    digest JSON there. ``arrival_round_s``: the engine leg's arrival
    clock (``ContinuousBatcher.run(round_s=)``; None: the wall clock).
    ``log``: a RunLog path that gets the timed leg's ``kind=reqtrace``
    record and one ``kind=slo_budget`` record a breach
    (``budget.publish``), for ``harness/explain.py`` and ``report``."""
    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    sync = _sync(dev)
    rng = np.random.RandomState(13)
    prompts = {r.index: rng.randint(0, cfg.vocab, size=r.prompt_len)
               .astype(np.int32) for r in schedule.requests}
    total_tokens = sum(r.max_new for r in schedule.requests)
    targets = slo.targets_from_classes(classes)
    reqs = [(prompts[r.index], r.max_new) for r in schedule.requests]

    def run_engine():
        eng = ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=pool_pages,
            pages_per_seq=pages_per_seq, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, preempt=True,
            admit_highwater=admit_highwater, slo=targets, device=dev)
        arrivals = [(r.t_arrival_s,
                     dict(prompt=prompts[r.index], max_new=r.max_new,
                          seq_id=r.index, priority=r.priority,
                          deadline_s=r.deadline_s))
                    for r in schedule.requests]
        got = eng.run(arrivals=arrivals, round_s=arrival_round_s)
        sync()
        return got, eng

    skw = dict(slots=slots, page_size=page_size, device=dev)
    # warm-up with the faults off, then the timed legs: the engine leg
    # runs under the seeded faults, static runs clean
    static_batching(params, cfg, reqs, **skw)
    run_engine()
    t0 = time.perf_counter()
    static_out = static_batching(params, cfg, reqs, **skw)
    sync()
    t_static = time.perf_counter() - t0
    chaoslib.configure(chaos_spec)  # also clears the injection log
    # the request trace is on for the timed leg (a fresh recorder: the
    # warm-up reused the seq ids)
    reqtracelib.configure(enabled=True)
    try:
        t0 = time.perf_counter()
        engine_out, eng = run_engine()
        t_engine = time.perf_counter() - t0
        stalls = [e for e in chaoslib.injections()
                  if e["site"] == "engine_round"]
        req_snap = reqtracelib.active().snapshot(eng.stats)
    finally:
        chaoslib.reset()
        reqtracelib.reset()

    tol = TIE_TOL[cfg.dtype]
    verdicts = {"exact": 0, "near_tie": 0}
    for r in schedule.requests:
        if eng.stats[r.index]["outcome"] != "ok":
            continue  # shed: empty output by contract
        want, margins = _standalone(params, cfg, prompts[r.index],
                                    r.max_new, page_size=page_size,
                                    device=dev)
        verdicts[_held(engine_out[r.index], want, margins, tol,
                       f"engine seq {r.index}")] += 1
        k = len(static_out[r.index])
        _held(static_out[r.index], want[:k], margins[:k], tol,
              f"static seq {r.index}")
    compiles = len(eng.prefill_rungs)
    assert compiles <= len(buckets), (
        f"{compiles} prefill shapes > ladder {len(buckets)}: resumed "
        "prompts left the bucket ladder")
    # tail attribution over the timed leg; the coverage invariant is
    # enforced here: a missing stamp site leaks untracked time
    dig = explainlib.digest([req_snap])
    cover = dig["coverage_frac"]
    assert cover >= 0.95, (
        f"request-trace coverage {cover:.3f} < 0.95: a stamp site is "
        "missing")
    # did any ONE lifecycle segment alone blow a class's target?
    breaches = budgetlib.evaluate(req_snap, targets)
    if log is not None:
        from hpc_patterns_tpu_torch.harness.runlog import RunLog

        runlog = RunLog(log, truncate=False)
        runlog.emit(kind="reqtrace", **req_snap)
        budgetlib.publish(breaches, emit=runlog.emit)
    rep = eng.last_slo
    tot = rep["total"]
    served_tokens = tot["tokens"]
    result = {
        "t_static": t_static, "t_engine": t_engine,
        "tokens": total_tokens, "served_tokens": served_tokens,
        "tokens_per_s_static": total_tokens / t_static,
        "tokens_per_s_engine": served_tokens / t_engine,
        "speedup": (served_tokens / t_engine) / (total_tokens / t_static),
        "goodput_tok_s": tot["goodput_tok_s"] * eng._serve_s / t_engine
        if eng._serve_s else 0.0,
        "attained_frac": tot["attained_frac"],
        "preemptions": tot["preemptions"], "shed": tot["shed"],
        "bubble_frac": eng.last_bubble_frac,
        "stall_injections": len(stalls),
        "stall_injected_s": sum(e["delay_s"] for e in stalls),
        "prefill_compiles": compiles, "ladder": len(buckets),
        "attribution_coverage_frac": cover,
        "ttft_p99_queue_share": dig["ttft_p99_queue_share"],
        "tpot_p99_stall_share": dig["tpot_p99_stall_share"],
        "budget_breaches": len(breaches),
        "schedule": schedule.spec,
        "oracle": verdicts, "admissions": eng.admissions,
        "decode_steps": eng.decode_steps,
    }
    out(f"scenario[{schedule.spec.get('process', schedule.spec.get('name', '?'))}, "
        f"{dev}]: n={schedule.n} slots={slots} chunk={chunk} "
        f"pool={pool_pages}p tokens={total_tokens} "
        f"chaos={chaos_spec or 'off'}")
    out(f"  static  : {t_static:.3f}s  "
        f"{result['tokens_per_s_static']:,.1f} tok/s (clean)")
    out(f"  engine  : {t_engine:.3f}s  "
        f"{result['tokens_per_s_engine']:,.1f} tok/s  goodput "
        f"{result['goodput_tok_s']:,.1f} tok/s  bubble "
        f"{result['bubble_frac']:.1%}  preempted {result['preemptions']}  "
        f"shed {result['shed']}  stalls {result['stall_injections']} "
        f"(+{result['stall_injected_s'] * 1e3:.0f}ms)")
    out(f"  engine/static speedup under chaos: {result['speedup']:.3f}x "
        f"(oracle {verdicts}, resumed rows included)")
    out("  " + slo.format_slo(rep).replace("\n", "\n  "))
    if explain:
        out("  " + explainlib.format_explain(dig).replace("\n", "\n  "))
        out("  " + budgetlib.format_budget(breaches).replace("\n", "\n  "))
    if explain_out:
        from pathlib import Path

        Path(explain_out).write_text(json.dumps(dig) + "\n")
        out(f"  explain digest -> {explain_out}")
    return result


# ------------------------------------------------------------ tiered rows

def offload_smoke_config(device=None):
    """The CI tiered-memory shape (JAX ``offload_smoke_config``): the
    smoke model, an HBM pool capped at half the stream's working set (real
    eviction by construction, asserted), a deterministic cold-after-2
    rotation and a host pool big enough for everything paged out."""
    base = smoke_config(device)
    return dict(cfg=base["cfg"], params=base["params"], n=8, slots=4,
                chunk=16, page_size=16, prompt_len=32, max_budget=96,
                hbm_frac=0.5, cold_n=2, device=base["device"])


def offload_full_config(device=None):
    """The re-grounding shape (JAX ``offload_full_config``): on the card
    the chip model, 24 requests, 8 slots, chunk 16, page 256, prompts to
    256, budgets to 512, the HBM pool at 0.4 of the working set,
    cold-after-3; on the CPU the smoke model at 8 requests, 4 slots, page
    16, prompts to 32, budgets to 128."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    cfg, params = _model(dev, gpu=gpu)
    return dict(cfg=cfg, params=params, n=24 if gpu else 8,
                slots=8 if gpu else 4, chunk=16,
                page_size=256 if gpu else 16,
                prompt_len=256 if gpu else 32,
                max_budget=512 if gpu else 128, hbm_frac=0.4, cold_n=3,
                device=dev)


def run_offload(*, cfg, params, n, slots, chunk, page_size, prompt_len,
                max_budget, hbm_frac, cold_n, quiet=False, device=None):
    """The tiered-memory row (JAX ``run_offload``): the same stream through
    (a) an all-HBM engine (the pool holds the whole working set: the
    baseline and the oracle) and (b) an engine whose pool is capped at
    ``hbm_frac`` of that, fronting a host pool through the residency
    manager (``memory/``): cold rows page out at chunk boundaries, swapped
    rows prefetch back with the pull dispatched before the decode chunk.
    Before any number: every tiered sequence equals the all-HBM one
    (counted ``tiered_vs_full``) and both are held against the standalone
    (exact in f32; on the card a divergence only at a near-tie), and the
    cap forced real paging. Reports ``offload_goodput_tok_s`` and
    ``prefetch_overlap_frac`` beside JAX's other keys."""
    from hpc_patterns_tpu_torch.memory import (
        ColdAfterNPolicy,
        ResidencyManager,
    )

    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    sync = _sync(dev)
    rng = np.random.RandomState(7)
    lengths = [prompt_len // 2, (3 * prompt_len) // 4, prompt_len]
    reqs = []
    for _ in range(n):
        t = int(rng.choice(lengths))
        prompt = rng.randint(0, cfg.vocab, size=t).astype(np.int32)
        budget = int(rng.choice(
            [max(1, max_budget // 2), max_budget], p=[0.4, 0.6]))
        reqs.append((prompt, budget))
    total_tokens = sum(b for _, b in reqs)
    buckets = bucket_ladder(prompt_len)
    targets = slo.targets_from_classes(SCENARIO_CLASSES)
    pages_per_seq = max(
        ContinuousBatcher.pages_needed(len(p), b, page_size,
                                       padded_len=pad_to_bucket(buckets,
                                                                len(p)))
        for p, b in reqs)
    full_pool = slots * pages_per_seq
    hbm_pool = max(pages_per_seq, int(full_pool * hbm_frac))
    assert hbm_pool < full_pool, (
        f"hbm_frac {hbm_frac} does not constrain the pool ({hbm_pool} vs "
        f"{full_pool}): nothing would evict")

    def serve(pool, mgr=None):
        eng = ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=pool,
            pages_per_seq=pages_per_seq, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, slo=targets, residency=mgr, device=dev)
        ids = [eng.submit(p, b) for p, b in reqs]
        got = eng.run()
        sync()
        return {i: got[s] for i, s in enumerate(ids)}, eng

    def manager():
        return ResidencyManager(host_blocks=2 * full_pool,
                                policy=ColdAfterNPolicy(cold_n), device=dev)

    # warm-up, then the timed legs
    serve(full_pool)
    serve(hbm_pool, manager())
    t0 = time.perf_counter()
    full_out, full_eng = serve(full_pool)
    t_full = time.perf_counter() - t0
    mgr = manager()
    t0 = time.perf_counter()
    tier_out, tier_eng = serve(hbm_pool, mgr)
    t_tier = time.perf_counter() - t0

    # the oracle before any number, and the cap really made the tier work
    tol = TIE_TOL[cfg.dtype]
    verdicts = {"full": {"exact": 0, "near_tie": 0},
                "tiered": {"exact": 0, "near_tie": 0},
                "tiered_vs_full": {"exact": 0, "differ": 0}}
    for i, (prompt, b) in enumerate(reqs):
        want, margins = _standalone(params, cfg, prompt, b,
                                    page_size=page_size, device=dev)
        verdicts["full"][_held(full_out[i], want, margins, tol,
                               f"all-HBM seq {i}")] += 1
        verdicts["tiered"][_held(tier_out[i], want, margins, tol,
                                 f"tiered seq {i}")] += 1
        verdicts["tiered_vs_full"][
            "exact" if np.array_equal(tier_out[i], full_out[i])
            else "differ"] += 1
    assert mgr.swap_outs > 0 and mgr.swap_ins > 0, (
        f"HBM cap {hbm_pool}/{full_pool} pages forced no paging: the row "
        "measured nothing")

    tot_full = full_eng.last_slo["total"]
    tot_tier = tier_eng.last_slo["total"]
    overlap = mgr.prefetch_overlap_frac or 0.0
    result = {
        "t_full": t_full, "t_tiered": t_tier, "tokens": total_tokens,
        "tokens_per_s_full": total_tokens / t_full,
        "tokens_per_s_tiered": total_tokens / t_tier,
        "full_goodput_tok_s": tot_full["goodput_tok_s"]
        * full_eng._serve_s / t_full if t_full > 0 else 0.0,
        "offload_goodput_tok_s": tot_tier["goodput_tok_s"]
        * tier_eng._serve_s / t_tier if t_tier > 0 else 0.0,
        "prefetch_overlap_frac": overlap,
        "swap_outs": mgr.swap_outs, "swap_ins": mgr.swap_ins,
        "prefetch_bytes": mgr.prefetch_bytes,
        "evict_bytes": mgr.evict_bytes,
        "hbm_pool": hbm_pool, "full_pool": full_pool,
        "bubble_frac": tier_eng.last_bubble_frac,
        "oracle": verdicts,
    }
    out(f"offload[{dev}]: n={n} slots={slots} chunk={chunk} "
        f"hbm={hbm_pool}p of {full_pool}p working set "
        f"(host pool {2 * full_pool}p) tokens={total_tokens}")
    out(f"  all-HBM : {t_full:.3f}s  "
        f"{result['tokens_per_s_full']:,.1f} tok/s  "
        f"goodput {result['full_goodput_tok_s']:,.1f}")
    out(f"  tiered  : {t_tier:.3f}s  "
        f"{result['tokens_per_s_tiered']:,.1f} tok/s  "
        f"goodput {result['offload_goodput_tok_s']:,.1f}  "
        f"swaps {mgr.swap_outs}/{mgr.swap_ins}  "
        f"prefetch overlap {overlap:.1%}")
    out(f"  capacity {t_full / t_tier:.3f}x wall cost for "
        f"{full_pool / hbm_pool:.1f}x pool oversubscription "
        f"(oracle {verdicts})")
    return result


def slo_budget_smoke_config(device=None):
    """The segment-budget shape (JAX ``slo_budget_smoke_config``, one
    shape on every device): a deliberately tiny model (vocab 64, d_model
    32, 2 heads, 2 layers, f32, gather; random weights from seed 5) on a
    5-request stream through a 2-resident tiered pool with a seeded
    ``slow_host_transfer`` — every pull eats a known delay, so the decode
    stall is injected into ONE mechanism and the budget must blame it."""
    dev = resolve_device(device)
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                            d_ff=64, max_seq=128, dtype="float32",
                            decode_attn="gather")
    gen = torch.Generator(device=dev).manual_seed(5)
    params = init_params(cfg, generator=gen, device=dev)
    return dict(cfg=cfg, params=params, n=5, prompt_len=8, max_budget=24,
                page_size=8, chunk=4, slots=5, hbm_seqs=2, cold_n=2,
                delay_ms=60, ttft_slo_s=5.0, tpot_slo_s=0.08, device=dev)


#: the seeded-stall budget (JAX's): prefetch_wait may eat 2% of the decode
#: allowance (0.02 * 0.08 s * 23 tokens ~ 37 ms, less than one 60 ms
#: injected transfer delay); every other segment most of the target
SLO_BUDGET_SEEDED = budgetlib.SLOBudget(
    ttft_shares={"queued": 0.9, "admit_wait": 0.9, "untracked": 0.5},
    tpot_shares={"prefetch_wait": 0.02, "swapped_out": 0.9,
                 "preempted": 0.9, "migrating": 0.9, "untracked": 0.5},
)


def _stall_prompts(n, prompt_len, vocab):
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab, size=prompt_len).astype(np.int32)
            for _ in range(n)]


def _tiered_stall_leg(*, cfg, params, n, prompt_len, max_budget,
                      page_size, chunk, slots, hbm_seqs, cold_n,
                      delay_ms, prefetch_depth=None,
                      min_resident_rounds=1, emit=None, device=None):
    """One tiered stream under a seeded ``slow_host_transfer`` with the
    request trace on: a pool for ``hbm_seqs`` of the ``n``-row working set
    forces the cold-after-N rotation to page, and every pull eats the
    delay. Returns ``(outs, eng, mgr, snapshot, fired)`` — the chassis of
    the ``--slo-budget`` row and the ``--fit`` blame A/B."""
    from hpc_patterns_tpu_torch.memory import (
        ColdAfterNPolicy,
        ResidencyManager,
    )

    dev = resolve_device(device)
    pps = ContinuousBatcher.pages_needed(prompt_len, max_budget, page_size)
    prompts = _stall_prompts(n, prompt_len, cfg.vocab)
    if delay_ms > 0:
        chaoslib.configure(f"slow_host_transfer:delay_ms={delay_ms}")
    reqtracelib.configure(enabled=True)
    try:
        mgr = ResidencyManager(host_blocks=n * pps,
                               policy=ColdAfterNPolicy(cold_n),
                               min_resident_rounds=min_resident_rounds,
                               prefetch_depth=prefetch_depth, device=dev)
        eng = ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=hbm_seqs * pps,
            pages_per_seq=pps, page_size=page_size, chunk=chunk,
            residency=mgr, emit=emit, device=dev)
        ids = [eng.submit(p, max_budget) for p in prompts]
        got = eng.run()
        _sync(dev)()
        fired = [e for e in chaoslib.injections()
                 if e["site"] == "host_transfer"]
        snap = reqtracelib.active().snapshot(eng.stats)
    finally:
        chaoslib.reset()
        reqtracelib.reset()
    return {i: got[s] for i, s in enumerate(ids)}, eng, mgr, snap, fired


def _stall_oracle(outs, *, cfg, params, n, prompt_len, max_budget,
                  page_size, device, label) -> dict:
    """The stall legs' sequences against their standalone (exact in f32 on
    the CPU; on the card a divergence only at a near-tie)."""
    verdicts = {"exact": 0, "near_tie": 0}
    for i, prompt in enumerate(_stall_prompts(n, prompt_len, cfg.vocab)):
        want, margins = _standalone(params, cfg, prompt, max_budget,
                                    page_size=page_size, device=device)
        verdicts[_held(outs[i], want, margins, TIE_TOL[cfg.dtype],
                       f"{label} seq {i}")] += 1
    return verdicts


def run_slo_budget(*, cfg, params, n, prompt_len, max_budget, page_size,
                   chunk, slots, hbm_seqs, cold_n, delay_ms, ttft_slo_s,
                   tpot_slo_s, quiet=False, explain=False, device=None):
    """The segment-budget row (JAX ``run_slo_budget``): seeded chaos must
    land in the budget bucket it was injected into. A
    ``slow_host_transfer`` run is evaluated against
    :data:`SLO_BUDGET_SEEDED`, and the row ASSERTS the breach set is
    exactly ``{"prefetch_wait"}`` and that the inter-token digest
    attributes a nonzero stall share. Every sequence is held against its
    standalone first (paging and chaos change when tokens arrive, never
    which). Reports ``tpot_p99_stall_share`` and
    ``budget_breach_segments``."""
    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    leg = dict(cfg=cfg, params=params, n=n, prompt_len=prompt_len,
               max_budget=max_budget, page_size=page_size, chunk=chunk,
               slots=slots, hbm_seqs=hbm_seqs, cold_n=cold_n, device=dev)
    # warm-up with the delay off; the judged leg runs seeded
    _tiered_stall_leg(**leg, delay_ms=0)
    t0 = time.perf_counter()
    outs, eng, mgr, snap, fired = _tiered_stall_leg(**leg,
                                                    delay_ms=delay_ms)
    wall = time.perf_counter() - t0

    verdicts = _stall_oracle(outs, cfg=cfg, params=params, n=n,
                             prompt_len=prompt_len, max_budget=max_budget,
                             page_size=page_size, device=dev,
                             label="budget")
    assert mgr.swap_outs > 0 and fired, (
        f"seeded stall row paged nothing (swap_outs={mgr.swap_outs}, "
        f"injections={len(fired)}): the row measured nothing")

    targets = {0: slo.SLOTarget(ttft_s=ttft_slo_s, tpot_s=tpot_slo_s)}
    breaches = budgetlib.evaluate(snap, targets, SLO_BUDGET_SEEDED)
    segs = budgetlib.breached_segments(breaches)
    assert segs == {"prefetch_wait"}, (
        f"seeded slow_host_transfer breached {sorted(segs)}: chaos must "
        "land in the budget bucket it was injected into")
    dig = explainlib.digest([snap])
    assert dig["tpot_p99_stall_share"] > 0.0, (
        "the inter-token digest attributes no stall time to a run whose "
        "every pull was seeded slow")

    result = {
        "wall_s": wall, "n": n, "tokens": n * max_budget,
        "swap_outs": mgr.swap_outs,
        "stall_injections": len(fired),
        "stall_injected_s": sum(e["delay_s"] for e in fired),
        "attribution_coverage_frac": dig["coverage_frac"],
        "tpot_p99_stall_share": dig["tpot_p99_stall_share"],
        "budget_breach_segments": sorted(segs),
        "budget_breaches": len(breaches),
        "oracle": verdicts,
    }
    out(f"slo-budget[{dev}]: n={n} hbm={hbm_seqs}/{n} seqs resident "
        f"chaos=slow_host_transfer:{delay_ms}ms "
        f"targets ttft={ttft_slo_s}s tpot={tpot_slo_s}s")
    out(f"  stream  : {wall:.3f}s  swaps {mgr.swap_outs}  injected "
        f"{result['stall_injected_s'] * 1e3:.0f}ms over {len(fired)} "
        f"pull(s) (oracle {verdicts})")
    out(f"  tpot p99-gap stall share {dig['tpot_p99_stall_share']:.0%}  "
        f"coverage {dig['coverage_frac']:.1%}")
    out("  " + budgetlib.format_budget(breaches).replace("\n", "\n  "))
    if explain:
        out("  " + explainlib.format_explain(dig).replace("\n", "\n  "))
    return result


def shared_smoke_config(device=None):
    """The CI prefix-sharing shape (JAX ``shared_smoke_config``): the
    smoke model on a template-pool + conversation-tree stream (2 templates
    of 32, tails 4/8/12, a quarter of arrivals extending an earlier
    prompt), 16 requests at 200 rps."""
    base = smoke_config(device)
    return dict(cfg=base["cfg"], params=base["params"], n=16, slots=4,
                chunk=8, page_size=16, n_templates=2, template_len=32,
                tail_lens=(4, 8, 12), budgets=(16, 32), tree_frac=0.25,
                rate_rps=200.0, seed=12, device=base["device"])


def shared_full_config(device=None):
    """The re-grounding shape (JAX ``shared_full_config``): on the card the
    chip model on 48 requests at 64 rps, 8 slots, chunk 16, page 256, 3
    templates of 512, tails 16/32/64, budgets 64/128; on the CPU the smoke
    model at 24 requests, 4 slots, page 16, templates of 32. The decode
    route is pinned to ``gather``, as JAX pins it: sharing mirrors the
    plain prefill, and the engine refuses ``flash`` with 128-multiple
    rungs (the ladder here is page multiples)."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    cfg, params = _model(dev, gpu=gpu)
    cfg = dataclasses.replace(cfg, decode_attn="gather")
    return dict(cfg=cfg, params=params, n=48 if gpu else 24,
                slots=8 if gpu else 4, chunk=16,
                page_size=256 if gpu else 16, n_templates=3,
                template_len=512 if gpu else 32,
                tail_lens=(16, 32, 64) if gpu else (4, 8, 12),
                budgets=(64, 128) if gpu else (16, 32), tree_frac=0.25,
                rate_rps=64.0, seed=12, device=dev)


def run_shared(*, cfg, params, n, slots, chunk, page_size, n_templates,
               template_len, tail_lens, budgets, tree_frac, rate_rps,
               seed=12, quiet=False, device=None):
    """The prefix-sharing row (JAX ``run_shared``): one shared-prefix
    open-loop stream (``loadgen.make_shared_prefix_schedule``: template
    pool and conversation-tree turns) served by (a) a private-pages engine
    and (b) the sharing-aware arena (``prefix_cache=True``). Before any
    number both engines are held against the standalone per request, and
    ``prefill_skip_frac`` must exceed 0.3 with a prefix hit. Reports
    ``shared_goodput_tok_s`` and ``prefill_skip_frac``."""
    schedule = loadgen.make_shared_prefix_schedule(
        n, rate_rps=rate_rps, classes=SCENARIO_CLASSES,
        n_templates=n_templates, template_len=template_len,
        tail_lens=tail_lens, budgets=budgets, tree_frac=tree_frac,
        seed=seed)
    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    sync = _sync(dev)
    prompts = {r.index: loadgen.materialize_prompt(schedule, r.index,
                                                   cfg.vocab)
               for r in schedule.requests}
    targets = slo.targets_from_classes(SCENARIO_CLASSES)
    # an ALIGNED ladder (page multiples, which the sharing engine needs
    # aligned to decode.PREFIX_ALIGN): sharing is rung-keyed, so rungs
    # double as sharing scopes
    buckets = tuple(sorted({-(-int(p.size) // page_size) * page_size
                            for p in prompts.values()}))
    pages_per_seq = max(
        ContinuousBatcher.pages_needed(
            len(prompts[r.index]), r.max_new, page_size,
            padded_len=pad_to_bucket(buckets, len(prompts[r.index])))
        for r in schedule.requests)
    pool_pages = slots * pages_per_seq
    total_tokens = sum(r.max_new for r in schedule.requests)
    arrivals = [(r.t_arrival_s, dict(prompt=prompts[r.index],
                                     max_new=r.max_new, seq_id=r.index,
                                     priority=r.priority,
                                     deadline_s=r.deadline_s))
                for r in schedule.requests]

    def run_one(share: bool):
        eng = ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=pool_pages,
            pages_per_seq=pages_per_seq, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, slo=targets, prefix_cache=share,
            device=dev)
        got = eng.run(arrivals=list(arrivals))
        sync()
        return got, eng

    # warm-up and best of 2 (open-loop pacing changes admission grouping
    # run to run): the (time, outputs, engine) triple of one rep
    def best_of(share: bool, reps: int = 2):
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            got, eng = run_one(share)
            dt = time.perf_counter() - t0
            if best is None or dt < best[0]:
                best = (dt, got, eng)
        return best

    run_one(False)
    run_one(True)
    t_priv, priv_out, priv_eng = best_of(False)
    t_shr, shr_out, shr_eng = best_of(True)

    tol = TIE_TOL[cfg.dtype]
    verdicts = {"private": {"exact": 0, "near_tie": 0},
                "shared": {"exact": 0, "near_tie": 0}}
    for r in schedule.requests:
        want, margins = _standalone(params, cfg, prompts[r.index],
                                    r.max_new, page_size=page_size,
                                    device=dev)
        verdicts["private"][_held(priv_out[r.index], want, margins, tol,
                                  f"private seq {r.index}")] += 1
        verdicts["shared"][_held(shr_out[r.index], want, margins, tol,
                                 f"shared seq {r.index}")] += 1
    skip = shr_eng.prefill_skip_frac
    assert skip > 0.3, (
        f"prefill_skip_frac {skip:.3f} <= 0.3 on the template mix: the "
        "radix match is not finding the shared prefixes")
    assert shr_eng._prefix.hits > 0, "no prefix-cache hit fired"

    tot_priv = priv_eng.last_slo["total"]
    tot_shr = shr_eng.last_slo["total"]
    result = {
        "t_private": t_priv, "t_shared": t_shr, "tokens": total_tokens,
        "tokens_per_s_private": total_tokens / t_priv,
        "tokens_per_s_shared": total_tokens / t_shr,
        "private_goodput_tok_s": tot_priv["goodput_tok_s"]
        * priv_eng._serve_s / t_priv if t_priv > 0 else 0.0,
        "shared_goodput_tok_s": tot_shr["goodput_tok_s"]
        * shr_eng._serve_s / t_shr if t_shr > 0 else 0.0,
        "prefill_skip_frac": skip,
        "prefix_hits": shr_eng._prefix.hits,
        "prefix_misses": shr_eng._prefix.misses,
        "ladder": buckets, "pool_pages": pool_pages,
        "bubble_frac": shr_eng.last_bubble_frac,
        "schedule": schedule.spec, "oracle": verdicts,
    }
    out(f"shared-prefix[{dev}, {cfg.decode_attn}]: n={n} slots={slots} "
        f"chunk={chunk} templates={n_templates}x{template_len} "
        f"tree={tree_frac:.0%} pool={pool_pages}p tokens={total_tokens}")
    out(f"  private : {t_priv:.3f}s  "
        f"{result['tokens_per_s_private']:,.1f} tok/s  "
        f"goodput {result['private_goodput_tok_s']:,.1f}")
    out(f"  shared  : {t_shr:.3f}s  "
        f"{result['tokens_per_s_shared']:,.1f} tok/s  "
        f"goodput {result['shared_goodput_tok_s']:,.1f}  skip {skip:.1%}  "
        f"hits {shr_eng._prefix.hits}/"
        f"{shr_eng._prefix.hits + shr_eng._prefix.misses}")
    out(f"  prefill skipped {skip:.1%} of prompt tokens (oracle "
        f"{verdicts})")
    return result


# ------------------------------------------------------------ plane row

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
               slo_targets=None, emit=None, **sampling) -> ServingPlane:
    """A plane of one replica per role; ``placed``: replica i on logical
    rank i of ``device`` (the weights shared), else host-shared (no
    device, so ``device_put`` degrades to the ``local`` passthrough).
    ``emit``: the plane's record sink (``ServingPlane(emit=)``).
    ``sampling``: ``temperature``/``top_k``/``seed`` of every replica."""
    replicas = []
    for i, role in enumerate(roles):
        eng = EngineCore(params, cfg, slots=slots, pool_pages=stream["pool"],
                         pages_per_seq=stream["pages_per_seq"],
                         page_size=page_size, chunk=chunk,
                         prompt_buckets=stream["buckets"], device=device,
                         **sampling)
        replicas.append(Replica(
            eng, name=f"r{i}", role=role,
            device=LogicalDevice(device, i) if placed else None))
    return ServingPlane(replicas, slo=slo_targets, migration=migration,
                        emit=emit)


class Oracle:
    """Each request's standalone ``paged_generate`` (computed once: it
    depends only on prompt, budget and, sampled, the request's key) and
    the tie-aware verdicts of served outputs against it. ``sampling``:
    the engines' ``temperature``/``top_k``/``seed``; request ``i``'s key
    is then ``sample_key(seed, i)``, the engine's ``request_key(i)`` of a
    plane that numbered the requests in schedule order."""

    def __init__(self, stream: dict, *, cfg, params, page_size, device,
                 **sampling):
        self.stream, self.cfg, self.params = stream, cfg, params
        self.page_size, self.device = page_size, device
        self.sampling = sampling
        self.tol = TIE_TOL[cfg.dtype]
        self._want: dict = {}

    def want(self, i: int):
        hit = self._want.get(i)
        if hit is None:
            r = self.stream["schedule"].requests[i]
            kw = {}
            if self.sampling.get("temperature", 0.0) > 0:
                kw = dict(key=sample_key(self.sampling.get("seed", 0), i),
                          temperature=self.sampling["temperature"],
                          top_k=self.sampling.get("top_k", 0))
            hit = self._want[i] = _standalone(
                self.params, self.cfg, self.stream["prompts"][i], r.max_new,
                page_size=self.page_size, device=self.device, **kw)
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


#: the plane row's sampled leg: every replica samples at this temperature
#: and top-k from keys of this seed
PLANE_SAMPLING = dict(temperature=0.8, top_k=50, seed=0)


def run_plane(*, cfg, params, n, slots, chunk, page_size, prompt_len,
              max_budget, rate_rps, seed=11, place_on_devices=False,
              migration="device_put", device=None, quiet=False,
              oracle: Oracle | None = None,
              sampled_oracle: Oracle | None = None, emit=None):
    """The serving-plane row (see the module docstring). ``dma`` forces
    placement on logical ranks (the exchange needs a reachable pair).
    The sampled leg: the same requests closed-loop (submitted up front,
    numbered in schedule order) through a sampling 1p/1d plane
    (:data:`PLANE_SAMPLING`) over the same transport, each against its
    standalone with its key. Returns JAX's result keys: the legs' wall
    times and goodputs,
    ``kv_migration_overlap_frac``, ``dma_migration_overlap_frac``,
    ``migration_bytes_per_round``, the transports, the ladders, and
    ``placement_shares_host`` (True: the replicas are logical ranks of
    one card) — plus the oracle verdicts. ``oracle``/``sampled_oracle``:
    :class:`Oracle` s of this stream (the second with
    :data:`PLANE_SAMPLING`) to reuse: their standalone runs are cached.
    ``emit``:
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
    splane = make_plane(stream, ["prefill", "decode"], **geom,
                        migration=migration, device=dev, placed=placed,
                        **PLANE_SAMPLING)
    t0 = time.perf_counter()
    sids = {r.index: splane.submit(stream["prompts"][r.index], r.max_new,
                                   priority=r.priority)
            for r in stream["schedule"].requests}
    sgot = splane.run()
    sync()
    t_sampled = time.perf_counter() - t0
    assert all(rid == i for i, rid in sids.items())
    if oracle is None:
        oracle = Oracle(stream, cfg=cfg, params=params,
                        page_size=page_size, device=dev)
    verdicts = {"single": oracle.check(single_out, "single"),
                "plane": oracle.check(plane_out, "2-replica"),
                "disagg": oracle.check(disagg_out, "1p/1d"),
                "sampled": (sampled_oracle or Oracle(
                    stream, cfg=cfg, params=params, page_size=page_size,
                    device=dev, **PLANE_SAMPLING)).check(
                    sgot, "sampled 1p/1d")}
    assert disagg.migrations > 0, "disaggregated leg migrated nothing"
    assert splane.migrations > 0, "the sampled leg migrated nothing"
    for leg in (plane2, disagg, splane):
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
        "t_sampled": t_sampled,
        "sampled_tok_s": sum(len(v) for v in sgot.values()) / t_sampled,
        "sampled_migrations": splane.migrations,
        "sampled_migration_transports": dict(splane.migration_transports),
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
    out(f"  sampled   : {t_sampled:.3f}s  "
        f"{result['sampled_tok_s']:,.1f} tok/s  closed-loop 1p/1d at "
        f"T {PLANE_SAMPLING['temperature']}, top-k "
        f"{PLANE_SAMPLING['top_k']}, migrations {splane.migrations}")
    out(f"  oracle on every leg (migrated rows included): {verdicts}")
    return result


# ------------------------------------------------------------ autofit row

def fit_smoke_config(device=None):
    """The CI autofit shape (JAX ``fit_smoke_config``): the smoke model
    on a prefill-heavy long-tail stream whose bulk (60%) sits at a prompt
    length the default ladder pads badly (40 -> 64), 16 requests, 4
    slots, chunk 16, page 16, budgets up to 32, two timed repetitions."""
    dev = resolve_device(device)
    cfg, params = _model(dev, gpu=False)
    return dict(cfg=cfg, params=params, n=16, slots=4, chunk=16,
                page_size=16, max_budget=32, reps=2,
                lengths=(16, 40, 64), length_probs=(0.2, 0.6, 0.2),
                device=dev)


def fit_full_config(device=None):
    """The re-grounding shape (JAX ``fit_full_config``): the same length
    mix scaled to the top prompt, 1/4, 5/8 and 1x of it at 0.2/0.6/0.2.
    On the card the chip model, prompts 128/320/512, page 256, 8 slots,
    32 requests, budgets up to 256; on the CPU the smoke model, prompts
    16/40/64, page 16, 4 slots, 16 requests, budgets up to 32."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    cfg, params = _model(dev, gpu=gpu)
    top = 512 if gpu else 64
    return dict(cfg=cfg, params=params, n=32 if gpu else 16,
                slots=8 if gpu else 4, chunk=16,
                page_size=256 if gpu else 16,
                max_budget=256 if gpu else 32, reps=2,
                lengths=(top // 4, (5 * top) // 8, top),
                length_probs=(0.2, 0.6, 0.2), device=dev)


def fit_requests(n, lengths, length_probs, max_budget, vocab):
    """The autofit row's stream (``RandomState(7)``): prompt lengths
    drawn from ``lengths`` at ``length_probs``, budgets 1/8, 1/4 or 1x of
    ``max_budget`` at 0.5/0.3/0.2."""
    rng = np.random.RandomState(7)
    reqs = []
    for _ in range(n):
        t = int(rng.choice(lengths, p=length_probs))
        prompt = rng.randint(0, vocab, size=t).astype(np.int32)
        budget = int(rng.choice([max(1, max_budget // 8),
                                 max(1, max_budget // 4), max_budget],
                                p=[0.5, 0.3, 0.2]))
        reqs.append((prompt, budget))
    return reqs


def run_fitted(*, cfg, params, n, slots, chunk, page_size, max_budget,
               lengths, length_probs, reps=2, autofit_path=None,
               fit_out=None, quiet=False, device=None):
    """The autofit row (JAX ``run_fitted``): one long-tail stream served
    three times.

    1. The recording leg: the default-ladder engine, untimed, its
       records (``serve_admit`` among them) captured to a RunLog JSONL.
    2. ``harness/autofit.py`` fits a FittedConfig from that file through
       the CLI's path (``fit_paths`` -> ``dumps_config`` ->
       ``load_fitted``).
    3. The A/B: the default-ladder engine against
       ``ContinuousBatcher.from_fitted`` on the same stream and pool
       geometry, both warmed, then timed min-of-``reps``.

    The fitted ladder's expected padding must be strictly below the
    default's on the observed lengths, asserted before any clock, and
    every sequence of both legs is held against its standalone (exact in
    f32; on the card a divergence only at a near-tie, ``TIE_TOL``).
    Returns ``fitted_goodput_tok_s`` and ``autofit_gain_frac``
    (default / fitted wall - 1) beside the ladders and paddings.

    4. The blame A/B (JAX ``:2091-2136``): the ``--slo-budget`` chassis
       (a seeded slow host transfer under a thrashing 2-resident tier) is
       recorded (records and request trace), fitted, and re-served under
       the blame-fitted residency (prefetch depth, anti-thrash floor). The
       fitter must blame ``tpot``/``prefetch_wait``, and the blamed
       segment's p99-gap-band share must strictly shrink; both stall legs
       are held against their standalone. Returns the ``blame_*`` keys.

    ``autofit_path``: skip the recording leg and apply an existing
    FittedConfig; ``fit_out``: also write the fitted config there."""
    import os
    import tempfile

    from hpc_patterns_tpu_torch.harness import autofit as autofitlib
    from hpc_patterns_tpu_torch.harness.runlog import RunLog

    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    sync = _sync(dev)
    reqs = fit_requests(n, lengths, length_probs, max_budget, cfg.vocab)
    total_tokens = sum(b for _, b in reqs)
    obs_lengths = [len(p) for p, _ in reqs]
    default_ladder = bucket_ladder(max(obs_lengths))

    def mk_engine(buckets, pages, *, emit=None):
        return ContinuousBatcher(
            params, cfg, slots=slots, pool_pages=slots * pages,
            pages_per_seq=pages, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, emit=emit, device=dev)

    def serve(eng):
        ids = [eng.submit(p, b) for p, b in reqs]
        got = eng.run()
        sync()
        return {i: got[sid] for i, sid in enumerate(ids)}

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "fitted.json")
        if autofit_path is None:
            # the recording leg: the profile run the fitter consumes
            log_path = os.path.join(tmp, "profile.jsonl")
            pages_rec = max(
                ContinuousBatcher.pages_needed(
                    len(p), b, page_size,
                    padded_len=pad_to_bucket(default_ladder, len(p)))
                for p, b in reqs)
            serve(mk_engine(default_ladder, pages_rec,
                            emit=RunLog(log_path).emit))
            with open(cfg_path, "w") as f:
                f.write(autofitlib.dumps_config(
                    autofitlib.fit_paths([log_path])))
        else:
            cfg_path = autofit_path
        # the round trip every consumer uses (CLI parity)
        fitted = autofitlib.load_fitted(cfg_path)
        if fit_out:
            with open(fit_out, "w") as f:
                f.write(autofitlib.dumps_config(fitted))
    fitted_ladder = autofitlib.ladder_from(fitted, max_seq=cfg.max_seq)
    assert fitted_ladder is not None, (
        "the fitted config carries no ladder: the recording leg emitted "
        "no serve_admit records")

    # the deterministic win before any clock
    pad_fit = expected_padding(fitted_ladder, obs_lengths)
    pad_default = expected_padding(default_ladder, obs_lengths)
    assert pad_fit < pad_default, (
        f"fitted ladder {fitted_ladder} does not beat default "
        f"{default_ladder}: E[pad] {pad_fit:.2f} vs {pad_default:.2f}")

    # one pool geometry for both legs (sized for whichever ladder pads a
    # length worse), so the comparison is the ladder alone
    pages_per_seq = max(
        ContinuousBatcher.pages_needed(
            len(p), b, page_size,
            padded_len=max(pad_to_bucket(default_ladder, len(p)),
                           pad_to_bucket(fitted_ladder, len(p))))
        for p, b in reqs)

    def mk_fitted():
        eng = ContinuousBatcher.from_fitted(
            params, cfg, fitted, slots=slots,
            pool_pages=slots * pages_per_seq,
            pages_per_seq=pages_per_seq, page_size=page_size,
            chunk=chunk, device=dev)
        assert eng.prompt_buckets == fitted_ladder, (
            "from_fitted did not apply the fitted ladder")
        return eng

    serve(mk_engine(default_ladder, pages_per_seq))  # warm-up
    serve(mk_fitted())
    t_default = t_fitted = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        default_out = serve(mk_engine(default_ladder, pages_per_seq))
        t_default = min(t_default, time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng = mk_fitted()
        fitted_out = serve(eng)
        t_fitted = min(t_fitted, time.perf_counter() - t0)
    assert len(eng.prefill_rungs) <= len(fitted_ladder), (
        f"{len(eng.prefill_rungs)} prefill shapes > fitted ladder "
        f"{len(fitted_ladder)}")

    # the oracle before any number: the ladder changes padding, never
    # tokens
    tol = TIE_TOL[cfg.dtype]
    verdicts = {"default": {"exact": 0, "near_tie": 0},
                "fitted": {"exact": 0, "near_tie": 0}}
    for i, (prompt, b) in enumerate(reqs):
        want, margins = _standalone(params, cfg, prompt, b,
                                    page_size=page_size, device=dev)
        verdicts["default"][_held(default_out[i], want, margins, tol,
                                  f"default seq {i}")] += 1
        verdicts["fitted"][_held(fitted_out[i], want, margins, tol,
                                 f"fitted seq {i}")] += 1

    # the blame A/B: attribution becomes control
    bcfg = slo_budget_smoke_config(dev)
    bleg = {k: bcfg[k] for k in ("cfg", "params", "n", "prompt_len",
                                 "max_budget", "page_size", "chunk",
                                 "slots", "hbm_seqs", "cold_n", "device")}
    _tiered_stall_leg(**bleg, delay_ms=0)  # warm-up
    blame_records: list = []
    outs_rec, _, _, snap_rec, _ = _tiered_stall_leg(
        **bleg, delay_ms=bcfg["delay_ms"],
        emit=lambda **kw: blame_records.append(kw))
    blame_records.append(dict(snap_rec, kind="reqtrace"))
    bfit = autofitlib.fit(blame_records)
    blame = bfit.get("blame")
    assert blame and blame["axis"] == "tpot" \
        and blame["dominant"] == "prefetch_wait", (
        f"the blame fitter read the seeded decode stall as {blame}: the "
        "injected mechanism must be the one blamed")
    bres = bfit.get("residency") or {}
    outs_bfit, _, _, snap_fit, _ = _tiered_stall_leg(
        **bleg, delay_ms=bcfg["delay_ms"],
        prefetch_depth=bres.get("prefetch_depth"),
        min_resident_rounds=int(bres.get("min_resident_rounds") or 1))
    okw = {k: bcfg[k] for k in ("cfg", "params", "n", "prompt_len",
                                "max_budget", "page_size", "device")}
    verdicts["blame_recorded"] = _stall_oracle(outs_rec, **okw,
                                               label="blame recorded")
    verdicts["blame_fitted"] = _stall_oracle(outs_bfit, **okw,
                                             label="blame fitted")
    blame_share_default = float(blame["share"])
    blame_share_fitted = float(
        (explainlib.digest([snap_fit])["tpot_p99_band_shares"] or {})
        .get("prefetch_wait", 0.0))
    assert blame_share_fitted < blame_share_default, (
        f"the blame-fitted config did not shrink the blamed segment: "
        f"prefetch_wait p99-band share {blame_share_default:.3f} -> "
        f"{blame_share_fitted:.3f}")

    gain = t_default / t_fitted - 1.0
    result = {
        "t_default": t_default, "t_fitted": t_fitted,
        "tokens": total_tokens,
        "default_goodput_tok_s": total_tokens / t_default,
        "fitted_goodput_tok_s": total_tokens / t_fitted,
        "autofit_gain_frac": gain,
        "ladder_default": list(default_ladder),
        "ladder_fitted": list(fitted_ladder),
        "expected_padding_default": pad_default,
        "expected_padding_fitted": pad_fit,
        "blame_segment": blame["dominant"],
        "blame_share_default": blame_share_default,
        "blame_share_fitted": blame_share_fitted,
        "blame_actions": blame.get("actions"),
        "config_sections": sorted(
            k for k in ("ladder", "residency", "placement", "autoscaler",
                        "blame") if fitted.get(k)),
        "oracle": verdicts,
    }
    out(f"autofit[{dev}]: n={n} slots={slots} chunk={chunk} "
        f"lengths={sorted(set(obs_lengths))} tokens={total_tokens} "
        f"({'replayed ' + str(autofit_path) if autofit_path else 'fitted from the recording leg'})")
    out(f"  default : {t_default:.3f}s  "
        f"{result['default_goodput_tok_s']:,.1f} tok/s  ladder "
        f"{list(default_ladder)}  E[pad] {pad_default:.1f}")
    out(f"  fitted  : {t_fitted:.3f}s  "
        f"{result['fitted_goodput_tok_s']:,.1f} tok/s  ladder "
        f"{list(fitted_ladder)}  E[pad] {pad_fit:.1f}")
    out(f"  autofit gain {gain:+.1%} wall clock, E[pad] {pad_default:.1f} "
        f"-> {pad_fit:.1f} tokens/req (oracle {verdicts}, strict padding "
        "win asserted)")
    out(f"  blame   : {blame['axis']}.{blame['dominant']} p99-band share "
        f"{blame_share_default:.0%} -> {blame_share_fitted:.0%} under "
        f"{blame.get('actions')} (strict shrink asserted)")
    return result


# ------------------------------------------------------- quantized row

def quantized_smoke_config(device=None):
    """The CI quantized-decode shape (JAX ``quantized_smoke_config``): the
    smoke model served with an int8 KV pool — 8 requests, 4 slots, chunk
    16, page 16, prompts up to 32, budgets up to 64."""
    base = smoke_config(device)
    return dict(cfg=base["cfg"], params=base["params"], n=8, slots=4,
                chunk=16, page_size=16, prompt_len=32, max_budget=64,
                kv_dtype="int8", device=base["device"])


def quantized_full_config(device=None):
    """The re-grounding shape (JAX ``quantized_full_config``): the
    scenario row's model with the attention-route race on the card — the
    quantized stream once on the gather route and once on
    ``paged_flash`` (kernel 7). On the card the chip model, 24 requests,
    8 slots, page 256, prompts up to 128, budgets up to 256; on the CPU
    the smoke model, 12 requests, 4 slots, page 16, prompts 32, budgets
    96, no race."""
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    cfg, params = _model(dev, gpu=gpu)
    return dict(cfg=cfg, params=params, n=24 if gpu else 12,
                slots=8 if gpu else 4, chunk=16,
                page_size=256 if gpu else 16,
                prompt_len=128 if gpu else 32,
                max_budget=256 if gpu else 96, kv_dtype="int8",
                race_attn=gpu, device=dev)


def run_quantized(*, cfg, params, n, slots, chunk, page_size, prompt_len,
                  max_budget, kv_dtype="int8", quant_weights=False,
                  race_attn=False, quiet=False, device=None):
    """The quantized-decode row (JAX ``run_quantized``): one mixed stream
    served by (a) the compute-dtype baseline engine and (b) an engine
    whose KV pool stores ``kv_dtype`` (int8/fp8 one-byte pages + per-row
    f32 scales; ``quant_weights`` also runs the int8 per-output-channel
    weight path, ``transformer.quantize_weights_int8``).

    Two oracles before any number is believed: every sequence of each
    engine equals its standalone ``paged_generate`` under the same config
    (exactly on the CPU, tie-aware on the card as every row of the port
    is), and the precision law across precisions
    (``models/quantization.precision_law``, checked against its
    bounds) — token identity cannot hold across precisions, so the law
    is the contract.

    Reports JAX's keys: ``quant_goodput_tok_s`` (SLO-attained tok/s of
    the quantized engine) and ``kv_pool_bytes_frac`` (the quantized pool's
    bytes over a bf16 pool at equal geometry, scale pools included).
    ``race_attn``: the quantized stream also on ``decode_attn="gather"``
    and ``"paged_flash"``, timed, their tokens equal on the CPU; on the
    card, where a dequant's multiply order may differ by an ulp, each
    sequence either equal or first apart at a near-tie of the gather
    route's standalone trajectory (the tie-aware verdict every row of the
    port takes on the card; JAX's TPU gate counts flipped tokens, >=
    0.999, and one early near-tie flip changes the rest of a greedy
    sequence), with the token agreement printed."""
    from hpc_patterns_tpu_torch.models.decode import init_paged_cache
    from hpc_patterns_tpu_torch.models.quantization import precision_law
    from hpc_patterns_tpu_torch.models.transformer import (
        quantize_weights_int8,
    )

    out = print if not quiet else (lambda *a, **k: None)
    dev = resolve_device(device)
    sync = _sync(dev)
    compute_dt, kv = resolve_kv_cache_dtype(kv_dtype, note=out, device=dev)
    if kv == "compute":
        raise SystemExit(
            f"--quant needs a quantized --kv-dtype (int8/fp8), got "
            f"{kv_dtype!r} — the compute-dtype rows are the ordinary "
            "serving benches")
    over = {"kv_cache_dtype": kv}
    if compute_dt:
        over["dtype"] = compute_dt
    cfg_q = dataclasses.replace(cfg, **over)
    params_q = quantize_weights_int8(params) if quant_weights else params

    rng = np.random.RandomState(7)
    lengths = [prompt_len // 2, (3 * prompt_len) // 4, prompt_len]
    reqs = []
    for _ in range(n):
        t = int(rng.choice(lengths))
        prompt = rng.randint(0, cfg.vocab, size=t).astype(np.int32)
        budget = int(rng.choice(
            [max(1, max_budget // 2), max_budget], p=[0.4, 0.6]))
        reqs.append((prompt, budget))
    total_tokens = sum(b for _, b in reqs)
    buckets = bucket_ladder(prompt_len)
    targets = slo.targets_from_classes(SCENARIO_CLASSES)
    pages_per_seq = max(
        ContinuousBatcher.pages_needed(len(p), b, page_size,
                                       padded_len=pad_to_bucket(
                                           buckets, len(p)))
        for p, b in reqs)
    pool = slots * pages_per_seq

    # the precision LAW gate first — broken dequant must fail before any
    # throughput number exists (TV toward 1, agreement toward 1/V)
    law_prompts = np.stack([
        rng.randint(0, cfg.vocab, size=prompt_len).astype(np.int32)
        for _ in range(4)])
    law = precision_law(params, cfg, params_q, cfg_q, law_prompts, steps=8)
    law.check()

    def run_one(c, p):
        eng = ContinuousBatcher(
            p, c, slots=slots, pool_pages=pool,
            pages_per_seq=pages_per_seq, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, slo=targets, device=dev)
        ids = [eng.submit(pr, b) for pr, b in reqs]
        got = eng.run()
        sync()
        return {i: got[s] for i, s in enumerate(ids)}, eng

    def timed(c, p):
        run_one(c, p)  # warm-up (kernel builds, allocator)
        t0 = time.perf_counter()
        got, eng = run_one(c, p)
        return time.perf_counter() - t0, got, eng

    t_base, base_out, base_eng = timed(cfg, params)
    t_q, q_out, q_eng = timed(cfg_q, params_q)

    # the oracle WITHIN each precision: each engine's tokens on its
    # standalone decode under the same config
    tol = TIE_TOL[cfg.dtype]
    verdicts = {"exact": 0, "near_tie": 0}
    for i, (prompt, b) in enumerate(reqs):
        for label, c, p, got in (("baseline", cfg, params, base_out),
                                 ("quantized", cfg_q, params_q, q_out)):
            want, margins = _standalone(p, c, prompt, b,
                                        page_size=page_size, device=dev)
            verdicts[_held(got[i], want, margins, tol,
                           f"{label} seq {i}")] += 1

    # pool bytes at EQUAL geometry: the quantized pool vs a bf16 pool
    # (scale pools included, the table excluded on both sides)
    def pool_bytes(c):
        cache = init_paged_cache(c, slots, pages_per_seq, page_size,
                                 pool_pages=pool + 1, device=dev)
        return sum(t.numel() * t.element_size()
                   for name, pools in cache.items() if name != "table"
                   for t in pools)

    bf16_cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                   kv_cache_dtype="compute")
    q_bytes = pool_bytes(cfg_q)
    bf16_bytes = pool_bytes(bf16_cfg)
    bytes_frac = q_bytes / bf16_bytes

    tot_base = base_eng.last_slo["total"]
    tot_q = q_eng.last_slo["total"]
    result = {
        "t_baseline": t_base, "t_quant": t_q, "tokens": total_tokens,
        "tokens_per_s_baseline": total_tokens / t_base,
        "tokens_per_s_quant": total_tokens / t_q,
        "baseline_goodput_tok_s": tot_base["goodput_tok_s"]
        * base_eng._serve_s / t_base if t_base > 0 else 0.0,
        "quant_goodput_tok_s": tot_q["goodput_tok_s"]
        * q_eng._serve_s / t_q if t_q > 0 else 0.0,
        "kv_pool_bytes_frac": bytes_frac,
        "kv_pool_bytes": q_bytes, "bf16_pool_bytes": bf16_bytes,
        "kv_dtype": kv, "quant_weights": bool(quant_weights),
        "greedy_agreement": law.greedy_agreement,
        "tv_mean": law.tv_mean, "tv_max": law.tv_max,
        "baseline_bubble_frac": base_eng.last_bubble_frac,
        "quant_bubble_frac": q_eng.last_bubble_frac,
    }
    out(f"quantized[{kv}{'+w8' if quant_weights else ''}]: n={n} "
        f"slots={slots} chunk={chunk} pool={pool}p "
        f"tokens={total_tokens}")
    out(f"  baseline : {t_base:.3f}s  "
        f"{result['tokens_per_s_baseline']:,.1f} tok/s  goodput "
        f"{result['baseline_goodput_tok_s']:,.1f}  bubble "
        f"{result['baseline_bubble_frac']:.1%}")
    out(f"  {kv:<9}: {t_q:.3f}s  "
        f"{result['tokens_per_s_quant']:,.1f} tok/s  goodput "
        f"{result['quant_goodput_tok_s']:,.1f}  bubble "
        f"{result['quant_bubble_frac']:.1%}")
    out(f"  kv pool bytes {q_bytes:,} = {bytes_frac:.3f}x the bf16 "
        f"pool ({bf16_bytes:,}) at equal residents")
    out(f"  precision law: greedy agreement "
        f"{law.greedy_agreement:.3f}, TV mean {law.tv_mean:.4f} / "
        f"max {law.tv_max:.4f} over {law.steps} teacher-forced steps "
        f"(on the standalone within the precision: {verdicts})")

    if race_attn:
        # the route race per precision: the same quantized stream on the
        # gather route and on the exact-softmax paged kernel
        cfg_pf = dataclasses.replace(cfg_q, decode_attn="paged_flash")
        cfg_ga = dataclasses.replace(cfg_q, decode_attn="gather")
        t_ga, ga_out, _ = timed(cfg_ga, params_q)
        t_pf, pf_out, _ = timed(cfg_pf, params_q)
        n_tok = n_flip = 0
        race = {"exact": 0, "near_tie": 0}
        for i in sorted(pf_out):
            a, b = np.asarray(pf_out[i]), np.asarray(ga_out[i])
            n_tok += a.size
            n_flip += int(np.sum(a != b))
            if np.array_equal(a, b):
                race["exact"] += 1
            elif dev.type == "cuda":
                # a greedy sequence that flips once follows another
                # continuation from there: the first flip must sit at a
                # near-tie of the gather route's own trajectory
                prompt, budget = reqs[i]
                want, margins = _standalone(params_q, cfg_ga, prompt,
                                            budget, page_size=page_size,
                                            device=dev)
                race[_held(a, want, margins, tol,
                           f"paged_flash vs gather seq {i}")] += 1
        agreement = 1.0 - n_flip / max(n_tok, 1)
        assert dev.type == "cuda" or n_flip == 0, (
            f"paged_flash vs gather: {n_flip}/{n_tok} token mismatches on "
            "the CPU's plain versions")
        result["tokens_per_s_gather"] = total_tokens / t_ga
        result["tokens_per_s_paged_flash"] = total_tokens / t_pf
        out(f"  route race [{kv}]: gather "
            f"{result['tokens_per_s_gather']:,.1f} tok/s vs "
            f"paged_flash {result['tokens_per_s_paged_flash']:,.1f} "
            f"tok/s ({t_ga / t_pf:.2f}x), token agreement {agreement:.4f}, "
            f"sequences {race}")
    return result


ELASTIC_CLASSES = (
    # generous latency targets: attainment in the CI shape is decided by
    # SERVING (a shed never attains), not by wall-clock jitter
    loadgen.PriorityClass("interactive", 0, weight=0.5,
                          ttft_slo_s=30.0, tpot_slo_s=5.0),
    loadgen.PriorityClass("batch", 1, weight=0.5),
)


def elastic_smoke_config(device=None):
    """The CI elastic shape (JAX ``elastic_smoke_config``): the smoke model
    on a diurnal open-loop ramp whose front-loaded peak oversubscribes a
    2-replica plane, with a seeded ``die:replica=1`` chaos fault killing
    one replica while it holds in-flight rows, on the chaos scenario's
    engine geometry (ladder top 192, a 12-page table, a 25-page arena a
    replica, budgets 16/24); the sampled leg is smaller still."""
    base = smoke_config(device)
    return dict(cfg=base["cfg"], params=base["params"], n=10, slots=3,
                chunk=8, page_size=16, prompt_len=32, max_budget=24,
                rate_rps=200.0, period_s=0.4, depth=0.8, seed=17,
                die_replica=1, die_at=2, sampled_n=4,
                ladder_top=192, pages_per_seq=12, pool_pages=25,
                budgets=(16, 24), device=base["device"])


def elastic_full_config(device=None):
    """The re-grounding shape (JAX ``elastic_full_config``): the scenario
    model on a longer diurnal ramp, 24 rps, period 1 s, depth 0.8, chunk
    16, replica 1 dying at its round 3. On the card: the chip model, 32
    requests, 4 slots, page 256, prompts 64/128, budgets 128/256; on the
    CPU the smoke model, 20 requests, 2 slots, page 16, prompts 16/32,
    budgets 32/64."""
    base = scenario_full_config(device)
    gpu = base["device"].type == "cuda"
    return dict(cfg=base["cfg"], params=base["params"],
                n=32 if gpu else 20, slots=4 if gpu else 2, chunk=16,
                page_size=256 if gpu else 16,
                prompt_len=128 if gpu else 32,
                max_budget=256 if gpu else 64, rate_rps=24.0, period_s=1.0,
                depth=0.8, seed=17, die_replica=1, die_at=3, sampled_n=6,
                device=base["device"])


def run_elastic(*, cfg, params, n, slots, chunk, page_size, prompt_len,
                max_budget, rate_rps, period_s, depth, seed=17,
                die_replica=1, die_at=2, sampled_n=5, ladder_top=None,
                pages_per_seq=None, pool_pages=None, budgets=None,
                device=None, quiet=False, after_timed=None):
    """The ELASTIC-PLANE row (JAX ``run_elastic``): one diurnal open-loop
    ramp under replica-death chaos, served by (a) a FIXED 2-replica plane
    (a death there ends in shedding) and (b) the autoscaled
    :class:`~hpc_patterns_tpu_torch.serving_plane.autoscaler.
    ElasticServingPlane` — SLO-feedback scale-up on warm residency-pulled
    params, checkpoint resume after the death, drain by migration on the
    way down. Asserted before any number is believed:

    - the seeded ``die`` fault FIRED on both legs;
    - the static plane SHEDS (``shed_on_death >= 1``) while the elastic
      plane serves everything;
    - the elastic plane's SLO attainment STRICTLY exceeds the static's on
      the same schedule;
    - every served stream — death-resumed and drain-migrated rows
      included — holds against the standalone ``paged_generate``: greedy,
      and sampled (a smaller closed-loop leg whose death resumes from the
      checkpointed keys) with each row's key; exact on the CPU,
      tie-aware on the card (:func:`_held`, ``TIE_TOL``, on the
      standalone's margins: a sampled step's whole decision margin);
    - warm spin-up (the ``plane.spinup`` span) beats a cold
      ``init_params`` + engine build — the row's own model's init, min of
      2 — on the CPU. On the card it is a named verdict
      (``warm_vs_cold``) printed with both times.

    Reports ``elastic_slo_attainment`` and ``goodput_per_replica_round``
    (SLO-attained tokens per live replica-round), each scale-up's reason
    and the drained replicas. ``after_timed()``, when given, runs once
    the timed work (both legs, warm spin-up and cold init) is done,
    before the oracle and the sampled leg: a caller sharing the device
    starts its own work there."""
    from hpc_patterns_tpu_torch.serving_plane.autoscaler import (
        Autoscaler,
        AutoscalerPolicy,
        ElasticServingPlane,
        WarmParamPool,
    )

    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    sync = _sync(dev)
    out = print if not quiet else (lambda *a, **k: None)
    tol = TIE_TOL[cfg.dtype] if gpu else 0.0
    schedule = loadgen.make_schedule(
        n, rate_rps=rate_rps, classes=ELASTIC_CLASSES,
        prompt_lens=(prompt_len // 2, prompt_len),
        budgets=budgets or (max(1, max_budget // 2), max_budget),
        process="diurnal", seed=seed, period_s=period_s, depth=depth)
    rng = np.random.RandomState(seed + 1)
    prompts = {r.index: rng.randint(0, cfg.vocab, size=r.prompt_len)
               .astype(np.int32) for r in schedule.requests}
    targets = slo.targets_from_classes(ELASTIC_CLASSES)
    # the ladder covers prompt + budget: a death-resume's prompt is the
    # original plus everything already emitted (rungs of 128 on the flash
    # route: every admission prefills through the flash kernel)
    buckets = prefill_ladder(ladder_top or (prompt_len + max_budget),
                             cfg.decode_attn)
    if pages_per_seq is None:
        pages_per_seq = max(
            EngineCore.pages_needed(r.prompt_len, r.max_new, page_size,
                                    padded_len=pad_to_bucket(
                                        buckets, r.prompt_len))
            for r in schedule.requests)
    pool = pool_pages or slots * pages_per_seq
    chaos_spec = (f"die:replica={die_replica},at={die_at},"
                  "site=replica_round")
    policy = AutoscalerPolicy(min_replicas=2, max_replicas=4,
                              up_queue=1.5, down_queue=0.25,
                              cooldown_rounds=3, window=4)

    def mk_engine(p, **skw):
        return EngineCore(
            p, cfg, slots=slots, pool_pages=pool,
            pages_per_seq=pages_per_seq, page_size=page_size, chunk=chunk,
            prompt_buckets=buckets, device=dev, **skw)

    def arrivals(sched):
        return [(r.t_arrival_s,
                 dict(prompt=prompts[r.index], max_new=r.max_new,
                      priority=r.priority, deadline_s=r.deadline_s))
                for r in sched.requests]

    def run_leg(plane, spec, submit=None):
        """``plane`` under the ``spec`` fault: open loop on the schedule,
        or closed loop on what ``submit`` submits; (outputs, its ids)."""
        chaoslib.configure(spec)
        try:
            ids = submit() if submit is not None else None
            got = (plane.run(arrivals=arrivals(schedule)) if submit is None
                   else plane.run())
            sync()
            died = [e for e in chaoslib.injections() if e["kind"] == "die"]
        finally:
            chaoslib.reset()
        assert died, "the seeded replica-death fault never fired"
        return got, ids

    def elastic_plane(**skw):
        return ElasticServingPlane(
            [Replica(mk_engine(params, **skw), name=f"r{i}")
             for i in range(2)],
            engine_factory=lambda p: mk_engine(p, **skw),
            warm_pool=WarmParamPool(params),
            autoscaler=Autoscaler(policy), slo=targets)

    static = ServingPlane([Replica(mk_engine(params), name=f"r{i}")
                           for i in range(2)], slo=targets)
    t0 = time.perf_counter()
    static_out, _ = run_leg(static, chaos_spec)
    t_static = time.perf_counter() - t0
    elastic = elastic_plane()
    t0 = time.perf_counter()
    elastic_out, _ = run_leg(elastic, chaos_spec)
    t_elastic = time.perf_counter() - t0

    # the fault did real damage: the fixed plane SHEDS, the elastic plane
    # serves everything
    assert static.deaths and elastic.deaths, "no replica died"
    assert static.shed_on_death >= 1, (
        "the static plane's dead replica held nothing — the death "
        "perturbed neither leg, the comparison measured nothing")
    assert elastic.shed_on_death == 0, (
        f"elastic plane shed {elastic.shed_on_death} on the death it "
        "exists to absorb")
    assert len(elastic.spinup_s) >= 1, "the autoscaler never scaled up"

    # warm spin-up vs cold init: the plane.spinup span (pull the parked
    # host params + build the engine on them) against the row model's own
    # init_params + engine build, min of 2 each side
    def cold_once():
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        p = init_params(cfg, generator=gen, device=dev,
                        dtype=torch_dtype(cfg.dtype))
        mk_engine(p)
        sync()
        return time.perf_counter() - t

    cold_init_s = min(cold_once() for _ in range(2))
    if after_timed is not None:
        after_timed()
    warm_spinup_s = min(elastic.spinup_s)
    warm_beats_cold = warm_spinup_s < cold_init_s
    if not gpu:
        assert warm_beats_cold, (
            f"warm spin-up {warm_spinup_s * 1e3:.1f}ms not faster than "
            f"cold init {cold_init_s * 1e3:.1f}ms — the residency-backed "
            "pool bought nothing")

    # the oracle before any number — death-resumed rows included
    oracle: dict = {}
    verdicts = {"exact": 0, "near_tie": 0}

    def check(outs, plane, label):
        for r in schedule.requests:
            ps = plane.stats.get(r.index)
            if ps is None or ps.get("outcome") != "ok":
                continue
            if r.index not in oracle:
                oracle[r.index] = _standalone(
                    params, cfg, prompts[r.index], r.max_new,
                    page_size=page_size, device=dev)
            want, margins = oracle[r.index]
            verdicts[_held(outs[r.index], want, margins, tol,
                           f"{label} seq {r.index}")] += 1

    check(static_out, static, "static")
    check(elastic_out, elastic, "elastic")
    for r in schedule.requests:
        assert elastic.stats[r.index]["outcome"] == "ok", (
            f"elastic plane failed to serve seq {r.index}: "
            f"{elastic.stats[r.index]}")

    att_static = static.last_slo["total"]["attained_frac"]
    att_elastic = elastic.last_slo["total"]["attained_frac"]
    assert att_elastic > att_static, (
        f"autoscaled attainment {att_elastic:.3f} does not exceed static "
        f"{att_static:.3f} — the loop closed nothing")

    # the SAMPLED leg, submitted up front so the victim structurally holds
    # in-flight rows when the fault fires: its death-resumes continue from
    # the checkpointed keys
    sprompts = [rng.randint(0, cfg.vocab,
                            size=int(rng.choice([prompt_len // 2,
                                                 prompt_len])))
                .astype(np.int32) for _ in range(sampled_n)]
    sbudget = max(2 * chunk, max_budget // 4)
    skw = dict(temperature=0.7, top_k=8, seed=0)
    es = elastic_plane(**skw)
    got_s, sids = run_leg(es, "die:replica=0,at=1,site=replica_round",
                          lambda: [es.submit(p, sbudget) for p in sprompts])
    assert es.deaths, "sampled-leg death never fired"
    assert es.resumed, (
        "the sampled-leg victim held no in-flight rows — the key-"
        "checkpoint path went unexercised")
    key_src = es.replicas[1].engine
    for sid, p in zip(sids, sprompts):
        assert es.stats[sid]["outcome"] == "ok", (
            f"sampled seq {sid}: {es.stats[sid]}")
        key = key_src.request_key(sid)
        law = {k: skw[k] for k in ("temperature", "top_k")}
        want, margins = _standalone(params, cfg, p, sbudget,
                                    page_size=page_size, device=dev,
                                    key=key, **law)
        verdicts[_held(got_s[sid], want, margins, tol,
                       f"sampled seq {sid}")] += 1

    gppr = elastic.goodput_per_replica_round or 0.0
    per_class = {
        prio: {"static": static.last_slo["classes"]
               .get(prio, {}).get("attained_frac"),
               "elastic": elastic.last_slo["classes"]
               .get(prio, {}).get("attained_frac")}
        for prio in sorted({c.priority for c in ELASTIC_CLASSES})
    }
    result = {
        "elastic_slo_attainment": att_elastic,
        "static_slo_attainment": att_static,
        "per_class_attainment": per_class,
        "goodput_per_replica_round": gppr,
        "static_goodput_per_replica_round":
            static.goodput_per_replica_round or 0.0,
        "static_shed_on_death": static.shed_on_death,
        "elastic_shed_on_death": elastic.shed_on_death,
        "spinups": len(elastic.spinup_s),
        "spinup_reasons": [d.reason for d in elastic.autoscaler.decisions
                           if d.action == "up"],
        "warm_spinup_s": warm_spinup_s,
        "cold_init_s": cold_init_s,
        "warm_vs_cold": ("warm spin-up faster" if warm_beats_cold
                         else "cold init faster"),
        "warm_param_bytes": elastic.warm_pool.nbytes,
        "resumed": sorted(elastic.resumed),
        "drained": list(elastic.drained),
        "replica_rounds": elastic.replica_rounds,
        "static_replica_rounds": static.replica_rounds,
        "sampled_resumed": sorted(es.resumed),
        "t_static": t_static, "t_elastic": t_elastic,
        "oracle": verdicts,
        "schedule": schedule.spec,
    }
    out(f"elastic: n={n} slots={slots} chunk={chunk} pool={pool}p "
        f"diurnal(period={period_s}s depth={depth}) chaos={chaos_spec}")
    out(f"  static  : attained {att_static:.1%}  shed-on-death "
        f"{static.shed_on_death}  replica-rounds {static.replica_rounds}")
    out(f"  elastic : attained {att_elastic:.1%}  shed-on-death 0  "
        f"spinups {len(elastic.spinup_s)}  drained {elastic.drained}  "
        f"resumed {sorted(elastic.resumed)}  replica-rounds "
        f"{elastic.replica_rounds}")
    out(f"  warm spin-up {warm_spinup_s * 1e3:.1f}ms vs cold init "
        f"{cold_init_s * 1e3:.1f}ms ({cold_init_s / warm_spinup_s:.1f}x): "
        f"{result['warm_vs_cold']}")
    out(f"  goodput/replica-round {gppr:,.2f} tok (static "
        f"{result['static_goodput_per_replica_round']:,.2f})")
    out(f"  every served stream on its standalone, greedy and sampled "
        f"(death-resumed rows included): {verdicts}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_serving_args(p)
    p.add_argument("--scenario", action="store_true",
                   help="the robustness row (preemption, chaos, goodput)")
    p.add_argument("--plane", action="store_true",
                   help="the serving-plane row")
    p.add_argument("--fit", action="store_true",
                   help="the autofit row: record, fit, then the default "
                        "ladder against the fitted one")
    p.add_argument("--offload", action="store_true",
                   help="the tiered-memory row: all-HBM against a capped "
                        "pool over the residency manager's host tier")
    p.add_argument("--shared", action="store_true",
                   help="the prefix-sharing row: private pages against the "
                        "sharing-aware arena")
    p.add_argument("--quant", action="store_true",
                   help="the quantized-decode row: a compute-dtype engine "
                        "against a quantized-KV one (--kv-dtype int8 by "
                        "default, or fp8), the precision law first")
    p.add_argument("--quant-weights", action="store_true",
                   help="with --quant: int8 per-output-channel weights too")
    p.add_argument("--slo-budget", action="store_true",
                   help="the segment-budget row: a seeded slow host "
                        "transfer must breach prefetch_wait and nothing "
                        "else")
    p.add_argument("--autofit", default=None, metavar="CONFIG",
                   help="with --fit: apply this FittedConfig instead of "
                        "fitting one from the recording leg")
    p.add_argument("--fit-out", default=None, metavar="PATH",
                   help="with --fit: also write the fitted config here")
    p.add_argument("--elastic", action="store_true",
                   help="the elastic-plane row: a diurnal ramp under "
                        "replica-death chaos, fixed plane against the "
                        "autoscaled one")
    add_explain_args(p)
    p.add_argument("--migration", default="device_put",
                   choices=list(MIGRATION_TRANSPORTS))
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="the CI shape (the smoke model)")
    add_kv_dtype_arg(p, default=None)
    args = p.parse_args(argv)
    if args.elastic:
        conf = (elastic_smoke_config if args.smoke
                else elastic_full_config)(args.device)
        result = run_elastic(**with_kv_dtype(conf, args.kv_dtype))
    elif args.quant:
        conf = (quantized_smoke_config if args.smoke
                else quantized_full_config)(args.device)
        if args.kv_dtype:
            conf["kv_dtype"] = args.kv_dtype
        result = run_quantized(**conf, quant_weights=args.quant_weights)
    elif args.shared:
        if args.kv_dtype and args.kv_dtype not in ("f32", "bf16"):
            # the documented refusal, surfaced before the engine's
            p.error(f"--shared refuses --kv-dtype {args.kv_dtype}: prefix "
                    "sharing needs exact KV pages (a tail computed from "
                    "dequantized shared pages could not be bit-identical); "
                    "run --shared at f32/bf16")
        conf = (shared_smoke_config if args.smoke else shared_full_config)(
            args.device)
        result = run_shared(**with_kv_dtype(conf, args.kv_dtype))
    elif args.offload:
        conf = (offload_smoke_config if args.smoke
                else offload_full_config)(args.device)
        result = run_offload(**with_kv_dtype(conf, args.kv_dtype))
    elif args.slo_budget:
        # one shape on every device: the row's value is the seeded
        # attribution assert, not throughput
        result = run_slo_budget(**slo_budget_smoke_config(args.device),
                                explain=explain_enabled(args))
    elif args.plane:
        conf = (plane_smoke_config if args.smoke else plane_full_config)(
            args.device)
        conf = with_kv_dtype(conf, args.kv_dtype)
        result = run_plane(**conf, migration=args.migration)
    elif args.fit:
        conf = (fit_smoke_config if args.smoke else fit_full_config)(
            args.device)
        result = run_fitted(**with_kv_dtype(conf, args.kv_dtype),
                            autofit_path=args.autofit,
                            fit_out=args.fit_out)
    elif args.scenario:
        conf = (scenario_smoke_config if args.smoke
                else scenario_full_config)(args.device)
        result = run_scenario(**with_kv_dtype(conf, args.kv_dtype),
                              explain=explain_enabled(args),
                              explain_out=args.explain_out)
    else:
        conf = (smoke_config if args.smoke else full_config)(args.device)
        result = run_bench(**with_kv_dtype(conf, args.kv_dtype),
                           buckets=args.prompt_buckets,
                           overlap=not args.no_overlap,
                           temperature=args.temperature, top_k=args.top_k,
                           seed=args.seed)
    print(json.dumps({k: v for k, v in result.items() if k != "schedule"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
