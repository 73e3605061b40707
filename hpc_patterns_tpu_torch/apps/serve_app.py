"""Serve app: continuous batching over the paged KV cache, validated —
the counterpart of ``hpc_patterns_tpu/apps/serve_app.py``.

A stream of requests with varied prompt lengths (``--prompt-mix``) and
budgets is served through ``models.serving.ContinuousBatcher`` (page
free-list, bucketed admission, overlapped prefill, chunked ragged
decode, per-row sampling), then EVERY sequence is held against its
standalone ``paged_generate`` — greedy, or sampled with the request's
own key (``--temperature``/``--top-k``/``--seed``). On the card both run
the hand-written kernels in bf16, where a batch-8 and a batch-1 matmul
may round a near-tie differently: a divergence passes only where the
standalone's top-1/top-2 gap at that step is below ``TIE_TOL`` (of the
logits when greedy, of the perturbed scores ``logits / T + g`` when
sampled). ``--eos-id`` truncates both at the first eos;
``--checkpoint-dir`` serves ``train_app``'s checkpoint;
``--static-compare`` also times static batching.
``--draft-pair DIR`` serves an aligned draft/target pair built by
``hpc_patterns_tpu_torch.make_draft_pair`` with speculative rounds
inside the engine (``--gamma`` proposals a round; the pair's configs
replace the model flags); a greedy run is held against the target's
standalone ``paged_generate`` as above, a sampled one only on its
tokens' range and count (the rounds keep the law, not the draws; its
byte oracle is ``speculative_generate_batched``, in the tests).
``--kv-dtype int8|fp8`` serves one-byte KV pools with
per-row scales (the standalone runs under the same quantized config, so
the oracle stays within one precision); ``f32``/``bf16`` set the compute
dtype instead. Prints tokens/s and SUCCESS/FAILURE (exit 0/1).

``--metrics``, ``--trace`` and ``--reqtrace`` instrument the measured
run (the warm-up stays out of the registry and the request trace); with
``--log`` their snapshots close the log, and ``--trace-out`` writes the
Chrome-trace timeline on any exit path. ``--explain`` (or
``--explain-out PATH``) records the request trace too and prints the
per-class tail-attribution table (``harness/explain.py``), writing its
digest JSON to PATH. ``--autofit CONFIG`` serves with the prompt ladder
of a FittedConfig (``harness/autofit.py``; an explicit
``--prompt-buckets`` wins):

    python -m hpc_patterns_tpu_torch.apps.serve_app --device cuda
    python -m hpc_patterns_tpu_torch.apps.serve_app --device cuda \\
        --kv-dtype int8
    python -m hpc_patterns_tpu_torch.apps.serve_app --device cpu \\
        --dtype float32 --prompt-mix --temperature 0.8 --top-k 8 \\
        --static-compare
    python -m hpc_patterns_tpu_torch.make_draft_pair --device cpu \\
        --out pair
    python -m hpc_patterns_tpu_torch.apps.serve_app --device cpu \\
        --draft-pair pair --gamma 4 --prompt-mix
    python -m hpc_patterns_tpu_torch.apps.serve_app --device cpu \\
        --dtype float32 --metrics --trace --reqtrace --log serve.jsonl \\
        --trace-out serve.trace.json
    python -m hpc_patterns_tpu_torch.harness.report serve.jsonl
    python -m hpc_patterns_tpu_torch.apps.serve_app --device cpu \\
        --dtype float32 --prompt-mix --log run.jsonl --explain \\
        --explain-out digest.json
    python -m hpc_patterns_tpu_torch.harness.autofit run.jsonl \\
        --emit fitted.json
    python -m hpc_patterns_tpu_torch.apps.serve_app --device cpu \\
        --dtype float32 --prompt-mix --autofit fitted.json
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib
from hpc_patterns_tpu_torch.harness import explain as explainlib
from hpc_patterns_tpu_torch.harness.cli import (
    add_autofit_arg,
    add_explain_args,
    add_kv_dtype_arg,
    add_reqtrace_arg,
    add_serving_args,
    base_parser,
    explain_enabled,
    load_autofit,
    parse_buckets,
    resolve_kv_cache_dtype,
)
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.verdict import Verdict
from hpc_patterns_tpu_torch.make_draft_pair import load_pair
from hpc_patterns_tpu_torch.models.decode import paged_generate
from hpc_patterns_tpu_torch.models.serving import (
    ContinuousBatcher,
    bucket_ladder,
    pad_to_bucket,
    tie_aware_compare,
)
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from hpc_patterns_tpu_torch.topology import resolve_device

#: top-1/top-2 gap below which an engine-vs-standalone divergence counts
#: as a near-tie: bf16 matmuls at two batch sizes may round a near-tie
#: either way; f32 on the CPU is exact in practice. A sampled step reads
#: the gap of its perturbed scores (``decode.sample_scores``), on the
#: same scale
TIE_TOL = {"bfloat16": 0.05, "float32": 1e-4}

#: the serving benchmark's chip shape (``benchmarks/bench_serving.py``):
#: model widths, then the engine and stream geometry
CHIP_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8,
                  d_ff=4096, dtype="bfloat16")
CHIP_SERVE = dict(slots=8, chunk=16, page_size=256, prompt_len=512,
                  max_budget=512)


def bench_stream(n: int, prompt_len: int, max_budget: int, vocab: int):
    """The serving benchmark's request stream (``RandomState(7)``):
    prompts 1/2, 3/4 or 1x of ``prompt_len``; long-tail budgets 1/8,
    1/4 or 1x of ``max_budget`` at 0.5/0.3/0.2."""
    rng = np.random.RandomState(7)
    lengths = [prompt_len // 2, (3 * prompt_len) // 4, prompt_len]
    reqs = []
    for _ in range(n):
        t = int(rng.choice(lengths))
        prompt = rng.randint(0, vocab, size=t).astype(np.int32)
        budget = int(rng.choice([max(1, max_budget // 8),
                                 max(1, max_budget // 4), max_budget],
                                p=[0.5, 0.3, 0.2]))
        reqs.append((prompt, budget))
    return reqs


def engine_geometry(reqs, *, slots: int, chunk: int, page_size: int,
                    prompt_len: int, **_) -> dict:
    """``ContinuousBatcher`` keyword arguments for ``reqs``: the ladder
    over ``prompt_len``, a table wide enough for the largest request
    (bucket pad included) and ``slots`` such rows of pool."""
    buckets = bucket_ladder(prompt_len)
    pages_per_seq = max(
        ContinuousBatcher.pages_needed(
            len(p), b, page_size, padded_len=pad_to_bucket(buckets, len(p)))
        for p, b in reqs)
    return dict(slots=slots, pool_pages=slots * pages_per_seq,
                pages_per_seq=pages_per_seq, page_size=page_size,
                chunk=chunk, prompt_buckets=buckets)


def static_batching(params, cfg, reqs, *, slots: int, page_size: int,
                    device, temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0) -> dict:
    """Static batching of a mixed-length stream — the baseline the engine
    is measured against: batches of ``slots`` in arrival order, rows
    inside a batch grouped by prompt length (rectangular batches only),
    every row paying its batch's LONGEST budget. Returns {index: tokens
    cut to the row's own budget}; sampled batches draw from one key
    (``seed``), so only their timing is comparable."""
    from hpc_patterns_tpu_torch.models.decode import sample_key

    key = sample_key(seed) if temperature > 0 else None
    outs = {}
    for i in range(0, len(reqs), slots):
        batch = reqs[i:i + slots]
        run_len = max(b for _, b in batch)
        bylen: dict[int, list] = {}
        for j, (p, b) in enumerate(batch):
            bylen.setdefault(len(p), []).append((i + j, p, b))
        for group in bylen.values():
            prompts = torch.from_numpy(np.stack([p for _, p, _ in group]))
            toks = paged_generate(params, prompts, cfg, run_len,
                                  page_size=page_size, device=device,
                                  key=key, temperature=temperature,
                                  top_k=top_k).cpu().numpy()
            for j, (idx, _, b) in enumerate(group):
                outs[idx] = toks[j, :b]
    return outs


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    add_serving_args(p)
    add_reqtrace_arg(p)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=2,
                   help="concurrent rows in the pool")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--chunk", type=int, default=4,
                   help="decode steps per dispatch (admission granularity)")
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--prompt-mix", action="store_true",
                   help="vary prompt lengths 1/2..1x of --prompt-len")
    p.add_argument("--budget", type=int, default=12,
                   help="max new tokens per request (actual budgets vary "
                        "1/4..1x)")
    p.add_argument("--pool-pages", type=int, default=0,
                   help="shared arena size (0 = slots x the pages the "
                        "largest request needs)")
    p.add_argument("--eos-id", type=int, default=-1,
                   help=">= 0: end rows early at this token")
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--pos-embed", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"], help="compute dtype")
    add_kv_dtype_arg(p, default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="serve a trained checkpoint (train_app "
                        "--checkpoint-dir; the model flags must match "
                        "it); default: random init")
    p.add_argument("--static-compare", action="store_true",
                   help="also time static batching (batches of --slots "
                        "padded to the batch max budget)")
    p.add_argument("--draft-pair", default=None, metavar="DIR",
                   help="serve an aligned draft/target pair "
                        "(hpc_patterns_tpu_torch.make_draft_pair): "
                        "speculative rounds inside the engine, rows "
                        "advancing 1..gamma+1 tokens a round (the pair's "
                        "configs replace the model flags)")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft proposals per round with --draft-pair")
    add_autofit_arg(p)
    add_explain_args(p)
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="enable the flight recorder (implies --trace) and "
                        "write the Chrome-trace JSON timeline here at exit")
    return p


def make_requests(n: int, prompt_len: int, budget: int, vocab: int,
                  mix: bool):
    """The JAX app's request stream (``RandomState(7)``): prompt lengths
    1/2..1x of ``prompt_len`` with ``mix``, budgets one of 1/4, 1/2, 1x
    of ``budget``."""
    rng = np.random.RandomState(7)
    reqs = []
    for _ in range(n):
        plen = (int(rng.randint(max(1, prompt_len // 2), prompt_len + 1))
                if mix else prompt_len)
        prompt = rng.randint(0, vocab, size=plen).astype(np.int32)
        b = int(rng.choice([max(1, budget // 4), max(1, budget // 2),
                            budget]))
        reqs.append((prompt, b))
    return reqs


def _fail(log, msg: str) -> int:
    log.print(f"ERROR: {msg}")
    log.print("FAILURE")
    return 1


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    if args.draft_pair and args.checkpoint_dir:
        return _fail(log, "--draft-pair serves the pair's own target "
                          "checkpoint; --checkpoint-dir would be silently "
                          "ignored — pass one or the other")
    if args.draft_pair and args.kv_dtype not in (None, "bf16"):
        return _fail(log, "--draft-pair serves from the pair's own "
                          "compute-dtype caches (META.json configs); "
                          f"--kv-dtype {args.kv_dtype} would be silently "
                          "ignored — drop it or serve without the pair")
    dev = resolve_device(args.device)
    if args.requests < 1 or args.slots < 1 or args.budget < 1:
        return _fail(log, "--requests/--slots/--budget must be >= 1")
    need = args.prompt_len + args.budget
    draft_params = draft_cfg = None
    if args.draft_pair:
        try:
            cfg, params, draft_cfg, draft_params, _ = load_pair(
                args.draft_pair, max_seq=need, device=dev)
        except (OSError, ValueError, KeyError) as e:
            return _fail(log, f"cannot load the pair {args.draft_pair}: "
                              f"{e}")
        dtype, kv_cache_dtype = cfg.dtype, cfg.kv_cache_dtype
        log.print(f"aligned pair from {args.draft_pair} "
                  f"(gamma={args.gamma})")
    else:
        dtype, kv_cache_dtype = args.dtype, "compute"
        if args.kv_dtype is not None:
            compute, kv_cache_dtype = resolve_kv_cache_dtype(args.kv_dtype,
                                                             device=dev)
            dtype = compute or dtype
        cfg = TransformerConfig(
            vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
            n_layers=args.n_layers, d_ff=4 * args.d_model, max_seq=need,
            n_kv_heads=args.n_kv_heads, pos_embed=args.pos_embed,
            dtype=dtype, decode_attn="flash",
            kv_cache_dtype=kv_cache_dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, generator=gen, device=dev,
                             dtype=torch_dtype(dtype))
    spec = draft_params is not None
    if args.checkpoint_dir:
        from hpc_patterns_tpu_torch.utils.checkpoint import restore_params

        try:
            params, step = restore_params(args.checkpoint_dir, device=dev)
        except (FileNotFoundError, ValueError, KeyError) as e:
            return _fail(log, f"cannot restore {args.checkpoint_dir}: {e}")
        log.print(f"restored step {step} from {args.checkpoint_dir}")
    try:
        buckets = parse_buckets(args.prompt_buckets, args.prompt_len)
        if args.autofit is not None:
            # the fitted ladder replaces the default 'auto' ladder; an
            # explicit --prompt-buckets value still wins
            from hpc_patterns_tpu_torch.harness import autofit as autofitlib

            fitted_buckets = autofitlib.ladder_from(
                load_autofit(args.autofit), max_seq=args.prompt_len)
            if (args.prompt_buckets.strip().lower() == "auto"
                    and fitted_buckets is not None):
                buckets = fitted_buckets
                log.print(f"autofit ladder from {args.autofit}: "
                          f"{list(buckets)}")
        padded_max = pad_to_bucket(buckets, args.prompt_len)
    except (OSError, ValueError, argparse.ArgumentTypeError) as e:
        return _fail(log, str(e))
    # the engine's sizing rule, the speculative slack included
    pages_per_seq = ContinuousBatcher.pages_needed(
        args.prompt_len, args.budget, args.page_size,
        gamma=args.gamma if spec else None, padded_len=padded_max)
    pool_pages = args.pool_pages or args.slots * pages_per_seq
    reqs = make_requests(args.requests, args.prompt_len, args.budget,
                         cfg.vocab, args.prompt_mix)
    sampled = args.temperature > 0.0

    def serve():
        # constructor/submit/run errors (a bad flag value, an oversize
        # request, a pool too small) keep the ERROR/FAILURE contract
        try:
            eng = ContinuousBatcher(
                params, cfg, slots=args.slots, pool_pages=pool_pages,
                pages_per_seq=pages_per_seq, page_size=args.page_size,
                chunk=args.chunk, prompt_buckets=buckets, device=dev,
                eos_id=args.eos_id if args.eos_id >= 0 else None,
                overlap=not args.no_overlap, temperature=args.temperature,
                top_k=args.top_k, seed=args.seed, emit=log.emit,
                draft_params=draft_params, draft_cfg=draft_cfg,
                gamma=args.gamma)
            ids = [eng.submit(p, b) for p, b in reqs]
            got = eng.run()
        except (ValueError, RuntimeError) as e:
            return None, None, str(e)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {i: got[sid] for i, sid in enumerate(ids)}, eng, None

    # warm-up (kernel build, library init, allocator), kept out of the
    # registry: its counters would double every request
    m = metricslib.get_metrics()
    prev_enabled, m.enabled = m.enabled, False
    try:
        _, _, err = serve()
    finally:
        m.enabled = prev_enabled
    if err is not None:
        return _fail(log, err)
    if args.reqtrace or explain_enabled(args):
        # a fresh recorder for the measured run: one id space per run
        reqtracelib.configure(enabled=True)
    t0 = time.perf_counter()
    with metricslib.span("serve.measure"):
        out, eng, _ = serve()
    dt = time.perf_counter() - t0
    served = sum(len(v) for v in out.values())
    metricslib.get_metrics().gauge("serve.tokens_per_s").set(served / dt)

    # the oracle: each sequence against its standalone paged_generate
    # with the same key and temperature, truncated at eos as the engine
    # truncates. Draft-assisted sampling is the one law-only combination
    # (its rounds keep the law, not the draws): a range and count check
    tol = TIE_TOL[dtype]
    counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
    for i, (prompt, budget) in enumerate(reqs):
        if sampled and spec:
            ok_i = (1 <= len(out[i]) <= budget and np.all(out[i] >= 0)
                    and np.all(out[i] < cfg.vocab))
            counts["exact" if ok_i else "mismatch"] += 1
            if not ok_i:
                log.print(f"OUT-OF-BOUNDS seq {i}: {out[i][:8]}...")
            continue
        want, margins = paged_generate(
            params, torch.from_numpy(prompt)[None, :], cfg, budget,
            page_size=args.page_size, device=dev, with_margins=True,
            key=eng.request_key(i) if sampled else None,
            temperature=args.temperature, top_k=args.top_k)
        want, margins = want[0].cpu().numpy(), margins[0].cpu().numpy()
        if args.eos_id >= 0 and np.any(want == args.eos_id):
            cut = int(np.argmax(want == args.eos_id)) + 1
            want, margins = want[:cut], margins[:cut]
        verdict = tie_aware_compare(out[i], want, margins, tol)
        counts[verdict] += 1
        if verdict == "mismatch":
            log.print(f"MISMATCH seq {i}: engine {out[i][:8]}... vs "
                      f"standalone {want[:8].tolist()}...")
    leaked = pool_pages - eng.free_page_count
    ok = counts["mismatch"] == 0 and served > 0 and leaked == 0
    log.emit(kind="result", name="serve", success=ok,
             requests=args.requests, slots=args.slots,
             pool_pages=pool_pages, page_size=args.page_size,
             chunk=args.chunk, served_tokens=served,
             tokens_per_s=served / dt, oracle=counts,
             bubble_frac=eng.last_bubble_frac,
             prompt_buckets=list(buckets) if buckets else None,
             temperature=args.temperature, top_k=args.top_k,
             overlap=not args.no_overlap, device=str(dev),
             gamma=args.gamma if spec else None,
             **({"spec_rounds": eng.spec_rounds, **{
                 f"spec_{k}": v for k, v in eng.spec_stats.items()}}
                if spec else {}))
    mode = ("draft+sampled law" if sampled and spec
            else "draft greedy" if spec
            else "sampled" if sampled else "greedy")
    log.print(f"serve[{dev}, {dtype}, kv {kv_cache_dtype}, "
              f"{args.slots} slots, pool {pool_pages}p x "
              f"{args.page_size}, {mode}] {args.requests} reqs, {served} "
              f"tokens: {dt:.3f}s, {served / dt:,.1f} tok/s, bubble "
              f"{eng.last_bubble_frac:.1%}; oracle exact "
              f"{counts['exact']}, near-tie {counts['near_tie']} "
              f"(gap < {tol}), mismatch {counts['mismatch']}; pages "
              f"leaked {leaked}")
    rtr = reqtracelib.active()
    if rtr is not None:
        snap = rtr.snapshot(eng.stats)
        log.emit(kind="reqtrace", **snap)
        log.print(f"reqtrace: {snap['n']} request(s), attribution "
                  f"coverage {snap['coverage_frac']:.1%}")
        if explain_enabled(args):
            dig = explainlib.digest([snap])
            log.print(explainlib.format_explain(dig))
            if args.explain_out:
                import json
                from pathlib import Path

                Path(args.explain_out).write_text(json.dumps(dig) + "\n")
                log.print(f"explain digest -> {args.explain_out}")
    if args.static_compare:
        kw = dict(slots=args.slots, page_size=args.page_size, device=dev,
                  temperature=args.temperature, top_k=args.top_k,
                  seed=args.seed)
        static_batching(params, cfg, reqs, **kw)  # warm-up
        t0 = time.perf_counter()
        static_batching(params, cfg, reqs, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts = time.perf_counter() - t0
        log.emit(kind="static_compare", seconds=ts, engine_seconds=dt)
        log.print(f"static batching: {ts:.3f}s ({served / ts:,.1f} tok/s)"
                  f" — engine/static {ts / dt:.2f}x")
    verdict = Verdict(success=ok,
                      messages=("SUCCESS" if ok else "FAILURE",))
    log.print(verdict.summary_line())
    return verdict.exit_code


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.trace_out:
        args.trace = True
    try:
        return common.run_instrumented(run, args)
    finally:
        # any exit path writes the timeline (run_instrumented leaves the
        # run's recorder installed), and the request trace is dropped
        reqtracelib.reset()
        if args.trace_out:
            from hpc_patterns_tpu_torch.harness import trace as tracelib

            rec = tracelib.get_tracer()
            if rec is not None and rec.enabled:
                out = rec.export(args.trace_out)
                print(f"trace timeline: {out} (open in Perfetto / "
                      "chrome://tracing)")


if __name__ == "__main__":
    sys.exit(main())
