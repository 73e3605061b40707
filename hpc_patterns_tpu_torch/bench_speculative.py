"""Speculative decoding's gamma sweep against plain decode, greedy and
sampled verify — the port of ``benchmarks/bench_speculative.py``.

Protocol: per-token time by generation differencing — each configuration
generates N and N/2 tokens (prefill and the whole decode/verify loop in
one call each), each call forced by reading its tokens back (the
synchronized host clock, ``harness.timing.measure_forced``), min of 3
after a warm-up; the difference over N/2 cancels prefill and kernel
builds. Plain is ``decode.generate`` (kernel 5 on a card); speculative is
``speculative_generate`` at gamma 2, 4 and 8 (the draft's steps on kernel
5, the target's extend plain PyTorch), greedy and at temperature 0.8,
top-k 40. ``--batched B``: ``speculative_generate_batched`` on B rows at
gamma 4, greedy, ``impl="ragged"`` (one batched round an iteration on the
paged caches, the draft on kernel 6) against ``impl="vmap"`` (a row at a
time).

``--pair DIR``: an aligned pair from ``hpc_patterns_tpu_torch.
make_draft_pair`` (prompts from its Markov process on a disjoint path,
draw_seed 777 and 778); without it, independent random weights: the
serving chip model's widths (8 layers, rope, 2 KV heads) and a draft of
d_model 256, 4 heads of 64 with 2 KV heads, 2 layers, d_ff 1024 (the
JAX script's random-draft branch; CPU: its small widths).

One JSON line a configuration, each with the card's name and power
limit (``nvidia-smi``; null on the CPU):

    python -m hpc_patterns_tpu_torch.bench_speculative [--n 256] \\
        [--temp 0.8] [--topk 40] [--pair DIR] [--batched 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from hpc_patterns_tpu_torch.harness.timing import measure_forced
from hpc_patterns_tpu_torch.make_draft_pair import load_pair, markov_corpus
from hpc_patterns_tpu_torch.models.decode import generate, sample_key
from hpc_patterns_tpu_torch.models.speculative import (
    speculative_generate,
    speculative_generate_batched,
)
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from hpc_patterns_tpu_torch.topology import resolve_device

GAMMAS = (2, 4, 8)
PROMPT_LEN = 128


def card(dev: torch.device) -> dict:
    """The device's name and, on a card, ``nvidia-smi``'s name and power
    limit line."""
    if dev.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def models(pair: str | None, n: int, dev: torch.device):
    """(cfg, params, draft_cfg, draft_params, prompt (1, 128), corpus or
    None): the pair's, or random ones at the JAX script's widths."""
    max_len = PROMPT_LEN + n + max(GAMMAS) + 1
    if pair:
        cfg, params, dcfg, dparams, _ = load_pair(pair, max_seq=max_len,
                                                  device=dev)
        # the pair's own Markov process on a disjoint sample path
        corpus = markov_corpus(cfg.vocab, 8192, draw_seed=777)
        prompt = torch.from_numpy(corpus[None, :PROMPT_LEN].copy()).to(dev)
        return cfg, params, dcfg, dparams, prompt, True
    on_card = dev.type == "cuda"
    base = dict(vocab=32768 if on_card else 256,
                d_model=1024 if on_card else 64,
                n_heads=8 if on_card else 4,
                n_layers=8 if on_card else 2,
                d_ff=4096 if on_card else 128,
                dtype="bfloat16" if on_card else "float32",
                n_kv_heads=2 if on_card else 0, pos_embed="rope",
                max_seq=max_len)
    cfg = TransformerConfig(**base)
    dcfg = TransformerConfig(**{
        **base, "d_model": 256 if on_card else 32,
        "n_layers": 2 if on_card else 1, "d_ff": 1024 if on_card else 64,
        "n_heads": 4 if on_card else 2, "n_kv_heads": 2 if on_card else 0})
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    params = init_params(cfg, generator=gen.manual_seed(0), device=dev,
                         dtype=dt)
    dparams = init_params(dcfg, generator=gen.manual_seed(1), device=dev,
                          dtype=dt)
    prompt = torch.randint(0, cfg.vocab, (1, PROMPT_LEN),
                           generator=gen.manual_seed(2), device=dev,
                           dtype=torch.int32)
    return cfg, params, dcfg, dparams, prompt, False


def run_bench(*, n: int, temp: float, top_k: int, pair: str | None,
              batched: int, batched_n: int | None = None, device=None,
              emit=None) -> list[dict]:
    """Every configuration's row (also passed to ``emit`` as it lands).
    ``batched_n``: the tokens a call of the ``batched`` rows (default
    ``n``; at most ``n``)."""
    dev = resolve_device(device)
    cfg, params, dcfg, dparams, prompt, aligned = models(pair, n, dev)
    info = {"bench": "speculative", "n": n, "aligned_pair": aligned,
            **card(dev)}
    rows = []

    def row(**kw):
        r = {**info, **kw}
        rows.append(r)
        if emit is not None:
            emit(r)

    def per_token(fn, m: int = n):
        full = measure_forced(lambda: fn(m), repetitions=3).min_s
        half = measure_forced(lambda: fn(m // 2), repetitions=3).min_s
        return max(full - half, 0.0) / (m - m // 2)

    key = sample_key(3)
    for label, kw in (("greedy", {}),
                      (f"temp={temp}/top{top_k}",
                       {"key": key, "temperature": temp, "top_k": top_k})):
        t_plain = per_token(lambda m: generate(params, prompt, cfg, m,
                                               device=dev, **kw))
        row(mode=label, impl="plain", gamma=None,
            ms_per_token=t_plain * 1e3)
        for gamma in GAMMAS:
            t = per_token(lambda m: speculative_generate(
                params, cfg, dparams, dcfg, prompt, m, gamma=gamma,
                device=dev, **kw))
            row(mode=label, impl="spec", gamma=gamma, ms_per_token=t * 1e3,
                speedup=t_plain / t if t > 0 else None)
    if batched:
        m = min(batched_n or n, n)
        if aligned:
            # heterogeneous on-distribution rows: per-row acceptance
            # varies, which is what per-row progress is for
            corpus = markov_corpus(cfg.vocab, 8192 + batched * 512,
                                   draw_seed=778)
            prompts = np.stack([corpus[i * 512:i * 512 + PROMPT_LEN]
                                for i in range(batched)])
            prompts = torch.from_numpy(prompts).to(dev)
        else:
            prompts = torch.randint(
                0, cfg.vocab, (batched, PROMPT_LEN),
                generator=torch.Generator(device=dev).manual_seed(4),
                device=dev, dtype=torch.int32)
        for impl in ("ragged", "vmap"):
            t = per_token(lambda k: speculative_generate_batched(
                params, cfg, dparams, dcfg, prompts, k, gamma=4, impl=impl,
                device=dev), m)
            row(mode="greedy", impl=f"batched[{impl}]", gamma=4, B=batched,
                n=m,
                ms_per_batch_token=t * 1e3,
                tokens_per_s=batched / t if t > 0 else None)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=None,
                   help="tokens a call (default 256 on a card, 16 on the "
                        "CPU)")
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--topk", type=int, default=40)
    p.add_argument("--pair", default=None, metavar="DIR")
    p.add_argument("--batched", type=int, default=0, metavar="B")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n or (256 if dev.type == "cuda" else 16)
    if n < 2:
        p.error("--n must be >= 2 (the protocol differences N and N/2)")
    run_bench(n=n, temp=args.temp, top_k=args.topk, pair=args.pair,
              batched=args.batched, device=dev,
              emit=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
