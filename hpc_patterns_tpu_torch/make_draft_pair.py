"""Build an ALIGNED draft/target pair for honest speculative numbers —
the port of ``benchmarks/make_draft_pair.py``:

1. a learnable corpus: an order-1 Markov chain with a sparse seeded
   transition table (:func:`markov_corpus`, numpy: the same bits as the
   JAX script's);
2. train the target on it (``models/train.make_train_step``; on a card
   with ``attention="flash"``, so the training kernels run);
3. make the draft by layer truncation of the trained target (its first
   ``--draft-layers`` layers with its embedding, final norm and head) and
   distill it: KL(target || draft) on corpus windows, the target frozen,
   the port's ``AdamW`` at 1e-3;
4. save both checkpoints and a ``META.json`` with the JAX script's keys;
5. report the held-out acceptance diagnostics — greedy top-1 agreement
   and E[sum min(p, q)] at temperature 0.8 — for the aligned pair and for
   a random draft of the same widths.

Widths follow the JAX script's two branches: on a card its chip widths
(vocab 32768, d_model 1024, 8 heads with 2 KV heads, d_ff 4096, bf16,
rope, max_seq 2048; a target of 8 layers, a draft of 2; 400 / 400 steps
at 16 x 256), on the CPU its small ones (vocab 256, d_model 64, 4 heads,
d_ff 128, f32; 2 and 1 layers; 30 / 30 steps at 4 x 32).

A pair written by the JAX script (orbax checkpoints) cannot be read by
the port, whose checkpoints are ``torch.save`` files
(``utils/checkpoint.py``): build the port's pair with this script.

    python -m hpc_patterns_tpu_torch.make_draft_pair --out pair_dir \\
        [--steps 400] [--distill-steps 400] [--draft-layers 2] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.models.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
    tree_leaves,
    tree_map,
)
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
)
from hpc_patterns_tpu_torch.topology import resolve_device
from hpc_patterns_tpu_torch.utils.checkpoint import (
    restore_params,
    save_checkpoint,
)


def markov_corpus(vocab: int, n_tokens: int, seed: int = 0,
                  branching: int = 8, draw_seed: int | None = None):
    """Order-1 Markov stream: every token has ``branching`` plausible
    successors (Zipf-ish weights). ``seed`` fixes the transition table
    (the process); ``draw_seed`` (default ``seed``) the sample path —
    held-out data and benchmark prompts come from the same process on a
    disjoint path. The JAX script's numpy calls, in its order."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, size=(vocab, branching))
    w = 1.0 / np.arange(1, branching + 1)
    w /= w.sum()
    draw_rng = np.random.RandomState(
        seed if draw_seed is None else draw_seed)
    out = np.empty(n_tokens, np.int32)
    tok = draw_rng.randint(vocab)
    draws = draw_rng.choice(branching, size=n_tokens, p=w)
    for i in range(n_tokens):
        tok = succ[tok, draws[i]]
        out[i] = tok
    return out


def windows(corpus, batch: int, seq: int, rng, device=None):
    """``batch`` random windows of ``seq`` tokens, (batch, seq) int32 on
    ``device`` (default ``cuda``); ``rng`` a ``numpy.random.RandomState``
    drawn from as the JAX script draws."""
    starts = rng.randint(0, len(corpus) - seq - 1, size=batch)
    toks = np.stack([corpus[s:s + seq] for s in starts])
    return torch.from_numpy(toks.astype(np.int32)).to(resolve_device(device))


def truncate_draft(params, dcfg: TransformerConfig):
    """Draft = the target's first ``dcfg.n_layers`` layers with its
    embedding, final norm and head, copied (same widths; only depth
    shrinks), each leaf a fresh f32 tensor that requires grad."""

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    draft = {k: leaf(v) for k, v in params.items() if k != "layers"}
    draft["layers"] = {k: leaf(v[:dcfg.n_layers])
                       for k, v in params["layers"].items()}
    return draft


@torch.no_grad()
def acceptance_stats(params, cfg, dparams, dcfg, corpus, rng, *,
                     batch: int = 8, seq: int = 128, temp: float = 0.8,
                     device=None):
    """Held-out diagnostics: the greedy top-1 agreement rate and the
    Leviathan expected sampling acceptance E[sum_v min(p, q)], both
    models' next-token laws on the same windows."""
    toks = windows(corpus, batch, seq, rng, device)
    lt = forward(params, toks, cfg)[:, :-1].float()
    ld = forward(dparams, toks, dcfg)[:, :-1].float()
    greedy = float((lt.argmax(-1) == ld.argmax(-1)).float().mean())
    p = torch.softmax(lt / temp, -1)
    q = torch.softmax(ld / temp, -1)
    return greedy, float(torch.minimum(p, q).sum(-1).mean())


def widths(on_card: bool, **over) -> tuple[dict, int, int]:
    """(base config dict, target layers, draft layers) of the JAX
    script's card or CPU branch, ``over`` replacing any of them."""
    base = dict(vocab=32768 if on_card else 256,
                d_model=1024 if on_card else 64,
                n_heads=8 if on_card else 4,
                d_ff=4096 if on_card else 128,
                dtype="bfloat16" if on_card else "float32",
                n_kv_heads=2 if on_card else 0,
                pos_embed="rope",
                max_seq=2048 if on_card else 256)
    if on_card:
        base["attention"] = "flash"
    layers = over.pop("layers", None) or (8 if on_card else 2)
    dlayers = over.pop("draft_layers", None) or (2 if on_card else 1)
    base.update({k: v for k, v in over.items() if v is not None})
    return base, layers, dlayers


def build_pair(out, *, steps: int, distill_steps: int, batch: int,
               seq: int, n_corpus: int, base: dict, layers: int,
               draft_layers: int, device=None, log=print) -> dict:
    """Train, truncate, distill, measure and save a pair under ``out``;
    returns the ``META.json`` dict (with ``"seconds"``: train, distill)."""
    dev = resolve_device(device)
    cfg = TransformerConfig(**base, n_layers=layers)
    dcfg = TransformerConfig(**base, n_layers=draft_layers)
    log(f"corpus: order-1 markov, {n_corpus} tokens")
    corpus = markov_corpus(cfg.vocab, n_corpus)
    rng = np.random.RandomState(1)

    # --- 1. train the target
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt_state = init_train_state(gen, cfg, device=dev)
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    for i in range(steps):
        loss, params, opt_state = step(params, opt_state,
                                       windows(corpus, batch, seq, rng, dev))
        if i % max(1, steps // 5) == 0 or i == steps - 1:
            log(f"target step {i}: loss {float(loss):.4f}")
    t_train = time.perf_counter() - t0
    log(f"target trained: {t_train:.1f}s")

    # --- 2. draft by truncation + distillation (target frozen)
    draft = truncate_draft(params, dcfg)
    opt = make_optimizer(1e-3)
    dopt = opt.init(draft)
    dleaves = tree_leaves(draft)

    def distill_step(toks):
        with torch.no_grad():
            tprob = torch.softmax(forward(params, toks, cfg).float(), -1)
        dlog = forward(draft, toks, dcfg).float()
        loss = -(tprob * torch.log_softmax(dlog, -1)).sum(-1).mean()
        opt.update(list(torch.autograd.grad(loss, dleaves)), dopt, draft)
        return loss.detach()

    t0 = time.perf_counter()
    for i in range(distill_steps):
        dl = distill_step(windows(corpus, batch, seq, rng, dev))
        if i % max(1, distill_steps // 5) == 0 or i == distill_steps - 1:
            log(f"distill step {i}: CE {float(dl):.4f}")
    t_distill = time.perf_counter() - t0
    log(f"draft distilled: {t_distill:.1f}s")

    # --- 3. diagnostics on a held-out path of the same process
    held_corpus = markov_corpus(cfg.vocab, 50_000, draw_seed=31337)
    held = np.random.RandomState(99)
    g_a, a_a = acceptance_stats(params, cfg, draft, dcfg, held_corpus, held,
                                device=dev)
    rand_draft = init_params(
        dcfg, generator=torch.Generator(device=dev).manual_seed(7),
        device=dev)
    g_r, a_r = acceptance_stats(params, cfg, rand_draft, dcfg, held_corpus,
                                held, device=dev)
    log(f"acceptance (held-out): aligned greedy-agree {g_a:.3f} "
        f"E[min(p,q)] {a_a:.3f} | random-draft greedy-agree {g_r:.3f} "
        f"E[min(p,q)] {a_r:.3f}")

    # --- 4. save the pair
    os.makedirs(out, exist_ok=True)
    save_checkpoint(os.path.join(out, "target"), params, opt_state)
    save_checkpoint(os.path.join(out, "draft"), draft, dopt)
    meta = {
        "target_cfg": {**base, "n_layers": cfg.n_layers},
        "draft_cfg": {**base, "n_layers": dcfg.n_layers},
        "steps": steps, "distill_steps": distill_steps,
        "acceptance": {"aligned_greedy": g_a, "aligned_minpq": a_a,
                       "random_greedy": g_r, "random_minpq": a_r},
        # torchlint: disable=record-kind-drift — a corpus descriptor's
        # kind, not a RunLog record
        "corpus": {"kind": "markov1", "tokens": n_corpus},
    }
    with open(os.path.join(out, "META.json"), "w") as f:
        json.dump(meta, f, indent=1)
    log(f"pair saved to {out}/ (META.json has the diagnostics)")
    return {**meta, "seconds": {"train": t_train, "distill": t_distill}}


def load_pair(path, *, max_seq: int | None = None,
              decode_attn: str = "flash", device=None):
    """(cfg, params, draft_cfg, draft_params, meta) of a pair built by
    :func:`build_pair`: the configs from ``META.json`` (``max_seq`` and
    ``decode_attn`` replaced when given), the params restored onto
    ``device`` (default ``cuda``) and stored in the compute dtype (every
    use casts to it, so the numbers are the same)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "META.json")) as f:
        meta = json.load(f)
    over = {"decode_attn": decode_attn,
            **({"max_seq": max_seq} if max_seq is not None else {})}

    def one(name):
        c = TransformerConfig(**{**meta[f"{name}_cfg"], **over})
        p, _ = restore_params(os.path.join(path, name), device=dev)
        dt = torch_dtype(c.dtype)
        return c, tree_map(lambda t: t.detach().to(dt), p)

    return (*one("target"), *one("draft"), meta)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="draft_pair")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; picks the width branch")
    for name in ("steps", "distill-steps", "batch", "seq", "corpus",
                 "vocab", "d", "ff", "max-seq", "layers", "draft-layers"):
        p.add_argument(f"--{name}", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    base, layers, dlayers = widths(
        on_card, vocab=args.vocab, d_model=args.d, d_ff=args.ff,
        max_seq=args.max_seq, layers=args.layers,
        draft_layers=args.draft_layers)

    def pick(v, card, cpu):
        return v if v is not None else (card if on_card else cpu)

    build_pair(args.out, steps=pick(args.steps, 400, 30),
               distill_steps=pick(args.distill_steps, 400, 30),
               batch=pick(args.batch, 16, 4), seq=pick(args.seq, 256, 32),
               n_corpus=pick(args.corpus, 2_000_000, 60_000), base=base,
               layers=layers, draft_layers=dlayers, device=dev,
               log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
