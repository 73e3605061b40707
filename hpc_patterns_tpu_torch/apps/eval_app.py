"""Eval app: perplexity of a checkpoint (or fresh params) over a corpus —
the counterpart of ``hpc_patterns_tpu/apps/eval_app.py``.

Sequential windows from a memmap token file (or synthetic fuel), the
masked causal NLL shared with training (``transformer.loss_fn``, so eval
and train loss cannot drift), forward only, mean NLL -> perplexity.
Self-validating: every NLL finite; a fresh model's perplexity within a
factor 20 of the uniform bound (vocab) both ways, a checkpoint's above 1
and at most 20x vocab. Prints SUCCESS/FAILURE (exit 0/1).

    python -m hpc_patterns_tpu_torch.apps.eval_app --device cpu \\
        --checkpoint-dir /tmp/ck --batches 2 --batch 2 --seq 64 \\
        --d-model 64 --n-layers 2 --n-heads 4 --vocab 256
"""

from __future__ import annotations

import math
import sys

import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness.cli import base_parser
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.verdict import Verdict
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_fn,
)
from hpc_patterns_tpu_torch.topology import resolve_device


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--data", default=None, metavar="TOKENS.bin",
                   help="raw binary token file (sequential windows); "
                        "default: synthetic fuel")
    p.add_argument("--data-dtype", default="uint16",
                   choices=["uint16", "uint32", "int32"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="restore params saved by train_app "
                        "--checkpoint-dir; default: fresh init")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--attention", default="full")
    p.add_argument("--pos-embed", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--loss-chunk", type=int, default=0, metavar="C",
                   help="online-logsumexp NLL over vocab chunks of C (must "
                        "divide --vocab; 0 = dense)")
    return p


def _fail(log, msg) -> int:
    log.print(f"ERROR: {msg}")
    log.print("FAILURE")
    return 1


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    try:
        cfg = TransformerConfig(
            vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
            n_layers=args.n_layers, d_ff=4 * args.d_model, max_seq=args.seq,
            attention=args.attention, n_kv_heads=args.n_kv_heads,
            pos_embed=args.pos_embed, loss_chunk=args.loss_chunk)
    except ValueError as e:
        return _fail(log, str(e))
    dev = resolve_device(args.device)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    if args.checkpoint_dir:
        from hpc_patterns_tpu_torch.utils.checkpoint import (
            restore_params,
            same_structure,
        )

        try:
            restored, step = restore_params(args.checkpoint_dir, device=dev)
        except (FileNotFoundError, ValueError, KeyError) as e:
            return _fail(log, f"cannot restore {args.checkpoint_dir}: {e}")
        if not same_structure(params, restored):
            return _fail(log, "checkpoint shapes/dtypes do not match the CLI "
                              "model config (wrong --d-model/--n-layers/"
                              "--vocab/--pos-embed?)")
        params = restored
        log.print(f"restored step {step} from {args.checkpoint_dir}")

    if args.data:
        from hpc_patterns_tpu_torch.utils.data import memmap_tokens

        source = memmap_tokens(args.data, batch=args.batch, seq=args.seq,
                               dtype=args.data_dtype, steps=args.batches,
                               sequential=True, vocab=cfg.vocab)
    else:
        from hpc_patterns_tpu_torch.utils.data import synthetic_tokens

        source = synthetic_tokens(1, batch=args.batch, seq=args.seq,
                                  vocab=cfg.vocab, steps=args.batches)
    m = metricslib.get_metrics()
    nlls = []
    with torch.no_grad():
        for b in source:
            with m.span("eval.batch"):
                tokens = torch.from_numpy(b).to(dev)
                # float() reads back, closing the span honestly
                nlls.append(float(loss_fn(params, tokens, cfg)))
    mean_nll = sum(nlls) / len(nlls)
    ppl = math.exp(mean_nll)
    m.gauge("eval.mean_nll").set(mean_nll)
    m.gauge("eval.perplexity").set(ppl)
    finite = all(math.isfinite(x) for x in nlls)
    if args.checkpoint_dir is None:
        # untrained params ~ uniform predictor: ppl near vocab (an
        # impossibly low fresh-init ppl means a masking/leakage bug)
        sane = cfg.vocab / 20 <= ppl <= 20 * cfg.vocab
    else:
        sane = 1.0 < ppl <= 20 * cfg.vocab
    ok = finite and sane
    log.emit(kind="result", name="eval", success=ok, batches=len(nlls),
             mean_nll=mean_nll, perplexity=ppl, vocab=cfg.vocab,
             device=str(dev))
    log.print(f"eval {len(nlls)} batches: nll {mean_nll:.4f}, perplexity "
              f"{ppl:.1f} (vocab {cfg.vocab})")
    verdict = Verdict(success=ok, messages=("SUCCESS" if ok else "FAILURE",))
    log.print(verdict.summary_line())
    return verdict.exit_code


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
