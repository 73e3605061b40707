"""The precision-law oracle: what "correct" means across precisions — the
counterpart of ``hpc_patterns_tpu/models/quantization.py``.

Token identity is the serving oracle WITHIN a precision (an int8-KV
engine equals int8-KV standalone decode). ACROSS precisions it cannot
hold: a quantized cache or weight set perturbs every logit, so the
contract is a law instead, measured teacher-forced (both variants walk
the reference's greedy tokens, so one early near-tie flip does not
compound):

- **greedy top-1 agreement**: the share of steps whose argmax equals
  the reference precision's;
- **total-variation distance**: ``0.5 * sum |softmax_a - softmax_b|``
  per step, as mean and max.

The serving check of quantized KV (``chip_smoke.py`` phase ``quant``)
runs this before it believes any quantized number, against
:data:`DEFAULT_BOUNDS`.
"""

from __future__ import annotations

import dataclasses

import torch

from hpc_patterns_tpu_torch.models.decode import decode_step, prefill
from hpc_patterns_tpu_torch.models.transformer import TransformerConfig

#: the law's bounds (JAX's ``DEFAULT_BOUNDS``, copied): above the values
#: measured at small scale (agreement ~0.95+, mean TV ~0.01) and tight
#: enough that a broken dequant, which sends TV toward 1, cannot pass
DEFAULT_BOUNDS = {
    "greedy_agreement_min": 0.85,
    "tv_mean_max": 0.05,
    "tv_max_max": 0.15,
}


@dataclasses.dataclass(frozen=True)
class PrecisionLaw:
    """One oracle run's verdict (:func:`precision_law`)."""
    greedy_agreement: float
    tv_mean: float
    tv_max: float
    steps: int

    def check(self, bounds: dict | None = None) -> None:
        """Raise AssertionError naming the violated bound."""
        b = {**DEFAULT_BOUNDS, **(bounds or {})}
        assert self.greedy_agreement >= b["greedy_agreement_min"], (
            f"precision law: greedy top-1 agreement "
            f"{self.greedy_agreement:.3f} < "
            f"{b['greedy_agreement_min']} over {self.steps} "
            "teacher-forced steps")
        assert self.tv_mean <= b["tv_mean_max"], (
            f"precision law: mean TV distance {self.tv_mean:.4f} > "
            f"{b['tv_mean_max']}")
        assert self.tv_max <= b["tv_max_max"], (
            f"precision law: max TV distance {self.tv_max:.4f} > "
            f"{b['tv_max_max']}")


def precision_law(params_ref, cfg_ref: TransformerConfig, params_q,
                  cfg_q: TransformerConfig, prompts, steps: int = 8,
                  ) -> PrecisionLaw:
    """Teacher-forced precision law between a reference precision
    (``params_ref``/``cfg_ref``) and a quantized variant
    (``params_q``/``cfg_q``: a quantized KV config, int8 weights from
    ``transformer.quantize_weights_int8``, or both). ``prompts``: (B, T) int,
    numpy or a tensor; the run is on the device of
    ``params_ref["embed"]``.

    Both variants prefill the prompts, then walk ``steps`` decode steps
    along the reference's greedy tokens on the linear cache (its
    ``decode_attn`` route: "flash" is the decode kernel on CUDA),
    comparing each step's argmax and softmax TV. KV precision shows from
    the first decode step, since prefill stores the quantized K/V."""
    dev = params_ref["embed"].device
    prompts = torch.as_tensor(prompts).to(device=dev, dtype=torch.int32)
    B, T = prompts.shape
    need = T + steps
    if need > min(cfg_ref.max_seq, cfg_q.max_seq):
        raise ValueError(
            f"prompt {T} + steps {steps} exceeds max_seq "
            f"{min(cfg_ref.max_seq, cfg_q.max_seq)}")
    la, cache_a = prefill(params_ref, prompts, cfg_ref, need)
    lb, cache_b = prefill(params_q, prompts, cfg_q, need)
    agree, tvs = [], []
    pos = T
    for step in range(steps):
        pa, pb = torch.softmax(la, dim=-1), torch.softmax(lb, dim=-1)
        tvs.append(0.5 * (pa - pb).abs().sum(dim=-1))
        ref_tok = torch.argmax(la, dim=-1).to(torch.int32)
        agree.append(ref_tok == torch.argmax(lb, dim=-1).to(torch.int32))
        if step == steps - 1:
            break  # the last judged logits need no successor state
        # both variants consume the reference's token (teacher forcing)
        la = decode_step(params_ref, cache_a, pos, ref_tok, cfg_ref)
        lb = decode_step(params_q, cache_b, pos, ref_tok, cfg_q)
        pos += 1
    tv = torch.stack(tvs).cpu()
    return PrecisionLaw(
        greedy_agreement=float(torch.stack(agree).float().mean()),
        tv_mean=float(tv.mean()),
        tv_max=float(tv.max()),
        steps=steps,
    )
