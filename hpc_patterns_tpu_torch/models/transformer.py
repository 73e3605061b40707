"""Decoder-only transformer: the counterpart of
``hpc_patterns_tpu/models/transformer.py`` — the config, parameter init,
the layer pieces shared with decode (``_rmsnorm``, ``apply_rope``,
``project_qkv``, ``matmul_weight``), the trunk (``forward_hidden``,
``forward``) and the training loss (``masked_causal_nll``,
``chunked_masked_causal_nll``, ``loss_fn``), differentiable with
PyTorch's autograd (the flash route through the hand-written backward
kernels of ``ops/flash_attention.py``, ``mlp_impl="fused"`` through those
of ``ops/fused_mlp.py``), with JAX's activation-checkpointing policies
(``remat``, ``remat_policy``) on ``torch.utils.checkpoint``.

Mixture-of-experts layers (``n_experts > 0``) route through
``parallel/moe.py`` (:func:`_moe_block`). A ``mesh`` is a ``{axis: size}``
dict whose ranks are logical ranks of one device, JAX's axes in JAX's
order (dp, fsdp, sp, tp, ep):

- ``tp``: Megatron tensor parallelism. The params are stored as their
  rank-stacked shards (``models/sharding.shard_params``); ``wqkv`` and
  ``w1`` are column-parallel (one product over the folded tp ranks), the
  heads split in contiguous blocks, attention runs on each (dp, tp)
  shard, ``wo`` and ``w2`` are row-parallel (each rank's partial product,
  summed over the tp ranks: ``parallel/tensor.row_parallel_out``), the
  fused MLP kernels run on each rank's ``(D, F/tp)`` / ``(F/tp, D)``
  shard, and the loss takes one log-sum-exp per row over the
  vocab-sharded ``lm_head`` (no rank forms the full-vocab logits);
- ``fsdp`` (with ``cfg.fsdp``): ZeRO-3. Each layer's weights, and the
  embedding tables, are all-gathered over fsdp just before use (the
  backward of the gather is the reduce-scatter of their gradients), and
  the batch shards over dp x fsdp;
- ``dp`` (and fsdp as data): the batch's row blocks. Every rank's rows go
  through one launch over the folded rank dims, and the gradient mean
  over those ranks is the weight-gradient product's reduction over them;
- ``sp``: the ring and Ulysses attentions over the sequence's blocks;
- ``ep``: the expert-parallel MoE over the batch's shards x ep.

Everything else computes once on the whole tensors, as every rank's
replica would.

Params keep the JAX layout: a plain dict with the same keys, layer
weights stacked on a leading ``n_layers`` axis, so a JAX params tree
maps over key for key (``models/convert.py``) and both sides compute
the same thing from the same numbers. Weights are cast to the compute
dtype at use, as in JAX (int8-quantized ones dequantized at use:
:func:`quantize_weights_int8`, :func:`matmul_weight`); storing them already in that dtype
(``init_params(..., dtype=torch.bfloat16)``) gives the same numbers and
skips the per-use cast.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.models.sharding_util import (
    from_ranks,
    is_stacked,
    mesh_axis_size,
    rank_axes,
    resolve_spec,
    to_ranks,
)
from hpc_patterns_tpu_torch.ops.flash_attention import flash_attention
from hpc_patterns_tpu_torch.ops.fused_mlp import fused_mlp
from hpc_patterns_tpu_torch.parallel import moe
from hpc_patterns_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
)
from hpc_patterns_tpu_torch.parallel.tensor import (
    column_parallel_in,
    row_parallel_out,
)
from hpc_patterns_tpu_torch.parallel.ulysses import ulysses_attention
from hpc_patterns_tpu_torch.topology import resolve_device

ATTENTION_IMPLS = ("full", "flash", "ring", "ring_flash", "ulysses",
                   "ulysses_flash")

#: sibling-key suffix of a quantized weight's scales in the JAX tree
QUANT_SCALE_SUFFIX = "_qscale"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields, defaults and validation as the JAX config (see its
    docstrings for each knob); the port runs every ``attention`` (the
    sharded ones over a mesh's ``sp`` ranks), dense layers with either
    ``mlp_impl`` (decode runs the dense MLP for both, as in JAX), MoE
    layers with every ``moe_dispatch``, every ``remat_policy``, and KV
    caches in the compute dtype, int8 or fp8, and every mesh axis as
    logical ranks of one device (module docstring)."""
    vocab: int = 32768
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_seq: int = 2048
    dtype: str = "bfloat16"
    attention: str = "full"
    n_kv_heads: int = 0
    remat_policy: str = "split"
    scan_layers: bool = True
    pos_embed: str = "learned"
    rope_theta: float = 10000.0
    remat: bool = False
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    n_experts_top_k: int = 1
    moe_dispatch: str = "auto"
    fsdp: bool = False
    axis_fsdp: str = "fsdp"
    loss_chunk: int = 0
    mlp_impl: str = "dense"
    decode_attn: str = "flash"
    kv_cache_dtype: str = "compute"
    axis_dp: str = "dp"
    axis_sp: str = "sp"
    axis_tp: str = "tp"
    axis_ep: str = "ep"

    @property
    def mesh_axes(self) -> frozenset:
        """Declared axis names: the set ``resolve_spec`` may prune."""
        return frozenset((self.axis_dp, self.axis_sp, self.axis_tp,
                          self.axis_ep, self.axis_fsdp))

    @property
    def batch_axes(self) -> tuple:
        """Mesh axes the batch dimension shards over (JAX's rule)."""
        if self.fsdp and self.axis_fsdp != self.axis_dp:
            return (self.axis_dp, self.axis_fsdp)
        return (self.axis_dp,)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} % n_heads {self.n_heads} != 0")
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.pos_embed not in ("learned", "rope"):
            raise ValueError(
                f"pos_embed {self.pos_embed!r} not in ('learned', 'rope')")
        if self.pos_embed == "rope" and self.head_dim % 2:
            raise ValueError("rope needs an even head_dim")
        if self.attention not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention {self.attention!r} not in {ATTENTION_IMPLS}")
        if self.loss_chunk < 0 or (self.loss_chunk and
                                   self.vocab % self.loss_chunk):
            raise ValueError(
                f"loss_chunk {self.loss_chunk} must be 0 or divide "
                f"vocab {self.vocab}")
        if self.moe_dispatch not in ("auto", "einsum", "scatter"):
            raise ValueError(
                f"moe_dispatch {self.moe_dispatch!r} not in "
                "('auto', 'einsum', 'scatter')")
        if self.n_experts and not (
                1 <= self.n_experts_top_k <= max(self.n_experts, 1)):
            raise ValueError(
                f"n_experts_top_k {self.n_experts_top_k} outside "
                f"[1, n_experts={self.n_experts}]")
        if self.kv_cache_dtype not in ("compute", "int8", "fp8"):
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r} not in "
                "('compute', 'int8', 'fp8')")
        if self.decode_attn not in ("flash", "gather", "paged_flash"):
            raise ValueError(
                f"decode_attn {self.decode_attn!r} not in "
                "('flash', 'gather', 'paged_flash')")
        if self.mlp_impl not in ("dense", "fused"):
            raise ValueError(
                f"mlp_impl {self.mlp_impl!r} not in ('dense', 'fused')")
        if self.remat_policy not in ("nothing", "attn", "dots", "dots_attn",
                                     "split"):
            raise ValueError(
                f"remat_policy {self.remat_policy!r} not in "
                "('nothing', 'attn', 'dots', 'dots_attn', 'split')")
        if self.n_kv_heads < 0 or self.n_kv_heads > self.n_heads or (
                self.n_kv_heads and self.n_heads % self.n_kv_heads):
            raise ValueError(
                f"n_kv_heads {self.n_kv_heads} must be in [1, n_heads] and "
                f"divide n_heads {self.n_heads} (0 = MHA)")


def init_params(cfg: TransformerConfig, *, generator: torch.Generator,
                device=None, dtype: torch.dtype = torch.float32):
    """Random params with the JAX init's shapes and scales
    (``transformer.py::init_params``): normal draws from ``generator``
    (on the generator's own device), then moved to ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``) and stored
    in ``dtype``. An MoE config draws ``router`` (L, D, E) and the expert
    stacks ``w1`` (L, E, D, F), ``w2`` (L, E, F, D) in JAX's order and
    scales."""
    dev = resolve_device(device)
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab

    def initn(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return w.to(device=dev, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    layers = {
        "ln1_scale": ones((L, D)),
        "ln2_scale": ones((L, D)),
        "wqkv": initn((L, D, D + 2 * cfg.kv_heads * cfg.head_dim),
                      D ** -0.5),
        "wo": initn((L, D, D), (2 * D * L) ** -0.5),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        layers["router"] = initn((L, D, E), D ** -0.5)
        layers["w1"] = initn((L, E, D, Fd), D ** -0.5)
        layers["w2"] = initn((L, E, Fd, D), (2 * Fd * L) ** -0.5)
    else:
        layers["w1"] = initn((L, D, Fd), D ** -0.5)
        layers["w2"] = initn((L, Fd, D), (2 * Fd * L) ** -0.5)
    params = {"embed": initn((V, D), 0.02)}
    if cfg.pos_embed == "learned":
        params["pos_embed"] = initn((cfg.max_seq, D), 0.02)
    params["layers"] = layers
    params["ln_f_scale"] = ones((D,))
    params["lm_head"] = initn((D, V), D ** -0.5)
    return params


def _quantize_channels(w):
    """Per-output-channel symmetric int8 quantization of a matmul weight
    ``(..., d_in, d_out)``: (int8 values, f32 scales ``(..., d_out)``)
    with ``w ~= q * scale`` (JAX ``transformer.py::_quantize_channels``:
    the same f32 ops, so the bytes agree on equal inputs)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


#: the decode-matmul weights :func:`quantize_weights_int8` covers (every
#: per-layer GEMM of the step, plus ``lm_head``)
QUANTIZED_LAYER_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def quantize_weights_int8(params):
    """Int8 weights for the decode matmuls: ``wqkv``/``wo``/``w1``/``w2``
    per layer and ``lm_head`` become int8 values with per-output-channel
    f32 scales under ``<name>_qscale`` sibling keys; norms and the
    embedding stay as they are. Dequant happens at use
    (:func:`matmul_weight`). Returns a new dict; ``params`` is not
    changed."""
    if "router" in params["layers"]:
        raise ValueError(
            "quantize_weights_int8 covers dense decode layers "
            f"({QUANTIZED_LAYER_WEIGHTS}); MoE expert weights would need "
            "per-expert channel scales")
    layers = dict(params["layers"])
    for name in QUANTIZED_LAYER_WEIGHTS:
        layers[name], layers[name + QUANT_SCALE_SUFFIX] = _quantize_channels(
            layers[name])
    out = dict(params)
    out["layers"] = layers
    out["lm_head"], out["lm_head" + QUANT_SCALE_SUFFIX] = _quantize_channels(
        params["lm_head"])
    return out


def matmul_weight(tree, name: str, dt: torch.dtype):
    """The dequant-at-use accessor of a (possibly int8-quantized) matmul
    weight: a plain weight is cast to the compute dtype; a quantized one
    (a ``<name>_qscale`` sibling) is widened to f32, scaled per output
    channel (the last axis) and cast to ``dt`` — JAX's order."""
    w = tree[name]
    qs = tree.get(name + QUANT_SCALE_SUFFIX)
    if qs is None:
        return w.to(dt)
    return (w.float() * qs.float()[..., None, :]).to(dt)


def tp_stack(w) -> int:
    """The tp ranks a 2-D matmul weight (``wqkv``, ``wo``, the dense
    ``w1``/``w2``, ``lm_head``) in :func:`local_params`' form is stacked
    over: (tp, in, out/tp) column or (tp, in/tp, out) row shards give tp,
    the global (in, out) weight 1. The one test of that storage form."""
    return w.shape[0] if w.dim() == 3 else 1


def layer_params(params, l: int):
    """Layer ``l``'s slice of the stacked layer weights (views)."""
    return {k: v[l] for k, v in params["layers"].items()}


def _rmsnorm(x, scale):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def apply_rope(x, positions, cfg: TransformerConfig):
    """Rotate each (first-half, second-half) feature pair of ``x``
    (..., T, heads, head_dim) by pos * theta^(-2i/d), in f32, cast
    back. ``positions``: int or (..., T) integer tensor of global
    positions (a decode step passes a scalar or (B,))."""
    half = x.shape[-1] // 2
    inv_freq = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device).float()
    angles = pos[..., None] * inv_freq
    cos = torch.cos(angles).unsqueeze(-2)  # broadcast over heads
    sin = torch.sin(angles).unsqueeze(-2)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def project_qkv(h, lp, cfg: TransformerConfig):
    """Fused qkv projection + head split (the JAX split order: q, then
    the kv_heads-narrow k, then v). ``h`` (..., d_model) -> q
    (..., n_heads, Dh), k/v (..., kv_heads, Dh)."""
    *lead, D = h.shape
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    w = matmul_weight(lp, "wqkv", h.dtype)
    if tp_stack(w) > 1:
        # column-parallel over the tp ranks' contiguous column blocks,
        # then the blocks gathered back into the fused column order (the
        # reshard JAX's partitioner inserts before the head split)
        qkv = torch.movedim(column_parallel_in(h, w), 0, -2).flatten(-2)
    else:
        qkv = h @ w
    q, k, v = torch.split(qkv, [D, Hkv * Dh, Hkv * Dh], dim=-1)
    return (q.reshape(*lead, H, Dh), k.reshape(*lead, Hkv, Dh),
            v.reshape(*lead, Hkv, Dh))


def _mlp_dense(h, lp):
    """The dense MLP on post-norm activations (tanh gelu, as
    ``jax.nn.gelu``'s default). tp-stacked weights ((tp, D, F/tp) /
    (tp, F/tp, D)): column-parallel in, gelu on each rank's shard,
    row-parallel out."""
    dt = h.dtype
    w1, w2 = matmul_weight(lp, "w1", dt), matmul_weight(lp, "w2", dt)
    if tp_stack(w1) > 1:
        a = F.gelu(column_parallel_in(h, w1), approximate="tanh")
        return row_parallel_out(a, w2)
    return F.gelu(h @ w1, approximate="tanh") @ w2


def _mlp_fused(h, lp):
    """The fused MLP kernels (``ops/fused_mlp.py``) on post-norm
    activations; a quantized tree is dequantized at entry (the kernels
    take dense compute-dtype operands). tp-stacked weights (JAX's mesh
    branch): the kernels on each tp rank's contiguous ``(D, F/tp)`` /
    ``(F/tp, D)`` shard, the partial outputs summed over the tp ranks."""
    dt = h.dtype
    w1, w2 = matmul_weight(lp, "w1", dt), matmul_weight(lp, "w2", dt)
    tp = tp_stack(w1)
    if tp > 1:
        return torch.stack([fused_mlp(h, w1[r], w2[r])
                            for r in range(tp)]).sum(0)
    return fused_mlp(h, w1, w2)


def _resolve_dispatch(cfg: TransformerConfig, n_tokens: int,
                      capacity: int) -> str:
    """``cfg.moe_dispatch``, with "auto" resolved as JAX does: scatter
    once the two live choice-major one-hots (k·N, E, C) f32 would pass
    16 MiB, else einsum."""
    if cfg.moe_dispatch != "auto":
        return cfg.moe_dispatch
    big = 2 * cfg.n_experts_top_k * n_tokens * cfg.n_experts * capacity * 4
    return "scatter" if big > 16 << 20 else "einsum"


def mlp(x, lp, cfg: TransformerConfig):
    """Pre-norm MLP block with residual: decode's MLP for either
    ``mlp_impl`` (the same function; JAX decode does the same). An MoE
    layer routes drop-free, capacity = the token count (a token's k
    choices are distinct experts, so no expert gets more): serving never
    drops a token, and incremental decode equals a drop-free forward.
    JAX's decode always takes the einsum dispatch; the port resolves
    ``cfg.moe_dispatch`` (scatter past 16 MiB of one-hots: a chip
    prefill's 8 x 1024 tokens would need 4 GiB each), with the same
    assignments."""
    h = _rmsnorm(x, lp["ln2_scale"])
    if not cfg.n_experts:
        return x + _mlp_dense(h, lp)
    *lead, D = h.shape
    flat = h.reshape(-1, D)
    n = flat.shape[0]
    y, _ = moe.moe_dense(flat, lp["router"], lp["w1"], lp["w2"],
                         capacity=n, top_k=cfg.n_experts_top_k,
                         dispatch=_resolve_dispatch(cfg, n, n))
    return x + y.reshape(*lead, D).to(x.dtype)


def logical_mesh(mesh, cfg: TransformerConfig) -> dict | None:
    """The mesh's axes of size > 1, checked: every axis must be one of the
    config's, each runs as logical ranks of one device (module
    docstring). A size-1 axis changes nothing and is dropped (an ``ep``
    of 1 is ``moe_dense``'s result; ``{}`` still routes the ring/Ulysses
    impls over one rank)."""
    if mesh is None:
        return None
    for a, n in mesh.items():
        if a not in cfg.mesh_axes:
            raise ValueError(f"mesh axis {a!r} is not a declared model axis "
                             f"{sorted(cfg.mesh_axes)}")
        if int(n) < 1:
            raise ValueError(f"mesh axis {a!r} has size {n}")
    return {a: int(n) for a, n in mesh.items() if int(n) > 1}


def tp_size(mesh, cfg: TransformerConfig) -> int:
    """The mesh's tp ranks (1 without a mesh)."""
    return mesh_axis_size(mesh, cfg.axis_tp) if mesh is not None else 1


def shards_params(mesh, cfg: TransformerConfig) -> bool:
    """Whether params are stored as shards on ``mesh``: a tp axis, or an
    fsdp axis under ``cfg.fsdp``."""
    return mesh is not None and (
        tp_size(mesh, cfg) > 1
        or (cfg.fsdp and mesh_axis_size(mesh, cfg.axis_fsdp) > 1))


def _only(spec, keep) -> tuple:
    """``spec`` with every axis outside ``keep`` dropped."""
    def fix(ax):
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a in keep)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return ax if ax in keep else None
    return tuple(fix(ax) for ax in spec)


def _local(leaf, spec, mesh, cfg: TransformerConfig):
    """A param (or one layer's slice of it) as the layer code takes it:
    stacked over the tp and ep ranks its spec names, every other rank
    axis gathered (fsdp's all-gather just before use; its backward is
    the gradients' reduce-scatter). A global leaf is split into a view."""
    s = resolve_spec(spec, mesh, cfg.mesh_axes)
    axes = rank_axes(s, mesh)
    keep = tuple(a for a in axes if a in (cfg.axis_tp, cfg.axis_ep))
    if is_stacked(leaf, spec):
        return leaf if axes == keep else from_ranks(leaf, s, mesh, axes,
                                                    keep)
    return to_ranks(leaf, _only(s, keep), mesh, keep) if keep else leaf


def local_params(params, cfg: TransformerConfig, mesh=None):
    """(top, layers): the non-layer params and a list of per-layer dicts,
    each leaf in :func:`_local`'s form (without a mesh: the params as
    they are). On a mesh that shards params (:func:`shards_params`) a
    global tree is first placed as its shards (``sharding.shard_params``,
    a no-op on a sharded tree). One unbind per stacked weight: its
    backward stacks the per-layer grads once (indexing each layer would
    build L full-size zeros)."""
    from hpc_patterns_tpu_torch.models import sharding

    if shards_params(mesh, cfg):
        params = sharding.shard_params(params, mesh, cfg)
    specs = sharding.param_specs(cfg) if mesh is not None else {}
    lspecs = specs.get("layers", {})

    def loc(leaf, spec):
        return leaf if spec is None else _local(leaf, spec, mesh, cfg)

    top = {k: loc(v, specs.get(k)) for k, v in params.items()
           if k != "layers"}
    layers = [{} for _ in range(cfg.n_layers)]
    for k, v in params["layers"].items():
        spec = lspecs.get(k)
        n_rank = 0 if spec is None else v.dim() - len(spec)
        for l, piece in enumerate(v.unbind(n_rank)):
            layers[l][k] = loc(piece, None if spec is None else spec[1:])
    return top, layers


def _heads_to_ranks(t, tp: int):
    """(..., H, Dh) -> (tp, ..., H/tp, Dh): contiguous head blocks, so
    q head k·g+j stays with kv head k."""
    *lead, H, Dh = t.shape
    return t.reshape(*lead, tp, H // tp, Dh).movedim(-3, 0)


def attention(q, k, v, cfg: TransformerConfig, mesh=None):
    """Causal self-attention per ``cfg.attention`` (JAX ``_attention``):
    "flash" runs ``ops.flash_attention`` (the Hopper kernels on CUDA,
    forward and backward) and needs the sequence unsharded; "full", or
    any impl without a mesh, the dense grouped-query path; "ring[_flash]"
    and "ulysses[_flash]" run over the ``sp`` ranks of ``mesh`` (a
    :func:`logical_mesh`) on the rank-stacked sequence blocks.

    tp-stacked heads (q (tp, B, T, H/tp, Dh), from :func:`_qkv_block`) and
    the dp/fsdp batch shards fold into the batch: every (dp, tp) shard in
    one launch over the folded rank dims. Returns q's form."""
    if q.dim() == 5:
        tp, B = q.shape[:2]
        o = attention(*(t.reshape(tp * B, *t.shape[2:]) for t in (q, k, v)),
                      cfg, mesh)
        return o.reshape(tp, B, *o.shape[1:])
    if cfg.attention == "flash":
        if mesh is not None and mesh_axis_size(mesh, cfg.axis_sp) > 1:
            raise ValueError(
                "attention='flash' needs the sequence unsharded (sp=1); "
                "use 'ring_flash' to run the kernel per ring step over a "
                "sharded sequence")
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    if cfg.attention == "full" or mesh is None:
        return full_attention(q, k, v, causal=True)
    sp = cfg.axis_sp
    spec = resolve_spec((None, sp, None, None), mesh, cfg.mesh_axes)
    base, _, variant = cfg.attention.partition("_")
    impl_fn = ulysses_attention if base == "ulysses" else ring_attention
    out = impl_fn(*(to_ranks(t, spec, mesh, (sp,)) for t in (q, k, v)),
                  causal=True, impl=variant or "dense")
    return from_ranks(out, spec, mesh, (sp,))


def _moe_block(h, lp, cfg: TransformerConfig, mesh, with_stats=False):
    """Top-k routed experts (JAX ``_moe_block``). Returns (out, aux), plus
    the kept fraction with ``with_stats``. Without a mesh, all tokens and
    experts at once. On a mesh (a :func:`logical_mesh`) the tokens shard
    over the ``sp`` ranks by sequence and over the ``ep`` ranks by batch
    when the batch divides them (else routing runs replicated across ep,
    with JAX's warning); the capacity is per local shard, as in JAX,
    since drops depend on it; each sp rank's ep group runs
    ``moe.moe_ep`` (``moe_dense`` without an ep axis), and aux and kept
    are averaged over every rank."""
    B, T, D = h.shape
    k, E = cfg.n_experts_top_k, cfg.n_experts
    if mesh is None:
        cap = moe.default_capacity(B * T * k, E, cfg.capacity_factor)
        y, *rest = moe.moe_dense(
            h.reshape(B * T, D), lp["router"], lp["w1"], lp["w2"],
            capacity=cap, top_k=k, with_stats=with_stats,
            dispatch=_resolve_dispatch(cfg, B * T, cap))
        return (y.reshape(B, T, D), *rest)

    sp, ep = cfg.axis_sp, cfg.axis_ep
    bx = cfg.batch_axes
    n_ep = mesh_axis_size(mesh, ep)
    b_size = math.prod(mesh_axis_size(mesh, ax) for ax in bx)
    batch_over_ep = B % (b_size * n_ep) == 0
    if not batch_over_ep and n_ep > 1:
        warnings.warn(
            f"moe: batch {B} does not divide batch_shards*ep "
            f"({b_size}*{n_ep}); routing runs replicated across ep (experts "
            "still partitioned) — pad the batch to recover partitioned "
            "routing", stacklevel=2)
    b_shards = b_size * (n_ep if batch_over_ep else 1)
    n_local = (B // b_shards) * (T // mesh_axis_size(mesh, sp))
    cap = moe.default_capacity(n_local * k, E, cfg.capacity_factor)
    disp = _resolve_dispatch(cfg, n_local, cap)
    tok_spec = resolve_spec(((*bx, ep) if batch_over_ep else bx, sp, None),
                            mesh, cfg.mesh_axes)
    # the token shards range over the batch axes x sp (one ep group each)
    # and over ep; x: (*batch ranks, n_sp, n_ep, b, t, D)
    axes = (*(a for a in bx if a in mesh), sp, ep)
    x = to_ranks(h, tok_spec, mesh, axes)
    *grid, n_ep_, b, t, _ = x.shape
    x = x.reshape(-1, n_ep, b * t, D)
    # the expert stacks as (ep, E/ep, ...) whether stored global or
    # stacked over ep (local_params)
    w1 = lp["w1"].reshape(n_ep, E // n_ep, *lp["w1"].shape[-2:])
    w2 = lp["w2"].reshape(n_ep, E // n_ep, *lp["w2"].shape[-2:])
    outs = [moe.moe_ep(x[s], lp["router"], w1, w2, capacity=cap, top_k=k,
                       with_stats=with_stats, dispatch=disp)
            for s in range(x.shape[0])]
    y = torch.stack([o[0] for o in outs]).reshape(*grid, n_ep_, b, t, D)
    # moe_ep averaged over ep; fold the batch and sp ranks for the
    # global scalars
    scalars = [torch.stack([o[i] for o in outs]).mean()
               for i in range(1, len(outs[0]))]
    return (from_ranks(y, tok_spec, mesh, axes), *scalars)


def _embed_tokens(params, tokens, cfg: TransformerConfig, dt):
    """Token + learned-position embedding lookup in the compute dtype
    (the tables are cast at use, as in JAX)."""
    x = params["embed"].to(dt)[tokens]
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"].to(dt)[:tokens.shape[1]]
    return x


@torch.library.custom_op("hpcpat::attn_out", mutates_args=())
def attn_out(o: torch.Tensor) -> torch.Tensor:
    """The attention output under a name a checkpoint policy can save
    (JAX's ``checkpoint_name(o, "attn_out")``): a copy, with the identity
    gradient. Only a layer checkpointed under the "attn" and "dots_attn"
    policies calls it, so it costs nothing elsewhere."""
    return o.clone()


attn_out.register_fake(torch.empty_like)
attn_out.register_autograd(lambda ctx, g: g)

#: the ops whose outputs each ``remat_policy`` keeps (None: a plain
#: checkpoint keeps nothing). "dots" is JAX's
#: ``dots_with_no_batch_dims_saveable``: the 2-D products (every
#: projection reaches dispatch as ``mm``; the port has no biased
#: ``addmm``) are saved, the batched ``bmm`` of full attention
#: recomputes. A kernel launched through ctypes is no op here, so its
#: outputs always recompute (as a ``custom_vjp``'s residuals do in JAX):
#: "split" keeps the kernels out of every checkpointed region instead.
_MM = torch.ops.aten.mm.default
_ATTN_OUT = torch.ops.hpcpat.attn_out.default
REMAT_SAVES = {"nothing": None, "attn": (_ATTN_OUT,), "dots": (_MM,),
               "dots_attn": (_MM, _ATTN_OUT)}


def _remat(fn, policy: str):
    """``fn`` under ``torch.utils.checkpoint`` keeping the outputs of
    ``REMAT_SAVES[policy]``; everything else recomputes in the
    backward. The cache holds op outputs only, never an ``empty``
    buffer a kernel writes into."""
    saves = REMAT_SAVES[policy]
    if saves is None:
        return partial(checkpoint, fn, use_reentrant=False)
    return partial(checkpoint, fn, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, list(saves)))


def _qkv_block(x, lp, cfg: TransformerConfig):
    """Pre-attention: norm, fused qkv projection and rope (the narrow
    K/V for GQA). Split out so ``remat_policy="split"`` can checkpoint it
    apart from the attention kernel. With tp-stacked weights the heads
    come back as their tp ranks' contiguous blocks (tp, B, T, H/tp, Dh);
    GQA stays narrow only where tp divides ``kv_heads``, else K and V are
    expanded to every head first, as JAX expands them."""
    T = x.shape[1]
    h = _rmsnorm(x, lp["ln1_scale"])
    q, k, v = project_qkv(h, lp, cfg)
    if cfg.pos_embed == "rope":
        pos = torch.arange(T, device=x.device)
        q = apply_rope(q, pos, cfg)
        k = apply_rope(k, pos, cfg)
    tp = tp_stack(lp["wqkv"])
    if tp > 1:
        if cfg.kv_heads % tp:
            g = cfg.n_heads // cfg.kv_heads
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        q, k, v = (_heads_to_ranks(t, tp) for t in (q, k, v))
    return q, k, v


def _post_attn(x, o, lp):
    """Output projection, residual and the pre-MLP norm: the first half
    of :func:`_post_block`, split out so split remat can checkpoint it
    while the fused MLP kernel stays outside the region. tp-stacked
    heads: ``wo`` row-parallel over their blocks."""
    B, T, D = x.shape
    wo = matmul_weight(lp, "wo", x.dtype)
    tp = tp_stack(wo)
    if tp > 1:
        x = x + row_parallel_out(o.reshape(tp, B, T, D // tp), wo)
    else:
        x = x + o.reshape(B, T, D) @ wo
    return x, _rmsnorm(x, lp["ln2_scale"])


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _post_block(x, o, lp, cfg: TransformerConfig, mesh=None,
                with_stats: bool = False):
    """Post-attention: output projection, residual, norm, the MLP (per
    ``cfg.mlp_impl``) or the MoE block, and its residual. Returns (x,
    moe aux), plus the MoE kept fraction with ``with_stats`` (1 for a
    dense layer)."""
    x, h = _post_attn(x, o, lp)
    if cfg.n_experts:
        h, aux, *st = _moe_block(h, lp, cfg, mesh, with_stats=with_stats)
        return (x + h.to(x.dtype), aux, *st)
    h = _mlp_fused(h, lp) if cfg.mlp_impl == "fused" else _mlp_dense(h, lp)
    st = [torch.ones((), dtype=torch.float32, device=x.device)] \
        if with_stats else []
    return (x + h, _zero(x), *st)


def _layer(x, lp, cfg: TransformerConfig, mesh=None,
           split_remat: bool = False, tag_attn: bool = False):
    """One pre-norm block: attention, then the MLP or MoE block. Returns
    (x, moe aux).

    ``split_remat``: checkpoint the qkv block and the post block apart
    (the "dots" policy in each), with attention outside every region,
    so the flash kernel's residuals persist and its forward runs once;
    with ``mlp_impl="fused"`` (dense layers) only o-proj/residual/norm
    are checkpointed and the MLP kernel runs on the saved norm output,
    outside too. ``tag_attn``: name the attention output for the "attn"
    policies."""
    pre, post = _qkv_block, _post_block
    if split_remat:
        pre, post = _remat(pre, "dots"), _remat(post, "dots")
    q, k, v = pre(x, lp, cfg)
    o = attention(q, k, v, cfg, mesh)
    if tag_attn:
        o = attn_out(o)
    if split_remat and cfg.mlp_impl == "fused" and not cfg.n_experts:
        x1, hn = _remat(_post_attn, "dots")(x, o, lp)
        return x1 + _mlp_fused(hn, lp), _zero(x)
    return post(x, o, lp, cfg, mesh)


def forward_hidden(params, tokens, cfg: TransformerConfig, mesh=None):
    """The trunk of :func:`forward` without the LM head: final-norm
    hidden states (B, T, d_model) in the compute dtype, plus the summed
    MoE aux loss (a zero for dense models). ``mesh``: a ``{axis: size}``
    dict of logical ranks (:func:`logical_mesh`; module docstring);
    None = one rank. ``params``: the global tree or its shards
    (``sharding.shard_params``). With ``cfg.remat`` (and gradients
    enabled) each layer runs under its ``remat_policy``: a checkpoint of
    the whole layer keeping :data:`REMAT_SAVES`, or the per-block split
    of :func:`_layer`."""
    mesh = logical_mesh(mesh, cfg)
    return _trunk(*local_params(params, cfg, mesh), tokens, cfg, mesh)


def _trunk(top, layers, tokens, cfg: TransformerConfig, mesh):
    """:func:`forward_hidden` on :func:`local_params`' forms."""
    dt = torch_dtype(cfg.dtype)
    x = _embed_tokens(top, tokens, cfg, dt)
    layer = partial(_layer, cfg=cfg, mesh=mesh)
    if cfg.remat and torch.is_grad_enabled():
        if cfg.remat_policy == "split":
            layer = partial(layer, split_remat=True)
        else:
            layer = _remat(partial(layer, tag_attn=cfg.remat_policy in (
                "attn", "dots_attn")), cfg.remat_policy)
    auxes = []
    for lp in layers:
        x, aux = layer(x, lp)
        auxes.append(aux)
    return _rmsnorm(x, top["ln_f_scale"]), torch.stack(auxes).sum()


def lm_logits(x, top):
    """``x @ lm_head`` as f32 logits (..., vocab); a vocab-sharded
    (tp, D, V/tp) head gives each rank's logits, gathered in vocab
    order."""
    w = matmul_weight(top, "lm_head", x.dtype)
    if tp_stack(w) > 1:
        return torch.movedim(column_parallel_in(x, w), 0, -2).flatten(
            -2).float()
    return (x @ w).float()


def forward(params, tokens, cfg: TransformerConfig, mesh=None, *,
            return_aux: bool = False):
    """Next-token logits (B, T, vocab) f32 for ``tokens`` (B, T); with
    ``return_aux`` also the MoE aux loss (zero for dense models)."""
    mesh = logical_mesh(mesh, cfg)
    top, layers = local_params(params, cfg, mesh)
    x, aux = _trunk(top, layers, tokens, cfg, mesh)
    logits = lm_logits(x, top)
    return (logits, aux) if return_aux else logits


@torch.no_grad()
def moe_drop_rates(params, tokens, cfg: TransformerConfig, mesh=None):
    """Per-layer MoE routing drop rate on this batch: (n_layers,) f32, the
    fraction of routed (token, choice) assignments that found no capacity
    slot — the training forward's routing, without gradients."""
    if not cfg.n_experts:
        raise ValueError("moe_drop_rates needs an MoE config")
    mesh = logical_mesh(mesh, cfg)
    top, layers = local_params(params, cfg, mesh)
    x = _embed_tokens(top, tokens, cfg, torch_dtype(cfg.dtype))
    kepts = []
    for lp in layers:
        o = attention(*_qkv_block(x, lp, cfg), cfg, mesh)
        x, _aux, kept = _post_block(x, o, lp, cfg, mesh, with_stats=True)
        kepts.append(kept)
    return 1.0 - torch.stack(kepts)


def _last_position_mask(tokens, dtype):
    B, T = tokens.shape
    keep = torch.arange(T, device=tokens.device) < T - 1
    return keep.to(dtype).expand(B, T)


def masked_causal_nll(logits, tokens):
    """Mean next-token NLL with the final position masked out: logits
    (B, T, V) f32 against ``tokens`` rolled left by one."""
    targets = torch.roll(tokens, -1, dims=1).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = logz - gold
    mask = _last_position_mask(tokens, nll.dtype)
    return (nll * mask).sum() / mask.sum()


def _nll_chunk(m, s, gold, x, wc, targets, lo: int):
    """One vocab chunk of the online logsumexp: (running max, rescaled
    sum of exps, gold logit) after logits x @ wc for vocab ids
    lo .. lo + chunk."""
    chunk = wc.shape[1]
    logits_c = (x @ wc).float()
    m_new = torch.maximum(m, logits_c.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits_c - m_new[..., None]).sum(-1)
    local = targets - lo
    in_chunk = (local >= 0) & (local < chunk)
    picked = logits_c.gather(-1, local.clamp(0, chunk - 1)[..., None])[..., 0]
    return m_new, s, torch.where(in_chunk, picked, gold)


def chunked_masked_causal_nll(x, lm_head, tokens, *, chunk: int):
    """:func:`masked_causal_nll` without the (B, T, V) logits: a loop over
    vocab chunks carries the online logsumexp state and picks each
    target's gold logit from the chunk that owns it; each chunk runs under
    ``torch.utils.checkpoint`` (JAX's ``@jax.checkpoint`` body), so the
    backward recomputes its logits and only the (B, T) carry is saved.
    ``x`` (B, T, d_model) from :func:`forward_hidden`, ``lm_head``
    (d_model, V) in the compute dtype; ``chunk`` must divide V."""
    B, T = tokens.shape
    V = lm_head.shape[1]
    if V % chunk:
        raise ValueError(f"loss chunk {chunk} must divide vocab {V}")
    targets = torch.roll(tokens, -1, dims=1).long()
    m = torch.full((B, T), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, T), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, T), dtype=torch.float32, device=x.device)
    for lo in range(0, V, chunk):
        m, s, gold = checkpoint(_nll_chunk, m, s, gold, x,
                                lm_head[:, lo:lo + chunk], targets, lo,
                                use_reentrant=False)
    nll = m + torch.log(s) - gold
    mask = _last_position_mask(tokens, nll.dtype)
    return (nll * mask).sum() / mask.sum()


def vocab_parallel_nll(x, lm_head, tokens, *, chunk: int = 0):
    """:func:`masked_causal_nll` over a vocab-sharded head ``lm_head``
    (tp, d_model, V/tp) in the compute dtype: each tp rank runs the
    online log-sum-exp over its own vocab block (in ``chunk`` columns
    under ``torch.utils.checkpoint`` as :func:`chunked_masked_causal_nll`,
    or its block's logits at once when ``chunk`` is 0), then one
    log-sum-exp per row across the ranks (the max, then the rescaled
    sums), and the gold logit from the rank whose block holds the
    target. No rank forms the full-vocab logits."""
    B, T = tokens.shape
    tp, _, Vl = lm_head.shape
    chunk = chunk or Vl
    if Vl % chunk:
        raise ValueError(f"loss chunk {chunk} must divide the vocab shard "
                         f"{Vl} (vocab {tp * Vl} over tp {tp})")
    targets = torch.roll(tokens, -1, dims=1).long()
    ms, ss, golds = [], [], []
    for r in range(tp):
        m = torch.full((B, T), -torch.inf, dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((B, T), dtype=torch.float32, device=x.device)
        gold = torch.zeros((B, T), dtype=torch.float32, device=x.device)
        for lo in range(0, Vl, chunk):
            args = (m, s, gold, x, lm_head[r, :, lo:lo + chunk], targets,
                    r * Vl + lo)
            m, s, gold = (checkpoint(_nll_chunk, *args, use_reentrant=False)
                          if chunk < Vl else _nll_chunk(*args))
        ms.append(m)
        ss.append(s)
        # a rank whose block misses the target contributes 0
        owns = (targets >= r * Vl) & (targets < (r + 1) * Vl)
        golds.append(torch.where(owns, gold, torch.zeros_like(gold)))
    m_all = torch.stack(ms).amax(0)
    s_all = sum(s * torch.exp(m - m_all) for m, s in zip(ms, ss))
    nll = m_all + torch.log(s_all) - torch.stack(golds).sum(0)
    mask = _last_position_mask(tokens, nll.dtype)
    return (nll * mask).sum() / mask.sum()


def loss_fn(params, tokens, cfg: TransformerConfig, mesh=None):
    """Causal LM loss: predict token t+1 from the prefix up to t (mean
    NLL), the final position masked out, plus ``moe_aux_weight`` x the
    summed aux loss for an MoE config. ``cfg.loss_chunk`` picks the
    chunked loss (no logits); ``mesh`` as :func:`forward_hidden`; a
    vocab-sharded head (tp) takes :func:`vocab_parallel_nll`."""
    mesh = logical_mesh(mesh, cfg)
    top, layers = local_params(params, cfg, mesh)
    x, aux = _trunk(top, layers, tokens, cfg, mesh)
    head = matmul_weight(top, "lm_head", x.dtype)
    if tp_stack(head) > 1:
        loss = vocab_parallel_nll(x, head, tokens, chunk=cfg.loss_chunk)
    elif cfg.loss_chunk:
        loss = chunked_masked_causal_nll(x, head, tokens,
                                         chunk=cfg.loss_chunk)
    else:
        loss = masked_causal_nll((x @ head).float(), tokens)
    if cfg.n_experts:
        loss = loss + cfg.moe_aux_weight * aux
    return loss
