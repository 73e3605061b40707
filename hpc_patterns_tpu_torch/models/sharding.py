"""Parameter and batch sharding rules: the counterpart of
``hpc_patterns_tpu/models/sharding.py`` — Megatron column/row tensor
parallelism over ``tp``, the batch over the data axes, the sequence over
``sp``, and ZeRO-3 feature sharding over ``fsdp`` — on logical ranks of
one device.

A spec is a tuple per tensor dim (``models/sharding_util``). A sharded
leaf is STORED as its shards stacked on one leading dim per axis its
resolved spec names (``sharding_util.rank_axes``, in the mesh's order):
``wqkv`` (L, D, N) on ``{"dp": 2, "fsdp": 2, "tp": 2}`` is (fsdp 2, tp 2,
L, D/2, N/2), each rank's shard contiguous, and a leaf replicated over an
axis has no dim for it — a replica is never a copy (dp and tp replicas
are the one tensor). The gradients, and both AdamW moments, take the same
layout, so the fsdp state lives sharded and every element of the model is
stored, clipped and updated exactly once.
"""

from __future__ import annotations

import math

from hpc_patterns_tpu_torch.models.sharding_util import (
    from_ranks,
    is_stacked,
    rank_axes,
    resolve_spec,
    shard_at,
    to_ranks,
)
from hpc_patterns_tpu_torch.models.transformer import (
    QUANT_SCALE_SUFFIX,
    TransformerConfig,
    shards_params,
)


def param_specs(cfg: TransformerConfig) -> dict:
    """The spec tree matching ``init_params``' structure (JAX's table):
    layer weights carry a leading unsharded ``n_layers`` dim; ``wqkv``
    and ``w1`` column-parallel over tp, ``wo`` and ``w2`` row-parallel,
    experts over ep, ``lm_head`` vocab-sharded; with ``cfg.fsdp`` each
    large weight also shards the feature dim tp leaves whole over
    ``axis_fsdp`` (no fsdp entry otherwise)."""
    tp = cfg.axis_tp
    fs = cfg.axis_fsdp if cfg.fsdp else None
    layers = {
        "ln1_scale": (None, None),
        "ln2_scale": (None, None),
        "wqkv": (None, fs, tp),         # column-parallel (heads split)
        "wo": (None, tp, fs),           # row-parallel
    }
    if cfg.n_experts:
        ep = cfg.axis_ep
        layers["router"] = (None, None, None)  # replicated routing table
        layers["w1"] = (None, ep, fs, None)    # experts over ep
        layers["w2"] = (None, ep, None, fs)
    else:
        layers["w1"] = (None, fs, tp)   # column-parallel
        layers["w2"] = (None, tp, fs)   # row-parallel
    pos = {} if cfg.pos_embed == "rope" else {"pos_embed": (None, fs)}
    return {
        "embed": (None, fs),            # lookup local; features sharded
        **pos,
        "layers": layers,
        "ln_f_scale": (None,),
        "lm_head": (fs, tp),            # vocab-sharded logits
    }


def batch_spec(cfg: TransformerConfig) -> tuple:
    """Tokens (batch, seq): the batch over ``cfg.batch_axes``, the
    sequence over sp."""
    return (cfg.batch_axes, cfg.axis_sp)


def batch_sharding(mesh: dict, cfg: TransformerConfig) -> tuple:
    """:func:`batch_spec` on ``mesh`` (a :func:`logical_mesh`, or None):
    (row blocks, sequence blocks). Rank r of the batch axes owns the r-th
    block of rows, sp rank s the s-th block of the sequence."""
    if not mesh:
        return 1, 1
    spec = resolve_spec(batch_spec(cfg), mesh, cfg.mesh_axes)
    return tuple(math.prod(mesh[a] for a in (
        () if g is None else (g,) if isinstance(g, str) else g))
        for g in spec)


def _map_specs(fn, params, specs):
    """``fn(leaf, spec)`` over the params tree; a leaf without a spec
    (int8 weights' ``_qscale`` siblings) raises: the quantized tree is a
    decode format, unsharded."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k not in specs:
                if k.endswith(QUANT_SCALE_SUFFIX):
                    raise ValueError(
                        f"{k}: int8-quantized weights are not sharded "
                        "(decode them on an unsharded route)")
                raise ValueError(f"no sharding spec for param {k!r}")
            out[k] = _map_specs(fn, v, specs[k])
        return out
    return fn(params, specs)


def shard_params(params, mesh: dict, cfg: TransformerConfig):
    """The global params tree as its rank-stacked shards on ``mesh``
    (module docstring): each leaf ``to_ranks`` over the axes its
    resolved spec names, made contiguous (one copy, once). A leaf that
    is already stacked, or that no mesh axis shards, comes back as it
    is, so the call is idempotent and cheap on a sharded tree. The copy
    is differentiable: gradients reach a global tree passed in."""
    specs = param_specs(cfg)

    def place(leaf, spec):
        if is_stacked(leaf, spec):
            return leaf
        s = resolve_spec(spec, mesh, cfg.mesh_axes)
        axes = rank_axes(s, mesh)
        if not axes:
            return leaf
        return to_ranks(leaf, s, mesh, axes).contiguous()

    return _map_specs(place, params, specs)


def unshard_params(params, mesh: dict, cfg: TransformerConfig):
    """The inverse of :func:`shard_params`: every leaf as the global
    tensor (a gather; a global leaf comes back as it is). What a
    checkpoint saves and what ``--generate`` decodes."""
    specs = param_specs(cfg)

    def gather(leaf, spec):
        if not is_stacked(leaf, spec):
            return leaf
        s = resolve_spec(spec, mesh, cfg.mesh_axes)
        return from_ranks(leaf, s, mesh, rank_axes(s, mesh)).contiguous()

    return _map_specs(gather, params, specs)


def state_layout(mesh: dict | None, cfg: TransformerConfig):
    """``(shard, unshard)`` tree functions of a sharded state's stored form
    (:func:`shard_params`, :func:`unshard_params` on ``mesh``), for the
    params and both moment trees: what a checkpoint saves global and
    restores into the layout (``utils/checkpoint``'s ``layout=``). None
    when the mesh shards nothing."""
    if not shards_params(mesh, cfg):
        return None
    return (lambda t: shard_params(t, mesh, cfg),
            lambda t: unshard_params(t, mesh, cfg))


def param_shard_at(params, mesh: dict, cfg: TransformerConfig,
                   coord: dict):
    """The shard of every leaf the rank at mesh coordinate ``coord``
    (``{axis: index}``) holds — what JAX's ``addressable_shards`` give for
    the device at that coordinate."""
    specs = param_specs(cfg)
    return _map_specs(
        lambda leaf, spec: shard_at(
            leaf, resolve_spec(spec, mesh, cfg.mesh_axes), mesh, coord),
        params, specs)
