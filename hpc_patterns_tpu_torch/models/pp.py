"""Pipeline-parallel training of the transformer: the counterpart of
``hpc_patterns_tpu/models/pp.py``, with the ``pp`` stages (and the dp,
fsdp and tp axes it composes with) as logical ranks of one device.

The layers split into P contiguous stages over ``pp``, driven by the 1F1B
schedule (``parallel/pipeline.py``, built on the ring's neighbour
handoff):

- the embedding (embed + pos_embed) runs outside the pipeline; its
  gradient comes back through the pipeline's input cotangents
  (``return_input_grads``), which are stage 0's;
- each stage scans its ``L/P`` layers as one shape-preserving
  ``stage_fn`` (stage r's layers are rows ``[r L/P, (r+1) L/P)`` of the
  stacked layer weights: a view, no copy);
- the head (ln_f_scale + lm_head) is the last stage's loss head, through
  the pipeline's ``loss_params``; its gradient is the last stage's. (JAX
  psums the replicated pieces' gradients over pp as a broadcast from the
  one rank that made them; here they are read from that rank.)

Compositions, as JAX's docstring gives them:

- dp outside the pipeline, the gradient the mean over dp: on logical
  ranks the data shards' rows fold into each microbatch (shard d's
  microbatch m is the d-th row block of the folded microbatch m), so one
  pipeline serves every shard and the mean over the folded rows is the
  mean over dp of the shards' mean losses. An MoE stage routes each
  shard's rows on their own (capacity a shard, as a shard-local stage
  does). Across launched processes the mean crosses the gloo wire
  (``models/train.process_mean``);
- fsdp (ZeRO-3): the stage weights are stored fsdp-stacked on the feature
  dims ``models/sharding.param_specs`` gives them (params, gradients and
  both moments), all-gathered before the pipeline and their gradients
  split back to the shards after it (the reduce-scatter; the folded rows
  made them the mean over the fsdp batch shards already);
- tp inside each stage (dense MLPs only: MoE with tp raises, and so does
  a tp that does not divide the widths): the port's tp layer, the
  column-parallel products over the tp ranks' contiguous column blocks of
  the packed ``wqkv`` gathered back into the fused order before the head
  split, attention on each rank's head block, ``wo``/``w2`` row-parallel
  — the values of JAX's ``_tp_layer`` on the permuted columns
  (:func:`tp_permute_wqkv`), which the port's layout does not need; the
  loss head vocab-sharded over tp where the vocab divides and no
  ``loss_chunk`` is set (``transformer.vocab_parallel_nll``), else the
  replicated head;
- MoE with stage-local experts: stages return ``(h, aux)`` and the
  schedule threads the aux through ``stage_aux_weight``;
- the chunked loss, GQA, rope (no ``pos_embed`` gradient) and the fused
  MLP (kernels 8/9 in each stage's forward and recompute).

The loss head's product runs in the compute dtype, as
``transformer.loss_fn``'s does (JAX's pipeline hands the head an f32
activation; its TPU runs an f32 product at default precision in bf16
passes).
"""

from __future__ import annotations

from functools import partial

import torch

from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.memory import kinds as kindslib
from hpc_patterns_tpu_torch.models import sharding as shardlib
from hpc_patterns_tpu_torch.models.sharding_util import (
    from_ranks,
    is_stacked,
    to_ranks,
)
from hpc_patterns_tpu_torch.models.train import (
    _moments,
    make_optimizer,
    offload_example_shardings,
    process_mean,
    tree_leaves,
    tree_map,
)
from hpc_patterns_tpu_torch.models.transformer import (
    QUANT_SCALE_SUFFIX,
    TransformerConfig,
    _layer,
    _local,
    _rmsnorm,
    chunked_masked_causal_nll,
    init_params,
    masked_causal_nll,
    vocab_parallel_nll,
)
from hpc_patterns_tpu_torch.parallel.pipeline import pipeline_train_1f1b


def _embed(outer, tokens, cfg: TransformerConfig):
    dt = torch_dtype(cfg.dtype)
    x = outer["embed"].to(dt)[tokens]
    if cfg.pos_embed == "learned":
        x = x + outer["pos_embed"].to(dt)[:tokens.shape[-1]]
    return x


def _stage_fn(layers_shard, h, cfg: TransformerConfig, tp: int = 1,
              data=None):
    """One pipeline stage: this rank's L/P layers in turn (shape
    preserving). ``tp > 1``: each layer's weights as the tp layer takes
    them (views stacked over the tp ranks' shards). ``data``: the folded
    data shards as ``{"dp": n}``, so an MoE layer routes each shard's rows
    alone. MoE configs return ``(h, aux)``, the stage's summed
    load-balance loss."""
    specs = shardlib.param_specs(cfg)["layers"]
    tp_mesh = {cfg.axis_tp: tp}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # one unbind a leaf: its backward stacks the layers' gradients once
    names = list(layers_shard)
    for vals in zip(*(layers_shard[k].unbind(0) for k in names)):
        lp = dict(zip(names, vals))
        if tp > 1:
            lp = {k: _local(v, specs[k][1:], tp_mesh, cfg)
                  for k, v in lp.items()}
        h, a = _layer(h, lp, cfg, mesh=data)
        aux = aux + a
    if cfg.n_experts:
        return h, aux
    return h


def tp_permute_wqkv(wqkv, cfg: TransformerConfig, tp: int):
    """Reorder the packed-qkv columns ``[q | k | v]`` into per-rank blocks
    ``[q_0|k_0|v_0 | q_1|k_1|v_1 | ...]``, so a contiguous last-dim split
    over tp hands each rank its own q/k/v sections (JAX's layout for its
    manual tp layer; a pure column gather)."""
    D = cfg.d_model
    S = cfg.kv_heads * cfg.head_dim
    q, k, v = torch.split(wqkv, [D, S, S], dim=-1)
    qs, ks, vs = (torch.chunk(t, tp, dim=-1) for t in (q, k, v))
    return torch.cat([torch.cat([qs[r], ks[r], vs[r]], dim=-1)
                      for r in range(tp)], dim=-1)


def tp_unpermute_wqkv(wqkv_p, cfg: TransformerConfig, tp: int):
    """The inverse of :func:`tp_permute_wqkv`."""
    Dl = cfg.d_model // tp
    Sl = cfg.kv_heads * cfg.head_dim // tp
    qs, ks, vs = [], [], []
    for blk in torch.chunk(wqkv_p, tp, dim=-1):
        qb, kb, vb = torch.split(blk, [Dl, Sl, Sl], dim=-1)
        qs.append(qb)
        ks.append(kb)
        vs.append(vb)
    return torch.cat(qs + ks + vs, dim=-1)


def check_tp(cfg: TransformerConfig, tp: int):
    """JAX's refusals of tp inside pipeline stages."""
    if cfg.n_experts:
        raise ValueError(
            "pp x tp with MoE stages is unsupported: experts route "
            "densely per stage (use ep outside pp, or tp without "
            "experts)")
    for name, val in (("d_model", cfg.d_model), ("n_heads", cfg.n_heads),
                      ("kv_heads", cfg.kv_heads), ("d_ff", cfg.d_ff)):
        if val % tp:
            raise ValueError(
                f"{name} {val} must divide by tp={tp} for Megatron "
                "stage sharding")


def _loss_head(lp, y, target_tokens, *, cfg: TransformerConfig):
    """Final norm + LM head + the masked causal NLL
    (``transformer.masked_causal_nll``, or its chunked form with
    ``cfg.loss_chunk``: the microbatch's (b, T, vocab) logits never
    materialize), in the compute dtype as ``transformer.loss_fn``."""
    dt = torch_dtype(cfg.dtype)
    x = _rmsnorm(y.to(dt), lp["ln_f_scale"])
    head = lp["lm_head"].to(dt)
    if cfg.loss_chunk:
        return chunked_masked_causal_nll(x, head, target_tokens,
                                         chunk=cfg.loss_chunk)
    return masked_causal_nll((x @ head).float(), target_tokens)


def _loss_head_tp(lp, y, target_tokens, *, cfg: TransformerConfig,
                  tp: int):
    """The vocab-sharded head (JAX ``_loss_head_tp``): lm_head as its tp
    ranks' column blocks, each rank's logits (b, T, V/tp) and one
    log-sum-exp per row across the ranks
    (``transformer.vocab_parallel_nll``)."""
    dt = torch_dtype(cfg.dtype)
    x = _rmsnorm(y.to(dt), lp["ln_f_scale"])
    head = to_ranks(lp["lm_head"].to(dt), (None, cfg.axis_tp),
                    {cfg.axis_tp: tp}, (cfg.axis_tp,))
    return vocab_parallel_nll(x, head, target_tokens)


def _pp_layer_specs(cfg: TransformerConfig, axis_pp: str,
                    axis_fsdp: str | None, axis_tp: str | None = None):
    """Each stacked layer leaf's spec inside the pipeline (JAX's): the
    leading ``n_layers`` dim over pp, and with ``axis_fsdp``/``axis_tp``
    the feature dims ``sharding.param_specs`` shards under fsdp and
    Megatron tp; ep is dropped (no expert axis inside a stage)."""
    import dataclasses

    base = shardlib.param_specs(dataclasses.replace(
        cfg, fsdp=bool(axis_fsdp), axis_fsdp=axis_fsdp or "fsdp",
        axis_tp=axis_tp or "tp"))["layers"]
    keep = {ax for ax in (axis_fsdp, axis_tp) if ax}
    return {k: (axis_pp, *(ax if ax in keep else None for ax in spec[1:]))
            for k, spec in base.items()}


def _fsdp_dim(spec, axis_fsdp):
    """The fsdp-sharded dim of a layer spec (None: replicated over fsdp,
    as the norm scales and the router are)."""
    for i, ax in enumerate(spec):
        if ax == axis_fsdp:
            return i
    return None


def _fsdp_spec(spec, axis_fsdp):
    """``spec`` with only its fsdp entry kept: how a leaf is stored."""
    return tuple(ax if ax == axis_fsdp else None for ax in spec)


def _place_fsdp(layers: dict, cfg: TransformerConfig, axis_fsdp: str,
                fs: int) -> dict:
    """Global layer leaves -> stored fsdp-stacked (fs, L, ...) where their
    spec shards a dim over fsdp (the others stay global)."""
    specs = _pp_layer_specs(cfg, "pp", axis_fsdp)
    mesh = {axis_fsdp: fs}
    return {k: (v if _fsdp_dim(specs[k], axis_fsdp) is None
                or is_stacked(v, specs[k]) else
                to_ranks(v, _fsdp_spec(specs[k], axis_fsdp), mesh,
                         (axis_fsdp,)).contiguous())
            for k, v in layers.items()}


def _gather_fsdp(layers: dict, cfg: TransformerConfig, axis_fsdp: str,
                 fs: int) -> dict:
    """The inverse of :func:`_place_fsdp`: every layer leaf global."""
    specs = _pp_layer_specs(cfg, "pp", axis_fsdp)
    return {k: (from_ranks(v, _fsdp_spec(specs[k], axis_fsdp),
                           {axis_fsdp: fs}, (axis_fsdp,)).contiguous()
                if is_stacked(v, specs[k]) else v)
            for k, v in layers.items()}


def state_layout(cfg: TransformerConfig, axis_fsdp: str | None, fs: int):
    """``(shard, unshard)`` tree functions of a pipeline state's stored
    form (:func:`init_pp_train_state`), for the params and both moment
    trees: what a checkpoint saves global and restores into the layout
    (``utils/checkpoint``'s ``layout=``). None when nothing is stacked."""
    if not axis_fsdp or fs < 2:
        return None

    def over_layers(fn):
        return lambda tree: {**tree, "layers": fn(tree["layers"], cfg,
                                                  axis_fsdp, fs)}

    return over_layers(_place_fsdp), over_layers(_gather_fsdp)


def pp_loss_and_grads(params, tokens, cfg: TransformerConfig, mesh, *,
                      microbatches: int, axis_pp: str = "pp",
                      axis_dp: str | None = None,
                      axis_fsdp: str | None = None,
                      axis_tp: str | None = None, stats: dict | None = None):
    """Mean causal-LM loss and full-parameter gradients through a 1F1B
    pipeline over ``axis_pp`` of ``mesh`` (a ``{axis: size}`` dict),
    optionally data-parallel over ``axis_dp``, ZeRO-3 over ``axis_fsdp``
    and Megatron tp inside each stage over ``axis_tp`` (module
    docstring).

    ``params``: the ``init_params`` tree (layers stacked on n_layers,
    which must divide by pp); with ``axis_fsdp`` the layer leaves may be
    stored fsdp-stacked (:func:`init_pp_train_state`). ``tokens`` (batch,
    seq) int32, the batch divisible by microbatches x dp x fsdp.
    Returns ``(loss, grads)``: the loss f32 (the MoE aux term added), the
    gradients in ``params``' structure and storage form, f32, the mean
    over the batch. ``stats``: receives the pipeline's (``peak_stash``,
    ``ticks``)."""
    M = microbatches
    if any(k.endswith(QUANT_SCALE_SUFFIX)
           for k in (*params, *params["layers"])):
        raise ValueError(
            "pp_loss_and_grads refuses an int8-quantized params tree "
            "(quantize_weights_int8): the pipeline's stage math spells "
            "its own matmuls and would apply raw int8 magnitudes — "
            "quantized weights are a decode-serving artifact "
            "(transformer.matmul_weight; docs/quantization.md)")
    pp = int(mesh[axis_pp])
    L = cfg.n_layers
    if L % pp:
        raise ValueError(f"n_layers {L} must divide by pp={pp}")
    B = tokens.shape[0]
    dp = int(mesh[axis_dp]) if axis_dp else 1
    fs = int(mesh[axis_fsdp]) if axis_fsdp else 1
    tp = int(mesh[axis_tp]) if axis_tp else 1
    if tp > 1:
        check_tp(cfg, tp)
    shard_head = tp > 1 and cfg.vocab % tp == 0 and not cfg.loss_chunk
    if B % (M * dp * fs):
        raise ValueError(
            f"batch {B} must divide by microbatches*dp*fsdp={M * dp * fs}")
    layer_specs = _pp_layer_specs(cfg, axis_pp, axis_fsdp)
    fs_mesh = {axis_fsdp: fs} if axis_fsdp else {}
    layers = {}
    for name, leaf in params["layers"].items():
        spec = layer_specs[name]
        d = _fsdp_dim(spec, axis_fsdp) if axis_fsdp else None
        stacked = is_stacked(leaf, spec)
        if d is not None and not stacked and leaf.shape[d] % fs:
            raise ValueError(
                f"layers[{name}] dim {d} ({leaf.shape[d]}) must divide by "
                f"fsdp={fs}")
        if stacked:
            # the ZeRO-3 all-gather, once a step before the stages
            with torch.no_grad():
                leaf = from_ranks(leaf, _fsdp_spec(spec, axis_fsdp),
                                  fs_mesh, (axis_fsdp,))
        layers[name] = leaf

    n_data = dp * fs
    b = B // (M * n_data)
    T = tokens.shape[-1]
    # shard d's microbatch m is the d-th row block of folded microbatch m
    toks = tokens.reshape(n_data, M, b, T).transpose(0, 1).reshape(
        M, n_data * b, T)
    outer_keys = ["embed"] + (["pos_embed"] if cfg.pos_embed == "learned"
                              else [])
    outer = {k: params[k].detach().requires_grad_(True) for k in outer_keys}
    head = {"ln_f_scale": params["ln_f_scale"], "lm_head": params["lm_head"]}
    with torch.enable_grad():
        x_mb = _embed(outer, toks, cfg)
    Lp = L // pp
    stage_params = [{k: v[r * Lp:(r + 1) * Lp] for k, v in layers.items()}
                    for r in range(pp)]
    data = ({cfg.axis_dp: n_data} if cfg.n_experts and n_data > 1
            else None)
    loss_head = (partial(_loss_head_tp, cfg=cfg, tp=tp) if shard_head
                 else partial(_loss_head, cfg=cfg))
    loss_r, layer_g, extras = pipeline_train_1f1b(
        partial(_stage_fn, cfg=cfg, tp=tp, data=data), stage_params,
        x_mb.detach(), toks, loss_head, loss_params=head,
        return_input_grads=True,
        stage_aux_weight=cfg.moe_aux_weight if cfg.n_experts else None,
        stats=stats)
    # the embedding's backward: stage 0's input cotangents through the
    # embedding lookup
    outer_g = dict(zip(outer_keys, torch.autograd.grad(
        x_mb, [outer[k] for k in outer_keys],
        grad_outputs=extras["input_grads"].to(x_mb.dtype))))
    loss = loss_r[pp - 1]
    if cfg.n_experts:
        # the stage-local aux sums over the stages, a microbatch's mean
        loss = loss + cfg.moe_aux_weight * extras["aux_sum"].sum() / M
    grads = {k: g.float() / M for k, g in outer_g.items()}
    grads.update({k: g / M for k, g in extras["loss_grads"].items()})
    grads["layers"] = {}
    for name, leaf in params["layers"].items():
        g = torch.cat([layer_g[r][name] for r in range(pp)]) / M
        spec = layer_specs[name]
        if is_stacked(leaf, spec):  # back to the shards (reduce-scatter)
            g = to_ranks(g, _fsdp_spec(spec, axis_fsdp), fs_mesh,
                         (axis_fsdp,)).contiguous()
        grads["layers"][name] = g
    return loss.detach(), {k: grads[k] for k in params}


def make_pp_train_step(cfg: TransformerConfig, mesh, *, microbatches: int,
                       axis_pp: str = "pp", axis_dp: str | None = None,
                       axis_fsdp: str | None = None,
                       axis_tp: str | None = None, optimizer=None,
                       offload_opt_example=None):
    """``step(params, opt_state, tokens) -> (loss, params, opt_state)``
    training the whole model through the 1F1B pipeline
    (:func:`pp_loss_and_grads`), the optimizer's update applied in place
    on the stored form (fsdp-stacked layer leaves update shard-local).
    Across launched processes the loss and gradients are first averaged
    over the gloo wire. ``offload_opt_example``: a host-resident state
    (``models/train.offload_opt_state``): the moments are pulled to the
    card for the update and pushed back, as ``make_train_step``'s
    unstreamed offload."""
    optimizer = optimizer or make_optimizer()
    if offload_opt_example is not None:
        host_sh, hbm_sh = offload_example_shardings(offload_opt_example)
    else:
        host_sh = hbm_sh = None

    def place(opt_state, sh):
        return {**opt_state, **kindslib.tree_map(
            lambda x, p: p.place(x), _moments(opt_state), sh)}

    def step(params, opt_state, tokens):
        if hbm_sh is not None:
            opt_state = place(opt_state, hbm_sh)
        loss, grads = pp_loss_and_grads(
            params, tokens, cfg, mesh, microbatches=microbatches,
            axis_pp=axis_pp, axis_dp=axis_dp, axis_fsdp=axis_fsdp,
            axis_tp=axis_tp)
        loss, leaves = process_mean(loss, tree_leaves(grads))
        optimizer.update(leaves, opt_state, params)
        if host_sh is not None:
            opt_state = place(opt_state, host_sh)
        return loss, params, opt_state

    return tracelib.instrument_jit(step, "train.step")


def init_pp_train_state(generator: torch.Generator, cfg: TransformerConfig,
                        optimizer=None, *, device=None, mesh=None,
                        axis_pp: str = "pp", axis_fsdp: str | None = None):
    """(params, opt_state): f32 params from ``generator`` on ``device``
    (default ``cuda``) and the optimizer's zero state. Global by default
    (a stage's layers are a view of the stacked leaves); with ``mesh``
    and ``axis_fsdp`` the layer leaves fsdp shards are stored stacked
    (``sharding_util.to_ranks`` over fsdp), and the moments take that
    layout."""
    del axis_pp  # the pp split of a layer stack is a view, not storage
    optimizer = optimizer or make_optimizer()
    params = init_params(cfg, generator=generator, device=device)
    if mesh is not None and axis_fsdp and int(mesh.get(axis_fsdp, 1)) > 1:
        params["layers"] = _place_fsdp(params["layers"], cfg, axis_fsdp,
                                       int(mesh[axis_fsdp]))
    tree_map(lambda p: p.requires_grad_(True), params)
    return params, optimizer.init(params)
