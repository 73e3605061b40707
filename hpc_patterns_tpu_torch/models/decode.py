"""Prefill and decode over the linear and the paged KV cache: the
counterpart of ``hpc_patterns_tpu/models/decode.py``.

- :func:`prefill` runs the prompt in one batched pass and captures each
  layer's K/V (the bucketed ``last_pos`` route included); padded
  lengths that are multiples of 128 go through the flash prefill kernel,
  others through ``full_attention`` (``decode.py:290-304``).
- The KV cache stores the compute dtype, or one byte per value
  (``cfg.kv_cache_dtype`` "int8"/"fp8") with per-row f32 dequant scales
  (:func:`_quantize_rows`) beside it: "k_scale"/"v_scale".
- The linear cache (:func:`init_cache`) is per-layer (B, kv_heads,
  max_len, head_dim) buffers; :func:`decode_step` writes one row and
  attends on the "flash" route (``ops.flash_decode.
  flash_decode_attention``, the Hopper kernel on CUDA) or the "gather"
  route (its plain version; "paged_flash" means gather here, as in JAX).
  :func:`generate` composes prefill and steps, greedy or sampled.
- The paged cache (:func:`init_paged_cache`) is per-layer page pools
  (pool_pages, kv_heads, page_size, head_dim) plus one (batch,
  pages_per_seq) int32 table; :func:`paged_decode_step` routes by
  ``cfg.decode_attn``: "flash" (``flash_decode_paged``), "paged_flash"
  (``ops.paged_attention.paged_attention_decode``, the exact-softmax
  kernel) or "gather" (the plain table-gather view);
  :func:`paged_extend_step` verifies a ragged multi-token chunk against
  the pools (speculative decoding's target step; plain PyTorch, as JAX's
  is XLA).

``mesh=`` (a ``{axis: size}`` dict of logical ranks; only its ``tp`` axis
shapes decode, as in JAX) is tp-sharded serving (JAX ``decode.py:64-131``):
the params are their tp shards (``models/sharding.shard_params``, once a
call), the qkv and MLP-in projections column-parallel, ``wo``, ``w2``
row-parallel with the sums over the tp ranks, the logits vocab-sharded
and gathered; where tp divides ``kv_heads`` (:func:`_kv_ranks`) the
cache and the page pools are kv-head-sharded over tp in contiguous head
blocks (q head k·g+j stays with kv head k), stored rank-stacked (tp, B,
kv_heads/tp, ...), and every decode kernel runs on each rank's block in
one launch over the folded ranks: kernel 5 on the linear cache, kernels
6/6q (and 7) through the page table, kernel 1 for the prompt. Otherwise
(JAX's warning, reworded: only the head sharding is lost) the cache
stays whole and the same kernels run on it, q gathered, as without a
mesh; JAX takes its gather route there only because its partitioner
cannot split a kernel call.

Every path runs each layer's MLP through ``transformer.mlp``: the dense
MLP for either ``mlp_impl`` (JAX decode never reads it), or for an MoE
model the experts routed drop-free (capacity = the step's tokens).

Unlike JAX's immutable arrays, the port writes caches and pools IN PLACE
(a copy per write would double the serving capacity), so the step
functions return logits only.

Sampling is Gumbel-max over a counter-based hash (:func:`sample_scores`):
the token drawn at position ``t`` of a row is ``argmax(top_k_mask(
logits) / T + g)``, where the Gumbel noise ``g`` is a pure function of
the row's key ((2,) uint32, the shape of JAX's PRNG key and of the
migration bundle's ``key`` field), ``t`` and the vocab index. The draw
depends on nothing else: a row samples the same alone or in a batch, on
the CPU or the card, in one batched pass with no host read, and the
serving engine's rows (``models/serving.py``) reproduce the standalone
:func:`paged_generate` token for token. Greedy (``temperature <= 0``)
is a plain argmax that runs no noise op. The stream is not JAX's
threefry stream; the two agree in law. Speculative decoding draws from
three more streams of the same hash, each the row's key folded with its
own tag (:data:`SPEC_STREAMS`, :func:`fold_keys`). :func:`generate` and
:func:`paged_generate` run under ``harness.trace.compile_watch``, as
JAX's do: with a flight recorder, a call that built kernels leaves a
named compile event.
"""

from __future__ import annotations

import warnings

import torch

from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    _heads_to_ranks,
    _rmsnorm,
    apply_rope,
    layer_params,
    lm_logits,
    local_params,
    logical_mesh,
    matmul_weight,
    mlp,
    project_qkv,
    shards_params,
    tp_size,
    tp_stack,
)
from hpc_patterns_tpu_torch.ops.flash_attention import flash_attention
from hpc_patterns_tpu_torch.ops.flash_decode import (
    _NEG_INF,
    flash_decode_attention,
    flash_decode_attention_reference,
    _gather_pages,
    flash_decode_paged,
    flash_decode_paged_reference,
    raw,
)
from hpc_patterns_tpu_torch.ops.paged_attention import paged_attention_decode
from hpc_patterns_tpu_torch.parallel.ring_attention import full_attention
from hpc_patterns_tpu_torch.parallel.tensor import row_parallel_out
from hpc_patterns_tpu_torch.topology import resolve_device

#: KV storage dtypes carrying per-row dequant scales
KV_QUANTIZED = ("int8", "fp8")

#: float8_e4m3fn's largest finite value, the fp8 analog of int8's 127
FP8_MAX = 448.0


def _kv_quantized(cfg: TransformerConfig) -> bool:
    return cfg.kv_cache_dtype in KV_QUANTIZED


def _kv_ranks(mesh, cfg: TransformerConfig) -> int:
    """The tp ranks the cache is sharded over: tp where it divides
    ``kv_heads`` (any route). The ONE tp layout of the linear and paged
    routes: every cache, pool and scale leaf shards its kv-head dim in
    contiguous blocks, stored stacked with the rank first (JAX
    ``_tp_serving_specs``). Where tp does not divide ``kv_heads`` it is 1
    with JAX's warning: the cache stays whole and every route, the
    decode kernels included, runs on it as without a mesh."""
    tp = tp_size(mesh, cfg)
    if tp > 1 and cfg.kv_heads % tp:
        warnings.warn(
            f"decode: tp size {tp} does not divide kv_heads "
            f"{cfg.kv_heads}; the KV cache stays unsharded and the decode "
            "kernels run on it whole (only the kv-head sharding is lost) "
            "— use a tp that divides kv_heads to shard the cache",
            stacklevel=3)
        return 1
    return tp


def _serving_params(params, cfg: TransformerConfig, mesh):
    """The checked mesh and the params as the steps take them: their
    shards on a mesh that shards params (one copy a call; a sharded tree
    passes through)."""
    mesh = logical_mesh(mesh, cfg)
    if shards_params(mesh, cfg):
        from hpc_patterns_tpu_torch.models.sharding import shard_params

        params = shard_params(params, mesh, cfg)
    return params, mesh


def pool_ranks(leaf) -> int:
    """The tp ranks a cache or pool leaf is stacked over, 1 for a whole
    one: THE test of the stacked form (:func:`init_cache`,
    :func:`init_paged_cache`), a rank dim in front of a 4-D K/V leaf
    (B | pages, kv_heads, S | P, D) or paged scale leaf."""
    return leaf.shape[0] if leaf.dim() == 5 else 1


def gather_pool_pages(pool, idx):
    """The pages ``idx`` of a paged ``pool`` in the global layout
    (n_pages, kv_heads, ...), gathered into new tensors on the device: a
    stacked pool's tp ranks' head blocks side by side in head order (a
    migration bundle's form)."""
    if pool_ranks(pool) == 1:
        return raw(pool)[idx].view(pool.dtype)
    g = raw(pool)[:, idx]  # (tp, n, kv_heads/tp, ...)
    return g.movedim(0, 1).reshape(g.shape[1], -1, *g.shape[3:]).view(
        pool.dtype)


def install_pool_pages(pool, idx, payload):
    """The inverse of :func:`gather_pool_pages`: ``payload`` (n_pages,
    kv_heads, ...) copied into ``pool`` at page ids ``idx`` in place
    (``index_copy_``), a stacked pool taking each tp rank's head block
    into its own pool. float8 moves through its byte view, as every
    gather and scatter of the port does. ``payload`` must already have
    the pool's dtype and page shape (nothing is cast), else
    ``ValueError``."""
    tp = pool_ranks(pool)
    page = pool.shape[2:] if tp > 1 else pool.shape[1:]
    want = (page[0] * tp, *page[1:])
    if payload.dtype != pool.dtype or tuple(payload.shape[1:]) \
            != tuple(want) or payload.shape[0] != idx.numel():
        raise ValueError(
            f"payload {tuple(payload.shape)} {payload.dtype} does not fit "
            f"{idx.numel()} page(s) of a {tuple(pool.shape)} {pool.dtype} "
            "pool")
    src = raw(payload.to(pool.device))
    if tp == 1:
        raw(pool).index_copy_(0, idx, src)
        return
    src = src.reshape(src.shape[0], tp, *page).movedim(1, 0)
    raw(pool).index_copy_(1, idx, src)


def _fold(t):
    """(tp, B, ...) -> (tp·B, ...): every rank's rows in one launch."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _fold_heads(t, tp: int):
    """(B, ..., H, Dh) -> (tp·B, ..., H/tp, Dh): each tp rank's contiguous
    head block (:func:`_heads_to_ranks`), the ranks folded into the batch
    as a kv-head-sharded cache's rows are."""
    return _fold(_heads_to_ranks(t, tp))


def _rank_tables(table, tp: int, n_pool: int):
    """A stacked pool's ranks folded into one pool of ``tp · n_pool``
    pages: the (tp·B, pages) table whose rank r rows read rank r's pool
    (page ids offset by r pools)."""
    off = torch.arange(tp, device=table.device).to(table.dtype) * n_pool
    return (table[None] + off[:, None, None]).reshape(
        tp * table.shape[0], -1)


def _attn_out(o, lp, dt, lead, stacked: bool):
    """The attention output through ``wo``: ``o`` (*lead, H, Dh), or its
    tp ranks' head blocks (tp, *lead, H/tp, Dh) when ``stacked``;
    row-parallel over tp-stacked ``wo`` (the partial products summed
    over the ranks)."""
    wo = matmul_weight(lp, "wo", dt)
    tp = tp_stack(wo)
    if tp == 1:
        return o.reshape(*lead, wo.shape[0]).to(dt) @ wo
    if not stacked:
        o = o.reshape(*lead, tp, -1).movedim(-2, 0)
    return row_parallel_out(o.reshape(tp, *lead, -1).to(dt), wo)


def _kv_storage_dtype(cfg: TransformerConfig) -> torch.dtype:
    """The dtype KV values are stored in: the compute dtype, int8 or
    float8_e4m3fn (one byte per value for both quantized forms)."""
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    if cfg.kv_cache_dtype == "fp8":
        return torch.float8_e4m3fn
    return torch_dtype(cfg.dtype)


def _quantize_rows(x, kv_dtype: str = "int8"):
    """Per-row symmetric quantization of (..., D) rows: (values, f32
    scales (...,)) with ``x ~= q * scale``. "int8": round half to even
    onto the +-127 grid; "fp8": the row's amax scaled onto
    float8_e4m3fn's +-448 and the cast rounds. The same f32 ops as JAX,
    so equal rows give equal bytes."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    if kv_dtype == "fp8":
        scale = torch.clamp(amax / FP8_MAX, min=1e-8)
        q = (x32 / scale[..., None]).to(torch.float8_e4m3fn)
    else:
        scale = torch.clamp(amax / 127.0, min=1e-8)
        q = torch.clamp(torch.round(x32 / scale[..., None]), -127,
                        127).to(torch.int8)
    return q, scale


def _quantize_cache(cache, cfg: TransformerConfig):
    """Compute-dtype {"k", "v"} per-layer tuples -> the quantized form
    with "k_scale"/"v_scale" tuples (identity for a compute-dtype cfg)."""
    if not _kv_quantized(cfg):
        return cache
    out = {}
    for name in ("k", "v"):
        q, s = zip(*(_quantize_rows(c, cfg.kv_cache_dtype)
                     for c in cache[name]))
        out[name], out[name + "_scale"] = tuple(q), tuple(s)
    return out


#: prefill lengths that are multiples of this go through the flash prefill
#: kernel on the "flash" route (its 128-row tiles); others run
#: ``full_attention``
FLASH_PREFILL_ALIGN = 128


def prefill(params, prompt, cfg: TransformerConfig, max_len: int,
            last_pos=None, mesh=None):
    """The prompt (B, T) in one pass, capturing K/V. Returns
    (logits (B, vocab) f32, cache): per-layer (B, kv_heads, max_len,
    head_dim) "k"/"v" in the compute dtype, zero past T — or, for a
    quantized ``cfg.kv_cache_dtype``, their one-byte form plus
    (B, kv_heads, max_len) f32 "k_scale"/"v_scale". ``last_pos``: int or
    (B,) — the position whose logits come back (default the last): the
    bucketed-prompt route, where a prompt right-padded to a ladder rung
    answers for its true end. ``mesh``: tp-sharded serving (module
    docstring); a kv-head-sharded cache comes back stacked (tp, B,
    kv_heads/tp, max_len, head_dim) (scales (tp, B, kv_heads/tp,
    max_len))."""
    B, T = prompt.shape
    if not 0 < T <= max_len <= cfg.max_seq:
        raise ValueError(f"need 0 < prompt len {T} <= max_len {max_len} "
                         f"<= max_seq {cfg.max_seq}")
    params, mesh = _serving_params(params, cfg, mesh)
    top, layers = local_params(params, cfg, mesh)
    dt = torch_dtype(cfg.dtype)
    x = top["embed"].to(dt)[prompt]
    if cfg.pos_embed == "learned":
        x = x + top["pos_embed"].to(dt)[:T]
    use_flash = cfg.decode_attn == "flash" and T % FLASH_PREFILL_ALIGN == 0
    tp = _kv_ranks(mesh, cfg)
    ks, vs = [], []
    for lp in layers:
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k, v = project_qkv(hn, lp, cfg)
        if cfg.pos_embed == "rope":
            # the cache stores POST-rope K
            pos = torch.arange(T, device=x.device)
            q = apply_rope(q, pos, cfg)
            k = apply_rope(k, pos, cfg)
        if tp > 1:  # each rank's head block, every rank in one launch
            q, k, v = (_fold(_heads_to_ranks(t, tp)) for t in (q, k, v))
        if use_flash:
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        else:
            o = full_attention(q, k, v, causal=True)
        if tp > 1:
            o, k, v = (t.reshape(tp, B, *t.shape[1:]) for t in (o, k, v))
        x = x + _attn_out(o, lp, dt, (B, T), tp > 1)
        x = mlp(x, lp, cfg)
        # capture in kernel layout ([tp,] B, Hkv[/tp], max_len, D)
        for store, t in ((ks, k), (vs, v)):
            c = t.new_zeros((*t.shape[:-3], t.shape[-2], max_len,
                             cfg.head_dim), dtype=dt)
            c[..., :T, :] = t.transpose(-3, -2)
            store.append(c)
    x = _rmsnorm(x, top["ln_f_scale"])
    if last_pos is None:
        x_last = x[:, -1]
    elif isinstance(last_pos, int):
        # a host position indexes on the host: no upload (the engine's
        # admission dispatches this without a synchronizing copy)
        x_last = x[:, last_pos]
    else:
        lp_ = torch.as_tensor(last_pos, device=x.device).long()
        x_last = x[torch.arange(B, device=x.device),
                   lp_.expand(B) if lp_.ndim == 0 else lp_]
    return lm_logits(x_last, top), _quantize_cache(
        {"k": tuple(ks), "v": tuple(vs)}, cfg)


def _token_step(params, pos, tokens, cfg: TransformerConfig, attend,
                mesh=None, stacked: bool = False):
    """Shared single-token skeleton: embed (+ learned position), per
    layer norm -> qkv -> rope at ``pos`` -> ``attend(l, q, k_new,
    v_new) -> o`` (the cache write + attention) -> wo -> MLP; final norm
    and lm_head. Returns logits (B, vocab) f32. ``mesh``: tp serving
    (``params`` their shards); ``stacked``: ``attend`` returns the tp
    ranks' head blocks (a kv-head-sharded cache)."""
    dt = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    top, layers = local_params(params, cfg, mesh)
    x = top["embed"].to(dt)[tokens]  # (B, D)
    if cfg.pos_embed == "learned":
        pe = top["pos_embed"].to(dt)
        # only a speculative round's overshoot past a row's budget reaches
        # past max_seq; JAX's gather clamps it, and so does this one
        x = x + (pe[pos.long().clamp(max=pe.shape[0] - 1)]
                 if torch.is_tensor(pos) and pos.ndim else pe[int(pos)])
    for l, lp in enumerate(layers):
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k_new, v_new = project_qkv(hn, lp, cfg)  # (B, H/Hkv, Dh)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, pos, cfg)
            k_new = apply_rope(k_new, pos, cfg)
        o = attend(l, q, k_new, v_new)
        x = x + _attn_out(o, lp, dt, (B,), stacked)
        x = mlp(x, lp, cfg)
    x = _rmsnorm(x, top["ln_f_scale"])
    return lm_logits(x, top)


# ---------------------------------------------------------------------------
# Linear KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               device=None, mesh=None):
    """Zeroed linear cache: "k"/"v" per-layer tuples of (B, kv_heads,
    max_len, head_dim) in the storage dtype; a quantized
    ``cfg.kv_cache_dtype`` adds (B, kv_heads, max_len) f32
    "k_scale"/"v_scale" tuples. ``device``: default ``cuda``. ``mesh``:
    kv-head-sharded over tp where tp divides kv_heads, stacked (tp, B,
    kv_heads/tp, ...)."""
    dev = resolve_device(device)
    tp = _kv_ranks(logical_mesh(mesh, cfg), cfg)
    shape = (batch, cfg.kv_heads // tp, max_len, cfg.head_dim)
    if tp > 1:
        shape = (tp, *shape)

    def fresh(sh, dt):
        return tuple(torch.zeros(sh, dtype=dt, device=dev)
                     for _ in range(cfg.n_layers))

    cache = {"k": fresh(shape, _kv_storage_dtype(cfg)),
             "v": fresh(shape, _kv_storage_dtype(cfg))}
    if _kv_quantized(cfg):
        cache["k_scale"] = fresh(shape[:-1], torch.float32)
        cache["v_scale"] = fresh(shape[:-1], torch.float32)
    return cache


def decode_step(params, cache, pos, tokens, cfg: TransformerConfig,
                mesh=None):
    """One token for every sequence at the shared position ``pos`` (a
    host int: the true current length). ``tokens`` (B,) int. Each
    layer's new K/V row (quantized for a one-byte cache) is written in
    place at row ``pos``, then attention runs per ``cfg.decode_attn``:
    "flash" is ``flash_decode_attention`` (the Hopper kernel on CUDA),
    anything else its plain version. Returns logits (B, vocab) f32.
    ``mesh``: tp serving on :func:`prefill`'s (or :func:`init_cache`'s)
    cache for that mesh: a stacked cache's ranks run in one launch."""
    pos = int(pos)
    params, mesh = _serving_params(params, cfg, mesh)
    tp = pool_ranks(cache["k"][0])
    stacked = tp > 1
    max_len = cache["k"][0].shape[-2]
    if not 0 <= pos < max_len:
        raise ValueError(f"position {pos} outside the cache [0, {max_len})")
    scale = 1.0 / (cfg.head_dim ** 0.5)
    quant = _kv_quantized(cfg)
    attend_fn = (flash_decode_attention if cfg.decode_attn == "flash"
                 else flash_decode_attention_reference)

    def attend(l, q, k_new, v_new):
        kc, vc = cache["k"][l], cache["v"][l]
        ks = vs = None
        if stacked:
            q, k_new, v_new = (_heads_to_ranks(t, tp) for t in (q, k_new, v_new))
        if quant:
            ks, vs = cache["k_scale"][l], cache["v_scale"][l]
            k_new, k_s = _quantize_rows(k_new, cfg.kv_cache_dtype)
            v_new, v_s = _quantize_rows(v_new, cfg.kv_cache_dtype)
            ks[..., pos] = k_s
            vs[..., pos] = v_s
        raw(kc)[..., pos, :] = raw(k_new.to(kc.dtype))
        raw(vc)[..., pos, :] = raw(v_new.to(vc.dtype))
        if not stacked:
            return attend_fn(q.contiguous(), kc, vc, pos, k_scale=ks,
                             v_scale=vs, scale=scale)
        o = attend_fn(_fold(q).contiguous(), _fold(kc), _fold(vc), pos,
                      k_scale=None if ks is None else _fold(ks),
                      v_scale=None if vs is None else _fold(vs),
                      scale=scale)
        return o.reshape(tp, -1, *o.shape[1:])

    return _token_step(params, pos, tokens, cfg, attend, mesh, stacked)


def extend_step(params, cache, pos: int, tokens, cfg: TransformerConfig,
                mesh=None):
    """Multi-token cache extension: ``tokens`` (B, c) at positions
    ``pos .. pos+c-1`` against the cache, writing their K/V in place and
    returning logits (B, c, vocab) f32 for every chunk position —
    :func:`decode_step` generalized from c = 1 (the verification
    primitive of speculative decoding). Query i attends rows <= pos+i.
    Compute-dtype caches only, always the gather form (JAX
    ``decode.py:510-583``). ``mesh``: tp serving on :func:`prefill`'s
    cache for that mesh (JAX's extend is GSPMD-partitioned from its
    sharded operands): the projections over the params' tp shards, a
    kv-head-sharded cache's ranks folded into the batch."""
    if cfg.kv_cache_dtype != "compute":
        raise ValueError("extend_step supports compute-dtype caches only")
    dt = torch_dtype(cfg.dtype)
    B, c = tokens.shape
    pos = int(pos)
    S = cache["k"][0].shape[-2]
    if pos < 0 or pos + c > S:
        raise ValueError(f"positions {pos}..{pos + c - 1} outside the "
                         f"cache [0, {S})")
    params, mesh = _serving_params(params, cfg, mesh)
    top, layers = local_params(params, cfg, mesh)
    tp = pool_ranks(cache["k"][0])
    stacked = tp > 1
    scale = 1.0 / (cfg.head_dim ** 0.5)
    Hkv, g, Dh = cfg.kv_heads // tp, cfg.n_heads // cfg.kv_heads, \
        cfg.head_dim
    dev = tokens.device
    positions = pos + torch.arange(c, device=dev)
    x = top["embed"].to(dt)[tokens]  # (B, c, D)
    if cfg.pos_embed == "learned":
        x = x + top["pos_embed"].to(dt)[pos:pos + c]
    # query i sees cache rows <= pos + i (its own row included)
    visible = torch.arange(S, device=dev)[None, :] <= positions[:, None]
    for l, lp in enumerate(layers):
        kc, vc = cache["k"][l], cache["v"][l]
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k_new, v_new = project_qkv(hn, lp, cfg)  # (B, c, H/Hkv, Dh)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, positions, cfg)
            k_new = apply_rope(k_new, positions, cfg)
        if stacked:  # each rank's head block, the ranks as batch rows
            q, k_new, v_new = (_fold_heads(t, tp) for t in (q, k_new, v_new))
            kc, vc = _fold(kc), _fold(vc)
        kc[:, :, pos:pos + c] = k_new.transpose(1, 2).to(dt)
        vc[:, :, pos:pos + c] = v_new.transpose(1, 2).to(dt)
        qg = q.reshape(q.shape[0], c, Hkv, g, Dh).float()
        s = torch.einsum("bckgd,bksd->bkgcs", qg, kc.float()) * scale
        s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgcs,bksd->bckgd", p, vc.float())
        o = o.reshape(tp, B, c, -1, Dh) if stacked else o
        x = x + _attn_out(o.to(dt), lp, dt, (B, c), stacked)
        x = mlp(x, lp, cfg)
    return lm_logits(_rmsnorm(x, top["ln_f_scale"]), top)


# ---------------------------------------------------------------------------
# Token choice and generation loops
# ---------------------------------------------------------------------------

def _topk_mask(logits, top_k: int):
    """Top-k truncation (0 = off): everything below the kth-highest
    logit goes to -inf; ties at the kth value all survive. The plain
    statement of the law :func:`sample_scores` draws from."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, float("-inf")))
    return logits


_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
#: lowbias32's multipliers (the 32-bit integer hash of C. Wellons'
#: hash-prospector) and the odd constants that spread a draw's inputs
#: (key words, position, vocab index) before it
_HASH_MUL = (0x7FEB352D, 0x846CA68B)
_SPREAD = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def _hash32(x):
    """lowbias32 on int64 lanes that hold uint32 values (the shifts are
    logical because every lane is non-negative; products are masked back
    to 32 bits, so int64 overflow never reaches a kept bit)."""
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _HASH_MUL[1]) & _M32
    return x ^ (x >> 16)


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def sample_key(seed: int, *data: int):
    """A sampler key, (2,) uint32 (low word, high word), from an int
    ``seed`` with each of ``data`` folded in (splitmix64 on the host) —
    the port's counterpart of ``jax.random.fold_in(PRNGKey(seed), d)``.
    The serving engine's ``request_key(seq_id)`` is
    ``sample_key(seed, seq_id)``."""
    import numpy as np

    z = _splitmix64(int(seed) & _M64)
    for d in data:
        z = _splitmix64(z ^ (int(d) & _M64))
    return np.array([z & _M32, z >> 32], np.uint32)


def _upload(a, device) -> torch.Tensor:
    """A host array on ``device`` without a synchronizing copy: on the card
    staged in pinned memory and copied on the current stream
    (``non_blocking``); on the CPU the array's own tensor."""
    t = torch.from_numpy(a)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _as_keys(key, batch: int, device) -> torch.Tensor:
    """(B, 2) int64 lanes holding uint32 key words, from one (2,) key
    (every row) or (B, 2) keys; uploaded through :func:`_upload`."""
    import numpy as np

    k = np.asarray(key, np.uint32).astype(np.int64)
    if k.shape == (2,):
        k = np.repeat(k[None], batch, axis=0)
    if tuple(k.shape) != (batch, 2):
        raise ValueError(f"key must be (2,) or ({batch}, 2) uint32, got "
                         f"{tuple(k.shape)}")
    return _upload(np.ascontiguousarray(k), device)


def uniform_noise(keys, pos, n: int):
    """Uniforms (..., B, n) f32 in (0, 1) for rows keyed by ``keys``
    ((B, 2) int64 lanes of uint32 words) at positions ``pos`` (an int or
    (B,) for one set a row, or (S, B) for S sets a row at once): 23 bits
    of a counter-based hash of (key, position, index). A row's uniforms
    are a function of its own key and position only."""
    lo, hi = keys[:, 0], keys[:, 1]
    if isinstance(pos, int):
        # a host position rides the kernel's scalar argument (no upload);
        # its low 32 bits are all the masked sum keeps
        step = (pos * _SPREAD[2]) & _M32
    else:
        step = torch.as_tensor(pos, device=keys.device).to(
            torch.int64) * _SPREAD[2]
    salt = _hash32((lo * _SPREAD[0] + hi * _SPREAD[1] + step) & _M32)
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)
    x = _hash32((salt[..., None] + idx * _SPREAD[3]) & _M32)
    # 23 bits and a half: every u is exact in f32, so none rounds to 1
    return ((x >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel_noise(keys, pos, vocab: int):
    """Gumbel noise (..., B, vocab) f32 for the tokens drawn at positions
    ``pos`` of rows keyed by ``keys``: ``-log(-log u)`` over
    :func:`uniform_noise`'s uniforms, one a vocab index."""
    return -torch.log(-torch.log(uniform_noise(keys, pos, vocab)))


#: the speculative sampler's streams (``models/speculative.py``): each
#: draws from the row's key folded with its own tag, so no stream reuses
#: the bits of another or of the plain draw (tag 0 is the key itself)
SPEC_STREAMS = {"draft": 1, "accept": 2, "residual": 3}


def fold_keys(keys, tag: int):
    """(B, 2) key lanes folded with a stream ``tag`` > 0 on the device:
    each word hashed with the tag (and the high one with the new low
    word), so a folded key's draws share no inputs with ``keys``'."""
    lo = _hash32(keys[:, 0] ^ ((tag * _SPREAD[0]) & _M32))
    hi = _hash32((keys[:, 1] + lo + tag * _SPREAD[1]) & _M32)
    return torch.stack([lo, hi], dim=1)


def sample_scores(logits, keys, pos, temps, top_k: int = 0, noise=None):
    """The perturbed scores whose argmax is the sampled token:
    ``top_k_mask(logits) / temps + g`` (f32; ``temps`` a float or (B,)).
    argmax of them is a draw from softmax(top-k-masked logits / T) —
    the Gumbel-max law ``jax.random.categorical`` uses. Their top-1 /
    top-2 gap is what a tie-aware oracle reads for a sampled step.
    ``noise``: ``g`` when the caller drew it already (the engine draws a
    chunk's in one pass), else drawn here."""
    t = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
    if t.ndim == 1:
        t = t[:, None]
    if noise is None:
        noise = gumbel_noise(keys, pos, logits.shape[-1])
    return _topk_mask(logits.float(), top_k) / t + noise


def _pick(logits, temperature=0.0, top_k: int = 0, keys=None, pos=None,
          noise=None):
    """Next token, int32: argmax (first maximal index) of the logits
    when ``temperature`` is a float <= 0 (no noise op runs); else the
    argmax of :func:`sample_scores` — ``temperature`` a float or (B,)
    per-row tensor, ``keys`` (B, 2) int64 lanes, ``pos`` the position
    the drawn token will take (int or (B,)), ``noise`` as there."""
    if not torch.is_tensor(temperature) and temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.argmax(sample_scores(logits, keys, pos, temperature,
                                      top_k, noise), dim=-1).to(torch.int32)


def support_edges(logits, top_k: int, t):
    """Each token's top-k membership (..., V) bool and its distance to the
    support's edge in score units (``logits / t``): above the (k+1)-th
    logit for a member, below the k-th for the rest; inf without top-k."""
    if not top_k or top_k >= logits.shape[-1]:
        return (torch.ones_like(logits, dtype=torch.bool),
                torch.full_like(logits, float("inf")))
    vals = torch.topk(logits, top_k + 1, dim=-1).values
    th, nx = vals[..., top_k - 1:top_k], vals[..., top_k:top_k + 1]
    inside = logits >= th
    return inside, torch.where(inside, logits - nx, th - logits) / t


def pick_margin(scores, raw, inside, member):
    """The margin of a Gumbel-max pick over ``scores`` (-inf off the
    support) with ``raw`` the scores every token would have inside it
    (``inside``, ``member``: :func:`support_edges`), in score units — how
    far the logits must move to change the token:
    the smallest of the top-1/top-2 gap, the winner's distance to the
    support's edge, and for each token outside, the larger of its
    distance to the edge and how far its raw score lies below the
    winner's (a token that would win must first enter)."""
    top = torch.topk(scores, 2, dim=-1)
    w = top.indices[..., :1]
    entry = torch.where(inside, float("inf"),
                        torch.maximum(member, top.values[..., :1] - raw))
    return torch.minimum(
        torch.minimum(top.values[..., 0] - top.values[..., 1],
                      member.gather(-1, w)[..., 0]), entry.amin(dim=-1))


def _top2_margin(logits):
    """top-1 minus top-2 logit per row (how close the greedy pick was
    to a tie)."""
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _sampling_keys(cfg: TransformerConfig, temperature: float, top_k: int,
                   key, generator, batch: int, device):
    """The (B, 2) key lanes of a sampled generation (None when greedy):
    ``key`` as given, else one key a row drawn from ``generator``."""
    if not 0 <= top_k <= cfg.vocab:
        raise ValueError(f"top_k {top_k} outside [0, vocab]")
    if temperature <= 0.0:
        return None
    if key is not None:
        return _as_keys(key, batch, device)
    if generator is None:
        raise ValueError("sampling (temperature > 0) needs a key or a "
                         "torch.Generator")
    return torch.randint(0, 1 << 32, (batch, 2), generator=generator,
                         device=generator.device,
                         dtype=torch.int64).to(device)


def _generation_loop(step, logits, T: int, new_tokens: int, keys,
                     temperature: float, top_k: int, with_margins: bool):
    """The loop shared by the linear and paged caches: pick the first
    token (position ``T``) from the prefill logits, then ``new_tokens -
    1`` steps ``step(pos, tok) -> logits``. Returns (B, new_tokens) int32
    (and, with ``with_margins``, each step's margin: the top-1/top-2
    logit gap when greedy; when sampled, the whole margin of the pick
    (:func:`pick_margin`: the perturbed scores' top-1/top-2 gap and the
    distances to the top-k support's edge) — how far the logits must move
    to change the token)."""

    def pick(lg, pos):
        if keys is None:
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            return tok, _top2_margin(lg) if with_margins else None
        g = gumbel_noise(keys, pos, lg.shape[-1])
        sc = sample_scores(lg, keys, pos, temperature, top_k, g)
        m = None
        if with_margins:
            lf = lg.float()
            inside, member = support_edges(lf, top_k, temperature)
            m = pick_margin(sc, lf / temperature + g, inside, member)
        return torch.argmax(sc, dim=-1).to(torch.int32), m

    tok, m = pick(logits, T)
    toks, margins = [tok], [m]
    for i in range(new_tokens - 1):
        logits = step(T + i, tok)
        tok, m = pick(logits, T + i + 1)
        toks.append(tok)
        margins.append(m)
    out = torch.stack(toks, dim=1)
    if with_margins:
        return out, torch.stack(margins, dim=1)
    return out


def generate(params, prompt, cfg: TransformerConfig, new_tokens: int, *,
             key=None, generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int = 0, device=None,
             with_margins: bool = False, mesh=None):
    """Continuation tokens (B, new_tokens) int32 from a fresh linear
    cache (``mesh``: tp-sharded serving, module docstring): one prefill,
    then ``new_tokens - 1`` :func:`decode_step` s.
    Greedy by default; temperature/top-k sampling when ``temperature >
    0``, from ``key`` ((2,) uint32 for every row, or (B, 2); see
    :func:`sample_key`) or, without one, a key a row drawn from
    ``generator``. ``device``: default ``cuda``; params and prompt must
    live there. ``with_margins``: also return each step's margin (B,
    new_tokens) f32 (:func:`_generation_loop`)."""
    dev = resolve_device(device)
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    prompt = torch.as_tensor(prompt).to(dev)
    T = prompt.shape[1]
    if T + new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt {T} + new {new_tokens} exceeds max_seq {cfg.max_seq}")
    keys = _sampling_keys(cfg, temperature, top_k, key, generator,
                          prompt.shape[0], dev)
    params, mesh = _serving_params(params, cfg, mesh)
    with tracelib.compile_watch("decode.generate", batch=prompt.shape[0],
                                prompt_len=T, new_tokens=new_tokens):
        logits, cache = prefill(params, prompt, cfg, T + new_tokens,
                                mesh=mesh)
        return _generation_loop(
            lambda pos, tok: decode_step(params, cache, pos, tok, cfg,
                                         mesh=mesh),
            logits, T, new_tokens, keys, temperature, top_k, with_margins)


def greedy_generate(params, prompt, cfg: TransformerConfig,
                    new_tokens: int, *, device=None, mesh=None):
    """Greedy continuation (B, new_tokens) int32 on the linear cache."""
    return generate(params, prompt, cfg, new_tokens, device=device,
                    mesh=mesh)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: TransformerConfig, batch: int,
                     pages_per_seq: int, page_size: int,
                     pool_pages: int | None = None, table=None, *,
                     device=None, mesh=None):
    """Zeroed per-layer page pools (pool_pages, kv_heads, page_size,
    head_dim) in the storage dtype plus a (batch, pages_per_seq) int32
    ``table`` (default: the identity layout, which needs a page per
    (sequence, slot)). A quantized ``cfg.kv_cache_dtype`` adds per-row
    f32 scale pools "k_scale"/"v_scale" (pool_pages, kv_heads, 1,
    page_size). ``device``: default ``cuda``. ``mesh``: pools
    kv-head-sharded over tp where tp divides kv_heads, stacked (tp,
    pool_pages, kv_heads/tp, ...); the table is every rank's."""
    dev = resolve_device(device)
    tp = _kv_ranks(logical_mesh(mesh, cfg), cfg)
    lead = (tp,) if tp > 1 else ()
    if pool_pages is None:
        pool_pages = batch * pages_per_seq
    if table is None:
        if pool_pages < batch * pages_per_seq:
            raise ValueError(
                f"pool_pages {pool_pages} < batch*pages_per_seq "
                f"{batch * pages_per_seq}: the default identity table "
                "needs a page per (sequence, slot); pass an explicit table")
        table = torch.arange(batch * pages_per_seq, dtype=torch.int32)
        table = table.reshape(batch, pages_per_seq)

    def fresh(sh, dt):
        return tuple(torch.zeros(sh, dtype=dt, device=dev)
                     for _ in range(cfg.n_layers))

    dt = _kv_storage_dtype(cfg)
    hkv = cfg.kv_heads // tp
    shape = (*lead, pool_pages, hkv, page_size, cfg.head_dim)
    cache = {"k": fresh(shape, dt), "v": fresh(shape, dt),
             "table": torch.as_tensor(table, dtype=torch.int32).to(dev)}
    if _kv_quantized(cfg):
        sshape = (*lead, pool_pages, hkv, 1, page_size)
        cache["k_scale"] = fresh(sshape, torch.float32)
        cache["v_scale"] = fresh(sshape, torch.float32)
    return cache


def paged_prefill(params, prompt, cfg: TransformerConfig, cache,
                  page_size: int, last_pos=None, mesh=None):
    """Prompt pass writing into the paged cache: :func:`prefill` captures
    (and, for a one-byte cache, quantizes) K/V at the prompt length,
    then each layer's pages — and scale rows — scatter into the pools
    through ``cache["table"]``, IN PLACE. Returns (last_logits, cache).
    ``mesh``: tp serving into :func:`init_paged_cache`'s pools for that
    mesh (each rank's kv-head block into its own pool)."""
    B, T = prompt.shape
    P = page_size
    t_pad = -(-T // P) * P
    n_used = t_pad // P
    table = cache["table"]
    if n_used > table.shape[1]:
        raise ValueError(f"prompt needs {n_used} pages; table has "
                         f"{table.shape[1]}")
    logits, lin = prefill(params, prompt, cfg, T, last_pos=last_pos,
                          mesh=mesh)
    idx = table[:, :n_used].long()  # (B, n_used)
    stacked = pool_ranks(cache["k"][0]) > 1
    for name in lin:
        for l, pool in enumerate(cache[name]):
            src = lin[name][l]
            for a, dst in (zip(src.unbind(0), pool.unbind(0)) if stacked
                           else ((src, pool),)):
                a = raw(a)  # (B, Hkv, T[, D])
                scales = a.ndim == 3
                if scales:  # (pool, Hkv, 1, P) pools: pages as (Hkv, P, 1)
                    a = a[..., None]
                if t_pad > T:
                    a = torch.nn.functional.pad(a, (0, 0, 0, t_pad - T))
                # (B, Hkv, t_pad, X) -> (B, n_used, Hkv, P, X) page blocks
                pages = a.reshape(B, a.shape[1], n_used, P,
                                  a.shape[-1]).transpose(1, 2)
                if scales:
                    pages = pages.transpose(-1, -2)
                dst = raw(dst)
                dst[idx] = pages.to(dst.dtype)  # in-place scatter
    return logits, cache


#: row-alignment quantum for bitwise prefill parity (JAX
#: ``models/decode.py:822``): a GEMM reproduces a row's dot products
#: bitwise across different total row counts only when both counts are
#: multiples of this on the CPU (JAX measured it on XLA:CPU; torch's CPU
#: GEMMs gave identical rows for 8-, 16- and 32-row tails of a 40-row
#: product). The sharing engine enforces rung and page alignment to it.
PREFIX_ALIGN = 8


def paged_tail_prefill(params, tail, cfg: TransformerConfig, cache,
                       page_size: int, n_prefix_pages: int, last_pos=None,
                       mesh=None):
    """Prefill ONLY the tail of a prompt whose first ``n_prefix_pages``
    pages of K/V already sit in the pool (the prefix-sharing arena's
    admission path, ``models/serving.py``): positions ``[M, M + c)``, ``M
    = n_prefix_pages * page_size``, are computed and scattered in place
    into the pages ``table[0, n_prefix_pages:]``; the prefix pages are
    gathered as attention context and never written. Returns ``(logits,
    cache)`` like :func:`paged_prefill`, with ``last_pos`` TAIL-RELATIVE.

    Parity: the tail's attention mirrors :func:`prefill`'s plain route
    (``full_attention``) term for term — the same grouped scores, mask
    constant and softmax over ``M + c`` keys — so on the CPU the tail
    pages and the logits equal a monolithic :func:`paged_prefill` of the
    whole ``M + c`` prompt bit for bit, provided the prefix pages hold
    what a SAME-LENGTH prefill wrote (rung-keyed sharing), ``M`` and
    ``c`` are multiples of :data:`PREFIX_ALIGN`, and the monolithic side
    took the plain route (not kernel 1, which a 128-multiple length on
    the ``flash`` route takes). On the card cuBLAS picks its kernel by
    the row count, so the tail rows may differ from the monolithic ones
    in their last bits.

    Refused, as in JAX: quantized pools (the monolithic prefill attends
    to the exact K/V and quantizes only for storage), ``B != 1`` and
    misaligned ``M`` or ``c``.

    ``mesh``: tp serving into :func:`init_paged_cache`'s pools for that
    mesh (JAX ``decode.py:822-824``), as :func:`paged_prefill`: each
    rank's kv-head block attends its own prefix pages and writes its own
    tail pages, the ranks folded into the batch."""
    if _kv_quantized(cfg):
        raise ValueError(
            f"paged_tail_prefill: kv_cache_dtype={cfg.kv_cache_dtype!r} "
            "pools cannot share prefixes bitwise — the monolithic prefill "
            "attends to exact K/V and quantizes only for storage, so a "
            "tail computed from dequantized shared pages would diverge; "
            "serve quantized KV with prefix_cache=False")
    B, c = tail.shape
    if B != 1:
        raise ValueError(
            f"paged_tail_prefill is single-row (got B={B}): the prefix "
            "context gathers through table[0]")
    P = page_size
    M = n_prefix_pages * P
    if M % PREFIX_ALIGN or c % PREFIX_ALIGN:
        raise ValueError(
            f"paged_tail_prefill needs prefix length {M} and tail length "
            f"{c} aligned to {PREFIX_ALIGN} rows (bitwise GEMM row "
            "stability); pad the rung/page geometry")
    table = cache["table"]
    n_tail = -(-c // P)
    if n_prefix_pages + n_tail > table.shape[1]:
        raise ValueError(
            f"tail needs pages {n_prefix_pages}..{n_prefix_pages + n_tail}"
            f"; table has {table.shape[1]}")
    dt = torch_dtype(cfg.dtype)
    params, mesh = _serving_params(params, cfg, mesh)
    top, layers = local_params(params, cfg, mesh)
    tp = pool_ranks(cache["k"][0])
    stacked = tp > 1
    Hkv, Dh = cfg.kv_heads // tp, cfg.head_dim
    tbl = table[:1].long()
    if stacked:
        tbl = _rank_tables(tbl, tp, cache["k"][0].shape[1])  # (tp, pages)
    pidx = tbl[:, :n_prefix_pages]

    def context(pool):
        # prefix pages (rows, m, Hkv, P, D) -> (rows, M, Hkv, D), layout
        pool = _fold(pool) if stacked else pool
        return raw(pool)[pidx].view(pool.dtype).permute(0, 1, 3, 2, 4) \
            .reshape(tp, M, Hkv, Dh).to(dt)

    x = top["embed"].to(dt)[tail]
    pos = M + torch.arange(c, device=x.device)
    if cfg.pos_embed == "learned":
        x = x + top["pos_embed"].to(dt)[pos]
    ks, vs = [], []
    for l, lp in enumerate(layers):
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k, v = project_qkv(hn, lp, cfg)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, pos, cfg)
            k = apply_rope(k, pos, cfg)
        if stacked:  # each rank's head block, the ranks as batch rows
            q, k, v = (_fold_heads(t, tp) for t in (q, k, v))
        k_ctx = torch.cat([context(cache["k"][l]), k], dim=1)
        v_ctx = torch.cat([context(cache["v"][l]), v], dim=1)
        o = full_attention(q, k_ctx, v_ctx, causal=True, q_offset=M)
        o = o.reshape(tp, B, c, -1, Dh) if stacked else o
        x = x + _attn_out(o, lp, dt, (B, c), stacked)
        x = mlp(x, lp, cfg)
        ks.append(k.transpose(1, 2))  # (rows, Hkv, c, D), as prefill stores
        vs.append(v.transpose(1, 2))
    x = _rmsnorm(x, top["ln_f_scale"])
    if last_pos is None:
        x_last = x[:, -1]
    else:
        x_last = x[:, int(last_pos)]
    logits = lm_logits(x_last, top)
    # scatter the tail pages as paged_prefill does: zero-pad the tail
    # K/V to the page boundary, page-blocked through the table
    t_pad = n_tail * P
    idx = tbl[:, n_prefix_pages:n_prefix_pages + n_tail]
    for name, lin in (("k", ks), ("v", vs)):
        for l, pool in enumerate(cache[name]):
            a = lin[l]
            if t_pad > c:
                a = torch.nn.functional.pad(a, (0, 0, 0, t_pad - c))
            pages = a.reshape(tp, Hkv, n_tail, P, Dh).transpose(1, 2)
            dst = raw(_fold(pool) if stacked else pool)
            dst[idx] = pages.to(pool.dtype).view(dst.dtype)
    return logits, cache


def _pool_write(pool, page_ids, offset, rows):
    """Write one (B, Hkv, D) K/V row per sequence into page
    ``page_ids[b]`` at slot ``offset`` (int or (B,)) — an in-place
    scatter into the pool (the port mutates; JAX returns a new pool)."""
    raw(pool)[page_ids, :, offset, :] = raw(rows.to(pool.dtype))


def _scale_write(pool, page_ids, offset, rows):
    """The scale companion of :func:`_pool_write` for the (pool_pages,
    kv_heads, 1, page_size) scale pools: one (B, kv_heads) row of scales
    lands at lane ``offset`` of its page."""
    pool[page_ids, :, 0, offset] = rows.to(pool.dtype)


def paged_decode_step(params, cache, pos, tokens, cfg: TransformerConfig,
                      mesh=None):
    """One token per sequence against the paged cache. ``tokens`` (B,);
    ``pos``: a shared int or a (B,) int32 tensor of per-sequence
    positions (ragged). Each layer's new K/V row (quantized, with its
    scales, for a one-byte cache) is written in place into page
    ``table[b, pos // P]`` at slot ``pos % P``, then attention runs per
    ``cfg.decode_attn``: "flash" (``flash_decode_paged``), "paged_flash"
    (``paged_attention_decode``; both the Hopper kernels on CUDA) or
    "gather" (the plain view on any device). Returns logits (B, vocab)
    f32; the cache is updated in place.

    CONTRACT: every position < pages_per_seq * page_size. An int or CPU
    ``pos`` is checked here; a CUDA ``pos`` is not (checking would force
    a device sync) and the kernels clamp it to the table's last page.

    ``mesh``: tp serving on :func:`paged_prefill`'s pools for that mesh:
    a stacked pool's ranks run in one launch, the pools folded over the
    ranks and each rank's table offset to its own pool."""
    params, mesh = _serving_params(params, cfg, mesh)
    table = cache["table"]
    tp = pool_ranks(cache["k"][0])
    stacked = tp > 1
    P = cache["k"][0].shape[-2]
    pages = table.shape[1]
    scale = 1.0 / (cfg.head_dim ** 0.5)
    quant = _kv_quantized(cfg)
    ragged = torch.is_tensor(pos) and pos.ndim == 1
    if not ragged:
        pos = int(pos)
    if not ragged or pos.device.type == "cpu":
        top = int(pos.max()) if ragged else pos
        if top >= pages * P:
            raise ValueError(
                f"position(s) {top} past cache capacity {pages * P} "
                "tokens: past-capacity writes would corrupt the last page")
    if ragged:
        page = (pos // P).long()
        page_ids = table.gather(1, page[:, None])[:, 0].long()
        offset = (pos % P).long()
    else:
        page_ids = table[:, pos // P].long()
        offset = pos % P
    attend_fn = {"flash": flash_decode_paged,
                 "paged_flash": paged_attention_decode}.get(cfg.decode_attn)
    t_att, pos_att, ids, offs = table, pos, page_ids, offset
    if stacked:
        # every rank's pool folded into one: rank r's rows read and write
        # its own pool, through page ids offset by r pools
        n_pool = cache["k"][0].shape[1]
        t_att = _rank_tables(table, tp, n_pool)
        off = torch.arange(tp, device=table.device) * n_pool
        ids = (page_ids[None] + off[:, None]).reshape(-1)
        if ragged:
            pos_att, offs = pos.repeat(tp), offset.repeat(tp)

    def attend(l, q, k_new, v_new):
        k_pool, v_pool = cache["k"][l], cache["v"][l]
        ks = vs = None
        if quant:
            ks, vs = cache["k_scale"][l], cache["v_scale"][l]
        if stacked:  # each rank's head block, all ranks in one call
            q, k_new, v_new = (_fold(_heads_to_ranks(t, tp))
                               for t in (q, k_new, v_new))
            k_pool, v_pool = _fold(k_pool), _fold(v_pool)
            ks, vs = (None if t is None else _fold(t) for t in (ks, vs))
        if quant:
            k_new, k_s = _quantize_rows(k_new, cfg.kv_cache_dtype)
            v_new, v_s = _quantize_rows(v_new, cfg.kv_cache_dtype)
            _scale_write(ks, ids, offs, k_s)
            _scale_write(vs, ids, offs, v_s)
        _pool_write(k_pool, ids, offs, k_new)
        _pool_write(v_pool, ids, offs, v_new)
        if attend_fn is None:
            o = flash_decode_paged_reference(
                q, k_pool, v_pool, t_att, pos_att, scale, k_scale_pool=ks,
                v_scale_pool=vs)
        else:
            o = attend_fn(q.contiguous(), k_pool, v_pool, t_att, pos_att,
                          k_scale_pool=ks, v_scale_pool=vs, scale=scale)
        return o.reshape(tp, -1, *o.shape[1:]) if stacked else o

    return _token_step(params, pos, tokens, cfg, attend, mesh, stacked)


def paged_extend_step(params, cache, pos, tokens, cfg: TransformerConfig,
                      mesh=None):
    """RAGGED multi-token extension against the paged cache (JAX
    ``decode.py:1250-1372``): row ``b``'s chunk ``tokens[b]`` (B, c)
    takes positions ``pos[b] .. pos[b]+c-1`` — the verification step of
    per-row-progress speculative decoding (``models/speculative.py``).
    ``pos``: (B,) int32 tensor.

    The chunk's K/V scatter into the pools IN PLACE at per-row (page,
    offset) pairs; a one-byte pool quantizes each row with
    :func:`_quantize_rows` and writes its scales as
    :func:`paged_decode_step` does. Attention is the gather form over the
    table-linearized pools in f32 (dequantized for one-byte pools) with
    the per-row mask ``row <= pos[b]+i``: plain PyTorch, as JAX's is XLA
    (no kernel). Returns logits (B, c, vocab) f32.

    ``mesh``: tp serving on :func:`paged_prefill`'s pools for that mesh
    (JAX's has no mesh argument: GSPMD partitions it from the sharded
    params and pools; the port's are rank-stacked, so it takes the mesh
    as the other steps do, and None changes nothing): the projections
    over the params' tp shards, a stacked pool's ranks folded into one
    pool with each rank's rows reading and writing its own.

    CONTRACT (as :func:`paged_decode_step`'s): every touched position <
    pages_per_seq * page_size. A CPU ``pos`` is checked; a CUDA one is
    not (checking would force a sync) and past capacity the page index
    clamps to the table's last page, as JAX's traced ``pos`` does."""
    B, c = tokens.shape
    if not (torch.is_tensor(pos) and pos.ndim == 1 and pos.shape[0] == B):
        raise ValueError(
            f"pos must be (batch,)={B} per-row positions, got "
            f"{tuple(pos.shape) if torch.is_tensor(pos) else pos!r}")
    quant = _kv_quantized(cfg)
    dt = torch_dtype(cfg.dtype)
    table = cache["table"]
    P = cache["k"][0].shape[-2]
    pages = table.shape[1]
    if pos.device.type == "cpu" and int(pos.max()) + c > pages * P:
        raise ValueError(f"chunk end {int(pos.max()) + c} past cache "
                         f"capacity {pages * P} tokens")
    params, mesh = _serving_params(params, cfg, mesh)
    top, layers = local_params(params, cfg, mesh)
    tp = pool_ranks(cache["k"][0])
    stacked = tp > 1
    scale = 1.0 / (cfg.head_dim ** 0.5)
    Hkv, g, Dh = cfg.kv_heads // tp, cfg.n_heads // cfg.kv_heads, \
        cfg.head_dim
    dev = tokens.device
    positions = pos.long()[:, None] + torch.arange(c, device=dev)  # (B, c)
    x = top["embed"].to(dt)[tokens]  # (B, c, D)
    if cfg.pos_embed == "learned":
        pe = top["pos_embed"].to(dt)
        x = x + pe[positions.clamp(max=pe.shape[0] - 1)]
    tbl = table.long()
    rows_pos = positions
    if stacked:
        tbl = _rank_tables(tbl, tp, cache["k"][0].shape[1])
        rows_pos = positions.repeat(tp, 1)
    page = (rows_pos // P).clamp(max=pages - 1)
    pids = tbl.gather(1, page).reshape(-1)  # (rows*c,)
    off = (rows_pos % P).reshape(-1)
    S = pages * P
    # query i of row b sees the rows <= pos[b] + i (its own included)
    visible = (torch.arange(S, device=dev)[None, None, None, None, :]
               <= rows_pos[:, None, None, :, None])  # (rows, 1, 1, c, S)
    for l, lp in enumerate(layers):
        k_pool, v_pool = cache["k"][l], cache["v"][l]
        ks = vs = None
        if quant:
            ks, vs = cache["k_scale"][l], cache["v_scale"][l]
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k_new, v_new = project_qkv(hn, lp, cfg)  # (B, c, H/Hkv, Dh)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, positions, cfg)
            k_new = apply_rope(k_new, positions, cfg)
        if stacked:  # each rank's head block and pool, one folded pass
            q, k_new, v_new = (_fold_heads(t, tp) for t in (q, k_new, v_new))
            k_pool, v_pool = _fold(k_pool), _fold(v_pool)
            ks, vs = (None if t is None else _fold(t) for t in (ks, vs))
        rows_k = k_new.reshape(-1, Hkv, Dh)
        rows_v = v_new.reshape(-1, Hkv, Dh)
        if quant:
            rows_k, k_s = _quantize_rows(rows_k, cfg.kv_cache_dtype)
            rows_v, v_s = _quantize_rows(rows_v, cfg.kv_cache_dtype)
            _scale_write(ks, pids, off, k_s)
            _scale_write(vs, pids, off, v_s)
        _pool_write(k_pool, pids, off, rows_k)
        _pool_write(v_pool, pids, off, rows_v)
        kd = _gather_pages(k_pool, tbl).float()
        vd = _gather_pages(v_pool, tbl).float()
        if quant:
            kd = kd * _gather_pages(ks.transpose(2, 3), tbl).float()
            vd = vd * _gather_pages(vs.transpose(2, 3), tbl).float()
        qg = q.reshape(q.shape[0], c, Hkv, g, Dh).float()
        s = torch.einsum("bckgd,bksd->bkgcs", qg, kd) * scale
        s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgcs,bksd->bckgd", p, vd)
        o = o.reshape(tp, B, c, -1, Dh) if stacked else o
        x = x + _attn_out(o.to(dt), lp, dt, (B, c), stacked)
        x = mlp(x, lp, cfg)
    return lm_logits(_rmsnorm(x, top["ln_f_scale"]), top)


def paged_generate(params, prompt, cfg: TransformerConfig,
                   new_tokens: int, *, page_size: int = 512,
                   pages_per_seq: int | None = None, key=None,
                   generator: torch.Generator | None = None,
                   temperature: float = 0.0, top_k: int = 0, device=None,
                   with_margins: bool = False, mesh=None):
    """Continuation (B, new_tokens) int32 served from a fresh paged
    cache (``mesh``: tp-sharded serving, module docstring): one prefill,
    then ``new_tokens - 1`` decode steps at a shared position. Greedy by default; sampling when ``temperature > 0``, as
    :func:`generate` (``key`` or ``generator``): with the serving
    engine's ``request_key(seq_id)`` it reproduces that request's served
    tokens. ``device``: default ``cuda`` (raises without a GPU unless
    ``device="cpu"``); params and prompt must live there.
    ``with_margins``: also return each step's margin (B, new_tokens) f32
    (:func:`_generation_loop`) — what a tie-aware comparison needs."""
    dev = resolve_device(device)
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    prompt = torch.as_tensor(prompt).to(dev)
    B, T = prompt.shape
    need = T + new_tokens
    if need > cfg.max_seq:
        raise ValueError(
            f"prompt {T} + new {new_tokens} exceeds max_seq {cfg.max_seq}")
    if pages_per_seq is None:
        pages_per_seq = -(-need // page_size)
    if pages_per_seq * page_size < need:
        raise ValueError(f"{pages_per_seq} pages of {page_size} < {need} "
                         "tokens")
    keys = _sampling_keys(cfg, temperature, top_k, key, generator, B, dev)
    with tracelib.compile_watch("decode.paged_generate", batch=B,
                                prompt_len=T, new_tokens=new_tokens,
                                page_size=page_size):
        params, mesh = _serving_params(params, cfg, mesh)
        cache = init_paged_cache(cfg, B, pages_per_seq, page_size,
                                 device=dev, mesh=mesh)
        logits, cache = paged_prefill(params, prompt, cfg, cache, page_size,
                                      mesh=mesh)
        return _generation_loop(
            lambda pos, tok: paged_decode_step(params, cache, pos, tok,
                                               cfg, mesh=mesh),
            logits, T, new_tokens, keys, temperature, top_k, with_margins)
