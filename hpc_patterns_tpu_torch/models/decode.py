"""Prefill and paged decode: the counterpart of the paged half of
``hpc_patterns_tpu/models/decode.py``.

- :func:`prefill` runs the prompt in one batched pass and captures each
  layer's K/V (the bucketed ``last_pos`` route included); padded
  lengths that are multiples of 128 go through the flash prefill kernel,
  others through ``full_attention`` (``decode.py:290-304``).
- The paged cache is per-layer page pools (pool_pages, kv_heads,
  page_size, head_dim) plus one (batch, pages_per_seq) int32 table.
  Unlike JAX's immutable arrays, the port writes the pools IN PLACE
  (:func:`paged_prefill`, :func:`_pool_write`): the pool is the serving
  capacity, and a copy per write would double it.
- :func:`paged_decode_step` routes attention by ``cfg.decode_attn``:
  "flash" runs ``ops.flash_decode.flash_decode_paged`` (the Hopper kernel
  on CUDA), "gather" the kernel's plain version — the table-gather
  view of ``_paged_attend_gather`` — on any device; "paged_flash" is
  not ported yet.

Greedy decoding only; compute-dtype KV only.
"""

from __future__ import annotations

import torch

from hpc_patterns_tpu_torch.dtypes import torch_dtype
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    _rmsnorm,
    apply_rope,
    layer_params,
    matmul_weight,
    mlp,
    project_qkv,
)
from hpc_patterns_tpu_torch.ops.flash_attention import flash_attention
from hpc_patterns_tpu_torch.ops.flash_decode import (
    flash_decode_paged,
    flash_decode_paged_reference,
)
from hpc_patterns_tpu_torch.parallel.ring_attention import full_attention
from hpc_patterns_tpu_torch.topology import resolve_device


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.kv_cache_dtype != "compute":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r}: quantized KV pools "
            "are not ported yet (compute-dtype pools only)")
    if cfg.n_experts or cfg.mlp_impl != "dense":
        raise NotImplementedError("dense MLP models only in this slice")


def prefill(params, prompt, cfg: TransformerConfig, max_len: int,
            last_pos=None):
    """The prompt (B, T) in one pass, capturing K/V. Returns
    (logits (B, vocab) f32, {"k", "v"}: per-layer tuples of
    (B, kv_heads, max_len, head_dim) caches in the compute dtype, zero
    past T). ``last_pos``: int or (B,) — the position whose logits come
    back (default the last): the bucketed-prompt route, where a prompt
    right-padded to a ladder rung answers for its true end."""
    _check_supported(cfg)
    B, T = prompt.shape
    if not 0 < T <= max_len <= cfg.max_seq:
        raise ValueError(f"need 0 < prompt len {T} <= max_len {max_len} "
                         f"<= max_seq {cfg.max_seq}")
    dt = torch_dtype(cfg.dtype)
    x = params["embed"].to(dt)[prompt]
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"].to(dt)[:T]
    use_flash = cfg.decode_attn == "flash" and T % 128 == 0
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k, v = project_qkv(hn, lp, cfg)
        if cfg.pos_embed == "rope":
            # the cache stores POST-rope K
            pos = torch.arange(T, device=x.device)
            q = apply_rope(q, pos, cfg)
            k = apply_rope(k, pos, cfg)
        if use_flash:
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        else:
            o = full_attention(q, k, v, causal=True)
        x = x + o.reshape(B, T, cfg.d_model) @ matmul_weight(lp, "wo", dt)
        x = mlp(x, lp, cfg)
        # capture in kernel layout (B, Hkv, max_len, D)
        for store, t in ((ks, k), (vs, v)):
            c = t.new_zeros((B, cfg.kv_heads, max_len, cfg.head_dim),
                            dtype=dt)
            c[:, :, :T] = t.transpose(1, 2)
            store.append(c)
    x = _rmsnorm(x, params["ln_f_scale"])
    if last_pos is None:
        x_last = x[:, -1]
    else:
        lp_ = torch.as_tensor(last_pos, device=x.device).long()
        x_last = x[torch.arange(B, device=x.device),
                   lp_.expand(B) if lp_.ndim == 0 else lp_]
    logits = x_last @ matmul_weight(params, "lm_head", dt)
    return logits.float(), {"k": tuple(ks), "v": tuple(vs)}


def init_paged_cache(cfg: TransformerConfig, batch: int,
                     pages_per_seq: int, page_size: int,
                     pool_pages: int | None = None, table=None, *,
                     device=None):
    """Zeroed per-layer page pools (pool_pages, kv_heads, page_size,
    head_dim) in the compute dtype plus a (batch, pages_per_seq) int32
    ``table`` (default: the identity layout, which needs a page per
    (sequence, slot)). ``device``: default ``cuda``."""
    _check_supported(cfg)
    dev = resolve_device(device)
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
    dt = torch_dtype(cfg.dtype)
    shape = (pool_pages, cfg.kv_heads, page_size, cfg.head_dim)
    return {
        "k": tuple(torch.zeros(shape, dtype=dt, device=dev)
                   for _ in range(cfg.n_layers)),
        "v": tuple(torch.zeros(shape, dtype=dt, device=dev)
                   for _ in range(cfg.n_layers)),
        "table": torch.as_tensor(table, dtype=torch.int32).to(dev),
    }


def paged_prefill(params, prompt, cfg: TransformerConfig, cache,
                  page_size: int, last_pos=None):
    """Prompt pass writing into the paged cache: :func:`prefill` captures
    K/V at the prompt length, then each layer's pages scatter into the
    pools through ``cache["table"]`` — IN PLACE. Returns
    (last_logits, cache)."""
    B, T = prompt.shape
    P = page_size
    t_pad = -(-T // P) * P
    n_used = t_pad // P
    table = cache["table"]
    if n_used > table.shape[1]:
        raise ValueError(f"prompt needs {n_used} pages; table has "
                         f"{table.shape[1]}")
    logits, lin = prefill(params, prompt, cfg, T, last_pos=last_pos)
    idx = table[:, :n_used].long()  # (B, n_used)
    for name in ("k", "v"):
        for l, pool in enumerate(cache[name]):
            a = lin[name][l]
            if t_pad > T:
                a = torch.nn.functional.pad(a, (0, 0, 0, t_pad - T))
            # (B, Hkv, t_pad, D) -> (B, n_used, Hkv, P, D) page blocks
            pages = a.reshape(B, cfg.kv_heads, n_used, P,
                              cfg.head_dim).transpose(1, 2)
            pool[idx] = pages.to(pool.dtype)  # in-place scatter
    return logits, cache


def _pool_write(pool, page_ids, offset, rows):
    """Write one (B, Hkv, D) K/V row per sequence into page
    ``page_ids[b]`` at slot ``offset`` (int or (B,)) — an in-place
    scatter into the pool (the port mutates; JAX returns a new pool)."""
    pool[page_ids, :, offset, :] = rows.to(pool.dtype)


def _token_step(params, pos, tokens, cfg: TransformerConfig, attend):
    """Shared single-token skeleton: embed (+ learned position), per
    layer norm -> qkv -> rope at ``pos`` -> ``attend(l, q, k_new,
    v_new) -> o`` (the cache write + attention) -> wo -> MLP; final norm
    and lm_head. Returns logits (B, vocab) f32."""
    dt = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    x = params["embed"].to(dt)[tokens]  # (B, D)
    if cfg.pos_embed == "learned":
        pe = params["pos_embed"].to(dt)
        x = x + (pe[pos.long()] if torch.is_tensor(pos) and pos.ndim
                 else pe[int(pos)])
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        hn = _rmsnorm(x, lp["ln1_scale"])
        q, k_new, v_new = project_qkv(hn, lp, cfg)  # (B, H/Hkv, Dh)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, pos, cfg)
            k_new = apply_rope(k_new, pos, cfg)
        o = attend(l, q, k_new, v_new)
        x = x + o.reshape(B, cfg.d_model).to(dt) @ matmul_weight(
            lp, "wo", dt)
        x = mlp(x, lp, cfg)
    x = _rmsnorm(x, params["ln_f_scale"])
    return (x @ matmul_weight(params, "lm_head", dt)).float()


def paged_decode_step(params, cache, pos, tokens, cfg: TransformerConfig):
    """One token per sequence against the paged cache. ``tokens`` (B,);
    ``pos``: a shared int or a (B,) int32 tensor of per-sequence
    positions (ragged). Each layer's new K/V row is written in place
    into page ``table[b, pos // P]`` at slot ``pos % P``, then attention
    runs per ``cfg.decode_attn``. Returns logits (B, vocab) f32; the
    cache is updated in place.

    CONTRACT: every position < pages_per_seq * page_size. An int or CPU
    ``pos`` is checked here; a CUDA ``pos`` is not (checking would force
    a device sync) and the kernel clamps it to the table's last page."""
    _check_supported(cfg)
    if cfg.decode_attn == "paged_flash":
        raise NotImplementedError(
            "decode_attn='paged_flash' needs the exact-softmax paged "
            "kernel hpc_patterns_tpu/ops/paged_attention.py::"
            "_paged_attention_kernel, not ported yet")
    table = cache["table"]
    P = cache["k"][0].shape[2]
    pages = table.shape[1]
    scale = 1.0 / (cfg.head_dim ** 0.5)
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

    def attend(l, q, k_new, v_new):
        k_pool, v_pool = cache["k"][l], cache["v"][l]
        _pool_write(k_pool, page_ids, offset, k_new)
        _pool_write(v_pool, page_ids, offset, v_new)
        if cfg.decode_attn == "gather":
            return flash_decode_paged_reference(q, k_pool, v_pool, table,
                                                pos, scale)
        return flash_decode_paged(q.contiguous(), k_pool, v_pool, table,
                                  pos, scale=scale)

    return _token_step(params, pos, tokens, cfg, attend)


def _pick(logits):
    """Greedy next token: argmax (first maximal index), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _top2_margin(logits):
    """top-1 minus top-2 logit per row (how close the greedy pick was
    to a tie)."""
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def paged_generate(params, prompt, cfg: TransformerConfig,
                   new_tokens: int, *, page_size: int = 512,
                   pages_per_seq: int | None = None, device=None,
                   with_margins: bool = False):
    """Greedy continuation (B, new_tokens) int32 served from a fresh
    paged cache: one prefill, then ``new_tokens - 1`` decode steps at a
    shared position. ``device``: default ``cuda`` (raises without a GPU
    unless ``device="cpu"``); params and prompt must live there.
    ``with_margins``: also return each step's top-1/top-2 logit gap
    (B, new_tokens) f32 — what a tie-aware comparison needs."""
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
    cache = init_paged_cache(cfg, B, pages_per_seq, page_size, device=dev)
    logits, cache = paged_prefill(params, prompt, cfg, cache, page_size)
    tok = _pick(logits)
    toks, margins = [tok], [_top2_margin(logits)] if with_margins else []
    for i in range(new_tokens - 1):
        logits = paged_decode_step(params, cache, T + i, tok, cfg)
        tok = _pick(logits)
        toks.append(tok)
        if with_margins:
            margins.append(_top2_margin(logits))
    out = torch.stack(toks, dim=1)
    if with_margins:
        return out, torch.stack(margins, dim=1)
    return out
