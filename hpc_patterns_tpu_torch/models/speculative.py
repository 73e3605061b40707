"""Speculative decoding: a small draft model proposes, the target
verifies a chunk in one pass — the counterpart of
``hpc_patterns_tpu/models/speculative.py``.

A round: the draft runs ``gamma + 1`` single-token steps from each row's
cursor (the extra one writes the last proposal's K/V, so a fully
accepted round leaves no hole), the target scores ``[cur, proposals]``
with one extend step, and acceptance is greedy-exact or rejection
sampling:

- greedy: accept while the proposal is the target's argmax, replace the
  first mismatch with it — token for token the target's own greedy
  decode, whatever the draft proposes;
- sampled (``temperature > 0``): proposal j, drawn from the draft's
  warped law q_j, is accepted when ``u * q_j(x_j) < min(q_j(x_j),
  p_j(x_j))`` against the target's warped p_j; the first rejection is
  replaced by a draw from the residual norm(max(p_j - q_j, 0)) (p_j
  itself when the residual is empty). The emitted law is target-only
  sampling's (Leviathan's rule, as JAX's ``_accept_resample``). A fully
  accepted round's extra token, which JAX draws from p_gamma directly,
  is decided here by the same rule against the draft's law from its
  extra step (which runs anyway): the same law, and the same tokens a
  round.

Cache invariant (both caches, one cursor a row): at the top of a round
the caches hold K/V for the prompt and every emitted token EXCEPT the
last, which is ``cur`` (at position ``pos``). Rejected rows go stale and
are overwritten when the cursor re-crosses them; position masking hides
them. The port writes caches in place, so nothing returns a cache.

Draws (the port's sampler, ``models/decode.py``): the first token is the
plain draw at position T from the row's key; then three streams, each
the row's key folded with its own tag (``decode.SPEC_STREAMS``): the
draft's proposal for position t, the accept uniform at t and the residual
draw at t. Every position's token is decided by the same rule from its
own draws, so it depends only on the row's key, its prefix and t — not
on where a round started or ended. :func:`speculative_generate_batched`
(either impl), the serving engine's draft-assisted rows and a
preempted-then-resumed row therefore give equal tokens, and on a card
two of them can part only at a decision within rounding of its edge.
JAX splits one engine key a round instead: its draws depend on batching,
so the two packages agree in law, not in draws. Greedy rounds run no
noise op.

Entry points: :func:`speculative_generate` (batch 1, linear caches:
kernel 5 for the draft steps on a card, the linear ``extend_step`` for
the target), :func:`speculative_generate_batched` (``impl="ragged"``:
per-row progress on the paged caches through :func:`paged_round`, the
draft's steps on kernel 6; ``impl="vmap"``: a loop of
:func:`speculative_generate` over the rows, the name kept so callers
port unchanged) and :func:`paged_round`, the one round body the engine
(``models/serving.py``) shares. Inside :func:`paged_round` nothing is
read back to the host.

``mesh=`` (a ``{axis: size}`` dict; its ``tp`` axis, as decode's) is
tp-sharded serving: both models' params as their tp shards (once a
call), both caches kv-head-sharded where tp divides their kv_heads; the
prefills take kernel 1 on each rank's head block, the draft's steps the
decode kernels through the table (5 on the linear cache, 6/6q paged), and
the verify extend runs on the tp shards (``decode.extend_step`` /
``paged_extend_step`` with ``mesh=``). ``impl="vmap"`` refuses a mesh, as
JAX's does.
"""

from __future__ import annotations

import torch

from hpc_patterns_tpu_torch.models.decode import (
    SPEC_STREAMS,
    _as_keys,
    _serving_params,
    _pick,
    _topk_mask,
    decode_step,
    extend_step,
    fold_keys,
    gumbel_noise,
    init_paged_cache,
    paged_decode_step,
    paged_extend_step,
    paged_prefill,
    prefill,
    uniform_noise,
)
from hpc_patterns_tpu_torch.models.transformer import TransformerConfig
from hpc_patterns_tpu_torch.topology import resolve_device


def _warp(logits, temperature, top_k: int):
    """The warped next-token law ``decode._pick`` samples: the top-k
    support, then the temperature softmax. (..., V) f32; ``temperature``
    a float or a tensor that broadcasts against ``logits``."""
    return torch.softmax(_topk_mask(logits.float(), top_k) / temperature,
                         dim=-1)


def spec_streams(keys) -> dict:
    """The speculative streams' (B, 2) key lanes of rows keyed by ``keys``
    (``decode.fold_keys`` with each tag of ``SPEC_STREAMS``) — per-row
    constants, folded once a dispatch."""
    return {name: fold_keys(keys, tag) for name, tag in SPEC_STREAMS.items()}


def _accept_resample(streams, pos, props, q_probs, p_probs):
    """The speculative-sampling verify rule over B rows (one round).

    ``props`` (B, gamma + 1) proposals, proposal j the token at position
    ``pos + j`` (``pos`` (B,)); ``q_probs`` and ``p_probs`` (B, gamma +
    1, V) the draft's and the target's warped laws there. Proposal j is
    accepted when ``u_j q_j(x_j) < min(q_j(x_j), p_j(x_j))``, ``u_j`` the
    accept stream's uniform at its position; the first rejection is
    replaced by the residual stream's draw from norm(max(p_j - q_j, 0))
    (p_j when that is empty). The last proposal is the bonus position:
    reached only when the first gamma are accepted, it is decided by the
    same rule as the others (its law is p_gamma, as a direct draw's), so
    a position's token never depends on where a round ended. Returns
    ``(a, nxt, parts)``: the accepted count among the first gamma (B,)
    int32, the closing token (B,) int32 at index ``a`` — the last
    proposal when every one was accepted, else the residual draw — and
    the rule's intermediates (a tie-aware oracle reads them to size a
    decision's margin; nothing in the round does)."""
    B, n = props.shape
    gamma = n - 1
    at = pos.long()[None, :] + torch.arange(n, device=pos.device)[:, None]
    u = uniform_noise(streams["accept"], at, 1)[..., 0].T  # (B, n)
    idx = props.long()[..., None]
    p_at = p_probs.gather(2, idx)[..., 0]
    q_at = q_probs.gather(2, idx)[..., 0]
    accept = u * q_at < torch.minimum(q_at, p_at)
    run = accept.to(torch.int32).cumprod(dim=1).sum(dim=1, dtype=torch.int32)
    a = run.clamp(max=gamma)
    V = p_probs.shape[-1]
    ai = a.long()[:, None, None].expand(B, 1, V)
    p_a, q_a = p_probs.gather(1, ai)[:, 0], q_probs.gather(1, ai)[:, 0]
    res = torch.clamp(p_a - q_a, min=0.0)
    res_sum = res.sum(dim=-1, keepdim=True)
    # p == q exactly leaves an empty residual; the limit law is p itself
    dist = torch.where(res_sum > 1e-12, res / res_sum, p_a)
    noise = gumbel_noise(streams["residual"], pos.long() + a, V)
    scores = torch.log(dist + 1e-30) + noise
    nxt = torch.where(run == n, props[:, gamma],
                      torch.argmax(scores, dim=-1).to(torch.int32))
    return a, nxt, {"u": u, "p_at": p_at, "q_at": q_at, "scores": scores,
                    "res": res, "p_a": p_a, "q_a": q_a, "noise": noise,
                    "all_accepted": run == n}


def _round(step, extend, vocab: int, pos, cur, gamma: int, streams,
           greedy: bool, top_k: int, temperature):
    """One draft/verify round, the body both cache layouts share: ``step(
    j, tok) -> draft logits`` (B, vocab) for the draft's step j (position
    ``pos + j``), ``extend(chunk) -> target logits`` (B, gamma + 1,
    vocab).
    ``pos`` (B,) the rows' cursors; ``temperature`` a float or (B,).
    Returns ``(a, emit)``: accepted-prefix lengths (B,) int32 and the
    round's tokens (B, gamma + 1) int32, positions past ``a`` filler."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=pos.device)
    t_draft = t[:, None] if t.ndim else t
    t_verify = t[:, None, None] if t.ndim else t
    # greedy picks gamma proposals (the extra step only writes the last
    # one's K/V); sampled rounds also pick at the bonus position, decided
    # like the others (_accept_resample)
    n_pick = gamma if greedy else gamma + 1
    if not greedy:
        # the draft's noise for the round in one pass: proposal j is the
        # token at position pos + 1 + j
        steps = torch.arange(1, n_pick + 1, device=pos.device)[:, None]
        g_draft = gumbel_noise(streams["draft"], pos[None].long() + steps,
                               vocab)
    props, qs = [], []
    tok = cur
    for j in range(gamma + 1):
        dlogits = step(j, tok)
        if j == n_pick:
            break
        if greedy:
            tok = _pick(dlogits)
        else:
            masked = _topk_mask(dlogits.float(), top_k) / t_draft
            tok = torch.argmax(masked + g_draft[j], dim=-1).to(torch.int32)
            qs.append(torch.softmax(masked, dim=-1))
        props.append(tok)
    props = torch.stack(props, dim=1)  # (B, n_pick)
    vlogits = extend(torch.cat([cur[:, None], props[:, :gamma]], dim=1))
    k = torch.arange(gamma + 1, device=pos.device)[None, :]
    if greedy:
        t_all = torch.argmax(vlogits, dim=-1).to(torch.int32)
        matches = (props == t_all[:, :gamma]).to(torch.int32)
        a = matches.cumprod(dim=1).sum(dim=1, dtype=torch.int32)
        nxt = t_all.gather(1, a.long()[:, None])[:, 0]
        emit = torch.where(k < a[:, None],
                           torch.cat([props, props[:, -1:]], dim=1),
                           nxt[:, None])
    else:
        a, nxt, _ = _accept_resample(streams, pos + 1, props,
                                     torch.stack(qs, 1),
                                     _warp(vlogits, t_verify, top_k))
        emit = torch.where(k < a[:, None], props, nxt[:, None])
    return a, emit


def paged_round(params, cfg: TransformerConfig, draft_params,
                draft_cfg: TransformerConfig, cache, dcache, pos_eff, cur,
                gamma: int, streams, greedy: bool, top_k: int, temperature,
                mesh=None):
    """ONE batched draft/verify round on the ragged paged caches — the
    round body :func:`speculative_generate_batched` (``impl="ragged"``)
    and the serving engine's draft-assisted chunks share (JAX
    ``speculative.py:252-315``): ``gamma + 1`` ragged draft steps
    (``paged_decode_step``, kernel 6 on a card) from each row's cursor
    ``pos_eff`` (B,) int32, then one :func:`~hpc_patterns_tpu_torch.
    models.decode.paged_extend_step` of ``[cur, proposals]``, then the
    acceptance. ``streams``: :func:`spec_streams` of the rows' keys (None
    when greedy); ``temperature`` a float or per-row (B,). ``mesh``:
    tp-sharded rounds on caches made for it (module docstring). Both
    caches are written in place; nothing is read back to the host.
    Returns what :func:`_round` returns."""

    def step(j, tok):
        return paged_decode_step(draft_params, dcache, pos_eff + j, tok,
                                 draft_cfg, mesh=mesh)

    return _round(step,
                  lambda chunk: paged_extend_step(params, cache, pos_eff,
                                                  chunk, cfg, mesh=mesh),
                  cfg.vocab, pos_eff, cur, gamma, streams, greedy, top_k,
                  temperature)


def _validate(cfg: TransformerConfig, draft_cfg: TransformerConfig,
              prompt_len: int, new_tokens: int, gamma: int) -> None:
    """The argument guards both entry points share (JAX's)."""
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab} != target vocab {cfg.vocab}")
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if prompt_len + new_tokens + gamma + 1 > min(cfg.max_seq,
                                                 draft_cfg.max_seq):
        raise ValueError(
            f"prompt {prompt_len} + new {new_tokens} + gamma slack "
            f"{gamma + 1} exceeds max_seq "
            f"{min(cfg.max_seq, draft_cfg.max_seq)}")


def _sampling_args(cfg: TransformerConfig, temperature: float, top_k: int,
                   key, batch: int, device):
    """The sampling guards (JAX's ``_sampling_args``): ``(keys (B, 2) or
    None, greedy, top_k, temperature)`` — ``key`` (2,) uint32 for every
    row, or (B, 2)."""
    if temperature > 0.0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    if not 0 <= top_k <= cfg.vocab:
        raise ValueError(f"top_k {top_k} outside [0, vocab]")
    greedy = temperature <= 0.0
    keys = None if greedy else _as_keys(key, batch, device)
    return keys, greedy, int(top_k), max(float(temperature), 1e-6)


def _first_pick(logits, keys, T: int, greedy: bool, top_k: int,
                temperature: float):
    """The first token (position ``T``) from the prefill logits: the
    plain draw of the row's key, as ``paged_generate``'s first pick."""
    if greedy:
        return _pick(logits)
    return _pick(logits, temperature, top_k, keys, T)


def _sharded(params, cfg, draft_params, draft_cfg, mesh):
    """Both models' params as the steps take them on ``mesh`` (their tp
    shards, once a call) and the checked mesh."""
    params, mesh_t = _serving_params(params, cfg, mesh)
    draft_params, _ = _serving_params(draft_params, draft_cfg, mesh)
    return params, draft_params, mesh_t


def _linear_generate(params, cfg, draft_params, draft_cfg, prompt,
                     new_tokens: int, gamma: int, keys, greedy: bool,
                     top_k: int, temperature: float, mesh=None):
    """One row (prompt (1, T)) over linear caches: the batch-1 loop. The
    draft's ``decode_step`` takes a host position, so a round ends with
    one readback of ``a``."""
    T = prompt.shape[1]
    max_len = T + new_tokens + gamma + 1  # slack for the final round
    logits, cache = prefill(params, prompt, cfg, max_len, mesh=mesh)
    _, dcache = prefill(draft_params, prompt, draft_cfg, max_len,
                        mesh=mesh)
    first = _first_pick(logits, keys, T, greedy, top_k, temperature)
    streams = None if greedy else spec_streams(keys)
    toks = [first[:, None]]
    n_out, pos, cur = 1, T, first
    while n_out < new_tokens:
        p = pos  # the round's host cursor

        def step(j, tok):
            return decode_step(draft_params, dcache, p + j, tok, draft_cfg,
                               mesh=mesh)

        a, emit = _round(
            step, lambda chunk: extend_step(params, cache, p, chunk, cfg,
                                            mesh=mesh),
            cfg.vocab, torch.full((1,), p, dtype=torch.int32,
                                  device=prompt.device),
            cur, gamma, streams, greedy, top_k, temperature)
        a = int(a[0])
        toks.append(emit[:, :a + 1])
        cur = emit[:, a]
        pos += a + 1
        n_out += a + 1
    return torch.cat(toks, dim=1)[:, :new_tokens]


def speculative_generate(params, cfg: TransformerConfig, draft_params,
                         draft_cfg: TransformerConfig, prompt,
                         new_tokens: int, *, gamma: int = 4, key=None,
                         temperature: float = 0.0, top_k: int = 0,
                         mesh=None, device=None):
    """Continuation (1, new_tokens) int32 of ``prompt`` (1, T). Greedy by
    default — token-identical to ``greedy_generate(params, prompt, cfg,
    new_tokens)``: the draft changes how fast tokens come, never which.
    With ``temperature > 0`` (``key`` (2,) uint32 required) the output is
    distributed as target-only sampling at that temperature and top-k
    (the same law, not the same draws). ``gamma``: proposals a round.
    Both configs share the vocabulary; compute-dtype caches (the linear
    ``extend_step``). ``mesh``: tp-sharded serving (module docstring).
    ``device``: default ``cuda``; params and prompt must live there."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(dev)
    if prompt.shape[0] != 1:
        raise ValueError(
            "speculative decoding is per-sequence (batch 1): acceptance "
            "lengths diverge per row; use speculative_generate_batched")
    _validate(cfg, draft_cfg, prompt.shape[1], new_tokens, gamma)
    keys, greedy, top_k, temperature = _sampling_args(
        cfg, temperature, top_k, key, 1, dev)
    params, draft_params, mesh = _sharded(params, cfg, draft_params,
                                          draft_cfg, mesh)
    return _linear_generate(params, cfg, draft_params, draft_cfg, prompt,
                            new_tokens, gamma, keys, greedy, top_k,
                            temperature, mesh)


def _ragged_generate(params, cfg, draft_params, draft_cfg, prompts,
                     new_tokens: int, gamma: int, keys, greedy: bool,
                     top_k: int, temperature: float, mesh=None):
    """Per-row progress on the paged caches (JAX ``speculative.py:318-
    383``): one batched :func:`paged_round` an iteration at each row's own
    cursor. A row that has its ``new_tokens`` freezes: its cursor stops,
    it steps at position 0 (its garbage lands in its own first page) and
    its output slots are rewritten with their own values. The loop reads
    back one flag a round (whether any row is still active)."""
    B, T = prompts.shape
    dev = prompts.device
    max_len = T + new_tokens + gamma + 1
    page = 128 if max_len > 128 else 16
    pages = -(-max_len // page)
    cache = init_paged_cache(cfg, B, pages, page, device=dev, mesh=mesh)
    dcache = init_paged_cache(draft_cfg, B, pages, page, device=dev,
                              mesh=mesh)
    logits, _ = paged_prefill(params, prompts, cfg, cache, page, mesh=mesh)
    paged_prefill(draft_params, prompts, draft_cfg, dcache, page, mesh=mesh)
    first = _first_pick(logits, keys, T, greedy, top_k, temperature)
    streams = None if greedy else spec_streams(keys)
    width = new_tokens + gamma + 1
    out = torch.zeros((B, width), dtype=torch.int32, device=dev)
    out[:, 0] = first
    pos = torch.full((B,), T, dtype=torch.int32, device=dev)
    n_out = torch.ones((B,), dtype=torch.int32, device=dev)
    cur = first
    ks = torch.arange(gamma + 1, device=dev)[None, :]
    while True:
        active = n_out < new_tokens
        if not bool(active.any()):
            break
        pos_eff = torch.where(active, pos, 0)
        a, emit = paged_round(params, cfg, draft_params, draft_cfg, cache,
                              dcache, pos_eff, cur, gamma, streams, greedy,
                              top_k, temperature, mesh=mesh)
        nxt = emit.gather(1, a.long()[:, None])[:, 0]
        # emitted this round: props[:a], then nxt; frozen rows rewrite
        # their own slots (gather, where, scatter)
        idx = (n_out.long()[:, None] + ks).clamp(max=width - 1)
        out.scatter_(1, idx, torch.where(active[:, None], emit,
                                         out.gather(1, idx)))
        adv = torch.where(active, a + 1, 0)
        pos = pos + adv
        cur = torch.where(active, nxt, cur)
        n_out = n_out + adv
    return out[:, :new_tokens]


def speculative_generate_batched(params, cfg: TransformerConfig,
                                 draft_params,
                                 draft_cfg: TransformerConfig, prompts,
                                 new_tokens: int, *, gamma: int = 4,
                                 key=None, temperature: float = 0.0,
                                 top_k: int = 0, impl: str = "ragged",
                                 mesh=None, device=None):
    """Batched speculative decoding, (B, new_tokens) int32.

    ``impl="ragged"`` (default): per-row progress on the paged caches —
    one batched :func:`paged_round` an iteration, each row advancing at
    its own acceptance (kernel 6 for the draft on a card, int8/fp8 pools
    compose). ``impl="vmap"``: :func:`speculative_generate` a row at a
    time over linear caches (JAX lifts those loops with ``vmap``; the
    name is kept). Greedy rows are token-identical to the target's greedy
    decode; sampled rows (``key`` (2,) uint32 for every row, or (B, 2))
    draw only from their own key and positions, so the two impls and the
    serving engine give the same tokens for a row and key. The call
    returns when the slowest row finishes. ``mesh``: tp-sharded serving on
    the ragged route (module docstring); ``impl="vmap"`` refuses it, as
    JAX's does. ``device``: default ``cuda``."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts).to(dev)
    if prompts.ndim != 2:
        raise ValueError(
            f"prompts must be (B, T), got {tuple(prompts.shape)}")
    _validate(cfg, draft_cfg, prompts.shape[1], new_tokens, gamma)
    B = prompts.shape[0]
    keys, greedy, top_k, temperature = _sampling_args(
        cfg, temperature, top_k, key, B, dev)
    args = (gamma, keys, greedy, top_k, temperature)
    if impl == "ragged":
        params, draft_params, mesh = _sharded(params, cfg, draft_params,
                                              draft_cfg, mesh)
        return _ragged_generate(params, cfg, draft_params, draft_cfg,
                                prompts, new_tokens, *args, mesh=mesh)
    if impl != "vmap":
        raise ValueError(f"impl must be 'ragged' or 'vmap', got {impl!r}")
    if mesh is not None:
        raise ValueError(
            "impl='vmap' is single-device (vmap over the shard_map "
            "route is unsupported); use impl='ragged' with a mesh")
    rows = [_linear_generate(params, cfg, draft_params, draft_cfg,
                             prompts[b:b + 1], new_tokens, gamma,
                             None if keys is None else keys[b:b + 1],
                             greedy, top_k, temperature)
            for b in range(B)]
    return torch.cat(rows)
