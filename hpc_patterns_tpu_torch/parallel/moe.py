"""Mixture-of-experts with expert parallelism over logical ranks — the
counterpart of ``hpc_patterns_tpu/parallel/moe.py``.

Tokens are routed top-k (k = 1 is Switch; k > 1 renormalizes the k gates,
GShard style) into fixed ``capacity`` slots per expert, the experts' FFNs
run as one batched product, and the results are combined with the gates.
Slots are assigned in token order, choice-major: every token's first
choice claims its slot before any second choice competes, so raising k
never evicts a first choice. Tokens past an expert's capacity are dropped
(their contribution is zero).

Two dispatch forms with the same assignments: ``"einsum"`` (one-hot
(N, E, C) tensors, the oracle form) and ``"scatter"`` (a stable sort of
the choice-major expert ids, O(N·D + E·C·D)). :func:`moe_ep` runs the
rank-stacked form of JAX's ``shard_map`` body: ``(ranks, N_local, D)``
tokens and ``(ranks, E/ranks, ...)`` expert shards, the two all-to-alls
over the rank dim. None of this is a kernel in JAX either: routing is
gathers and scatters, the experts a batched matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpc_patterns_tpu_torch.comm import collectives

DISPATCHES = ("einsum", "scatter")


def _gates(x, router_w):
    """(N, E) f32 softmax gates: the routing math stays f32."""
    return torch.softmax(x.float() @ router_w.float(), dim=-1)


def _aux(gates, first_choice, n_experts: int):
    """Switch load-balancing loss E * sum_e f_e * P_e, f the FIRST-choice
    routing fraction."""
    first_frac = F.one_hot(first_choice, n_experts).float().mean(0)
    return n_experts * torch.sum(first_frac * gates.mean(0))


def _dispatch_combine(x, router_w, n_experts: int, capacity: int,
                      top_k: int = 1):
    """Top-k routing tensors for tokens x (N, D): (dispatch (N, E, C) f32
    0/1, combine (N, E, C) f32 gates, aux scalar, kept_frac scalar — the
    fraction of (token, choice) assignments that got a slot)."""
    n = x.shape[0]
    gates = _gates(x, router_w)
    if top_k == 1:
        expert = gates.argmax(-1)
        onehot = F.one_hot(expert, n_experts).float()
        # each token's slot within its expert (token order); -1 elsewhere
        position = torch.cumsum(onehot, 0) * onehot - 1.0
        kept = onehot * (position < capacity)
        slot = F.one_hot(position.clamp(0, capacity - 1).long(),
                         capacity).float()
        dispatch = kept[..., None] * slot
        combine = dispatch * (gates * onehot).sum(-1)[:, None, None]
        first = expert
        kept_frac = kept.sum() / n
    else:
        vals, idx = torch.topk(gates, top_k)
        norm = vals / vals.sum(-1, keepdim=True)
        oh = F.one_hot(idx, n_experts).float()  # (N, k, E)
        flat = oh.transpose(0, 1).reshape(top_k * n, n_experts)
        position = torch.cumsum(flat, 0) * flat - 1.0
        kept = flat * (position < capacity)
        slot = F.one_hot(position.clamp(0, capacity - 1).long(),
                         capacity).float()
        disp_choice = (kept[..., None] * slot).reshape(
            top_k, n, n_experts, capacity)
        dispatch = disp_choice.sum(0)  # a token's choices are distinct
        combine = torch.einsum("knec,nk->nec", disp_choice, norm)
        first = idx[:, 0]
        kept_frac = kept.sum() / (top_k * n)
    return dispatch, combine, _aux(gates, first, n_experts), kept_frac


def _token_sum(rows, pos):
    """``y[t] = 0 + rows[pos[t, 0]] + rows[pos[t, 1]] + ...``: each token's
    k rows of the sorted array summed from zero in ``pos``'s column order
    — a fixed order, where an ``index_add`` adds with float atomics on a
    card (no fixed order once a token has three terms)."""
    y = rows.new_zeros((pos.shape[0], rows.shape[1]))
    for j in range(pos.shape[1]):
        y = y + rows.index_select(0, pos[:, j])
    return y


class _GatherRows(torch.autograd.Function):
    """``x.index_select(0, src)`` whose backward sums each token's k row
    gradients with :func:`_token_sum` (``pos``: every token's positions
    in ``src``), not with ``index_add``."""

    @staticmethod
    def forward(ctx, x, src, pos):
        ctx.save_for_backward(pos)
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return _token_sum(g, pos), None, None


class _CombineRows(torch.autograd.Function):
    """:func:`_token_sum` with its backward as copies: every row of the
    sorted array belongs to one token, so its gradient is that token's."""

    @staticmethod
    def forward(ctx, rows, pos):
        ctx.save_for_backward(pos)
        ctx.n_rows = rows.shape[0]
        return _token_sum(rows, pos)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        grad = g.new_empty((ctx.n_rows, g.shape[1]))
        for j in range(pos.shape[1]):
            grad[pos[:, j]] = g
        return grad, None


def _scatter_dispatch(x, gates, n_experts: int, capacity: int, top_k: int):
    """Sort/scatter routing with the einsum form's assignments: a STABLE
    sort of the choice-major expert ids gives each (token, choice) the
    within-expert rank the cumsum computes. Returns (xin (E, C, D),
    combine(out) -> y (N, D), aux, kept_frac).

    Each token's k terms (its gathered input's gradients, its expert
    outputs) are summed in a fixed order: by their position in the sorted
    array, i.e. by expert id, the order in which XLA's CPU scatter-add
    applies JAX's ``.at[src_tok].add`` updates."""
    n, D = x.shape
    if top_k == 1:
        vals = gates.amax(-1, keepdim=True)
        idx = gates.argmax(-1, keepdim=True)
        gate_per_choice = vals
    else:
        vals, idx = torch.topk(gates, top_k)
        gate_per_choice = vals / vals.sum(-1, keepdim=True)
    k = idx.shape[1]
    dev = x.device
    # choice-major (all first choices before any second choice)
    expert_flat = idx.T.reshape(k * n)
    token_flat = torch.arange(n, device=dev).repeat(k)
    gate_flat = gate_per_choice.T.reshape(k * n)
    order = torch.argsort(expert_flat, stable=True)
    sorted_e = expert_flat[order]
    start = torch.searchsorted(sorted_e,
                               torch.arange(n_experts, device=dev))
    rank = torch.arange(k * n, device=dev) - start[sorted_e]
    keep = rank < capacity
    kept_frac = keep.sum() / (k * n)
    # dropped entries scatter to a trash row past the real slots
    trash = n_experts * capacity
    slot = torch.where(keep, sorted_e * capacity + rank,
                       torch.full_like(rank, trash))
    src_tok = token_flat[order]
    # pos[t]: token t's k positions in the sorted array, ascending (its
    # choices are distinct experts, so ascending = by expert id)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(k * n, device=dev)
    pos = inv.view(k, n).T.sort(dim=1).values.contiguous()
    # a gather whose backward is a fixed-order sum, not x[idx]'s
    # sort-based accumulate (half the MoE step on a card) nor an index_add
    xin = x.new_zeros((trash + 1, D)).index_put(
        (slot,), _GatherRows.apply(x, src_tok, pos))
    xin = xin[:-1].reshape(n_experts, capacity, D)
    gate_sorted = gate_flat[order]

    def combine(out):
        out_flat = out.reshape(trash, -1)
        picked = torch.where(keep[:, None],
                             out_flat.index_select(0,
                                                   slot.clamp(max=trash - 1)),
                             torch.zeros((), dtype=out_flat.dtype,
                                         device=dev))
        return _CombineRows.apply(
            picked * gate_sorted[:, None].to(out_flat.dtype), pos)

    return xin, combine, _aux(gates, idx[:, 0], n_experts), kept_frac


def _route(x, router_w, n_experts: int, capacity: int, top_k: int,
           dispatch: str):
    """The routing front end of :func:`moe_dense` and :func:`moe_ep`:
    ``(xin (E, C, D), combine(out) -> y, aux, kept_frac)``."""
    if dispatch == "scatter":
        return _scatter_dispatch(x, _gates(x, router_w), n_experts,
                                 capacity, top_k)
    if dispatch == "einsum":
        disp, comb, aux, kept = _dispatch_combine(x, router_w, n_experts,
                                                  capacity, top_k)
        # routing math stays f32; dispatch and the FFN run in x's dtype
        xin = torch.einsum("nec,nd->ecd", disp.to(x.dtype), x)

        def combine_fn(out):
            return torch.einsum("nec,ecd->nd", comb.to(out.dtype), out)

        return xin, combine_fn, aux, kept
    raise ValueError(f"dispatch {dispatch!r} not in {DISPATCHES}")


def _expert_ffn(xin, w1, w2, activation=None):
    """Batched per-expert FFN: xin (E, C, D), w1 (E, D, F), w2 (E, F, D);
    tanh gelu by default, as ``jax.nn.gelu``."""
    act = activation or (lambda t: F.gelu(t, approximate="tanh"))
    h = act(torch.bmm(xin, w1.to(xin.dtype)))
    return torch.bmm(h, w2.to(xin.dtype))


def default_capacity(n_tokens: int, n_experts: int,
                     capacity_factor: float = 1.25) -> int:
    return max(1, int(n_tokens * capacity_factor / n_experts))


def moe_dense(x, router_w, w1, w2, *, capacity: int, activation=None,
              top_k: int = 1, with_stats: bool = False,
              dispatch: str = "einsum"):
    """All E experts local. x (N, D); router_w (D, E); w1 (E, D, F); w2
    (E, F, D). Returns (y (N, D) in x's dtype, aux), plus the kept
    fraction when ``with_stats`` (drop rate = 1 - kept)."""
    xin, combine_fn, aux, kept = _route(x, router_w, w1.shape[0], capacity,
                                        top_k, dispatch)
    y = combine_fn(_expert_ffn(xin, w1, w2, activation)).to(x.dtype)
    return (y, aux, kept) if with_stats else (y, aux)


def moe_ep(x, router_w, w1_local, w2_local, *, capacity: int,
           activation=None, top_k: int = 1, with_stats: bool = False,
           dispatch: str = "einsum"):
    """Expert-parallel MoE over logical ranks. ``x`` (P, N_local, D): rank
    r's tokens; ``w1_local``/``w2_local`` (P, E/P, D, F)/(P, E/P, F, D):
    rank r's expert shard; ``router_w`` (D, E) replicated. Each rank
    routes its own tokens; an all-to-all moves (E, C, D) slots to the
    experts' owners as (E/P, P·C, D), they run their experts, and a second
    all-to-all brings the results back. Returns (y (P, N_local, D), aux
    (P,)), plus kept (P,) with ``with_stats``: the ranks' mean on every
    rank (JAX's ``pmean``). Per token equal to :func:`moe_dense` on the
    same shard with the same capacity."""
    P, e_local = w1_local.shape[:2]
    E = e_local * P
    routes = [_route(x[r], router_w, E, capacity, top_k, dispatch)
              for r in range(P)]
    xin = torch.stack([r[0] for r in routes])  # (P, E, C, D)
    xin = collectives.all_to_all(xin, split_axis=0, concat_axis=1)
    # every rank's E/P experts over its P·C slots: one batched product
    out = _expert_ffn(xin.flatten(0, 1), w1_local.flatten(0, 1),
                      w2_local.flatten(0, 1), activation)
    out = out.unflatten(0, (P, e_local))
    out = collectives.all_to_all(out, split_axis=1, concat_axis=0)
    y = torch.stack([routes[r][1](out[r]) for r in range(P)]).to(x.dtype)
    aux = collectives.allreduce(torch.stack([r[2] for r in routes]), "mean")
    if with_stats:
        kept = collectives.allreduce(
            torch.stack([r[3].float() for r in routes]), "mean")
        return y, aux, kept
    return y, aux
