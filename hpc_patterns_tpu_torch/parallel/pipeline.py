"""Pipeline parallelism: microbatch schedules over the pt2pt ring — the
counterpart of ``hpc_patterns_tpu/parallel/pipeline.py``, on logical
ranks of one device.

The reference's pairwise Send/Recv between ring neighbours is the core of
PP: a stage boundary is one neighbour handoff a tick, here
``comm.ring.ring_shift`` over the rank-stacked ``(P, ...)`` buffer, as in
JAX. Two schedules:

- :func:`pipeline_forward`: GPipe fill-drain. Rank r runs stage r;
  microbatch m enters at tick m, reaches stage r at tick m + r, and
  leaves after M + P - 1 ticks.
- :func:`pipeline_train_1f1b`: the 1F1B training schedule
  (:func:`schedule_1f1b`). Each stage runs its warm-up forwards, then
  alternates one forward and one backward, so stage r never holds more
  than min(P - r, M) stashed microbatches: the input stash and both
  mailboxes have min(P, M) ring-indexed slots a rank, not M. The
  backward recomputes the stage's forward on the stashed input under
  ``torch.enable_grad()`` and pulls the cotangent through it with
  ``torch.autograd.grad`` (the kernels' autograd functions carry it on
  the card), the standard PP memory/FLOPs trade.

JAX's SPMD body computes every rank every tick and masks the bubble
ticks' results away. One process runs only the (stage, microbatch) pairs
the tick table assigns to a tick: the masked results were discarded, so
the values are the same. The tags JAX shifts beside each payload (the
microbatch index and its validity) are static here: they come from the
same table on the host.

Stage parameters are a sequence of P per-stage trees (a tensor, or nested
dicts of tensors): rank r's stage r. The gradients come back the same
way, f32.
"""

from __future__ import annotations

from typing import Callable

import torch

from hpc_patterns_tpu_torch.comm import ring


def _leaves(tree) -> list:
    """The tensors of a tree in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure over ``leaves`` (in :func:`_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def _grad_leaves(tree):
    """(tree of detached leaves requiring grad, their list): the stage's
    differentiable inputs, sharing storage with ``tree``'s tensors."""
    leaves = [t.detach().requires_grad_(t.is_floating_point())
              for t in _leaves(tree)]
    return _unflatten(tree, leaves), leaves


def pipeline_forward(stage_fn: Callable, stage_params, x_microbatches):
    """``stage_fn(stage_params[r], x)`` as a P-stage fill-drain pipeline.

    ``stage_params``: P per-stage params (stage r on rank r);
    ``x_microbatches`` (M, ...): the entry rank's input. The stage must
    preserve the microbatch's shape and dtype (the handoff buffer is
    reused every tick). Returns the rank-stacked (P, M, ...) outputs,
    valid on the last rank and zero elsewhere (JAX's per-rank outputs
    under ``out_specs=P(axis)``)."""
    P, M = len(stage_params), x_microbatches.shape[0]
    mb_shape, dt = x_microbatches.shape[1:], x_microbatches.dtype
    outs = torch.zeros((P, M, *mb_shape), dtype=dt,
                       device=x_microbatches.device)
    buf = torch.zeros((P, *mb_shape), dtype=dt, device=x_microbatches.device)
    with torch.no_grad():
        for tick in range(M + P - 1):
            send = torch.zeros_like(buf)
            for r in range(P):
                m = tick - r
                if not 0 <= m < M:
                    continue  # a bubble tick: JAX masks its result away
                cur = x_microbatches[m] if r == 0 else buf[r]
                y = stage_fn(stage_params[r], cur)
                if not torch.is_tensor(y):
                    raise ValueError(
                        "stage_fn must return a single activation tensor; "
                        "aux-returning (MoE) stages are only supported by "
                        "pipeline_train_1f1b, which threads the aux through "
                        "the backward")
                if y.shape != mb_shape or y.dtype != dt:
                    raise ValueError(
                        f"stage_fn must preserve microbatch shape/dtype: "
                        f"{tuple(mb_shape)}/{dt} -> {tuple(y.shape)}/"
                        f"{y.dtype}")
                if r == P - 1:
                    outs[r, m] = y
                send[r] = y
            # the neighbour handoff; the last stage's wrap to rank 0 is
            # overwritten by its injection, as in JAX
            buf = ring.ring_shift(send, 1)
    return outs


def schedule_1f1b(P: int, M: int):
    """The 1F1B tick table (pure Python, JAX's). Returns ``(fwd, bwd)``
    dicts mapping ``(stage, microbatch) -> tick``: forward ``m + r`` for
    the first ``P - r`` microbatches (warm-up), then ``2m + r``; backward
    ``2P - 1 - r + 2m``. Per stage no two ops share a tick, an activation
    is produced a tick or more before its consumer needs it, and stage r
    holds at most ``min(P - r, M)`` stashed activations."""
    fwd = {}
    bwd = {}
    for r in range(P):
        for m in range(M):
            fwd[(r, m)] = m + r if m <= P - 1 - r else 2 * m + r
            bwd[(r, m)] = 2 * P - 1 - r + 2 * m
    return fwd, bwd


class _Slots:
    """One rank's ring-indexed slots (``m % S``) with the microbatch each
    holds: banking over a slot still in use raises (the 1F1B bound
    broken), so the memory bound is checked, not assumed."""

    def __init__(self, S: int):
        self.S = S
        self.held: dict[int, int] = {}

    def bank(self, m: int) -> int:
        slot = m % self.S
        if slot in self.held:
            raise RuntimeError(
                f"1F1B slot {slot} still holds microbatch "
                f"{self.held[slot]} when microbatch {m} arrives")
        self.held[slot] = m
        return slot

    def take(self, m: int) -> int:
        slot = m % self.S
        if self.held.get(slot) != m:
            raise RuntimeError(f"microbatch {m} is not in slot {slot}")
        del self.held[slot]
        return slot


def pipeline_train_1f1b(stage_fn: Callable, stage_params, x_microbatches,
                        targets, loss_fn: Callable, *, loss_params=None,
                        return_input_grads: bool = False,
                        stage_aux_weight: float | None = None,
                        stats: dict | None = None):
    """One 1F1B training pass over the P stages ``stage_params`` (module
    docstring): every microbatch forward through the stages, each
    backward seeded with d(loss)/dy on the last stage, the stage
    gradients accumulated.

    ``stage_fn(params, x) -> y`` preserves the microbatch's shape;
    ``loss_fn(y, target) -> scalar`` (``loss_fn(loss_params, y, target)``
    with ``loss_params``) runs per microbatch on the last stage on ``y``
    in f32. ``x_microbatches`` (M, ...) enter at stage 0; ``targets``
    (M, ...) are read at stage P - 1. Returns ``(mean_loss, grads)``:
    ``mean_loss`` the rank-stacked (P,) f32 loss, valid on the last rank
    and zero elsewhere (JAX's), and ``grads`` P per-stage trees of f32
    gradients summed over the microbatches.

    ``loss_params``: the last stage's loss head, differentiated too;
    ``return_input_grads``: d(loss)/d(x_m) as (M, ...) f32;
    ``stage_aux_weight``: ``stage_fn`` returns ``(y, aux)``, aux a scalar
    auxiliary loss a microbatch whose sum over each rank's forwards lands
    in ``extras["aux_sum"]`` ((P,) f32, unweighted), and each backward
    seeds the aux output's cotangent with the weight. With any of these
    the return is ``(mean_loss, grads, extras)`` with the requested keys
    of ``{"loss_grads", "input_grads", "aux_sum"}``. JAX returns the
    loss head's gradients and the input gradients on every rank, zero off
    the one rank that produces them; here they are that rank's: the last
    stage's tree and the first stage's (M, ...) tensor.

    ``stats``: a dict that receives ``"peak_stash"``, the most
    microbatches each stage held stashed at once (at most
    ``min(P - r, M)``), and ``"ticks"``."""
    P, M = len(stage_params), x_microbatches.shape[0]
    mb_shape, dt = x_microbatches.shape[1:], x_microbatches.dtype
    dev = x_microbatches.device
    S = min(P, M)  # the 1F1B in-flight bound
    f32 = torch.float32
    has_aux = stage_aux_weight is not None
    fwd, bwd = schedule_1f1b(P, M)
    n_ticks = 2 * M + 2 * P - 2
    at: dict[int, list] = {t: [] for t in range(n_ticks)}
    for (r, m), t in fwd.items():
        at[t].append((r, m, "f"))
    for (r, m), t in bwd.items():
        at[t].append((r, m, "b"))

    stages = [_grad_leaves(p) for p in stage_params]
    grads = [[torch.zeros(p.shape, dtype=f32, device=p.device) for p in lv]
             for _, lv in stages]
    if loss_params is not None:
        head, head_leaves = _grad_leaves(loss_params)
        head_grads = [torch.zeros(p.shape, dtype=f32, device=p.device)
                      for p in head_leaves]
    in_grads = (torch.zeros((M, *mb_shape), dtype=f32, device=dev)
                if return_input_grads else None)
    in_stash = torch.zeros((P, S, *mb_shape), dtype=dt, device=dev)
    fwd_mail = torch.zeros((P, S, *mb_shape), dtype=dt, device=dev)
    bwd_mail = torch.zeros((P, S, *mb_shape), dtype=f32, device=dev)
    stash = [_Slots(S) for _ in range(P)]
    fmail = [_Slots(S) for _ in range(P)]
    bmail = [_Slots(S) for _ in range(P)]
    peak = [0] * P
    loss_sum = torch.zeros((), dtype=f32, device=dev)
    aux_sum = torch.zeros((P,), dtype=f32, device=dev)

    def eval_stage(params, x):
        if has_aux:
            y, aux = stage_fn(params, x)
            return y, aux.float()
        return stage_fn(params, x), None

    for t in range(n_ticks):
        y_send = dx_send = None
        f_recv, b_recv = {}, {}
        for r, m, kind in at[t]:
            params = stages[r][0]
            if kind == "f":
                with torch.no_grad():
                    x = (x_microbatches[m] if r == 0
                         else fwd_mail[r, fmail[r].take(m)])
                    in_stash[r, stash[r].bank(m)] = x
                    y, aux = eval_stage(params, x)
                peak[r] = max(peak[r], len(stash[r].held))
                if has_aux:
                    aux_sum[r] += aux
                if r < P - 1:
                    if y_send is None:
                        y_send = torch.zeros((P, *mb_shape), dtype=dt,
                                             device=dev)
                    y_send[r] = y
                    f_recv[r + 1] = m
                continue
            # the backward: recompute the stage on the stashed input
            last = r == P - 1
            want_dx = r > 0 or return_input_grads
            x = in_stash[r, stash[r].take(m)].detach().requires_grad_(
                want_dx)
            inputs = list(stages[r][1]) + ([x] if want_dx else [])
            if last and loss_params is not None:
                inputs += head_leaves
            with torch.enable_grad():
                y, aux = eval_stage(params, x)
                if last:
                    yf = y.float()
                    loss_m = (loss_fn(yf, targets[m]) if loss_params is None
                              else loss_fn(head, yf, targets[m]))
                    total = loss_m if aux is None \
                        else loss_m + stage_aux_weight * aux
                    outs, seeds = [total], None
                    loss_sum += loss_m.detach()
                else:
                    outs = [y]
                    seeds = [bwd_mail[r, bmail[r].take(m)].to(y.dtype)]
                    if aux is not None:
                        outs.append(aux)
                        seeds.append(torch.full_like(aux, stage_aux_weight))
                got = torch.autograd.grad(outs, inputs, grad_outputs=seeds,
                                          allow_unused=True)
            n = len(stages[r][1])
            for acc, g in zip(grads[r], got[:n]):
                if g is not None:
                    acc += g.float()
            if last and loss_params is not None:
                for acc, g in zip(head_grads, got[n + want_dx:]):
                    if g is not None:
                        acc += g.float()
            if want_dx:
                dx = got[n]
                if r == 0:
                    in_grads[m] = dx.float()
                else:
                    if dx_send is None:
                        dx_send = torch.zeros((P, *mb_shape), dtype=f32,
                                              device=dev)
                    dx_send[r] = dx.float()
                    b_recv[r - 1] = m
        # the tick's handoffs: activations one stage on, cotangents one
        # stage back (the ring's wrap lands on a rank that reads nothing)
        if f_recv:
            y_recv = ring.ring_shift(y_send, 1)
            for r, m in f_recv.items():
                fwd_mail[r, fmail[r].bank(m)] = y_recv[r]
        if b_recv:
            dx_recv = ring.ring_shift(dx_send, -1)
            for r, m in b_recv.items():
                bwd_mail[r, bmail[r].bank(m)] = dx_recv[r]

    if stats is not None:
        stats["peak_stash"] = peak
        stats["ticks"] = n_ticks
    mean_loss = torch.zeros((P,), dtype=f32, device=dev)
    mean_loss[P - 1] = loss_sum / M
    grads = [_unflatten(stage_params[r], grads[r]) for r in range(P)]
    extras = {}
    if loss_params is not None:
        extras["loss_grads"] = _unflatten(loss_params, head_grads)
    if return_input_grads:
        extras["input_grads"] = in_grads
    if has_aux:
        extras["aux_sum"] = aux_sum
    if extras:
        return mean_loss, grads, extras
    return mean_loss, grads
