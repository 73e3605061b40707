"""Training step: the counterpart of ``hpc_patterns_tpu/models/train.py``
for one device.

The step is forward (compute dtype), loss, backward through PyTorch's
autograd (the flash route through the hand-written backward kernels),
then the optimizer's update applied to the f32 master params IN PLACE
under ``torch.no_grad()`` — the port's counterpart of JAX's donated,
in-HBM update. The optimizer is optax's ``chain(clip_by_global_norm,
adamw)`` written out, with optax's numbers:

- clip scales every gradient by ``max_norm / g_norm`` (as ``(g / g_norm)
  * max_norm``) only when ``g_norm >= max_norm`` — no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``;
- Adam's moments and bias correction as ``scale_by_adam`` (b1 0.9, b2
  0.999, eps 1e-8 outside the square root);
- weight decay on every leaf, norms and embeddings included (optax's
  ``adamw`` with no mask);
- the learning-rate schedule is read at the update count *before* the
  increment, so a warmup's first update has lr 0.

Per-step telemetry goes to the metrics registry through
:func:`record_step_metrics`, and the step is wrapped by
``harness.trace.instrument_jit`` as JAX wraps its jitted step
(``train.step``: a compile event for a step that built kernels).

Host-offloaded optimizer state (JAX ``models/train.py:97-147``,
``:254-351``): :func:`offload_opt_state` parks the AdamW moments in
pinned host memory (on the CPU it leaves them in place with JAX's note);
``make_train_step(..., offload_opt_example=...)`` pulls them to the card
for the update and pushes them back, and with ``residency=`` (a
``memory.ResidencyManager``) the step is STREAMED: the previous push is
drained, the pull is dispatched on the manager's side stream before the
gradient accumulation, the accumulation's end is observed before the
pull's, and the update runs on the pulled moments before they are pushed
back — the same kernels and the same numbers as resident moments.

``mesh=`` (a ``{axis: size}`` dict, ``transformer.logical_mesh``) runs
the step over logical ranks of one device (JAX ``train.py:148-322``):
:func:`init_train_state` places the params and both AdamW moments per
``models/sharding.param_specs`` (under fsdp the moments live sharded),
the dp (and fsdp-as-data) gradient is the mean over those ranks (the
weight-gradient products reduce over their rows), the fsdp gradient
arrives reduce-scattered (the backward of the all-gather before use),
and the update is elementwise on the shards. The clip norm is the global
norm: every element of the model counted exactly once
(:func:`global_sq_norm`; the layout stores each once).

Across launched processes (``apps/launch.py``; a gloo group of more than
one process is up) each process holds a block of the dp ranks and the
rows of the batch they own; the step's gradients and loss are averaged
across processes by one flat allreduce over the gloo wire
(``comm/processes.allreduce_mean``) before the update, so every process
applies the same update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.memory import kinds as kindslib
from hpc_patterns_tpu_torch.models.sharding import batch_sharding, shard_params
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    logical_mesh,
    loss_fn,
    shards_params,
)
from hpc_patterns_tpu_torch.topology import is_multihost, resolve_device

def record_step_metrics(step: int, loss: float, dt_s: float,
                        tokens: int) -> None:
    """Per-step training telemetry into the process-wide registry (no-op
    when disabled): loss, step-time and throughput gauges, and a
    step-time histogram by phase — step 0 builds the kernels, so it
    lands in a ``train.compile_s`` gauge instead of the steady-state
    ``train.step_s`` percentiles."""
    m = metricslib.get_metrics()
    if not m.enabled:
        return
    m.counter("train.steps").inc()
    m.gauge("train.loss").set(loss)
    m.gauge("train.step_time_s").set(dt_s)
    if dt_s > 0:
        m.gauge("train.tokens_per_s").set(tokens / dt_s)
    if step == 0:
        m.gauge("train.compile_s").set(dt_s)
    else:
        m.histogram("train.step_s").observe(dt_s)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in JAX's flatten order (keys
    sorted), so leaf-ordered sums (the global norm) follow it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: ``init -> end`` over ``transition_steps``
    updates, then held (a constant ``init`` if the steps are <= 0)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float):
    """optax.warmup_cosine_decay_schedule from 0: linear warmup to the
    peak, then cosine decay to ``end_value`` at ``decay_steps`` (warmup
    included)."""
    warm = linear_schedule(0.0, peak_value, warmup_steps)
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def global_sq_norm(grads: list) -> torch.Tensor:
    """The squared global norm ``sum(g * g)`` over the stored leaves: the
    sharded layout (``models/sharding.py``) stores every element of the
    model exactly once (a replicated axis gets no rank dim, a sharded
    one's shards partition the leaf), so this counts each once."""
    return sum(torch.sum(g * g) for g in grads)


@dataclasses.dataclass
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay=...))`` over nested dicts of tensors. State: ``{"mu",
    "nu"}`` trees of f32 zeros like the params and the update ``count``."""
    learning_rate: float | Callable[[int], float] = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                           requires_grad=False)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params) -> None:
        """One update, in place: ``grads`` in :func:`tree_leaves` order of
        ``params``; the moments, the count and the params change."""
        ps = tree_leaves(params)
        mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        g_norm = torch.sqrt(global_sq_norm(grads))
        keep = g_norm < self.grad_clip
        count = state["count"]
        # bias corrections and the step size in f32, as optax computes them
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** (count + 1)
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** (count + 1)
        step = -self.lr(count)
        for p, g, mu, nu in zip(ps, grads, mus, nus):
            g = torch.where(keep, g, (g / g_norm) * self.grad_clip)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            u = (mu / c1.item()) / (torch.sqrt(nu / c2.item()) + self.eps)
            p.add_(step * (u + self.weight_decay * p))
        state["count"] = count + 1


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.01,
                   grad_clip: float = 1.0, *, warmup_steps: int = 0,
                   total_steps: int = 0, schedule: str = "constant") -> AdamW:
    """adamw + global-norm clip with the JAX module's schedules:
    ``constant`` (a linear warmup from 0 over ``warmup_steps`` first, if
    any) or ``cosine`` (linear warmup, then cosine decay to 10% of the
    peak at ``total_steps``, which must exceed ``warmup_steps``)."""
    if schedule == "constant":
        lr = (linear_schedule(0.0, learning_rate, warmup_steps)
              if warmup_steps else learning_rate)
    elif schedule == "cosine":
        if total_steps <= warmup_steps:
            raise ValueError(
                f"cosine needs total_steps > warmup_steps, got "
                f"{total_steps} <= {warmup_steps}")
        lr = warmup_cosine_decay_schedule(learning_rate, warmup_steps,
                                          total_steps, 0.1 * learning_rate)
    else:
        raise ValueError(f"schedule {schedule!r} not in (constant, cosine)")
    return AdamW(lr, weight_decay, grad_clip)


#: the optimizer state's tensor subtrees (``count`` is a host int)
MOMENTS = ("mu", "nu")


def _moments(opt_state) -> dict:
    return {k: opt_state[k] for k in MOMENTS}


def offload_opt_state(opt_state, kind: str = "pinned_host"):
    """Move the optimizer's moments to host memory. AdamW's moments are
    twice the f32 parameter footprint and are touched once a step —
    parking them in pinned host memory frees that card memory at the cost
    of streaming them over PCIe each step. Pair with
    ``make_train_step(..., offload_opt_example=...)``.

    Gated on the placement probe (``memory/kinds.py``): where ``kind``
    cannot be placed (the CPU has no page-locked memory) the input comes
    back UNCHANGED with a printed note."""
    leaves = kindslib.tree_tensors(_moments(opt_state))
    device = leaves[0].device if leaves else None
    if not kindslib.memory_kind_placement_works(device, kind):
        print(f"note: backend has no usable {kind!r} memory kind; "
              "optimizer state left in place (no offload benefit "
              "available here)")
        return opt_state
    move = kindslib.move_to_kind(device, kind)
    hosted = {**opt_state, **kindslib.tree_map(move, _moments(opt_state))}
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)  # the D2H copies land before use
    return hosted


def _placement_of(x: torch.Tensor):
    if x.device.type == "cuda":
        return kindslib.kind_sharding(x.device, "device")
    if x.is_pinned():
        return kindslib.kind_sharding(None, "pinned_host")
    return kindslib.kind_sharding("cpu", "device")


def offload_shardings(opt_state_host):
    """(host placements, HBM placements) of a host-resident optimizer
    state's moments — the pull/push targets of the offloaded update,
    shared by :func:`make_train_step` and its measurements."""
    moments = _moments(opt_state_host)
    return (kindslib.tree_map(_placement_of, moments),
            kindslib.memory_kind_shardings(moments, "device"))


def offload_example_shardings(example):
    """:func:`offload_shardings`, tolerant of the probe-gated identity
    fallback: when :func:`offload_opt_state` left the state in place the
    tiers collapse onto one memory and both targets are the example's own
    placements (the staging still runs, as same-memory copies)."""
    leaves = kindslib.tree_tensors(_moments(example))
    if leaves and all(x.device.type == "cpu" and x.is_pinned()
                      for x in leaves):
        return offload_shardings(example)
    host_sh = kindslib.tree_map(_placement_of, _moments(example))
    return host_sh, host_sh


def make_train_step(cfg: TransformerConfig, optimizer: AdamW | None = None,
                    accum_steps: int = 1, offload_opt_example=None,
                    residency=None, *, mesh=None):
    """``step(params, opt_state, tokens) -> (loss, params, opt_state)``:
    the loss (f32, detached) of ``tokens`` at the params it was given,
    then the update applied in place (the same ``params`` and
    ``opt_state`` objects come back). ``accum_steps > 1`` splits the
    batch into that many micro-batches and takes the mean of their
    mean losses and gradients (accumulated in f32) before the one update
    — the same numbers as the whole batch, at a fraction of the
    activation memory.

    ``offload_opt_example``: a host-resident state from
    :func:`offload_opt_state`; the step pulls its moments to the card,
    updates them and pushes them back, returning a host-resident state.
    ``residency``: a ``memory.ResidencyManager`` — the STREAMED step
    (module docstring), with measured ``mem.prefetch`` / ``mem.evict``
    windows and ``prefetch_overlap_frac``; requires
    ``offload_opt_example``. ``mesh``: the step's logical ranks (module
    docstring); ``params`` then come from :func:`init_train_state` with
    the same mesh (a global tree also works: its gradients come back
    global)."""
    optimizer = optimizer or make_optimizer()
    mesh = logical_mesh(mesh, cfg)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    n_data = _data_ranks(mesh, cfg)
    if residency is not None and offload_opt_example is None:
        raise ValueError(
            "residency streaming needs offload_opt_example (a host-"
            "resident opt state from offload_opt_state)")
    if offload_opt_example is not None:
        host_sh, hbm_sh = offload_example_shardings(offload_opt_example)
    else:
        host_sh = hbm_sh = None

    def grads_of(params, tokens):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(params, tokens, cfg, mesh)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def local_grads(params, tokens):
        B = tokens.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} must divide by accum_steps "
                             f"{accum_steps}")
        if (B // accum_steps) % n_data:
            raise ValueError(
                f"micro-batch {B // accum_steps} (batch {B} / accum "
                f"{accum_steps}) must divide over the {n_data} data ranks "
                f"{cfg.batch_axes}")
        if accum_steps == 1:
            return grads_of(params, tokens)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for p in tree_leaves(params)]
        for mb in tokens.reshape(accum_steps, B // accum_steps, -1):
            loss_i, g_i = grads_of(params, mb)
            loss = loss + loss_i
            grads = [a + b for a, b in zip(grads, g_i)]
        scale = 1.0 / accum_steps
        return loss * scale, [g * scale for g in grads]

    def accum_grads(params, tokens):
        return process_mean(*local_grads(params, tokens))

    if residency is not None:
        return _make_streamed_step(optimizer, accum_grads, host_sh, hbm_sh,
                                   residency)

    def step(params, opt_state, tokens):
        if hbm_sh is not None:
            opt_state = {**opt_state, **kindslib.tree_map(
                lambda x, p: p.place(x), _moments(opt_state), hbm_sh)}
        loss, grads = accum_grads(params, tokens)
        optimizer.update(grads, opt_state, params)
        if host_sh is not None:
            opt_state = {**opt_state, **kindslib.tree_map(
                lambda x, p: p.place(x), _moments(opt_state), host_sh)}
        return loss, params, opt_state

    return tracelib.instrument_jit(step, "train.step")


def process_mean(loss, grads: list):
    """(loss, grads) averaged over the launched processes' dp ranks: one
    flat allreduce of the loss and the gradient leaves over the gloo
    wire (``comm/processes.allreduce_mean``); unchanged in one process."""
    if not is_multihost():
        return loss, grads
    from hpc_patterns_tpu_torch.comm.processes import allreduce_mean

    flat = allreduce_mean(torch.cat(
        [loss.reshape(1).float()] + [g.reshape(-1).float() for g in grads]))
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
        at += g.numel()
    return flat[0], out


def _make_streamed_step(optimizer, accum_grads, host_sh, hbm_sh,
                        residency):
    """The residency-managed offloaded step (JAX ``_make_streamed_step``):
    the pull is dispatched first and runs on the manager's side stream
    under the gradient accumulation; the accumulation's end is observed
    before the pull's, so the wait that remains is the transfer time the
    accumulation failed to hide, and the ``mem.prefetch`` window and the
    overlap fraction report it."""
    import time

    def step(params, opt_state, tokens):
        dev = tree_leaves(params)[0].device
        residency.bind_device(dev)
        # the previous step's push had a whole step to land: observe it
        # (and close its mem.evict window) before its tensors are read
        residency.drain()
        opt_dev, handle = residency.pull_payload(
            _moments(opt_state), shardings=hbm_sh,
            attrs={"consumer": "train.accum"})
        t_acc0 = time.perf_counter()
        loss, grads = accum_grads(params, tokens)
        # the consumer window ends when the hiding compute ended
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        t_acc1 = time.perf_counter()
        residency.wait_pull(handle)
        residency.complete_pull(handle, chunk_windows=((t_acc0, t_acc1),))
        state = {**opt_state, **opt_dev}
        optimizer.update(grads, state, params)
        opt_host = residency.push_payload(
            _moments(state), shardings=host_sh,
            attrs={"consumer": "train.apply"})
        return loss, params, {**state, **opt_host}

    return tracelib.instrument_jit(step, "train.step")


def _data_ranks(mesh, cfg: TransformerConfig) -> int:
    """The ranks the batch's rows divide over (``cfg.batch_axes``)."""
    return batch_sharding(mesh, cfg)[0]


def init_train_state(generator: torch.Generator, cfg: TransformerConfig,
                     optimizer: AdamW | None = None, *, device=None,
                     mesh=None):
    """(params, opt_state): f32 master params from ``generator`` on
    ``device`` (default ``cuda``), requiring grad, and the optimizer's
    zero state beside them. On a ``mesh`` that shards params (tp, or fsdp
    under ``cfg.fsdp``) the params are placed as their rank-stacked
    shards (``sharding.shard_params``: the same numbers as without a
    mesh), and both moments take that layout."""
    mesh = logical_mesh(mesh, cfg)
    optimizer = optimizer or make_optimizer()
    params = init_params(cfg, generator=generator, device=device)
    if shards_params(mesh, cfg):
        params = shard_params(params, mesh, cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, optimizer.init(params)


def make_batch(generator: torch.Generator, cfg: TransformerConfig,
               batch: int, seq: int, *, device=None, mesh=None):
    """Synthetic (batch, seq) int32 tokens drawn from ``generator`` (on
    its own device), moved to ``device`` (default ``cuda``). ``mesh``:
    the batch's rank layout (``sharding.batch_sharding``: rank r of the
    batch axes owns the r-th block of rows, sp rank s the s-th block of
    the sequence), checked to divide."""
    n_data, n_sp = batch_sharding(logical_mesh(mesh, cfg), cfg)
    if batch % n_data or seq % n_sp:
        raise ValueError(
            f"batch {batch} x seq {seq} does not divide over the data "
            f"ranks {n_data} x sp {n_sp}")
    dev = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                           device=generator.device, dtype=torch.int32)
    return tokens.to(dev)
