"""Open-loop load generation: seeded arrival processes for serving.

The port's copy of ``hpc_patterns_tpu/harness/loadgen.py`` (numpy
only, so it carries over unchanged; the JAX package's harness
``__init__`` imports jax, so the port does not import it from there).

``bench_serving``'s original stream is CLOSED-loop: every request is
queued up front and a new one only makes progress when the engine frees
capacity — so the offered load adapts to the server and overload can
never happen. Real traffic is OPEN-loop: arrivals come on the *users'*
clock (the classic closed-vs-open distinction; under-provisioned
open-loop systems build queues and blow deadlines instead of politely
slowing the benchmark down). This module generates those arrival
schedules:

- **poisson** — memoryless arrivals at a constant mean rate (the
  steady-traffic null model);
- **bursty** — a two-phase Markov-modulated process: quiet periods at
  the base rate alternate with bursts at ``burst_factor`` times it
  (queue-depth spikes, the admission-control stressor);
- **diurnal** — a sinusoidally modulated rate (period ``period_s``,
  modulation depth ``depth``) sampled by thinning (peak-hour vs
  trough, the capacity-planning shape);
- **shared-prefix** (:func:`make_shared_prefix_schedule`, round 12) —
  any of the above arrival processes carrying shared-prefix STRUCTURE:
  template-pool prompts (K shared templates × per-request tails) and
  conversation-tree turns (a request extends an earlier request's
  prompt), the traffic the prefix-sharing KV arena serves
  (``models/serving.py`` ``prefix_cache=True``); token content comes
  from the one seeded rule :func:`materialize_prompt`.

Every schedule is DETERMINISTIC given its parameters and seed, and
round-trips through JSON (:meth:`Schedule.to_json`) — so a chaos run's
exact traffic can be replayed against a fix, and a scenario row in a
benchmark names the schedule that produced it.

Requests carry a **priority class** (:class:`PriorityClass`: lower
``priority`` number = more important, the P0/P1 convention) with
per-class SLO targets (consumed by ``harness/slo.py``) and an optional
queue ``deadline_s`` (consumed by the engine's shedding policy). The
serving engine admits in priority order and — with ``preempt=True`` —
evicts lower classes under page pressure (``models/serving.py``).

Import-light (numpy only): schedules must be buildable from jax-free
drivers and launcher children.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Sequence

import numpy as np


@dataclass(frozen=True)
class PriorityClass:
    """One traffic class. ``priority``: lower = more important (the
    engine admits lower numbers first and may preempt higher ones for
    them). ``weight``: relative share of arrivals. ``ttft_slo_s`` /
    ``tpot_slo_s``: the class's SLO targets (None = no target —
    trivially attained). ``deadline_s``: queue-time shedding deadline
    (None = never shed)."""
    name: str
    priority: int
    weight: float = 1.0
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None
    deadline_s: float | None = None


@dataclass(frozen=True)
class ScheduledRequest:
    """One arrival: WHEN it enters (``t_arrival_s``, relative to the
    run start), what class it belongs to, and its shape (prompt
    length, generation budget). Prompt token CONTENT is the driver's
    job (seeded separately) — the schedule is shape + timing only, so
    one schedule replays against any vocabulary.

    Shared-prefix STRUCTURE (round 12) rides as two optional fields:
    ``template`` (>= 0: this prompt = template ``template``'s tokens +
    a per-request tail) and ``parent`` (>= 0: a conversation-tree
    turn — this prompt = request ``parent``'s prompt + a tail, so
    prefixes grow down the tree). Still shape-only: the driver
    materializes tokens with :func:`materialize_prompt`, the ONE
    seeded content rule, so schedules stay vocabulary-agnostic and
    JSON-replayable."""
    index: int
    t_arrival_s: float
    cls: str
    priority: int
    prompt_len: int
    max_new: int
    deadline_s: float | None = None
    template: int = -1
    parent: int = -1


@dataclass(frozen=True)
class Schedule:
    """A replayable arrival schedule: the requests in arrival order
    plus the generating spec (provenance — a benchmark row can name
    exactly which traffic produced it)."""
    requests: tuple[ScheduledRequest, ...]
    spec: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].t_arrival_s if self.requests else 0.0

    def to_json(self) -> str:
        return json.dumps({
            "spec": self.spec,
            "requests": [asdict(r) for r in self.requests],
        })

    @classmethod
    def from_json(cls, text: str) -> "Schedule":
        obj = json.loads(text)
        return cls(
            requests=tuple(ScheduledRequest(**r)
                           for r in obj.get("requests", [])),
            spec=dict(obj.get("spec", {})),
        )


# ---------------------------------------------------------------------------
# arrival processes (times only; all driven by one RandomState)
# ---------------------------------------------------------------------------


def poisson_times(n: int, rate_rps: float,
                  rng: np.random.RandomState) -> np.ndarray:
    """n arrival instants of a homogeneous Poisson process: cumulative
    exponential inter-arrivals at mean ``1/rate``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def bursty_times(n: int, rate_rps: float, rng: np.random.RandomState,
                 *, burst_factor: float = 8.0,
                 mean_quiet_s: float = 1.0,
                 mean_burst_s: float = 0.25) -> np.ndarray:
    """Two-phase modulated Poisson: exponential quiet phases at the
    base rate alternating with exponential burst phases at
    ``burst_factor``× it. The phase sequence and the arrivals inside
    each phase all come from ``rng`` — one seed, one schedule."""
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    times: list[float] = []
    t = 0.0
    burst = False
    while len(times) < n:
        phase = rng.exponential(mean_burst_s if burst else mean_quiet_s)
        rate = rate_rps * (burst_factor if burst else 1.0)
        # arrivals inside this phase: sequential exponentials until the
        # phase ends (keeps the draw count deterministic per phase)
        u = t
        while True:
            u += rng.exponential(1.0 / rate)
            if u > t + phase or len(times) >= n:
                break
            times.append(u)
        t += phase
        burst = not burst
    return np.asarray(times[:n])


def diurnal_times(n: int, rate_rps: float, rng: np.random.RandomState,
                  *, period_s: float = 60.0,
                  depth: float = 0.8) -> np.ndarray:
    """Sinusoidally modulated Poisson sampled by thinning: the
    instantaneous rate is ``rate*(1 + depth*sin(2πt/period))``;
    candidates are generated at the peak rate and accepted with
    probability rate(t)/peak — the standard exact thinning
    construction, deterministic given ``rng``."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    peak = rate_rps * (1.0 + depth)
    times: list[float] = []
    t = 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / peak)
        rate_t = rate_rps * (1.0 + depth * np.sin(2 * np.pi * t / period_s))
        if rng.uniform() * peak <= rate_t:
            times.append(t)
    return np.asarray(times)


_PROCESSES = {
    "poisson": poisson_times,
    "bursty": bursty_times,
    "diurnal": diurnal_times,
}


# ---------------------------------------------------------------------------
# schedule assembly
# ---------------------------------------------------------------------------


def _arrivals_and_classes(n: int, rate_rps: float,
                          classes: Sequence[PriorityClass],
                          process: str, seed: int, process_kw: dict):
    """Shared prologue of the schedule constructors: validate, pick
    the arrival process, seed the ONE RandomState, draw arrival times
    then per-request classes. The draw ORDER is part of the seeded
    contract — both constructors consume (times, classes) first, in
    this order, then continue with their own draws."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if not classes:
        raise ValueError("need at least one PriorityClass")
    gen = _PROCESSES.get(process)
    if gen is None:
        raise ValueError(f"unknown process {process!r} "
                         f"(known: {', '.join(sorted(_PROCESSES))})")
    rng = np.random.RandomState(seed)
    times = gen(n, rate_rps, rng, **process_kw)
    weights = np.asarray([c.weight for c in classes], np.float64)
    if weights.sum() <= 0:
        raise ValueError("class weights must sum > 0")
    weights = weights / weights.sum()
    cls_idx = rng.choice(len(classes), size=n, p=weights)
    return rng, times, cls_idx


def make_schedule(n: int, *, rate_rps: float,
                  classes: Sequence[PriorityClass],
                  prompt_lens: Sequence[int],
                  budgets: Sequence[int],
                  budget_probs: Sequence[float] | None = None,
                  process: str = "poisson", seed: int = 0,
                  **process_kw: Any) -> Schedule:
    """The one constructor: ``n`` arrivals from the named process, each
    assigned a class (by weight), a prompt length, and a budget — all
    from ONE seeded RandomState, so (params, seed) fully determine the
    schedule. ``process_kw`` passes through to the arrival process
    (``burst_factor``, ``period_s``, ...)."""
    rng, times, cls_idx = _arrivals_and_classes(
        n, rate_rps, classes, process, seed, process_kw)
    plens = rng.choice(np.asarray(prompt_lens, np.int64), size=n)
    budgets_arr = np.asarray(budgets, np.int64)
    probs = (np.asarray(budget_probs, np.float64)
             if budget_probs is not None else None)
    news = rng.choice(budgets_arr, size=n, p=probs)
    reqs = []
    for i in range(n):
        c = classes[int(cls_idx[i])]
        reqs.append(ScheduledRequest(
            index=i, t_arrival_s=float(times[i]), cls=c.name,
            priority=c.priority, prompt_len=int(plens[i]),
            max_new=int(news[i]), deadline_s=c.deadline_s))
    spec = {"process": process, "n": n, "rate_rps": rate_rps,
            "seed": seed, "prompt_lens": list(map(int, prompt_lens)),
            "budgets": list(map(int, budgets)),
            "classes": [asdict(c) for c in classes], **process_kw}
    return Schedule(requests=tuple(reqs), spec=spec)


def make_shared_prefix_schedule(
        n: int, *, rate_rps: float, classes: Sequence[PriorityClass],
        n_templates: int, template_len: int | Sequence[int],
        tail_lens: Sequence[int], budgets: Sequence[int],
        budget_probs: Sequence[float] | None = None,
        template_weights: Sequence[float] | None = None,
        tree_frac: float = 0.0, process: str = "poisson",
        seed: int = 0, **process_kw: Any) -> Schedule:
    """A SHARED-PREFIX arrival schedule — the traffic shape that makes
    a prefix-sharing KV arena earn its keep (models/serving.py's
    ``prefix_cache=True``): every prompt is a TEMPLATE (one of
    ``n_templates`` shared system-prompt/few-shot pools) plus a
    per-request tail, and with probability ``tree_frac`` a request is
    instead a CONVERSATION-TREE turn extending an earlier request's
    prompt by a tail — prefixes then grow down chains, the radix-tree
    shape. Arrival times come from the named process (Poisson/bursty/
    diurnal, like :func:`make_schedule`); everything — times, class,
    template, tail length, budget, parent — draws from ONE seeded
    RandomState, so (params, seed) fully determine the schedule and it
    JSON round-trips like every other process.

    ``template_len``: one length for all templates, or one per
    template. ``template_weights``: relative template popularity
    (default uniform — skew it to model a hot system prompt). The
    driver materializes token content with :func:`materialize_prompt`.
    """
    if n_templates < 1:
        raise ValueError(f"n_templates must be >= 1, got {n_templates}")
    if not 0.0 <= tree_frac <= 1.0:
        raise ValueError(f"tree_frac must be in [0, 1], got {tree_frac}")
    tlens = ([int(t) for t in template_len]
             if hasattr(template_len, "__len__")
             else [int(template_len)] * n_templates)
    if len(tlens) != n_templates or min(tlens) < 1:
        raise ValueError(
            f"template_len must be one positive length or one per "
            f"template, got {tlens} for {n_templates}")
    rng, times, cls_idx = _arrivals_and_classes(
        n, rate_rps, classes, process, seed, process_kw)
    tw = (np.asarray(template_weights, np.float64)
          if template_weights is not None
          else np.ones(n_templates, np.float64))
    if len(tw) != n_templates or tw.sum() <= 0:
        raise ValueError("template_weights must be one positive weight "
                         "per template")
    tmpl_idx = rng.choice(n_templates, size=n, p=tw / tw.sum())
    tails = rng.choice(np.asarray(tail_lens, np.int64), size=n)
    budgets_arr = np.asarray(budgets, np.int64)
    probs = (np.asarray(budget_probs, np.float64)
             if budget_probs is not None else None)
    news = rng.choice(budgets_arr, size=n, p=probs)
    tree_draw = rng.uniform(size=n)
    parent_pick = rng.randint(0, max(1, n), size=n)
    reqs: list[ScheduledRequest] = []
    plens: list[int] = []
    for i in range(n):
        c = classes[int(cls_idx[i])]
        tail = int(tails[i])
        if i > 0 and tree_draw[i] < tree_frac:
            # a follow-up turn: extend an EARLIER request's prompt —
            # the tree is over PROMPTS (deterministic lengths), the
            # documented modeling choice: response content would need
            # runtime feedback the schedule cannot carry
            parent = int(parent_pick[i]) % i
            plen = plens[parent] + tail
            template, par = -1, parent
        else:
            template = int(tmpl_idx[i])
            plen = tlens[template] + tail
            par = -1
        plens.append(plen)
        reqs.append(ScheduledRequest(
            index=i, t_arrival_s=float(times[i]), cls=c.name,
            priority=c.priority, prompt_len=plen, max_new=int(news[i]),
            deadline_s=c.deadline_s, template=template, parent=par))
    # torchlint: disable=record-kind-drift — a schedule descriptor's
    # kind, not a RunLog record
    spec = {"process": process, "kind": "shared_prefix", "n": n,
            "rate_rps": rate_rps, "seed": seed,
            "n_templates": n_templates, "template_len": tlens,
            "tail_lens": list(map(int, tail_lens)),
            "budgets": list(map(int, budgets)),
            "tree_frac": tree_frac,
            "classes": [asdict(c) for c in classes], **process_kw}
    return Schedule(requests=tuple(reqs), spec=spec)


def materialize_prompt(schedule: Schedule, index: int, vocab: int,
                       *, seed: int | None = None) -> np.ndarray:
    """THE content rule for shared-prefix schedules: deterministic
    int32 tokens for request ``index`` — template tokens seeded by
    (seed, template id) so every request on a template shares the SAME
    prefix bytes, tails seeded by (seed, request index) so they
    diverge, and tree turns recursively extend their parent's prompt.
    One definition shared by drivers, benchmarks, and tests, so "the
    same schedule" always means the same tokens."""
    if vocab < 1:
        raise ValueError(f"vocab must be >= 1, got {vocab}")
    if seed is None:
        seed = int(schedule.spec.get("seed", 0))
    req = schedule.requests[index]
    tail_len = req.prompt_len - (
        schedule.requests[req.parent].prompt_len if req.parent >= 0
        else int(np.asarray(schedule.spec["template_len"])[req.template]))
    tail = np.random.RandomState(
        (seed * 1_000_003 + 7919 * (index + 1)) % (2 ** 31 - 1)
    ).randint(0, vocab, size=tail_len).astype(np.int32)
    if req.parent >= 0:
        head = materialize_prompt(schedule, req.parent, vocab, seed=seed)
    else:
        tlen = int(np.asarray(schedule.spec["template_len"])[req.template])
        head = np.random.RandomState(
            (seed * 1_000_003 + 104_729 * (req.template + 1))
            % (2 ** 31 - 1)
        ).randint(0, vocab, size=tlen).astype(np.int32)
    return np.concatenate([head, tail])


def staged_schedule(stages: Sequence[tuple[float, PriorityClass, int, int]],
                    spec: dict | None = None) -> Schedule:
    """An explicit hand-staged schedule — (t_arrival_s, class,
    prompt_len, max_new) tuples in arrival order. The deterministic
    building block for CI scenario smokes, where the preemption trigger
    must not depend on a random draw; still a :class:`Schedule`, so it
    serializes and replays exactly like a generated one."""
    reqs = []
    last = -np.inf
    for i, (t, c, plen, mnew) in enumerate(stages):
        if t < last:
            raise ValueError("staged arrivals must be non-decreasing")
        last = t
        reqs.append(ScheduledRequest(
            index=i, t_arrival_s=float(t), cls=c.name,
            priority=c.priority, prompt_len=int(plen),
            max_new=int(mnew), deadline_s=c.deadline_s))
    return Schedule(requests=tuple(reqs),
                    spec={"process": "staged", **(spec or {})})
