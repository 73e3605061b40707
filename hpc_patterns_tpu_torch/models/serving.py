"""Continuous batching over the ragged paged cache — the engine of
``hpc_patterns_tpu/models/serving.py`` (``EngineCore`` +
``ContinuousBatcher``), and its half of the serving plane's KV handoff.

- a page free-list over one shared pool; each admitted sequence takes
  the pages its bucket-padded prompt + budget needs
  (:meth:`EngineCore.pages_needed`) and returns them on completion;
- one extra TRASH page (with its scale rows in a quantized pool): idle
  slots point their whole table row at it, so their frozen decode
  writes land in garbage nobody reads;
- prompts right-pad to a bucket ladder rung (:func:`bucket_ladder`, or
  one fitted to an observed length sample, :func:`fit_bucket_ladder`);
  the one-row prefill writes through the shared pool and its logits
  come from the last real token;
- admission walks the queue in priority order (lower number first,
  resumes before fresh arrivals within a class, FCFS with skip inside
  that), sheds fresh requests whose ``deadline_s`` expired, holds fresh
  admissions under ``admit_highwater`` of the pool, and (``overlap``)
  happens at chunk boundaries behind the already-enqueued decode chunk
  (the CUDA stream orders them, as JAX's async dispatch did); the
  first-token readback is deferred to the round's sync point;
- a decode chunk is ``chunk`` ragged steps (``paged_decode_step`` with a
  (slots,) position vector): a row advances while ``pos < limit``; its
  position freezes at ``limit`` after it finishes, so a frozen write
  re-targets the row's own last slot; an emitted ``eos_id`` pulls the
  limit down;
- sampling (``temperature > 0``, ``top_k``, ``seed``): each row draws
  with the Gumbel-max sampler of ``models/decode.py`` from its own key
  ((slots, 2) on the device; default :meth:`EngineCore.request_key`)
  and temperature ((slots,)); a draw depends only on the row's key,
  its position and its logits, so a sampled row's tokens equal
  ``paged_generate(..., key=request_key(sid))``'s, preempted, resumed
  or migrated. Greedy engines run a plain argmax and touch no key;
- preemption (``preempt=True``): when the most urgent waiting request
  cannot get pages, strictly lower classes are evicted at a chunk
  boundary (lowest class first, most recently admitted first), their
  tokens and keys to the host, their pages back to the arena, and they
  re-enter through the ordinary prefill with prompt = original +
  generated; causality makes the resumed cache the uninterrupted one;
- every request has a ``stats`` row (``t_submit``, ``t_first``,
  ``t_finish``, ``tokens``, ``outcome``, ``preemptions``, ``token_ts``);
  with ``slo={priority: SLOTarget}`` each :meth:`ContinuousBatcher.run`
  ends with the attainment rollup in ``last_slo`` (``harness/slo.py``);
- ``emit=``: a ``**record`` callable (``RunLog.emit`` fits) receiving
  JAX's ``serve_shed``, ``serve_admit``, ``serve_finish``,
  ``serve_preempt``, ``serve_migrate_out`` and ``serve_migrate_in``
  records, field for field;
- chaos: each round probes ``harness.chaos``'s ``engine_round`` site;
- draft-assisted rounds (``draft_params``, ``draft_cfg``, ``gamma``):
  a draft pool with the target's page geometry shares its page table;
  admission prefills both; a dispatch is ``chunk`` rounds of
  ``models/speculative.paged_round`` (:func:`_spec_chunk`), each row
  advancing 1..gamma+1 tokens a round with budget and EOS truncation on
  the device between rounds and one readback a chunk; requests hold
  ``gamma + 1`` pages' worth of slack rows (``spec_slack``). A greedy row
  equals the target's standalone ``paged_generate``; a sampled one equals
  ``speculative_generate_batched`` with the request's key. A resumed draft
  row re-prefills both caches with everything but its last token and
  continues from that token, so its rounds start where an uninterrupted
  run's do. Draft engines do not migrate (as in JAX);
- KV migration (the serving plane's prefill -> decode handoff,
  ``serving_plane/``): :meth:`EngineCore.export_migration` detaches a
  row into a :class:`MigrationBundle` (cursors, key and temperature
  snapshot to host, its pages gathered on the device into new tensors)
  and :meth:`EngineCore.install_migration` seats one in another engine
  (pages copied into the pool in place, cursors and key seeded; no
  readback). A migrated row is structurally a resume on another
  engine, so its tokens equal the colocated engine's byte for byte.

The pool stores ``cfg.kv_cache_dtype``: the compute dtype, or int8/fp8
values with per-row scale pools, served on any ``cfg.decode_attn``
route ("flash", "paged_flash", "gather"); a bundle carries the scale
pools beside the K/V pages.

Observability (``harness/metrics.py``, ``trace.py``, ``reqtrace.py``),
at the JAX engine's sites: the ``serve.queue_depth`` and
``serve.free_pages`` gauges, the admission / finish / token / shed /
preemption / migration counters, the ``serve.prefill``,
``serve.decode_dispatch`` and ``serve.decode_round`` spans, a device
window for each admission (track ``slot + 1``) and each decode chunk
(track 0) — CUDA events on a card, read after the round's own readbacks
— and each request's lifecycle segments (``preempted`` included), which
a migrated bundle carries in ``segments``. With no registry, recorder,
reqtrace or chaos enabled each site costs one check.

Tiered residency (``residency=``, a ``memory.ResidencyManager``): the
pool becomes a cache over the manager's host tier. At a chunk boundary,
demanded and cold rows page out (:meth:`EngineCore._swap_out`: the
migration snapshot, its gathered pages pushed to pinned host tensors on
the manager's side stream); swapped rows prefetch back with the pull
dispatched BEFORE the round's decode chunk and installed behind it, the
compute stream waiting on the pull's event. Pages reserved for pulls in
flight are not free to admissions. :meth:`EngineCore.export_swapped`
hands a parked row to another engine without paging it back in. Records
``serve_swap_out``, ``serve_prefetch`` and ``serve_swap_in``; request
segments ``swapped_out`` and ``prefetch_wait``.

Prefix sharing (``prefix_cache=True``): a radix index
(``memory.RadixPrefixCache``) over admitted prompts, keyed by the
admission rung, and refcounted pages. Admission maps the longest cached
chain read-only into the row's table and prefills only the tail
(``decode.paged_tail_prefill``); copy-on-write is resolved at admission
(the boundary page is always private, decode writes start at the
prompt's own tail); every release path decrefs. A migration destination
resolves a bundle's ``prefix_len`` span to its own cached chain at the
bundle's ``rung``, or installs the whole payload. A row that maps pages
another row reads is pinned against paging. Refused: draft pairs,
quantized pools, a missing or misaligned ladder, and on the ``flash``
route rungs that are multiples of 128 (their monolithic prefill takes
kernel 1, which the tail cannot mirror).

tp-sharded serving (``mesh=``, a ``{axis: size}`` dict whose ``tp`` axis
shapes serving, as decode's): the params (and a draft's) are stored as
their tp shards once, the pools kv-head-sharded over tp and stacked (tp,
pool_pages, kv_heads/tp, ...) where tp divides kv_heads (else JAX's
warning and whole pools), and every piece that touches them carries that
layout: the one-row prefill and the tail prefill (kernel 1 on each
rank's head block), the decode chunk and the draft rounds (kernels 6/6q
or 7 on the folded ranks, the verify extend on the tp shards),
preemption's re-prefill, the residency manager's swap-out and prefetch,
and migration. A :class:`MigrationBundle` keeps JAX's global layout (all
kv heads), so a bundle from a tp engine installs in an unsharded one
and the reverse. The sampler reads the gathered logits, so a tp engine's
rows equal the tp standalone ``paged_generate(..., mesh=)``'s.

Correctness contract: every sequence's tokens equal the standalone
``paged_generate`` for the same prompt, budget, config and (sampled)
key (exactly in f32 on the CPU; on the card up to near-ties where bf16
matmuls at batch 8 and batch 1 round differently), preempted, resumed,
migrated, paged through the host tier or served from shared pages; a sampled draft-assisted sequence equals
``speculative_generate_batched``'s instead (the same law, other draws).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib
from hpc_patterns_tpu_torch.harness import slo as slolib
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.memory.prefix_cache import RadixPrefixCache
from hpc_patterns_tpu_torch.models.decode import (
    FLASH_PREFILL_ALIGN,
    PREFIX_ALIGN,
    _as_keys,
    _pick,
    _upload,
    gather_pool_pages,
    gumbel_noise,
    init_paged_cache,
    install_pool_pages,
    paged_decode_step,
    paged_prefill,
    paged_tail_prefill,
    sample_key,
)
from hpc_patterns_tpu_torch.models.speculative import (
    paged_round,
    spec_streams,
)
from hpc_patterns_tpu_torch.models.sharding import shard_params
from hpc_patterns_tpu_torch.models.transformer import (
    TransformerConfig,
    logical_mesh,
    shards_params,
)
from hpc_patterns_tpu_torch.topology import resolve_device


def bucket_ladder(max_len: int, *, lo: int = 16,
                  growth: float = 2.0) -> tuple[int, ...]:
    """A power-of-two-ish prompt-length ladder covering 1..``max_len``:
    rungs ``lo, lo*growth, ...`` with the top rung clamped to
    ``max_len``."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if lo < 1 or growth <= 1.0:
        raise ValueError(f"need lo >= 1 and growth > 1, got {lo}/{growth}")
    rungs = []
    r = lo
    while r < max_len:
        rungs.append(r)
        r = max(int(r * growth), r + 1)
    rungs.append(max_len)
    return tuple(rungs)


def prefill_ladder(max_len: int, decode_attn: str) -> tuple[int, ...]:
    """The default ladder for prompts up to ``max_len`` on a decode route:
    :func:`bucket_ladder` on the plain routes; on the "flash" route rungs
    that are all multiples of ``FLASH_PREFILL_ALIGN`` (128, 256, ...,
    ``max_len`` rounded up), so that every admission prefills through
    the flash prefill kernel."""
    if decode_attn != "flash":
        return bucket_ladder(max_len)
    a = FLASH_PREFILL_ALIGN
    return bucket_ladder(-(-max_len // a) * a, lo=a)



def fit_bucket_ladder(lengths, max_rungs: int, *,
                      max_len: int | None = None) -> tuple[int, ...]:
    """Fit a prompt-length ladder to an observed length sample: up to
    ``max_rungs`` rungs minimizing the expected padding ``E[rung(len) -
    len]`` over the sample (exact DP over the distinct lengths: optimal
    rungs sit on sample points). ``max_len``: extend the top rung to
    cover prompts up to it even if the sample never reached it. Also
    reachable as ``bucket_ladder.fit``."""
    lengths = [int(t) for t in lengths]
    if not lengths or min(lengths) < 1:
        raise ValueError("fit_bucket_ladder needs a nonempty sample of "
                         "positive lengths")
    if max_rungs < 1:
        raise ValueError(f"max_rungs must be >= 1, got {max_rungs}")
    counts: dict[int, int] = {}
    for t in lengths:
        counts[t] = counts.get(t, 0) + 1
    if max_len is not None and max_len > max(counts):
        counts[int(max_len)] = counts.get(int(max_len), 0)
    cand = sorted(counts)
    n_cand = len(cand)
    cnt = np.asarray([counts[c] for c in cand], np.int64)
    val = np.asarray(cand, np.int64)
    pc = np.concatenate([[0], np.cumsum(cnt)])
    pv = np.concatenate([[0], np.cumsum(cnt * val)])

    def seg_waste(i: int, j: int) -> int:
        # lengths cand[i..j] all pad up to cand[j]
        return int(val[j] * (pc[j + 1] - pc[i]) - (pv[j + 1] - pv[i]))

    r_max = min(max_rungs, n_cand)
    inf = float("inf")
    # dp[r][j]: min waste covering cand[0..j] with r rungs, top = cand[j]
    dp = [[inf] * n_cand for _ in range(r_max + 1)]
    back = [[-1] * n_cand for _ in range(r_max + 1)]
    for j in range(n_cand):
        dp[1][j] = seg_waste(0, j)
    for r in range(2, r_max + 1):
        for j in range(r - 1, n_cand):
            best, bi = inf, -1
            for i in range(r - 2, j):
                w = dp[r - 1][i] + seg_waste(i + 1, j)
                if w < best:
                    best, bi = w, i
            dp[r][j], back[r][j] = best, bi
    # the ladder must cover the sample max: chains end at the top cand
    r_best = min(range(1, r_max + 1), key=lambda r: dp[r][n_cand - 1])
    rungs, j, r = [], n_cand - 1, r_best
    while r >= 1 and j >= 0:
        rungs.append(int(val[j]))
        j = back[r][j]
        r -= 1
    return tuple(sorted(rungs))


bucket_ladder.fit = fit_bucket_ladder


def expected_padding(buckets, lengths) -> float:
    """Mean padded-minus-true tokens per prompt for ``lengths`` under
    ``buckets`` (None = exact lengths): what :func:`fit_bucket_ladder`
    minimizes."""
    lengths = [int(t) for t in lengths]
    if not lengths:
        return 0.0
    return float(sum(pad_to_bucket(buckets, t) - t
                     for t in lengths)) / len(lengths)


def pad_to_bucket(buckets, prompt_len: int) -> int:
    """The padded prefill length: the smallest rung that fits (the exact
    length when ``buckets`` is None). Pool-sizing callers must use the
    same rule as admission."""
    if buckets is None:
        return prompt_len
    for rung in sorted(buckets):
        if rung >= prompt_len:
            return int(rung)
    raise ValueError(
        f"prompt length {prompt_len} above the bucket-ladder top "
        f"{max(buckets)}; extend prompt_buckets")


@dataclass
class Request:
    """One sequence to serve: ``prompt`` (T,) int32, up to ``max_new``
    generated tokens (fewer if ``eos_id`` fires). ``t_submit`` stamps
    queue entry (time to first token counts from it).
    ``temperature``/``key``: per-request sampling overrides (None = the
    engine's defaults; the default key is
    :meth:`EngineCore.request_key`). ``priority``: lower number = more
    important (admission order; preemption eligibility). ``deadline_s``:
    queue-time shedding deadline relative to submit (None = never shed).
    ``resume_prefix``: tokens this request already emitted (before a
    preemption, or elsewhere); its prompt then carries them, and the
    engine prepends them to the output."""
    prompt: np.ndarray
    max_new: int
    seq_id: int = -1
    t_submit: float = 0.0
    temperature: float | None = None
    key: np.ndarray | None = None
    priority: int = 0
    deadline_s: float | None = None
    resume_prefix: np.ndarray | None = None


@dataclass
class MigrationBundle:
    """One row's complete serving state, detached from its engine — what
    a prefill-role replica hands a decode-role replica. The fields and
    their names are JAX's (``hpc_patterns_tpu/models/serving.py``), so
    the wire codec (``serving_plane/migration.py``) stays byte-compatible
    across the two packages. ``pages_payload``: {cache key: per-layer
    tensors with leading dim ``n_pages``} — the K/V pages, plus the scale
    pools of a quantized cache. ``key`` is the row's sampler key (the
    sampler's whole state: a draw depends on it and the position only);
    a greedy engine's bundle carries ``key = zeros(2, uint32)`` and
    ``temp = 0.0``."""
    seq_id: int
    prompt: np.ndarray       # THIS admission's (possibly resume) prompt
    out: list                # tokens emitted so far (prefix included)
    prefix: list             # tokens emitted before THIS admission
    budget: int
    pos: int
    limit: int
    token: int               # current device token (== out[-1])
    key: np.ndarray          # (2,) uint32 sampler key
    temp: float              # effective per-row temperature
    temp_override: float | None
    priority: int
    deadline_s: float | None
    t_submit: float
    t_first: float | None
    preemptions: int
    n_pages: int
    page_size: int
    pages_payload: dict
    seq: int = -1            # plane-assigned migration sequence number
    #: the admission rung (bucket-padded length) the row prefilled at
    rung: int = 0
    #: leading tokens whose pages hold pure-prompt K/V (page-aligned)
    prefix_len: int = 0
    #: how the payload reached the installing replica: "local",
    #: "device_put", "dma" (comm/migration_dma.py) or "wire"
    transport: str = "local"
    #: request-lifecycle segments carried across the handoff
    #: (``harness/reqtrace.py``; None when the donor traced nothing)
    segments: tuple | None = None


@dataclass
class _Slot:
    seq_id: int = -1
    pages: list = field(default_factory=list)
    prompt_len: int = 0
    budget: int = 0
    out: list = field(default_factory=list)
    active: bool = False
    t_submit: float = 0.0
    first_dev: torch.Tensor | None = None  # pending first-token readback
    prompt: np.ndarray | None = None  # THIS admission's unpadded prompt
    priority: int = 0
    deadline_s: float | None = None
    temp_override: float | None = None  # the request's own temperature
    prefix: list = field(default_factory=list)  # tokens before admission
    padded_len: int = 0      # the admission rung this row prefilled at
    t_admit: float = 0.0     # host clock at admission / install
    t_dispatch: object = None  # the admission's open device window
    #: a draft row resumed with its last token as the pending one (no
    #: first-token pick at admission)
    resumed_cur: bool = False
    shared_pages: int = 0    # leading table entries mapped SHARED


def _chunk_step(params, cache, pos, limit, tokens, keys, temps, *, cfg,
                chunk, eos_id, greedy, top_k, mesh=None):
    """``chunk`` ragged decode steps, all enqueued without a host sync:
    rows advance while ``pos < limit``; an emitted ``eos_id`` (>= 0)
    pulls the row's limit to its current end. ``greedy`` picks the
    argmax; otherwise each row draws the token at ``pos + 1`` from its
    own key (``keys`` (B, 2)) at its own temperature (``temps`` (B,)) —
    the draw :func:`~hpc_patterns_tpu_torch.models.decode.paged_generate`
    makes at that position, so nothing advances on an inactive step.
    ``mesh``: tp serving on pools made for it. Returns (pos, limit,
    tokens, out (chunk, B) int32); the cache is updated in place."""
    if not greedy:
        # the chunk's noise in one pass: step j of an active row draws at
        # pos + 1 + j (an idle row's draw is discarded)
        steps = torch.arange(1, chunk + 1, device=pos.device)[:, None]
        noise = gumbel_noise(keys, pos[None].long() + steps, cfg.vocab)
    outs = []
    for j in range(chunk):
        active = pos < limit
        logits = paged_decode_step(params, cache, pos, tokens, cfg,
                                   mesh=mesh)
        pick = (_pick(logits) if greedy
                else _pick(logits, temps, top_k, keys, pos + 1, noise[j]))
        nxt = torch.where(active, pick, tokens)
        if eos_id >= 0:
            limit = torch.where(active & (nxt == eos_id),
                                torch.minimum(limit, pos + 1), limit)
        pos = torch.where(active, pos + 1, pos)
        tokens = nxt
        outs.append(nxt)
    return pos, limit, tokens, torch.stack(outs)


def _chunk_step_rows(params, cache, pos, limit, tokens, keys, temps, rows,
                     pages: int, **kw):
    """:func:`_chunk_step` over the listed ``rows`` and the first ``pages``
    columns of their tables: every other row is idle (``pos >= limit``),
    keeps its cursors and emits its current token, as in the full step,
    and no listed row reaches a later page within the chunk. Returns what
    ``_chunk_step`` returns, over all rows."""
    idx = torch.tensor(rows, device=pos.device)
    sub = dict(cache, table=cache["table"][idx, :pages])
    p, lim, tok, o = _chunk_step(params, sub, pos[idx], limit[idx],
                                 tokens[idx], keys[idx], temps[idx], **kw)
    out = tokens.expand(o.shape[0], -1).clone()
    out[:, idx] = o
    pos, limit, tokens = pos.clone(), limit.clone(), tokens.clone()
    pos[idx], limit[idx], tokens[idx] = p, lim, tok
    return pos, limit, tokens, out


def _furthest(pos, rows) -> int:
    """The furthest cursor of the listed rows, on the CPU branch of the
    dispatch (``pos`` a host tensor: nothing is read back)."""
    return int(pos[rows].max())


def _spec_chunk(params, dparams, cache, dcache, pos, limit, cur, streams,
                temps, *, cfg, dcfg, gamma, rounds, eos_id, greedy, top_k,
                mesh=None):
    """``rounds`` draft-assisted rounds, all enqueued without a host sync
    (JAX ``serving.py:458-519``): each round is ``paged_round`` at each
    row's cursor; a row advances ``min(a + 1, limit - pos)`` tokens, cut
    after an emitted ``eos_id`` (>= 0), which also pulls its limit to its
    new end. A row at its limit steps at a cursor clamped to 0 (its
    garbage lands in its own first page or the trash page) and advances
    nothing. ``streams``: ``spec_streams`` of the rows' keys (None when
    greedy); ``temps`` (B,); ``mesh``: tp rounds on caches made for it.
    Returns (pos, limit, cur, out (rounds, B,
    gamma + 3) int32): a round's tokens (gamma + 1), then its advance and
    its accepted count (0 for an idle row). The caches are updated in
    place."""
    k = torch.arange(gamma + 1, device=pos.device)[None, :]
    outs = []
    for _ in range(rounds):
        active = pos < limit
        pos_eff = torch.where(active, pos, 0)
        a, emit = paged_round(params, cfg, dparams, dcfg, cache, dcache,
                              pos_eff, cur, gamma, streams, greedy, top_k,
                              temps, mesh=mesh)
        adv = torch.where(active, torch.minimum(a + 1, limit - pos), 0)
        if eos_id >= 0:
            is_eos = (emit == eos_id) & (k < adv[:, None])
            has = is_eos.any(dim=1)
            first = is_eos.to(torch.int32).argmax(dim=1).to(torch.int32)
            adv = torch.where(has, first + 1, adv)
        new_cur = emit.gather(1, (adv - 1).clamp(0, gamma).long()[:, None])
        cur = torch.where(adv > 0, new_cur[:, 0], cur)
        pos = pos + adv
        if eos_id >= 0:
            limit = torch.where(has, pos, limit)
        outs.append(torch.cat([emit, adv[:, None],
                               torch.where(adv > 0, a, 0)[:, None]], dim=1))
    return pos, limit, cur, torch.stack(outs)


class EngineCore:
    """Serve :class:`Request`s through ``slots`` concurrent rows of one
    paged pool — the engine core shared by :class:`ContinuousBatcher`
    and the serving plane's replicas. ``pool_pages``: the shared arena
    (one trash page is appended). ``pages_per_seq``: table width.
    ``chunk``: decode steps per dispatch (admission granularity).
    ``prompt_buckets``: the prompt ladder (None = exact lengths).
    ``overlap``: dispatch the decode chunk BEFORE the round's admissions
    (False: admit, then decode — the measurable baseline).
    ``temperature``/``top_k``/``seed``: sampling (temperature <= 0 is
    greedy); per-request ``temperature``/``key`` at :meth:`submit`.
    ``preempt``: evict strictly lower classes when the most urgent
    waiting request cannot get pages. ``admit_highwater``: the fraction
    of the pool FRESH admissions may fill (1.0 = off; resumes and
    migrations bypass it). ``slo``: ``{priority: harness.slo.
    SLOTarget}`` — each :meth:`ContinuousBatcher.run` then leaves its
    attainment rollup in ``last_slo``. ``emit``: a ``**record``
    callable receiving the engine's records (None = silent).
    ``draft_params``/``draft_cfg``/``gamma``: draft-assisted rounds,
    ``gamma`` proposals a round (``chunk`` rounds a dispatch).
    ``residency``: a ``memory.ResidencyManager`` — tiered HBM <-> host
    paging (the module docstring); bound to this engine's device.
    ``prefix_cache``: the sharing-aware arena (radix index, refcounted
    pages, tail-only prefill). ``mesh``: tp-sharded serving (the module
    docstring; a draft must shard over the same tp). ``device``: default
    ``cuda`` (raises without a GPU unless ``device="cpu"``); params must
    live there."""

    def __init__(self, params, cfg: TransformerConfig, *, slots: int,
                 pool_pages: int, pages_per_seq: int, page_size: int,
                 chunk: int = 8, eos_id: int | None = None,
                 prompt_buckets=None, device=None, slo=None, emit=None,
                 overlap: bool = True, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, preempt: bool = False,
                 admit_highwater: float = 1.0, residency=None,
                 prefix_cache: bool = False, draft_params=None,
                 draft_cfg: TransformerConfig | None = None, gamma: int = 4,
                 mesh=None):
        if cfg.n_experts:
            raise ValueError("continuous batching: dense models only")
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError("draft/target vocab mismatch")
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            if draft_cfg.n_experts:
                raise ValueError("continuous batching: dense models only")
        if slots < 1 or chunk < 1:
            raise ValueError(f"need slots >= 1 and chunk >= 1, got "
                             f"{slots}/{chunk}")
        if not 0 <= top_k <= cfg.vocab:
            raise ValueError(f"top_k {top_k} outside [0, vocab]")
        if not 0.0 < admit_highwater <= 1.0:
            raise ValueError(
                f"admit_highwater must be in (0, 1], got {admit_highwater}")
        if prompt_buckets is not None:
            rungs = tuple(sorted({int(b) for b in prompt_buckets}))
            if not rungs or rungs[0] < 1:
                raise ValueError(
                    f"prompt_buckets must be positive ints, {rungs}")
            if rungs[-1] > cfg.max_seq:
                raise ValueError(
                    f"bucket rung {rungs[-1]} exceeds max_seq "
                    f"{cfg.max_seq} (padded prompts must still fit)")
            prompt_buckets = rungs
        if prefix_cache:
            # the sharing arena's byte-exactness preconditions: rung-keyed
            # chains need a ladder; row-stable GEMMs need aligned rungs and
            # pages; the tail prefill mirrors the plain attention route and
            # attends to exact (not re-quantized) prefix K/V
            if draft_params is not None:
                raise ValueError(
                    "prefix sharing does not compose with draft-assisted "
                    "serving: the draft cache's pages would need their own "
                    "refcounted sharing tier")
            if cfg.kv_cache_dtype != "compute":
                raise ValueError(
                    f"prefix sharing needs exact KV pages but "
                    f"kv_cache_dtype={cfg.kv_cache_dtype!r}: the monolithic "
                    "prefill attends to unquantized K/V and quantizes only "
                    "for storage, so a tail computed from dequantized shared "
                    "pages could not be bit-identical to it — serve "
                    "quantized KV with prefix_cache=False")
            if prompt_buckets is None:
                raise ValueError(
                    "prefix sharing is RUNG-KEYED (prefix K/V bytes depend "
                    "on the prefill row count): pass prompt_buckets so "
                    "admissions land on shared rungs")
            if page_size % PREFIX_ALIGN or any(
                    r % PREFIX_ALIGN for r in prompt_buckets):
                raise ValueError(
                    f"prefix sharing needs page_size {page_size} and every "
                    f"rung {prompt_buckets} aligned to {PREFIX_ALIGN} "
                    "(bitwise GEMM row stability — decode.PREFIX_ALIGN)")
            if cfg.decode_attn == "flash" and any(
                    r % 128 == 0 for r in prompt_buckets):
                raise ValueError(
                    "prefix sharing mirrors the plain prefill route; a "
                    "flash-attn config with 128-multiple rungs would send "
                    "monolithic prefills through kernel 1 instead — use "
                    "off-multiple rungs or decode_attn='gather'")
        if residency is not None and draft_params is not None:
            raise ValueError(
                "draft-assisted engines do not page: the draft cache's row "
                "state would have to tier too")
        self.device = resolve_device(device)
        #: the checked mesh; the params (and a draft's) as their tp shards
        self.mesh = logical_mesh(mesh, cfg)
        if shards_params(self.mesh, cfg):
            params = shard_params(params, self.mesh, cfg)
            if draft_params is not None:
                draft_params = shard_params(draft_params, self.mesh,
                                            draft_cfg)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.chunk = chunk
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.prompt_buckets = prompt_buckets
        self.slo = slo
        self.overlap = bool(overlap)
        self.preempt = bool(preempt)
        self.admit_highwater = float(admit_highwater)
        #: the sampling mode (the router checks replicas agree on these)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.greedy = self.temperature <= 0.0
        self.seed = int(seed)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.gamma = int(gamma)
        self.spec = draft_params is not None
        # speculative rounds touch positions up to pos + gamma; the page
        # allocation (not max_seq) must cover the overshoot
        self.spec_slack = self.gamma + 1 if self.spec else 0
        self.trash = pool_pages  # the appended trash page's id
        self.pool_pages = pool_pages
        self._table = np.full((slots, pages_per_seq), self.trash, np.int32)
        self.cache = init_paged_cache(
            cfg, slots, pages_per_seq, page_size,
            pool_pages=pool_pages + 1, table=self._table,
            device=self.device, mesh=self.mesh)
        if self.spec:
            # the draft pool mirrors the target's page geometry and SHARES
            # its page table (one allocation serves both caches)
            self.dcache = init_paged_cache(
                draft_cfg, slots, pages_per_seq, page_size,
                pool_pages=pool_pages + 1, table=self._table,
                device=self.device, mesh=self.mesh)
            self.dcache["table"] = self.cache["table"]
        self.free_pages = list(range(pool_pages))
        z = dict(dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((slots,), **z)
        self.limit = torch.zeros((slots,), **z)
        self.tokens = torch.zeros((slots,), **z)
        #: per-row sampler keys (uint32 words in int64 lanes) and
        #: temperatures; a greedy engine never reads or writes them
        self.keys = torch.zeros((slots, 2), dtype=torch.int64,
                                device=self.device)
        self.temps = torch.ones((slots,), dtype=torch.float32,
                                device=self.device)
        self._slots = [_Slot() for _ in range(slots)]
        self._pending: list[int] = []  # admitted, first token unread
        self._queue: list[Request] = []
        self.finished: dict[int, np.ndarray] = {}
        self._next_id = 0
        #: per-request outcome table (``harness/slo.py``'s input), keyed
        #: by seq_id: priority, t_submit, t_first, t_finish, tokens,
        #: outcome ("ok" | "shed" | "migrated"), preemptions, token_ts
        #: (host instants each token became available)
        self.stats: dict[int, dict] = {}
        self.last_slo: dict | None = None  # attainment of the last run
        self._serve_s = 0.0  # cumulative run() wall time (goodput base)
        #: host-clock (dispatch, readback) stamps of decode chunks: the
        #: serving plane intersects migration windows with them; off on
        #: the single-process path (the plane turns it on for decode
        #: replicas)
        self.track_chunk_windows = False
        self.chunk_windows: deque = deque(maxlen=8192)
        #: ragged decode steps dispatched (``chunk`` per dispatch) and
        #: admissions (one prefill each, resumes included) — what kernel
        #: launch counts are checked against; a draft engine counts its
        #: rounds (``chunk`` per dispatch, ``gamma + 1`` draft steps each)
        #: and, over the rows a round advanced, their row-rounds, tokens
        #: and accepted proposals
        self.decode_steps = 0
        self.admissions = 0
        self.spec_rounds = 0
        self.spec_stats = {"row_rounds": 0, "tokens": 0, "accepted": 0}
        #: the distinct padded prefill lengths admitted (the shapes a JAX
        #: engine compiles one prefill for; bounded by the ladder)
        self.prefill_rungs: set[int] = set()
        #: admission host time with nothing in flight over the last
        #: run's wall time (the admission bubble)
        self.last_bubble_frac = 0.0
        # the sharing-aware arena: a radix index over admitted prompts and
        # per-page refcounts — a page is owned by every row whose table
        # maps it AND by the cache chain that indexes it; release paths
        # decref and a page returns to free_pages only at refcount 0
        self._prefix = RadixPrefixCache(page_size) if prefix_cache \
            else None
        self._page_refs: dict[int, int] = {}
        self._match_memo: tuple | None = None
        self._prefill_skip_tokens = 0
        self._prefill_total_tokens = 0
        # tiered residency: the pool as a cache over the manager's host
        # tier — admission consults the manager instead of failing at
        # free_pages == 0; cold rows page out at chunk boundaries and page
        # back in with the pull dispatched before the decode chunk
        self.residency = residency
        self._swapped: dict[int, MigrationBundle] = {}
        #: pulls in flight: (host bundle, device payload, pull handle)
        self._prefetching: list[tuple] = []
        #: installed this round, window completion pending
        self._installed_prefetch: list[tuple] = []
        self._external_demand = 0  # router-signaled install pressure
        #: host-clock (dispatch start, readback) of the decode chunks: the
        #: windows a pull's overlap is folded against
        self._compute_windows: deque = deque(maxlen=8192)
        self._page_nbytes = 0
        if residency is not None:
            residency.bind_device(self.device)
            # per-page payload bytes (every non-table pool, all layers):
            # the manager's block accounting unit
            self._page_nbytes = sum(
                arr.numel() * arr.element_size() // (pool_pages + 1)
                for name, pools in self.cache.items() if name != "table"
                for arr in pools)
        self._emit = emit or (lambda **kw: None)

    # -- admission ---------------------------------------------------------

    @classmethod
    def from_fitted(cls, params, cfg: TransformerConfig, fitted, **kw):
        """Build an engine from a :mod:`hpc_patterns_tpu_torch.harness.
        autofit` ``FittedConfig`` (the dict ``autofit.load_fitted``
        returns): the fitted prompt ladder becomes ``prompt_buckets``
        (clamped to this model's ``max_seq``), everything else passes
        through unchanged. An explicit ``prompt_buckets=`` wins."""
        from hpc_patterns_tpu_torch.harness import autofit as autofitlib

        fitted = autofitlib.validate_fitted(fitted)
        if kw.get("prompt_buckets") is None:
            buckets = autofitlib.ladder_from(fitted, max_seq=cfg.max_seq)
            if buckets is not None:
                kw["prompt_buckets"] = buckets
        return cls(params, cfg, **kw)

    @staticmethod
    def pages_needed(prompt_len: int, max_new: int, page_size: int, *,
                     gamma: int | None = None,
                     padded_len: int | None = None) -> int:
        """Pages one request holds: prompt + budget, plus the speculative
        overshoot slack (gamma + 1) when a draft serves, or the
        bucket-padded prefill length if that reaches further — THE sizing
        rule; callers sizing their own pools (serve_app) use it."""
        slack = (gamma + 1) if gamma is not None else 0
        span = max(prompt_len + max_new + slack, padded_len or 0)
        return -(-span // page_size)

    def _bucket_len(self, prompt_len: int) -> int:
        return pad_to_bucket(self.prompt_buckets, prompt_len)

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        return self.pages_needed(prompt_len, max_new, self.page_size,
                                 gamma=self.gamma if self.spec else None,
                                 padded_len=self._bucket_len(prompt_len))

    def _known(self, sid: int) -> bool:
        return (sid in self.finished
                or any(r.seq_id == sid for r in self._queue)
                or sid in self._swapped
                or any(b.seq_id == sid for b, _, _ in self._prefetching)
                or any(s.active and s.seq_id == sid for s in self._slots))

    # -- the sharing-aware arena (refcounted pages + radix index) ----------

    def _alloc_pages(self, n: int) -> list[int]:
        """Take ``n`` pages from the free list at refcount 1 (the caller
        checked capacity)."""
        pages = [self.free_pages.pop() for _ in range(n)]
        if self._prefix is not None:
            for p in pages:
                self._page_refs[p] = 1
        return pages

    def _incref_pages(self, pages) -> None:
        for p in pages:
            self._page_refs[p] += 1

    def _decref_pages(self, pages) -> None:
        """THE release path: drop one reference per page, freeing only at
        zero — completion, preemption, migration-out, swap-out and cache
        eviction all come here, so a page another row (or the index)
        still maps is never handed out twice. Without a cache: the plain
        free-list append."""
        if self._prefix is None:
            self.free_pages.extend(pages)
            return
        for p in pages:
            r = self._page_refs[p] - 1
            if r:
                self._page_refs[p] = r
            else:
                del self._page_refs[p]
                self.free_pages.append(p)

    def _prefix_match(self, prompt) -> list[int]:
        """Longest cached chain for ``prompt`` at ITS rung, capped at
        ``(T - 1) // page_size`` pages so the tail keeps the last true
        token (the first-token logits are computed, never looked up). A
        pure peek: no LRU touch, no hit/miss accounting."""
        if self._prefix is None:
            return []
        T = int(prompt.size)
        return self._prefix.match(
            prompt, self._bucket_len(T),
            max_pages=(T - 1) // self.page_size, touch=False)

    def _memo_match(self, req: Request) -> list[int]:
        """:meth:`_prefix_match` with a one-round, one-entry memo keyed by
        request identity (the queue head is sized up to three times a
        round: preemption, residency balance, admission), cleared at
        :meth:`service_round` entry."""
        memo = self._match_memo
        if memo is not None and memo[0] is req:
            return memo[1]
        chain = self._prefix_match(req.prompt)
        self._match_memo = (req, chain)
        return chain

    def _request_need(self, req: Request) -> int:
        """PRIVATE pages this request needs now: the sizing rule minus what
        a prefix match would map shared."""
        need = self._pages_for(req.prompt.size, req.max_new)
        if self._prefix is not None:
            need -= len(self._memo_match(req))
        return need

    def _insert_prefix(self, prompt, rung: int, pages) -> None:
        """Publish an admission's full-prompt pages (``[0, T //
        page_size)``, pure-prompt K/V computed at ``rung``) into the
        index; newly indexed pages take the cache's own reference."""
        if self._prefix is None:
            return
        n_full = int(prompt.size) // self.page_size
        if n_full:
            self._incref_pages(
                self._prefix.insert(prompt, rung, pages[:n_full]))

    def _reclaim_cache_pages(self, need: int, fresh: bool,
                             keep=()) -> int:
        """Free LRU cache-only pages (refcount 1: no row maps them) until a
        ``need``-page request could admit — the raw free count and, for a
        fresh one, the high-water mark. ``keep``: the request's own
        matched chain (evicting it would grow its need by as much).
        Partial progress is kept."""
        if self._prefix is None:
            return 0
        reserved = self._reserved_prefetch_pages()
        shortfall = need - (len(self.free_pages) - reserved)
        if fresh:
            used = self.pool_pages - len(self.free_pages) + reserved
            hw_cap = self.admit_highwater * self.pool_pages
            shortfall = max(shortfall, math.ceil(used + need - hw_cap))
        if shortfall <= 0:
            return 0
        kept = set(keep)
        freed = self._prefix.evict(
            shortfall,
            lambda p: p not in kept and self._page_refs.get(p, 0) == 1)
        self._decref_pages(freed)
        return len(freed)

    def _row_swappable(self, slot: int) -> bool:
        """May the residency manager page this row out? Not while another
        row maps any of its pages (refcount >= 2 net of the cache's own
        reference); cache-only references do not block — those pages
        stay resident and shareable while the row's private pages move."""
        if self._prefix is None:
            return True
        for p in self._slots[slot].pages:
            if (self._page_refs.get(p, 0)
                    - (1 if self._prefix.has_page(p) else 0)) >= 2:
                return False
        return True

    @property
    def prefill_skip_frac(self) -> float:
        """Fraction of admitted prompt tokens whose prefill a prefix match
        skipped (``serve.prefill_skip_frac``)."""
        if not self._prefill_total_tokens:
            return 0.0
        return self._prefill_skip_tokens / self._prefill_total_tokens

    def release_prefix_cache(self) -> None:
        """Drop every cached chain and return cache-only pages to the arena
        (rows keep their own references)."""
        if self._prefix is not None:
            self._decref_pages(self._prefix.clear())

    def request_key(self, seq_id: int) -> np.ndarray:
        """The sampler key (2,) uint32 a default (key=None) submit gets:
        the standalone-reproduction handle. A sampled row's served
        tokens equal ``paged_generate(prompt, budget,
        key=request_key(sid), temperature=engine.temperature,
        top_k=engine.top_k)``'s."""
        return sample_key(self.seed, seq_id)

    def submit(self, prompt, max_new: int, seq_id: int | None = None, *,
               temperature: float | None = None, key=None,
               priority: int = 0, deadline_s: float | None = None,
               resume_prefix=None) -> int:
        """Enqueue a sequence; returns its id. Tokens appear in
        ``finished[id]`` once served. ``temperature``/``key``: per-row
        sampling overrides (sampling engines only; ``key`` (2,) uint32
        defaults to :meth:`request_key`). ``priority``: lower = more
        important (with ``preempt=True`` it may evict numerically
        higher classes under page pressure). ``deadline_s``: shed the
        request (empty output, outcome ``"shed"``) if still queued this
        long after submit. ``resume_prefix``: tokens this request
        already emitted elsewhere — ``prompt`` must then be the original
        prompt plus those tokens, and the engine prepends them to the
        output."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be 1-D nonempty, {prompt.shape}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if key is not None and self.greedy:
            raise ValueError(
                "per-request key needs a sampling engine (construct with "
                "temperature > 0); a greedy engine never reads keys and "
                "would silently ignore it")
        if temperature is not None:
            if self.greedy:
                raise ValueError(
                    "per-request temperature needs a sampling engine "
                    "(construct with temperature > 0); a greedy engine "
                    "runs the argmax path only")
            if temperature <= 0.0:
                raise ValueError(f"per-request temperature must be > 0, "
                                 f"got {temperature}")
        if key is not None:
            key = np.asarray(key, np.uint32).copy()
            if key.shape != (2,):
                raise ValueError(f"key must be (2,) uint32, got "
                                 f"{key.shape}")
        padded = self._bucket_len(int(prompt.size))  # raises off-ladder
        need = self._pages_for(prompt.size, max_new)
        if need > min(self.pages_per_seq, self.pool_pages):
            raise ValueError(
                f"prompt {prompt.size} + budget {max_new} (bucket pad "
                f"{padded}) needs {need} pages > pages_per_seq "
                f"{self.pages_per_seq} or pool {self.pool_pages}")
        if max(prompt.size + max_new, padded) > self.cfg.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + budget {max_new} (bucket pad "
                f"{padded}) exceeds max_seq {self.cfg.max_seq}")
        sid = self._next_id if seq_id is None else seq_id
        if self._known(sid):
            raise ValueError(f"seq_id {sid} already queued/active/finished")
        if resume_prefix is not None:
            resume_prefix = np.asarray(resume_prefix, np.int32)
            if resume_prefix.size > prompt.size:
                raise ValueError(
                    f"resume_prefix ({resume_prefix.size} tokens) longer "
                    f"than the prompt ({prompt.size}) that must carry it")
        self._next_id = max(self._next_id, sid) + 1
        now = time.perf_counter()
        self._queue.append(Request(prompt, max_new, sid, t_submit=now,
                                   temperature=temperature, key=key,
                                   priority=int(priority),
                                   deadline_s=deadline_s,
                                   resume_prefix=resume_prefix))
        self.stats[sid] = {"priority": int(priority), "t_submit": now,
                           "t_first": None, "t_finish": None, "tokens": 0,
                           "outcome": None, "preemptions": 0,
                           "token_ts": []}
        rtr = reqtracelib.active()
        if rtr is not None:
            rtr.begin_request(sid, now)
        m = metricslib.get_metrics()
        if m.enabled:
            m.gauge("serve.queue_depth").set(len(self._queue))
        return sid

    def _queue_order(self) -> list[int]:
        """Queue indices in admission order: priority class first (lower
        number = more important), resumes before fresh arrivals within a
        class, FCFS within that."""
        return sorted(
            range(len(self._queue)),
            key=lambda qi: (self._queue[qi].priority,
                            self._queue[qi].resume_prefix is None, qi))

    def _shed_expired(self) -> None:
        """Drop queued FRESH requests whose ``deadline_s`` expired: empty
        output, outcome ``"shed"`` (resumes are exempt — their tokens are
        already paid for). Host bookkeeping only."""
        if not any(r.deadline_s is not None and r.resume_prefix is None
                   for r in self._queue):
            return
        now = time.perf_counter()
        kept = []
        for req in self._queue:
            if (req.deadline_s is None or req.resume_prefix is not None
                    or now - req.t_submit <= req.deadline_s):
                kept.append(req)
                continue
            self.finished[req.seq_id] = np.zeros((0,), np.int32)
            rec = self.stats.get(req.seq_id)
            if rec is not None:
                rec["outcome"] = "shed"
                rec["t_finish"] = now
            rtr = reqtracelib.active()
            if rtr is not None:
                rtr.finish_request(req.seq_id, now, final="shed")
            self._emit(kind="serve_shed", seq_id=req.seq_id,
                       priority=req.priority, waited_s=now - req.t_submit,
                       deadline_s=req.deadline_s)
            m = metricslib.get_metrics()
            if m.enabled:
                m.counter("serve.shed").inc()
        self._queue = kept
        m = metricslib.get_metrics()
        if m.enabled:
            m.gauge("serve.queue_depth").set(len(self._queue))

    def _try_admit(self, overlapped: bool = False) -> int:
        """One admission pass per round: shed, then walk the queue in
        :meth:`_queue_order`, admitting every request that fits (a large
        request does not block a small one behind it; fresh admissions
        stay under ``admit_highwater``, resumes bypass it).
        ``overlapped``: a decode chunk is in flight. Returns the number
        admitted."""
        self._shed_expired()
        # one pass-start stamp: every request seated this round closes
        # its queued segment here
        t_pass = (time.perf_counter()
                  if reqtracelib.active() is not None else None)
        admitted = 0
        for req in [self._queue[qi] for qi in self._queue_order()]:
            free_slot = next(
                (i for i, s in enumerate(self._slots) if not s.active), None)
            if free_slot is None:
                break
            fresh = req.resume_prefix is None
            need = self._pages_for(req.prompt.size, req.max_new)
            # PRIVATE pages only: a prefix match maps the rest shared;
            # cache-only pages are reclaimed LRU first when the request
            # would not fit (never its own matched chain). With sharing
            # the one sorted walk is one-round approximate: a request
            # skipped earlier waits for the next round's pass
            chain = self._memo_match(req)
            if self._prefix is not None:
                self._reclaim_cache_pages(need - len(chain), fresh,
                                          keep=chain)
            # ONE admissibility definition: the policy _maybe_preempt
            # predicts with must be the one applied here
            if not self._admissible(need - len(chain), fresh=fresh):
                continue
            # identity removal: Request holds an ndarray, so == is not
            # a usable comparison
            self._queue = [r for r in self._queue if r is not req]
            self._admit(free_slot, req, need, overlapped, t_pass,
                        chain=chain)
            admitted += 1
        return admitted

    def _seat(self, slot: int, pages: list) -> np.ndarray:
        """Point ``slot``'s table row at ``pages`` (trash beyond) and
        upload the table. Returns the row."""
        row = np.full((self.pages_per_seq,), self.trash, np.int32)
        row[:len(pages)] = pages
        self._table[slot] = row
        self.cache["table"] = _upload(self._table.copy(), self.device)
        if self.spec:
            self.dcache["table"] = self.cache["table"]
        return row

    def _admit(self, slot: int, req: Request, need: int,
               overlapped: bool = False, t_pass: float | None = None,
               chain: list[int] | None = None):
        """Dispatch-only admission: table upload, one-row bucket-padded
        prefill through the shared pool, first-token pick and cursor
        seeding all enqueue without a host readback. With a flight
        recorder all of it lies in one device window on track
        ``slot + 1``, closed by the first-token readback.

        Sharing-aware (``prefix_cache=True``): ``chain``, the cached
        chain the caller's admissibility math walked, maps read-only into
        the row's leading table entries (incref, no bytes move), private
        pages are allocated for the rest, and the prefill computes only
        the tail (``decode.paged_tail_prefill``)."""
        rec = tracelib.active()
        window = rec.open_window(self.device) if rec is not None else None
        if chain is None:
            chain = self._prefix_match(req.prompt)
        m = len(chain)
        if self._prefix is not None:
            self._prefix.count_match(m)
        self._incref_pages(chain)
        pages = list(chain) + self._alloc_pages(need - m)
        if self.residency is not None:
            self.residency.register_group(
                req.seq_id, need, need * self._page_nbytes, tier="hbm",
                priority=req.priority)
        row = self._seat(slot, pages)
        # a resumed draft row prefills all but its last token, which stays
        # pending (cur): its next round starts where an uninterrupted
        # run's would, so its sampled draws are the same
        resumed_cur = self.spec and req.resume_prefix is not None
        T = int(req.prompt.size) - resumed_cur
        padded = self._bucket_len(T)
        prompt = np.zeros((padded,), np.int32)
        prompt[:T] = req.prompt[:T]  # pad K/V is cursor-masked garbage
        prompt_dev = _upload(prompt, self.device)[None, :]
        # the shared pools (scale pools too, for a one-byte cache) under
        # this row's own one-row table
        one = dict(self.cache)
        one["table"] = _upload(row[None, :].copy(), self.device)
        M = m * self.page_size
        if m:
            # tail-only prefill: positions [M, padded) against the mapped
            # prefix pages; the matched span's compute and page writes are
            # skipped (the TTFT lever prefill_skip_frac measures)
            with metricslib.span("serve.prefill", prompt_len=T,
                                 padded_len=padded, matched=M), \
                    tracelib.compile_watch("serving._tail_prefill_one",
                                           padded_len=padded, matched=M):
                logits, _ = paged_tail_prefill(
                    self.params, prompt_dev[:, M:], self.cfg, one,
                    self.page_size, m, last_pos=T - 1 - M, mesh=self.mesh)
        else:
            with metricslib.span("serve.prefill", prompt_len=T,
                                 padded_len=padded), \
                    tracelib.compile_watch("serving._prefill_one",
                                           padded_len=padded):
                logits, _ = paged_prefill(self.params, prompt_dev, self.cfg,
                                          one, self.page_size,
                                          last_pos=T - 1, mesh=self.mesh)
        # publish this admission's full-prompt pages so the next same-rung
        # prompt shares them
        self._insert_prefix(req.prompt, padded, pages)
        self._prefill_total_tokens += T
        self._prefill_skip_tokens += M
        if self.spec:
            done = dict(self.dcache, table=one["table"])
            with tracelib.compile_watch("serving._prefill_one[draft]",
                                        padded_len=padded):
                paged_prefill(self.draft_params, prompt_dev, self.draft_cfg,
                              done, self.page_size, last_pos=T - 1,
                              mesh=self.mesh)
        if not self.greedy:
            # the row's key and temperature
            key = (req.key if req.key is not None
                   else self.request_key(req.seq_id))
            temp = max(req.temperature if req.temperature is not None
                       else self.temperature, 1e-6)
            self.keys[slot] = _as_keys(key, 1, self.device)[0]
            self.temps[slot].fill_(temp)
        if resumed_cur:
            first = torch.full((), int(req.prompt[-1]), dtype=torch.int32,
                               device=self.device)
        elif self.greedy:
            first = _pick(logits)[0]
        else:
            # the draw at position T — paged_generate's first pick
            first = _pick(logits, self.temps[slot:slot + 1], self.top_k,
                          self.keys[slot:slot + 1], T)[0]
        # budget b emits 1 token at admission + (limit - T) from chunks (a
        # resumed draft row emits none at admission)
        lim = torch.full((), T + req.max_new - 1 + resumed_cur,
                         dtype=torch.int32, device=self.device)
        if self.eos_id >= 0 and not resumed_cur:
            lim = torch.where(first == self.eos_id,
                              torch.full_like(lim, T), lim)
        self.pos[slot].fill_(T)  # a fill, not a host-to-device copy
        self.limit[slot] = lim
        self.tokens[slot] = first
        self._slots[slot] = _Slot(
            seq_id=req.seq_id, pages=pages, prompt_len=T,
            budget=req.max_new, active=True, t_submit=req.t_submit,
            first_dev=first, prompt=req.prompt, priority=req.priority,
            deadline_s=req.deadline_s, temp_override=req.temperature,
            prefix=([] if req.resume_prefix is None
                    else [int(t) for t in req.resume_prefix]),
            padded_len=padded, t_admit=time.perf_counter(),
            resumed_cur=resumed_cur, shared_pages=m)
        if rec is not None:
            # every admission op is enqueued: the first-token readback
            # in _resolve_pending closes the window
            self._slots[slot].t_dispatch = rec.mark_dispatch(
                "serve.admit", {"seq_id": req.seq_id, "slot": slot,
                                "padded_len": padded,
                                "overlapped": overlapped},
                track=slot + 1, window=window)
        self._pending.append(slot)
        self.admissions += 1
        self.prefill_rungs.add(padded)
        self._emit(kind="serve_admit", seq_id=req.seq_id, slot=slot,
                   pages=need, prompt_len=T, padded_len=padded,
                   budget=req.max_new, overlapped=overlapped,
                   free_pages=len(self.free_pages),
                   queued=len(self._queue), priority=req.priority,
                   resumed=req.resume_prefix is not None,
                   matched_tokens=M, shared_pages=m)
        mx = metricslib.get_metrics()
        if mx.enabled:
            mx.gauge("serve.queue_depth").set(len(self._queue))
            mx.gauge("serve.free_pages").set(len(self.free_pages))
            mx.counter("serve.admitted").inc()
            if overlapped:
                mx.counter("serve.admit_overlapped").inc()
            if m:
                mx.counter("serve.prefix_matched_pages").inc(m)
                mx.counter("serve.prefill_skip_tokens").inc(M)
        rtr = reqtracelib.active()
        if rtr is not None:
            # queued closed at the pass start; admit_wait covers the
            # host admission work, prefill runs to the first-token
            # readback
            st = self._slots[slot]
            rtr.stamp_transition(
                req.seq_id, "admit_wait",
                st.t_admit if t_pass is None else t_pass)
            rtr.stamp_transition(req.seq_id, "prefill")

    def _resolve_pending(self):
        """Read back the admissions' first tokens (the round's sync
        point), stamp time to first token, and finish rows done at
        admission (budget 1 or eos)."""
        for slot in self._pending:
            st = self._slots[slot]
            first = int(st.first_dev)
            st.first_dev = None
            # a resumed row re-opens with everything it already emitted (a
            # resumed draft row's first token is the last of those)
            st.out = list(st.prefix) + ([] if st.resumed_cur else [first])
            tr = tracelib.active()
            if tr is not None and st.t_dispatch:
                # the readback IS completion: prefill + first-token pick
                tr.mark_complete("serve.admit", st.t_dispatch,
                                 {"seq_id": st.seq_id, "slot": slot},
                                 track=slot + 1)
                st.t_dispatch = None
            now = time.perf_counter()
            rec = self.stats.get(st.seq_id)
            if rec is not None and rec["t_first"] is None:
                rec["t_first"] = now
            if rec is not None and not st.resumed_cur:
                # first-token availability (a resume stamps only its new
                # token: the prefix's stamps rode the earlier life)
                rec.setdefault("token_ts", []).append(now)
            rtr = reqtracelib.active()
            if rtr is not None:
                rtr.stamp_transition(st.seq_id, "decode", now)
            m = metricslib.get_metrics()
            if m.enabled and not st.prefix:
                # TTFT from submit (a resume keeps its first token time)
                ttft = now - (st.t_submit or now)
                m.histogram("serve.ttft_s").observe(ttft)
                if self.slo is not None:
                    m.histogram(
                        f"serve.ttft_s.p{st.priority}").observe(ttft)
            if not st.resumed_cur and (
                    (self.eos_id >= 0 and first == self.eos_id)
                    or st.budget == 1):
                self._finish(slot)
        self._pending.clear()

    # -- completion --------------------------------------------------------

    def _release_slot(self, slot: int):
        """Return a row's pages to the arena (decref: a page the index or
        another row still maps stays allocated), point its table row at
        the trash page and zero its cursors — the shared tail of
        completion, preemption, export and swap-out."""
        self._decref_pages(self._slots[slot].pages)
        self._seat(slot, [])
        self._slots[slot] = _Slot()
        self.pos[slot] = 0
        self.limit[slot] = 0

    def _residency_release(self, seq_id: int) -> None:
        """Drop a row's blocks from the residency accounting (it finished,
        was preempted back to the queue, or migrated away)."""
        if self.residency is not None:
            self.residency.release_group(seq_id)

    def _finish(self, slot: int):
        st = self._slots[slot]
        self._residency_release(st.seq_id)
        self.finished[st.seq_id] = np.asarray(st.out, np.int32)
        self._emit(kind="serve_finish", seq_id=st.seq_id, slot=slot,
                   tokens=len(st.out), pages_freed=len(st.pages))
        now = time.perf_counter()
        rec = self.stats.get(st.seq_id)
        if rec is not None:
            rec["t_finish"] = now
            rec["tokens"] = len(st.out)
            rec["outcome"] = "ok"
        rtr = reqtracelib.active()
        if rtr is not None:
            rtr.finish_request(st.seq_id, now)
        m = metricslib.get_metrics()
        if m.enabled:
            m.histogram("serve.per_token_s").observe(
                (now - st.t_admit) / max(1, len(st.out)))
            if self.slo is not None and rec is not None \
                    and rec["t_first"] is not None and len(st.out) > 1:
                m.histogram(f"serve.tpot_s.p{st.priority}").observe(
                    (now - rec["t_first"]) / (len(st.out) - 1))
            m.counter("serve.finished").inc()
            m.counter("serve.tokens").inc(len(st.out))
            # shared pages do not free with the row
            m.gauge("serve.free_pages").set(
                len(self.free_pages) + self._row_freeable_pages(slot))
        self._release_slot(slot)

    # -- preemption --------------------------------------------------------

    def _reserved_prefetch_pages(self) -> int:
        """Pages spoken for by pulls in flight (dispatched prefetches not
        yet installed): admissions and preemption must not take them."""
        return sum(b.n_pages for b, _, _ in self._prefetching)

    def _admissible(self, need: int, fresh: bool) -> bool:
        """Would a request needing ``need`` (private) pages admit right
        now? A free slot, the pages, and for a FRESH request the
        high-water mark — the checks :meth:`_try_admit` applies and
        :meth:`_maybe_preempt` predicts with. Slots and pages reserved
        for pulls in flight are not free, and count as USED for the
        high-water mark (the staged swap-in will occupy them)."""
        free_slots = sum(1 for s in self._slots if not s.active)
        if free_slots <= len(self._prefetching):
            return False
        reserved = self._reserved_prefetch_pages()
        if need > len(self.free_pages) - reserved:
            return False
        if fresh:
            used = self.pool_pages - len(self.free_pages) + reserved
            if used + need > self.admit_highwater * self.pool_pages:
                return False
        return True

    def _row_freeable_pages(self, slot: int) -> int:
        """Pages an eviction of this row would ACTUALLY free (refcount 1):
        the feasibility math must not count shared pages."""
        if self._prefix is None:
            return len(self._slots[slot].pages)
        return sum(1 for p in self._slots[slot].pages
                   if self._page_refs.get(p, 0) == 1)

    def _can_resume(self, slot: int) -> bool:
        """Is this active row safely evictable? Its resume request
        (prompt = this admission's prompt + the tokens generated since)
        must fit the ladder, the table width and the arena — a victim
        that could never re-admit must not be evicted."""
        st = self._slots[slot]
        if not st.active or slot in self._pending or st.prompt is None:
            return False
        emitted = len(st.out) - len(st.prefix)
        remaining = st.budget - emitted
        if remaining < 1:
            return False  # about to finish; nothing left to resume
        resumed_len = int(st.prompt.size) + emitted
        if self.prompt_buckets is not None \
                and resumed_len > max(self.prompt_buckets):
            return False
        pages = self._pages_for(resumed_len, remaining)
        return pages <= min(self.pages_per_seq, self.pool_pages)

    def _maybe_preempt(self):
        """Preemption policy, decision half (at a chunk boundary, nothing
        in flight): when the head of the admission order cannot be
        admitted for lack of pages, evict strictly-lower-priority victims
        — lowest class first, most recently admitted first within a class
        (least sunk latency) — until it fits or no eligible victim
        remains. Only the head is served per round (it stays the head
        until admitted, so nothing starves)."""
        # shed first: an expired request must not evict a victim only to
        # be dropped by the admission pass right after
        self._shed_expired()
        if not self._queue:
            return
        req = self._queue[self._queue_order()[0]]
        # private pages only: the head's match maps the rest shared
        chain = self._memo_match(req)
        need = self._pages_for(req.prompt.size, req.max_new) - len(chain)
        fresh = req.resume_prefix is None
        if self._prefix is not None:
            # cache-only pages are cheaper to free than a victim's
            # eviction and resume: reclaim first
            self._reclaim_cache_pages(need, fresh, keep=chain)
        if self._admissible(need, fresh):
            return  # ordinary admission takes it this round
        victims = [
            v for v in sorted(
                (i for i, s in enumerate(self._slots)
                 if s.active and s.priority > req.priority),
                key=lambda i: (-self._slots[i].priority,
                               -self._slots[i].t_admit))
            if self._can_resume(v)]
        # feasibility BEFORE the first eviction: would evicting EVERY
        # eligible victim admit the head? Pages held by non-victim rows
        # still count toward the fresh high-water cap, so a head they
        # keep over the mark must not trigger evictions — the victim's
        # resume bypasses the mark and re-admits the same round, and the
        # next round would evict it again: an evict/re-prefill thrash
        # loop while the head stays stuck regardless
        freeable = sum(self._row_freeable_pages(v) for v in victims)
        if need > len(self.free_pages) + freeable:
            return
        if fresh:
            used_after = self.pool_pages - len(self.free_pages) - freeable
            if used_after + need > self.admit_highwater * self.pool_pages:
                return
        for v in victims:
            if self._admissible(need, fresh):
                break
            self._preempt(v, for_sid=req.seq_id)

    def _preempt(self, slot: int, for_sid: int | None = None):
        """Evict one active row: its generated tokens and (sampled) its
        key go to the host, its pages back to the arena, and it re-queues
        as a RESUME whose prompt is this admission's prompt + the tokens
        generated since. The resume's prefill rebuilds exactly the
        uninterrupted cache (causality), and its draws are keyed by
        position, so its remaining tokens equal an uninterrupted run's.
        A deliberate sync point at a chunk boundary; ``tolist`` copies
        (a host view of ``keys`` would change under a later in-place
        admission write)."""
        st = self._slots[slot]
        new = st.out[len(st.prefix):]
        remaining = st.budget - len(new)
        key = (None if self.greedy else
               # torchlint: disable=host-sync-in-dispatch — eviction IS a
               # deliberate chunk-boundary sync: the key's copy rides the
               # resume request
               np.asarray(self.keys[slot].tolist(), np.uint32))
        prompt = (np.concatenate([st.prompt, np.asarray(new, np.int32)])
                  if new else st.prompt)
        req = Request(prompt, remaining, st.seq_id, t_submit=st.t_submit,
                      temperature=st.temp_override, key=key,
                      priority=st.priority, deadline_s=st.deadline_s,
                      resume_prefix=np.asarray(st.out, np.int32))
        rec = self.stats.get(st.seq_id)
        if rec is not None:
            rec["preemptions"] += 1
        rtr = reqtracelib.active()
        if rtr is not None:
            # decode closes; preempted spans the wait for re-admission
            rtr.stamp_transition(st.seq_id, "preempted")
        self._emit(kind="serve_preempt", seq_id=st.seq_id, slot=slot,
                   tokens_done=len(st.out), remaining=remaining,
                   pages_freed=len(st.pages), priority=st.priority,
                   for_seq_id=for_sid)
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("serve.preempted").inc()
            m.gauge("serve.free_pages").set(
                len(self.free_pages) + self._row_freeable_pages(slot))
        self._residency_release(st.seq_id)
        self._release_slot(slot)
        self._queue.append(req)
        if m.enabled:
            m.gauge("serve.queue_depth").set(len(self._queue))

    # -- the loop ----------------------------------------------------------

    def _dispatch_chunk(self):
        # the chunk's start cursors (nothing is in flight at a round
        # start) as a device COPY, read back with the chunk's tokens in
        # _collect_chunk: no readback here, and no view of self.pos,
        # which installs and completions write in place
        pos_start = self.pos.clone()
        parts = [i for i, s in enumerate(self._slots) if s.active]
        rec = tracelib.active()
        window = rec.open_window(self.device) if rec is not None else None
        with metricslib.span("serve.decode_dispatch", chunk=self.chunk), \
                tracelib.compile_watch("serving._chunk_step",
                                       chunk=self.chunk):
            kw = dict(cfg=self.cfg, chunk=self.chunk, eos_id=self.eos_id,
                      greedy=self.greedy, top_k=self.top_k, mesh=self.mesh)
            state = (self.params, self.cache, self.pos, self.limit,
                     self.tokens, self.keys, self.temps)
            # on the CPU a step's cost grows with its rows and pages, so
            # the idle rows and the pages no row reaches in this chunk
            # are left out (as the kernel's chunks past a fill exit); on
            # the card the step is bound by its launches and keeps its
            # fixed shape
            if self.device.type == "cpu":
                reach = _furthest(pos_start, parts) + self.chunk - 1
                self.pos, self.limit, self.tokens, out = _chunk_step_rows(
                    *state, parts, min(self.pages_per_seq,
                                       reach // self.page_size + 1), **kw)
            else:
                self.pos, self.limit, self.tokens, out = _chunk_step(
                    *state, **kw)
        self.decode_steps += self.chunk
        t_disp = (rec.mark_dispatch(
            "serve.chunk", {"chunk": self.chunk, "rows": len(parts)},
            window=window) if rec is not None else None)
        return parts, pos_start, out, t_disp

    def _collect_chunk(self, inflight):
        parts, pos_start, out, t_disp = inflight
        with metricslib.span("serve.decode_round", chunk=self.chunk):
            out = out.cpu().numpy()  # (chunk, slots); readback = sync
        pos_start = pos_start.cpu().numpy()
        rec = tracelib.active()
        if rec is not None and t_disp:
            # the readback resolved: the chunk's window is complete
            rec.mark_complete("serve.chunk", t_disp,
                              {"chunk": self.chunk, "rows": len(parts)})
        limit_new = self.limit.cpu().numpy()
        # the chunk's tokens all became host-visible at this readback:
        # one shared availability instant
        now = time.perf_counter()
        for i in parts:
            st = self._slots[i]
            if not st.active:
                continue
            valid = int(np.clip(limit_new[i] - pos_start[i], 0, self.chunk))
            st.out.extend(int(t) for t in out[:valid, i])
            rec_s = self.stats.get(st.seq_id)
            if rec_s is not None and valid:
                rec_s.setdefault("token_ts", []).extend([now] * valid)
            if pos_start[i] + valid >= limit_new[i]:
                self._finish(i)

    def _dispatch_spec(self):
        """``chunk`` draft-assisted rounds a dispatch (:func:`_spec_chunk`:
        budget and EOS truncation on the device between rounds, so an
        over-acceptance past a limit is dropped there). With a flight
        recorder the chunk is one device window on track 0."""
        parts = [i for i, s in enumerate(self._slots) if s.active]
        rec = tracelib.active()
        window = rec.open_window(self.device) if rec is not None else None
        with metricslib.span("serve.spec_dispatch", rounds=self.chunk,
                             gamma=self.gamma), \
                tracelib.compile_watch("serving._spec_chunk",
                                       rounds=self.chunk, gamma=self.gamma):
            self.pos, self.limit, self.tokens, out = _spec_chunk(
                self.params, self.draft_params, self.cache, self.dcache,
                self.pos, self.limit, self.tokens,
                None if self.greedy else spec_streams(self.keys),
                self.temps, cfg=self.cfg, dcfg=self.draft_cfg,
                gamma=self.gamma, rounds=self.chunk, eos_id=self.eos_id,
                greedy=self.greedy, top_k=self.top_k, mesh=self.mesh)
        self.spec_rounds += self.chunk
        t_disp = (rec.mark_dispatch(
            "serve.spec_chunk", {"rounds": self.chunk, "gamma": self.gamma,
                                 "rows": len(parts)}, window=window)
                  if rec is not None else None)
        return parts, out, t_disp

    def _collect_spec(self, inflight):
        parts, out, t_disp = inflight
        g1 = self.gamma + 1
        with metricslib.span("serve.spec_round", rounds=self.chunk,
                             gamma=self.gamma):
            out = out.cpu().numpy()  # (rounds, slots, gamma + 3); = sync
        rec = tracelib.active()
        if rec is not None and t_disp:
            rec.mark_complete("serve.spec_chunk", t_disp,
                              {"rounds": self.chunk, "rows": len(parts)})
        emits, advs, accs = out[..., :g1], out[..., g1], out[..., g1 + 1]
        self.spec_stats["row_rounds"] += int((advs > 0).sum())
        self.spec_stats["tokens"] += int(advs.sum())
        self.spec_stats["accepted"] += int(accs.sum())
        pos_np = self.pos.cpu().numpy()
        limit_np = self.limit.cpu().numpy()
        # the chunk's tokens all became host-visible at this readback
        now = time.perf_counter()
        for i in parts:
            st = self._slots[i]
            if not st.active:
                continue
            accepted = 0
            for r in range(advs.shape[0]):
                v = int(advs[r, i])
                if v:
                    st.out.extend(int(t) for t in emits[r, i, :v])
                    accepted += v
            rec_s = self.stats.get(st.seq_id)
            if rec_s is not None and accepted:
                rec_s.setdefault("token_ts", []).extend([now] * accepted)
            if pos_np[i] >= limit_np[i]:
                self._finish(i)

    def service_round(self, *, decode: bool = True, chaos_index=None,
                      pre_collect=None) -> dict:
        """ONE scheduler round: the chaos probe (``chaos_index``: this
        round's index at the ``engine_round`` site), the preemption
        policy, the decode chunk for the rows already running (first,
        with ``overlap``), admissions behind it, first-token readbacks,
        then the chunk's collection.

        ``decode=False`` is the prefill-role round: admissions run but no
        decode chunk is dispatched; admitted rows park at their first
        token for :meth:`export_migration`. ``pre_collect``: called with
        ``overlapped`` (True iff a decode chunk is in flight) after the
        admissions and before the chunk's readback — the plane installs
        arrived migrations there, so their device work enqueues behind
        the chunk. Returns ``{"admitted", "exposed_s" (admission host
        time with nothing in flight), "stalled" (requests wait, nothing
        admitted, nothing runs), "active"}``."""
        if chaos_index is not None and chaoslib.active() is not None:
            chaoslib.maybe_inject("engine_round", chaos_index)
        # fresh round, fresh head-match memo (its validity is one round's)
        self._match_memo = None
        if self.preempt:
            self._maybe_preempt()
        if self.residency is not None:
            self.residency.begin_round()
            for si, st in enumerate(self._slots):
                if st.active:
                    self.residency.touch_group(st.seq_id)
                    if self._prefix is not None:
                        # pin-while-shared: a row whose pages another row
                        # maps must not page out while that reader runs
                        self.residency.pin_group(
                            st.seq_id, not self._row_swappable(si))
            # pulls for swapped rows dispatch BEFORE the decode chunk: the
            # host -> HBM copies run on the side stream while the chunk
            # computes, and the install lands behind it (pre_collect)
            self._dispatch_prefetch()
        active = lambda: any(s.active for s in self._slots)  # noqa: E731
        dispatch = self._dispatch_spec if self.spec else self._dispatch_chunk
        collect = self._collect_spec if self.spec else self._collect_chunk
        inflight = None
        t_chunk0 = t_launch = 0.0
        if decode and self.overlap and active():
            t_launch = time.perf_counter()
            inflight = dispatch()
            t_chunk0 = time.perf_counter()
        t0 = time.perf_counter()
        admitted = self._try_admit(overlapped=inflight is not None)
        self._resolve_pending()
        exposed_s = 0.0
        stalled = False
        if inflight is None:
            exposed_s = time.perf_counter() - t0
            if decode and active():
                t_launch = time.perf_counter()
                inflight = dispatch()
                t_chunk0 = time.perf_counter()
            elif not active():
                stalled = (bool(self._queue) and not admitted
                           and not self._swapped and not self._prefetching)
        if self.residency is not None:
            self._install_prefetched(inflight is not None)
        if pre_collect is not None:
            pre_collect(inflight is not None)
        if inflight is not None:
            collect(inflight)
            t_end = time.perf_counter()
            if self.track_chunk_windows:
                self.chunk_windows.append((t_chunk0, t_end))
            if self.residency is not None:
                # the chunk computes while the host enqueues it (eager
                # launches), so the window a pull hides under starts at
                # the dispatch, not after it (JAX's one-call dispatch
                # returns at once and makes no difference there)
                self._compute_windows.append((t_launch, t_end))
        if self.residency is not None:
            # round boundary, nothing in flight: observe this round's
            # prefetch completions, then run the eviction policy
            self._complete_prefetches()
            self._residency_balance()
        return {"admitted": admitted, "exposed_s": exposed_s,
                "stalled": stalled, "active": active()}

    # -- load observables (what the router reads) --------------------------

    @property
    def free_page_count(self) -> int:
        return len(self.free_pages)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for s in self._slots if s.active)

    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._swapped)
                or bool(self._prefetching)
                or any(s.active for s in self._slots))

    def request_pages(self, n_pages: int) -> None:
        """Install pressure from the router (a migration waiting to land):
        the residency manager frees ``n_pages`` at this round's balance
        point. Without a manager nothing acts on it, and the install waits
        for ordinary completions."""
        self._external_demand = max(self._external_demand, int(n_pages))

    def would_fit(self, prompt_len: int, max_new: int) -> bool:
        """Could this engine EVER serve the request (table width, pool,
        ladder, max_seq) — the router's placement feasibility check."""
        try:
            padded = self._bucket_len(int(prompt_len))
        except ValueError:
            return False
        need = self._pages_for(prompt_len, max_new)
        return (need <= min(self.pages_per_seq, self.pool_pages)
                and max(prompt_len + max_new, padded) <= self.cfg.max_seq)

    # -- migration (the serving plane's KV handoff) ------------------------

    def migration_admissible(self, n_pages: int) -> bool:
        """Could :meth:`install_migration` of an ``n_pages`` bundle
        succeed right now (a free slot and the pages, net of the pulls in
        flight)? Migrations bypass the high-water mark, as resumes do."""
        free_slots = sum(1 for s in self._slots if not s.active)
        return (free_slots > len(self._prefetching)
                and n_pages <= len(self.free_pages)
                - self._reserved_prefetch_pages()
                and n_pages <= self.pages_per_seq)

    def exportable_slots(self) -> list[int]:
        """Active rows whose first token is resolved — what a prefill
        replica offers for migration after a ``decode=False`` round."""
        return [i for i, s in enumerate(self._slots)
                if s.active and i not in self._pending]

    def _detach_row(self, slot: int) -> MigrationBundle:
        """Detach one active row into a :class:`MigrationBundle` and
        release its slot and pages. Runs at a chunk boundary, so the
        cursor snapshot is a deliberate sync point; ``tolist`` COPIES the
        values into host ints (a host view of a cursor tensor would
        change under a later in-place write). The K/V pages (and scale
        pools) are gathered on the device into new tensors in the
        bundle's global layout (``decode.gather_pool_pages``): the
        released pages may be reused at once."""
        st = self._slots[slot]
        if not st.active or slot in self._pending or st.prompt is None:
            raise ValueError(f"slot {slot} has no exportable row")
        if self.spec:
            raise ValueError(
                "draft-assisted engines do not migrate: the draft cache's "
                "row state would have to move too")
        # torchlint: disable=host-sync-in-dispatch — the chunk-boundary
        # cursor snapshot the bundle carries (a deliberate sync point)
        pos, limit, token = torch.stack(
            [self.pos[slot], self.limit[slot], self.tokens[slot]]).tolist()
        if self.greedy:
            key, temp = np.zeros(2, np.uint32), 0.0
        else:
            # torchlint: disable=host-sync-in-dispatch — the same snapshot
            key = np.asarray(self.keys[slot].tolist(), np.uint32)
            # torchlint: disable=host-sync-in-dispatch — and its temperature
            temp = float(self.temps[slot])
        idx = torch.tensor(st.pages, dtype=torch.long, device=self.device)
        payload = {name: tuple(gather_pool_pages(pool, idx)
                               for pool in pools)
                   for name, pools in self.cache.items() if name != "table"}
        rec = self.stats.get(st.seq_id) or {}
        bundle = MigrationBundle(
            seq_id=st.seq_id, prompt=st.prompt, out=list(st.out),
            prefix=list(st.prefix), budget=st.budget, pos=pos,
            limit=limit, token=token, key=key, temp=temp,
            temp_override=st.temp_override, priority=st.priority,
            deadline_s=st.deadline_s, t_submit=st.t_submit,
            t_first=rec.get("t_first"),
            preemptions=int(rec.get("preemptions") or 0),
            n_pages=len(st.pages), page_size=self.page_size,
            pages_payload=payload, rung=int(st.padded_len),
            prefix_len=((st.prompt_len // self.page_size) * self.page_size
                        if st.padded_len else 0))
        self._release_slot(slot)
        return bundle

    def export_migration(self, slot: int) -> MigrationBundle:
        """Detach one active row for a cross-engine handoff (the donor
        half of the plane's KV migration); its stats outcome closes as
        ``"migrated"``."""
        bundle = self._detach_row(slot)
        rec = self.stats.get(bundle.seq_id)
        if rec is not None:
            rec["outcome"] = "migrated"
        rtr = reqtracelib.active()
        if rtr is not None:
            # decode closes into an open `migrating` segment; the copy
            # rides the bundle so the installer closes it on its side
            bundle.segments = rtr.export_history(bundle.seq_id)
        self._residency_release(bundle.seq_id)
        self._emit(kind="serve_migrate_out", seq_id=bundle.seq_id,
                   slot=slot, pages=bundle.n_pages,
                   tokens_done=len(bundle.out))
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("serve.migrated_out").inc()
        return bundle

    def export_swapped(self, seq_id: int) -> MigrationBundle:
        """Export a row parked in the HOST tier — the cross-tier migration
        path: the plane can migrate a row the manager swapped out without
        paging it back in. Its pushes are observed complete first, and the
        payload is the host tier's tensors (plain CPU tensors on the CPU,
        pinned ones on a card)."""
        if self.residency is None or seq_id not in self._swapped:
            raise ValueError(
                f"seq_id {seq_id} is not swapped out of this engine")
        self.residency.drain()
        bundle = self._swapped.pop(seq_id)
        rec = self.stats.get(seq_id)
        if rec is not None:
            rec["outcome"] = "migrated"
        rtr = reqtracelib.active()
        if rtr is not None:
            # the open swapped_out segment closes into migrating
            bundle.segments = rtr.export_history(seq_id)
        self._residency_release(seq_id)
        self._emit(kind="serve_migrate_out", seq_id=seq_id, slot=-1,
                   pages=bundle.n_pages, tokens_done=len(bundle.out),
                   tier="host")
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("serve.migrated_out").inc()
        return bundle

    def install_migration(self, bundle: MigrationBundle) -> int:
        """Continue a migrated row in THIS engine — the receiver half of
        the handoff. Dispatch-only: the table upload, the page copies
        into the pool and the cursor seeding all enqueue without a host
        readback, so an in-flight decode chunk is never stalled (the
        plane calls this from ``service_round``'s ``pre_collect``).
        A sharing engine resolves the bundle's prefix span to its own
        cached chain at the bundle's rung where it has it. Returns the
        slot."""
        if self.spec:
            raise ValueError("draft-assisted engines do not migrate")
        if bundle.page_size != self.page_size:
            raise ValueError(
                f"page_size mismatch: bundle {bundle.page_size} vs "
                f"engine {self.page_size} — pools are not layout-"
                "compatible across different page sizes")
        pools = {k: len(v) for k, v in self.cache.items() if k != "table"}
        got = {k: len(v) for k, v in bundle.pages_payload.items()}
        if got != pools:
            raise ValueError(
                f"bundle payload {got} does not match this engine's pools "
                f"{pools} (another kv_cache_dtype or depth)")
        if not self.migration_admissible(bundle.n_pages):
            raise ValueError(
                f"migration of {bundle.n_pages} page(s) not admissible "
                f"(free slots {self.slots - self.active_count}, "
                f"free pages {len(self.free_pages)})")
        if self._known(bundle.seq_id):
            raise ValueError(
                f"seq_id {bundle.seq_id} already known to this engine")
        slot = self._attach_row(bundle)
        if self.residency is not None:
            self.residency.register_group(
                bundle.seq_id, bundle.n_pages,
                bundle.n_pages * self._page_nbytes, tier="hbm",
                priority=bundle.priority)
        self._emit(kind="serve_migrate_in", seq_id=bundle.seq_id,
                   slot=slot, pages=bundle.n_pages, seq=bundle.seq,
                   tokens_done=len(bundle.out))
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("serve.migrated_in").inc()
            m.gauge("serve.free_pages").set(len(self.free_pages))
        return slot

    def _attach_row(self, bundle: MigrationBundle) -> int:
        """Seat a detached row in this engine — the install half shared by
        :meth:`install_migration` and the residency swap-in (admissibility
        is the caller's to have checked). A sharing engine whose index
        holds the bundle's pure-prompt span at its rung maps those cached
        pages (incref; the same bytes) and installs only the rest; a cold
        index installs everything. Returns the slot."""
        slot = next(i for i, s in enumerate(self._slots) if not s.active)
        prompt = np.asarray(bundle.prompt, np.int32)
        resolved: list[int] = []
        if self._prefix is not None and bundle.rung and bundle.prefix_len:
            resolved = self._prefix.match(
                prompt[:bundle.prefix_len], bundle.rung,
                max_pages=bundle.prefix_len // self.page_size)
        m = len(resolved)
        self._incref_pages(resolved)
        pages = resolved + self._alloc_pages(bundle.n_pages - m)
        self._seat(slot, pages)
        if m < bundle.n_pages:
            idx = _upload(np.asarray(pages[m:], np.int64), self.device)
            for name, pools in self.cache.items():
                if name != "table":
                    for pool, pl in zip(pools, bundle.pages_payload[name]):
                        install_pool_pages(pool, idx, pl[m:] if m else pl)
        # fills, not host-to-device copies
        self.pos[slot].fill_(int(bundle.pos))
        self.limit[slot].fill_(int(bundle.limit))
        self.tokens[slot].fill_(int(bundle.token))
        if not self.greedy:
            self.keys[slot] = _as_keys(bundle.key, 1, self.device)[0]
            self.temps[slot].fill_(float(bundle.temp))
        self._slots[slot] = _Slot(
            seq_id=bundle.seq_id, pages=pages, prompt_len=int(prompt.size),
            budget=bundle.budget, out=list(bundle.out), active=True,
            t_submit=bundle.t_submit, prompt=prompt,
            priority=bundle.priority, deadline_s=bundle.deadline_s,
            temp_override=bundle.temp_override,
            prefix=list(bundle.prefix), padded_len=int(bundle.rung),
            t_admit=time.perf_counter(), shared_pages=m)
        if bundle.rung:
            # warm this engine's index with the installed chain
            self._insert_prefix(prompt, int(bundle.rung), pages)
        prior = self.stats.get(bundle.seq_id)
        self.stats[bundle.seq_id] = {
            "priority": bundle.priority, "t_submit": bundle.t_submit,
            "t_first": bundle.t_first, "t_finish": None, "tokens": 0,
            "outcome": None, "preemptions": bundle.preemptions,
            # a migration install starts empty: the donor's stamps are
            # its own host clock, not wire state
            "token_ts": (list(prior.get("token_ts") or [])
                         if prior is not None else [])}
        rtr = reqtracelib.active()
        if rtr is not None:
            # adopt the carried history (a local one wins) and open decode
            rtr.install_history(bundle.seq_id, bundle.segments,
                                t=self._slots[slot].t_admit,
                                t_submit=bundle.t_submit)
        return slot

    # -- tiered residency (HBM <-> host paging, memory/residency.py) -------

    def _swap_out(self, slot: int) -> None:
        """Page one active row out to the host tier: detach it (the
        migration snapshot — pages gathered into new tensors on the
        compute stream, cursors and key to the host, slot and pages
        released at once) and push the gathered payload through the
        manager (the side stream waits for the gather). The row is not
        re-prefilled on return: its KV bytes come back exactly."""
        sid = self._slots[slot].seq_id
        bundle = self._detach_row(slot)
        host_payload = self.residency.push_payload(
            bundle.pages_payload,
            attrs={"seq_id": sid, "pages": bundle.n_pages})
        self._swapped[sid] = replace(bundle, pages_payload=host_payload)
        rtr = reqtracelib.active()
        if rtr is not None:
            rtr.stamp_transition(sid, "swapped_out")
        self.residency.retier_group(sid, "host")
        self._emit(kind="serve_swap_out", seq_id=sid, slot=slot,
                   pages=bundle.n_pages, tokens_done=len(bundle.out),
                   free_pages=len(self.free_pages))
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("serve.swapped_out").inc()
            m.gauge("serve.free_pages").set(len(self.free_pages))

    def _dispatch_prefetch(self) -> None:
        """Dispatch host -> HBM pulls for swapped rows that will fit,
        BEFORE the round's decode chunk, so the copies run under it.
        Priority class first, swap-out order within a class, with skip;
        a strictly more urgent queued class outranks the swap-in; at most
        the manager's ``prefetch_depth`` pulls in flight. Pulled pages and
        slots stay reserved (:meth:`_reserved_prefetch_pages`) until the
        install."""
        if not self._swapped:
            return
        free_pages = len(self.free_pages) - self._reserved_prefetch_pages()
        free_slots = (sum(1 for s in self._slots if not s.active)
                      - len(self._prefetching))
        q_min = min((r.priority for r in self._queue), default=None)
        depth = self.residency.prefetch_depth
        for sid, bundle in sorted(self._swapped.items(),
                                  key=lambda kv: kv[1].priority):
            if depth is not None and len(self._prefetching) >= depth:
                break
            if free_slots < 1:
                break
            if q_min is not None and q_min < bundle.priority:
                break
            if bundle.n_pages > free_pages:
                continue
            rtr = reqtracelib.active()
            if rtr is not None:
                # stamped before the pull so an injected slow host transfer
                # lands inside prefetch_wait
                rtr.stamp_transition(sid, "prefetch_wait")
            payload, handle = self.residency.pull_payload(
                bundle.pages_payload,
                attrs={"seq_id": sid, "pages": bundle.n_pages})
            self._prefetching.append((bundle, payload, handle))
            del self._swapped[sid]
            free_pages -= bundle.n_pages
            free_slots -= 1
            self._emit(kind="serve_prefetch", seq_id=sid,
                       pages=bundle.n_pages)

    def _install_prefetched(self, overlapped: bool) -> None:
        """Seat arrived prefetches in the arena at the ``pre_collect``
        position: behind the in-flight decode chunk when there is one
        (``overlapped``), the compute stream waiting on each pull's event
        first. A bundle that cannot seat yet stays staged."""
        if not self._prefetching:
            return
        still = []
        for bundle, payload, handle in self._prefetching:
            free_slots = sum(1 for s in self._slots if not s.active)
            if free_slots < 1 or bundle.n_pages > len(self.free_pages):
                still.append((bundle, payload, handle))
                continue
            self.residency.wait_pull(handle)
            slot = self._attach_row(replace(bundle, pages_payload=payload))
            self.residency.retier_group(bundle.seq_id, "hbm")
            self._installed_prefetch.append((bundle, handle))
            self._emit(kind="serve_swap_in", seq_id=bundle.seq_id,
                       slot=slot, pages=bundle.n_pages,
                       overlapped=overlapped)
            m = metricslib.get_metrics()
            if m.enabled:
                m.counter("serve.swapped_in").inc()
        self._prefetching = still

    def _complete_prefetches(self) -> None:
        """Close this round's installed pulls at an observed completion and
        fold their overlap against the decode chunks' compute windows
        (dispatch start to readback) into the manager's
        ``prefetch_overlap_frac``."""
        if not self._installed_prefetch:
            return
        floor = min(h[3] for _, h in self._installed_prefetch)
        windows = [w for w in self._compute_windows if w[1] >= floor]
        for _bundle, handle in self._installed_prefetch:
            self.residency.complete_pull(handle, chunk_windows=windows)
        self._installed_prefetch.clear()

    def _residency_balance(self) -> None:
        """Eviction decision at the end of a round (chunk collected,
        nothing in flight): free enough HBM for the most urgent demand —
        router-signaled install pressure (:meth:`request_pages`), the head
        queued request that cannot admit (only strictly less urgent rows
        may make room for it), or the next swapped row due back in
        (rotation within same-or-less-urgent classes) — by paging policy-
        chosen victims out; then page out what the policy calls cold."""
        r = self.residency
        avail = len(self.free_pages) - self._reserved_prefetch_pages()
        # pages a victim would ACTUALLY free (shared pages stay)
        slot_of = {s.seq_id: i for i, s in enumerate(self._slots)
                   if s.active}
        sizes = {g.group: (self._row_freeable_pages(slot_of[g.group])
                           if g.group in slot_of else g.n_blocks)
                 for g in r.groups("hbm")}
        victims: list = []

        def planned_avail():
            # pages this pass's earlier picks free count toward later
            # demands (without the credit co-occurring demands over-evict)
            return avail + sum(sizes.get(v, 0) for v in victims)

        # (a) router-signaled install pressure: any victim class
        demand = self._external_demand
        self._external_demand = 0
        if demand > planned_avail():
            victims += r.victims(demand - planned_avail(), exclude=victims)
        # (b) the head queued request that cannot admit
        if self._queue:
            req = self._queue[self._queue_order()[0]]
            need = self._request_need(req)
            fresh = req.resume_prefix is None
            if not self._admissible(need, fresh=fresh):
                # sized to the binding constraint: raw pages, and for a
                # fresh head the high-water cap too
                shortfall = need - planned_avail()
                if fresh:
                    used = (self.pool_pages - len(self.free_pages)
                            + self._reserved_prefetch_pages()
                            - (planned_avail() - avail))
                    hw_cap = self.admit_highwater * self.pool_pages
                    shortfall = max(shortfall,
                                    math.ceil(used + need - hw_cap))
                free_slots = (sum(1 for s in self._slots if not s.active)
                              - len(self._prefetching))
                if shortfall <= 0 and free_slots < 1:
                    # the binding failure is the SLOT: any one victim
                    # frees a whole slot
                    shortfall = 1
                if shortfall > 0:
                    victims += r.victims(shortfall, exclude=victims,
                                         min_priority=req.priority + 1)
        # (c) the next swapped row due back in
        if self._swapped and not victims:
            head = sorted(self._swapped.values(),
                          key=lambda b: b.priority)[0]
            if head.n_pages > avail:
                victims += r.victims(head.n_pages - avail, exclude=victims,
                                     min_priority=head.priority)
        cold = r.cold_groups(exclude=victims)
        for sid in victims + cold:
            slot = next((i for i, s in enumerate(self._slots)
                         if s.active and s.seq_id == sid), None)
            if slot is None or slot in self._pending:
                continue
            if not r.can_host(len(self._slots[slot].pages)):
                # earlier picks in this pass took the host tier's room
                continue
            if sid in cold and sid not in victims \
                    and sum(1 for s in self._slots if s.active) <= 1:
                # proactive cold paging never empties the arena: one row
                # keeps decoding, so next round's pulls have a chunk to
                # hide under
                continue
            self._swap_out(slot)


class ContinuousBatcher(EngineCore):
    """The single-process serving engine: ``submit()`` requests, then
    :meth:`run` until everything drains."""

    def run(self, *, arrivals=None, max_rounds: int | None = None,
            round_s: float | None = None):
        """Serve until queue, slots and (open-loop) arrivals drain (or
        ``max_rounds`` rounds ran). Returns ``finished``: {seq_id:
        np.ndarray of emitted tokens}.

        ``arrivals``: open-loop traffic — ``(t_rel_s, submit_kwargs)``
        pairs (``harness/loadgen.py`` schedules); each is submitted once
        the run clock passes its instant. A bounded run never waits for a
        future arrival (undelivered arrivals are dropped: pass them to
        the continuing call); it parks at a chunk boundary, and a later
        ``run()`` continues.

        ``round_s``: the run clock. None (JAX's): the wall clock since the
        run began; an arrival's ``t_submit`` is its instant (the wait the
        user saw, not when the loop got to it), and the loop idles in
        bounded sleeps while nothing is servable. A float: the engine's
        own progress, ``round_s`` schedule seconds a service round plus
        each round's injected chaos delay; an arrival's ``t_submit`` is
        the wall instant it is delivered, and with nothing servable the
        clock jumps to the next arrival. Arrivals then land on the same
        rounds however fast the host runs, so a loaded host costs time,
        not extra queueing and preemption.

        Each round probes the chaos ``engine_round`` site at its index
        (when a chaos spec is active), then runs the preemption policy
        (``preempt``) with nothing in flight, then the ordinary round."""
        t_run0 = time.perf_counter()
        t_exposed = 0.0
        pending = (deque(sorted(arrivals, key=lambda a: a[0]))
                   if arrivals else None)
        chaos_on = chaoslib.active() is not None
        progress = round_s is not None
        clock = 0.0  # the progress clock (schedule seconds)
        rounds = 0
        while True:
            now = clock if progress else time.perf_counter() - t_run0
            while pending and pending[0][0] <= now:
                t_arr, kw = pending.popleft()
                sid = self.submit(**kw)
                if not progress:  # submit() stamped the delivery instant
                    self._queue[-1].t_submit = t_run0 + t_arr
                    self.stats[sid]["t_submit"] = t_run0 + t_arr
                    rtr = reqtracelib.active()
                    if rtr is not None:
                        rtr.restamp_submit(sid, t_run0 + t_arr)
            if not self.has_work():
                if not pending or max_rounds is not None:
                    break
                if progress:
                    clock = pending[0][0]
                else:
                    wait = pending[0][0] - (time.perf_counter() - t_run0)
                    time.sleep(min(max(wait, 0.0), 0.005))
                continue
            if max_rounds is not None and rounds >= max_rounds:
                break
            rounds += 1
            n_inj = len(chaoslib.injections()) if progress and chaos_on \
                else 0
            r = self.service_round(
                chaos_index=rounds - 1 if chaos_on else None)
            if progress:
                clock += round_s + sum(
                    e["delay_s"] for e in chaoslib.injections()[n_inj:])
            t_exposed += r["exposed_s"]
            if r["stalled"]:
                raise RuntimeError(
                    "serving deadlock: waiting requests but no admissible "
                    "slot/pages (pool too small for the smallest waiting "
                    "request, or admit_highwater leaves it no headroom)")
        total = time.perf_counter() - t_run0
        if self.residency is not None:
            self.residency.drain()  # close any open mem.evict windows
        self.last_bubble_frac = t_exposed / total if total > 0 else 0.0
        self._serve_s += total
        m = metricslib.get_metrics()
        if m.enabled:
            m.gauge("serve.admit_bubble_frac").set(self.last_bubble_frac)
            if self._prefix is not None:
                m.gauge("serve.prefill_skip_frac").set(
                    self.prefill_skip_frac)
        if self.slo is not None:
            self.last_slo = slolib.attainment(self.stats, self.slo,
                                              self._serve_s)
            if m.enabled:
                tot = self.last_slo["total"]
                m.gauge("serve.tok_s").set(tot["tok_s"])
                m.gauge("serve.goodput_tok_s").set(tot["goodput_tok_s"])
        return self.finished


def tie_aware_compare(got, want, margins, tol: float) -> str:
    """Hold an engine sequence ``got`` against its standalone
    ``paged_generate`` tokens ``want`` with that run's per-step top-1 /
    top-2 logit gaps ``margins``. Returns ``"exact"``, ``"near_tie"``
    (the first divergence falls on a step whose gap is below ``tol``:
    matmuls at another batch size may round a near-tie either way; the
    sequences differ from there on, so nothing after it is compared) or
    ``"mismatch"``."""
    got, want = np.asarray(got), np.asarray(want)
    margins = np.asarray(margins, np.float64)
    if got.shape != want.shape:
        return "mismatch"
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return "exact"
    return "near_tie" if margins[diff[0]] < tol else "mismatch"
