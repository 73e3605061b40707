"""Continuous batching over the ragged paged cache — the greedy core of
``hpc_patterns_tpu/models/serving.py`` (``EngineCore`` +
``ContinuousBatcher``).

- a page free-list over one shared pool; each admitted sequence takes
  the pages its bucket-padded prompt + budget needs
  (:meth:`EngineCore.pages_needed`) and returns them on completion;
- one extra TRASH page (with its scale rows in a quantized pool): idle
  slots point their whole table row at it, so their frozen decode
  writes land in garbage nobody reads;
- prompts right-pad to a bucket ladder rung (:func:`bucket_ladder`,
  :func:`pad_to_bucket`); the one-row prefill writes through the shared
  pool and its logits come from the last real token;
- admission happens at chunk boundaries, behind the already-enqueued
  decode chunk (the CUDA stream orders them, as JAX's async dispatch
  did); the first-token readback is deferred to the round's sync point;
- a decode chunk is ``chunk`` ragged steps (``paged_decode_step`` with a
  (slots,) position vector): a row advances while ``pos < limit``; its
  position freezes at ``limit`` after it finishes, so a frozen write
  re-targets the row's own last slot; an emitted ``eos_id`` pulls the
  limit down.

The pool stores ``cfg.kv_cache_dtype``: the compute dtype, or int8/fp8
values with per-row scale pools, served on any ``cfg.decode_attn``
route ("flash", "paged_flash", "gather").

Greedy only. Sampling (``temperature > 0``), preemption, tiered
residency, prefix sharing, draft-assisted rounds, meshes, SLO tracking
and the chaos/reqtrace hooks belong to later slices: asking for them
raises ``ValueError``.

Correctness contract: every sequence's tokens equal the standalone
``paged_generate`` for the same prompt, budget and config (exactly in f32
on the CPU; up to near-ties where bf16 matmuls at batch 8 and batch 1
round differently on the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpc_patterns_tpu_torch.models.decode import (
    _pick,
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
)
from hpc_patterns_tpu_torch.models.transformer import TransformerConfig
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
    generated tokens (fewer if ``eos_id`` fires)."""
    prompt: np.ndarray
    max_new: int
    seq_id: int = -1


@dataclass
class _Slot:
    seq_id: int = -1
    pages: list = field(default_factory=list)
    budget: int = 0
    out: list = field(default_factory=list)
    active: bool = False
    first_dev: torch.Tensor | None = None  # pending first-token readback


def _chunk_step(params, cache, pos, limit, tokens, *, cfg, chunk, eos_id):
    """``chunk`` ragged greedy decode steps, all enqueued without a host
    sync: rows advance while ``pos < limit``; an emitted ``eos_id``
    (>= 0) pulls the row's limit to its current end. Returns
    (pos, limit, tokens, out (chunk, B) int32); the cache is updated in
    place."""
    outs = []
    for _ in range(chunk):
        active = pos < limit
        logits = paged_decode_step(params, cache, pos, tokens, cfg)
        nxt = torch.where(active, _pick(logits), tokens)
        if eos_id >= 0:
            limit = torch.where(active & (nxt == eos_id),
                                torch.minimum(limit, pos + 1), limit)
        pos = torch.where(active, pos + 1, pos)
        tokens = nxt
        outs.append(nxt)
    return pos, limit, tokens, torch.stack(outs)


class EngineCore:
    """Serve :class:`Request`s through ``slots`` concurrent rows of one
    paged pool. ``pool_pages``: the shared arena (one trash page is
    appended). ``pages_per_seq``: table width. ``chunk``: decode steps
    per dispatch (admission granularity). ``prompt_buckets``: the prompt
    ladder (None = exact lengths). ``device``: default ``cuda`` (raises
    without a GPU unless ``device="cpu"``); params must live there."""

    def __init__(self, params, cfg: TransformerConfig, *, slots: int,
                 pool_pages: int, pages_per_seq: int, page_size: int,
                 chunk: int = 8, eos_id: int | None = None,
                 prompt_buckets=None, device=None,
                 temperature: float = 0.0, preempt: bool = False,
                 residency=None, prefix_cache: bool = False,
                 draft_params=None, mesh=None, slo=None):
        later = {"temperature > 0 (sampling)": temperature > 0.0,
                 "preempt": preempt, "residency": residency is not None,
                 "prefix_cache": prefix_cache,
                 "draft_params": draft_params is not None,
                 "mesh": mesh is not None, "slo": slo is not None}
        asked = [name for name, on in later.items() if on]
        if asked:
            raise ValueError(
                f"not ported yet (greedy core only): {', '.join(asked)}")
        if cfg.n_experts:
            raise ValueError("continuous batching: dense models only")
        if slots < 1 or chunk < 1:
            raise ValueError(f"need slots >= 1 and chunk >= 1, got "
                             f"{slots}/{chunk}")
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
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.chunk = chunk
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.prompt_buckets = prompt_buckets
        self.trash = pool_pages  # the appended trash page's id
        self.pool_pages = pool_pages
        self._table = np.full((slots, pages_per_seq), self.trash, np.int32)
        self.cache = init_paged_cache(
            cfg, slots, pages_per_seq, page_size,
            pool_pages=pool_pages + 1, table=self._table,
            device=self.device)
        self.free_pages = list(range(pool_pages))
        z = dict(dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((slots,), **z)
        self.limit = torch.zeros((slots,), **z)
        self.tokens = torch.zeros((slots,), **z)
        self._slots = [_Slot() for _ in range(slots)]
        self._pending: list[int] = []  # admitted, first token unread
        self._queue: list[Request] = []
        self.finished: dict[int, np.ndarray] = {}
        self._next_id = 0
        #: ragged decode steps dispatched (``chunk`` per dispatch) and
        #: admissions (one prefill each) — what kernel launch counts are
        #: checked against
        self.decode_steps = 0
        self.admissions = 0

    # -- admission ---------------------------------------------------------

    @staticmethod
    def pages_needed(prompt_len: int, max_new: int, page_size: int, *,
                     padded_len: int | None = None) -> int:
        """Pages one request holds: prompt + budget, or the bucket-padded
        prefill length if that reaches further — THE sizing rule."""
        span = max(prompt_len + max_new, padded_len or 0)
        return -(-span // page_size)

    def _bucket_len(self, prompt_len: int) -> int:
        return pad_to_bucket(self.prompt_buckets, prompt_len)

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        return self.pages_needed(prompt_len, max_new, self.page_size,
                                 padded_len=self._bucket_len(prompt_len))

    def submit(self, prompt, max_new: int, seq_id: int | None = None) -> int:
        """Enqueue a sequence; returns its id. Tokens appear in
        ``finished[id]`` once served."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be 1-D nonempty, {prompt.shape}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
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
        if (sid in self.finished
                or any(r.seq_id == sid for r in self._queue)
                or any(s.active and s.seq_id == sid for s in self._slots)):
            raise ValueError(f"seq_id {sid} already queued/active/finished")
        self._next_id = max(self._next_id, sid) + 1
        self._queue.append(Request(prompt, max_new, sid))
        return sid

    def _try_admit(self) -> int:
        """One FCFS-with-skip admission pass (a large request does not
        block a small one behind it). Returns the number admitted."""
        admitted = 0
        for req in list(self._queue):
            free_slot = next(
                (i for i, s in enumerate(self._slots) if not s.active), None)
            if free_slot is None:
                break
            need = self._pages_for(req.prompt.size, req.max_new)
            if need > len(self.free_pages):
                continue
            # identity removal: Request holds an ndarray, so == is not
            # a usable comparison
            self._queue = [r for r in self._queue if r is not req]
            self._admit(free_slot, req, need)
            admitted += 1
        return admitted

    def _admit(self, slot: int, req: Request, need: int):
        """Dispatch-only admission: table upload, one-row bucket-padded
        prefill through the shared pool, first-token pick and cursor
        seeding all enqueue without a host readback."""
        pages = [self.free_pages.pop() for _ in range(need)]
        row = np.full((self.pages_per_seq,), self.trash, np.int32)
        row[:need] = pages
        self._table[slot] = row
        self.cache["table"] = torch.from_numpy(self._table.copy()).to(
            self.device)
        T = int(req.prompt.size)
        padded = self._bucket_len(T)
        prompt = np.zeros((padded,), np.int32)
        prompt[:T] = req.prompt  # pad K/V is cursor-masked garbage
        # the shared pools (scale pools too, for a one-byte cache) under
        # this row's own one-row table
        one = dict(self.cache)
        one["table"] = torch.from_numpy(row[None, :].copy()).to(self.device)
        logits, _ = paged_prefill(
            self.params, torch.from_numpy(prompt)[None, :].to(self.device),
            self.cfg, one, self.page_size, last_pos=T - 1)
        first = _pick(logits)[0]
        # budget b emits 1 token at admission + (limit - T) from chunks
        lim = torch.full((), T + req.max_new - 1, dtype=torch.int32,
                         device=self.device)
        if self.eos_id >= 0:
            lim = torch.where(first == self.eos_id,
                              torch.full_like(lim, T), lim)
        self.pos[slot] = T
        self.limit[slot] = lim
        self.tokens[slot] = first
        self._slots[slot] = _Slot(seq_id=req.seq_id, pages=pages,
                                  budget=req.max_new, active=True,
                                  first_dev=first)
        self._pending.append(slot)
        self.admissions += 1

    def _resolve_pending(self):
        """Read back the admissions' first tokens (the round's sync
        point) and finish rows done at admission (budget 1 or eos)."""
        for slot in self._pending:
            st = self._slots[slot]
            first = int(st.first_dev)
            st.first_dev = None
            st.out = [first]
            if (self.eos_id >= 0 and first == self.eos_id) \
                    or st.budget == 1:
                self._finish(slot)
        self._pending.clear()

    # -- completion --------------------------------------------------------

    def _finish(self, slot: int):
        """Record the row's tokens, return its pages to the free list,
        point its table row at the trash page and zero its cursors."""
        st = self._slots[slot]
        self.finished[st.seq_id] = np.asarray(st.out, np.int32)
        self.free_pages.extend(st.pages)
        self._table[slot] = self.trash
        self.cache["table"] = torch.from_numpy(self._table.copy()).to(
            self.device)
        self._slots[slot] = _Slot()
        self.pos[slot] = 0
        self.limit[slot] = 0

    # -- the loop ----------------------------------------------------------

    def _dispatch_chunk(self):
        # the chunk's start cursors: nothing is in flight at a round start
        pos_start = self.pos.cpu().numpy()
        parts = [i for i, s in enumerate(self._slots) if s.active]
        self.pos, self.limit, self.tokens, out = _chunk_step(
            self.params, self.cache, self.pos, self.limit, self.tokens,
            cfg=self.cfg, chunk=self.chunk, eos_id=self.eos_id)
        self.decode_steps += self.chunk
        return parts, pos_start, out

    def _collect_chunk(self, inflight):
        parts, pos_start, out = inflight
        out = out.cpu().numpy()  # (chunk, slots); readback = sync
        limit_new = self.limit.cpu().numpy()
        for i in parts:
            st = self._slots[i]
            if not st.active:
                continue
            valid = int(np.clip(limit_new[i] - pos_start[i], 0, self.chunk))
            st.out.extend(int(t) for t in out[:valid, i])
            if pos_start[i] + valid >= limit_new[i]:
                self._finish(i)

    def service_round(self) -> dict:
        """ONE scheduler round: dispatch the decode chunk for the rows
        already running, admit behind it, read back first tokens, then
        collect the chunk. Returns ``{"admitted", "stalled", "active"}``
        (``stalled``: requests wait, nothing admitted, nothing runs)."""
        inflight = None
        if any(s.active for s in self._slots):
            inflight = self._dispatch_chunk()
        admitted = self._try_admit()
        self._resolve_pending()
        stalled = False
        if inflight is None:
            if any(s.active for s in self._slots):
                inflight = self._dispatch_chunk()
            else:
                stalled = bool(self._queue) and not admitted
        if inflight is not None:
            self._collect_chunk(inflight)
        return {"admitted": admitted, "stalled": stalled,
                "active": any(s.active for s in self._slots)}

    @property
    def free_page_count(self) -> int:
        return len(self.free_pages)

    def has_work(self) -> bool:
        return bool(self._queue) or any(s.active for s in self._slots)


class ContinuousBatcher(EngineCore):
    """The single-process serving engine: ``submit()`` requests, then
    :meth:`run` until everything drains."""

    def run(self, *, max_rounds: int | None = None):
        """Serve until queue and slots drain (or ``max_rounds``). Returns
        ``finished``: {seq_id: np.ndarray of emitted tokens}."""
        rounds = 0
        while self.has_work():
            if max_rounds is not None and rounds >= max_rounds:
                break
            rounds += 1
            if self.service_round()["stalled"]:
                raise RuntimeError(
                    "serving deadlock: waiting requests but no admissible "
                    "slot/pages (pool too small for the smallest waiting "
                    "request)")
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
