"""The residency manager: per-block tier tracking, eviction policies, and
the overlapped HBM <-> host transfer pipeline — the counterpart of
``hpc_patterns_tpu/memory/residency.py``. The accounting and the policies
are JAX's, as written; the transfers are the torch rewrite.

- **accounting**: every BLOCK (a KV page, an optimizer-state leaf) has a
  tier (``"hbm"`` / ``"host"``), a pin state, a last-touch round and a
  priority; blocks belong to GROUPS (a serving row's pages, one named
  state tree), because migration is group-granular;
- **policy**: eviction order over the unpinned resident groups —
  :class:`LRUPolicy`, :class:`PriorityAwarePolicy` (numerically highest
  priority class first, then LRU) and :class:`ColdAfterNPolicy` (a group
  resident for N rounds is cold and proactively evictable);
- **transfers**: on a card both directions run on the manager's SIDE
  STREAM with ``non_blocking=True`` copies between the card and pinned
  host tensors (the caching host allocator's; a failed pinned allocation
  raises, nothing falls back to pageable memory):

  * :meth:`ResidencyManager.push_payload` (HBM -> host) waits on an
    event recorded on the compute stream after the payload was produced
    (the engine's page gather), records the source tensors on the side
    stream so their memory is not reused before the copy read it, and
    keeps them until its ``mem.evict`` window closes;
  * :meth:`ResidencyManager.pull_payload` (host -> HBM) dispatches the
    copies into tensors allocated on the compute stream; the consumer
    makes its stream wait on the pull (:meth:`wait_pull`) before reading
    them, and the pinned sources stay alive until :meth:`complete_pull`.
  * the ``mem.prefetch`` / ``mem.evict`` windows are opened and closed
    with the side stream current, so on a card their CUDA events time
    the copies, not the compute stream. The ``host_transfer`` chaos site
    fires between a pull window's opening and the copies' dispatch.

  On the CPU the host tier is a plain clone (JAX's numpy fallback, the
  documented degraded mode) and both directions copy synchronously.
  Either way the bytes round-trip exactly, which is what the serving
  oracle (a constrained engine token-identical to an all-HBM one) rides
  on.

Gauges (``harness/metrics.py``, no-op when disabled): ``mem.hbm_pages``,
``mem.host_pages`` and ``mem.prefetch_bytes``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.memory import kinds as kindslib

#: device-subtrack band for ``mem.prefetch`` / ``mem.evict`` windows
#: (``harness/trace.py``'s TRACK_BANDS)
MEM_TRACK_BASE, MEM_TRACKS = tracelib.track_band("residency")


def mem_track(seq: int) -> int:
    """The device subtrack a prefetch/evict window lands on."""
    return MEM_TRACK_BASE + int(seq) % MEM_TRACKS


@dataclass
class BlockState:
    """One tracked block: a KV page or one training-state leaf."""
    key: object          # block id: (group, index)
    group: object        # migration unit: serving seq_id / tree name
    nbytes: int
    tier: str            # "hbm" | "host"
    pinned: bool = False
    priority: int = 0
    last_touch: int = 0
    resident_since: int = 0


@dataclass
class GroupView:
    """Policy-facing summary of one group's blocks."""
    group: object
    n_blocks: int
    nbytes: int
    tier: str
    pinned: bool
    priority: int
    last_touch: int
    resident_since: int


class EvictionPolicy:
    """Victim ordering over resident, unpinned groups. ``victim_order``
    returns groups most-evictable first; ``is_cold`` marks groups the
    manager should evict PROACTIVELY (without demand)."""

    name = "?"

    def victim_order(self, groups: list[GroupView],
                     round_no: int) -> list[GroupView]:
        raise NotImplementedError

    def is_cold(self, group: GroupView, round_no: int) -> bool:
        return False


class LRUPolicy(EvictionPolicy):
    """Least-recently-touched first (ties: longest-resident, then group
    id). Decode rows are touched every resident round, so among them LRU
    is longest-resident-first — fair rotation. Demand-driven only."""

    name = "lru"

    def victim_order(self, groups, round_no):
        return sorted(groups, key=lambda g: (g.last_touch,
                                             g.resident_since,
                                             str(g.group)))


class PriorityAwarePolicy(LRUPolicy):
    """Numerically-highest priority class first (lower number = more
    important), LRU inside a class — background work pages out before
    interactive work."""

    name = "priority"

    def victim_order(self, groups, round_no):
        return sorted(groups, key=lambda g: (-g.priority,
                                             g.last_touch,
                                             g.resident_since,
                                             str(g.group)))


class ColdAfterNPolicy(LRUPolicy):
    """A group RESIDENT for >= ``n`` rounds is cold: proactively evictable
    even without demand (rotation by residency age — decode rows are
    touched every resident round, so touch-recency cannot be the clock).
    Deterministic given the round schedule."""

    name = "cold_after_n"

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"cold-after-n needs n >= 1, got {n}")
        self.n = int(n)

    def is_cold(self, group, round_no):
        return (round_no - group.resident_since) >= self.n


class ResidencyManager:
    """Tiered-residency bookkeeping and the instrumented transfer engine
    (the module docstring has the design). One manager serves ONE
    consumer (an ``EngineCore(residency=...)`` or a
    ``make_train_step(..., residency=...)``).

    ``host_blocks``: host-tier capacity in blocks (pages). ``policy``: an
    :class:`EvictionPolicy` (default LRU). ``min_resident_rounds``: a
    group prefetched in stays unevictable this many rounds (anti-thrash
    floor). ``prefetch_depth``: cap on concurrently in-flight pulls the
    consumer dispatches (None = unlimited). ``device``: where pulls land;
    None binds to the consumer's device at first use (an engine binds its
    own), else ``cuda``."""

    def __init__(self, *, host_blocks: int, policy: EvictionPolicy
                 | None = None, min_resident_rounds: int = 1,
                 prefetch_depth: int | None = None, device=None):
        if host_blocks < 1:
            raise ValueError(
                f"host_blocks must be >= 1, got {host_blocks}")
        if prefetch_depth is not None and prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1 or None, got "
                f"{prefetch_depth}")
        self.host_blocks = int(host_blocks)
        self.policy = policy or LRUPolicy()
        self.min_resident_rounds = int(min_resident_rounds)
        self.prefetch_depth = (None if prefetch_depth is None
                               else int(prefetch_depth))
        self._device = None if device is None else torch.device(device)
        self.blocks: dict[object, BlockState] = {}
        self.round = 0
        # pinned-host tier or the CPU clone, probed once at first use
        self._host_kind_works: bool | None = None
        self._side: torch.cuda.Stream | None = None
        # transfer telemetry
        self.swap_outs = 0
        self.swap_ins = 0
        self.prefetch_bytes = 0
        self.evict_bytes = 0
        self._win_seq = 0
        self._chaos_index = 0
        self._prefetch_overlap_s = 0.0
        self._prefetch_total_s = 0.0
        #: pushes not yet observed complete: (window, track, seq, attrs,
        #: done event, kept source and destination tensors)
        self._open_evicts: list[tuple] = []

    @classmethod
    def from_fitted(cls, fitted, *, host_blocks: int, device=None):
        """Build a manager from an autofit ``FittedConfig``: the fitted
        ``residency`` section picks the eviction policy (``lru`` /
        ``priority`` / ``cold_after_n``), the anti-thrash floor and the
        prefetch depth; a config with no residency section yields the
        plain default manager. Capacity (``host_blocks``) stays the
        caller's."""
        from hpc_patterns_tpu_torch.harness import autofit as autofitlib

        fitted = autofitlib.validate_fitted(fitted)
        section = fitted.get("residency") or {}
        name = section.get("policy") or "lru"
        if name == "priority":
            policy: EvictionPolicy = PriorityAwarePolicy()
        elif name == "cold_after_n":
            policy = ColdAfterNPolicy(int(section.get("cold_after_n")
                                          or 1))
        elif name == "lru":
            policy = LRUPolicy()
        else:
            raise ValueError(
                f"fitted residency policy {name!r} unknown (expected "
                "lru / priority / cold_after_n)")
        return cls(
            host_blocks=host_blocks,
            policy=policy,
            min_resident_rounds=int(
                section.get("min_resident_rounds") or 1),
            prefetch_depth=section.get("prefetch_depth"),
            device=device,
        )

    # -- device / tier plumbing --------------------------------------------

    @property
    def device(self) -> torch.device:
        if self._device is None:
            from hpc_patterns_tpu_torch.topology import resolve_device

            self._device = resolve_device(None)
        return self._device

    def bind_device(self, device) -> None:
        """Bind an unbound manager to its consumer's device; a bound one
        must agree."""
        dev = torch.device(device)
        if self._device is None:
            self._device = dev
        elif self._device.type != dev.type:
            raise ValueError(
                f"residency manager on {self._device} cannot serve a "
                f"consumer on {dev}")

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def host_tier_is_pinned(self) -> bool:
        """True when the host side is pinned host memory (async both
        ways); False = the CPU clone. On a card whose pinned transfers
        fail the probe this raises: the tier never quietly takes
        pageable memory."""
        if self._host_kind_works is None:
            works = kindslib.memory_kind_transfers_work(self.device)
            if self.on_card and not works:
                raise RuntimeError(
                    f"pinned host transfers fail on {self.device}: the "
                    "residency manager's host tier needs them")
            self._host_kind_works = works
        return self._host_kind_works

    @property
    def side_stream(self) -> torch.cuda.Stream | None:
        """The stream every transfer runs on (None on the CPU)."""
        if self._side is None and self.on_card:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    # -- block accounting ---------------------------------------------------

    def register_group(self, group, n_blocks: int, nbytes: int, *,
                       tier: str = "hbm", priority: int = 0) -> None:
        """Track a new group of ``n_blocks`` blocks totaling ``nbytes``
        (evenly attributed). Raises if the group exists or the host tier
        would overflow."""
        if tier not in ("hbm", "host"):
            raise ValueError(f"tier {tier!r} not in ('hbm', 'host')")
        if (group, 0) in self.blocks:
            raise ValueError(f"group {group!r} already registered")
        if tier == "host" and not self.can_host(n_blocks):
            raise ValueError(
                f"host tier full: {n_blocks} blocks over capacity "
                f"{self.host_blocks} (used {self.host_blocks_used()})")
        per = max(1, nbytes // max(1, n_blocks))
        for i in range(n_blocks):
            self.blocks[(group, i)] = BlockState(
                key=(group, i), group=group, nbytes=per, tier=tier,
                priority=priority, last_touch=self.round,
                resident_since=self.round)
        self.update_gauges()

    def release_group(self, group) -> None:
        i = 0
        while (group, i) in self.blocks:
            del self.blocks[(group, i)]
            i += 1
        self.update_gauges()

    def _group_blocks(self, group) -> list[BlockState]:
        # blocks are keyed (group, i) with i dense from register_group, so
        # group operations are O(group size), not O(all blocks)
        out, i = [], 0
        while (group, i) in self.blocks:
            out.append(self.blocks[(group, i)])
            i += 1
        return out

    def touch_group(self, group) -> None:
        for b in self._group_blocks(group):
            b.last_touch = self.round

    def pin_group(self, group, pinned: bool = True) -> None:
        for b in self._group_blocks(group):
            b.pinned = pinned

    def retier_group(self, group, tier: str) -> None:
        """Move a group's accounting to ``tier`` (the caller moved the
        bytes). To host counts against ``host_blocks``; to HBM stamps
        ``resident_since`` with the current round."""
        blocks = self._group_blocks(group)
        if not blocks:
            raise ValueError(f"group {group!r} not registered")
        if tier == "host" and blocks[0].tier != "host" \
                and not self.can_host(len(blocks)):
            raise ValueError(
                f"host tier full: {len(blocks)} blocks over capacity "
                f"{self.host_blocks} (used {self.host_blocks_used()})")
        for b in blocks:
            if tier == "hbm" and b.tier != "hbm":
                b.resident_since = self.round
                b.last_touch = self.round
            b.tier = tier
        self.update_gauges()

    def hbm_blocks_used(self) -> int:
        return sum(1 for b in self.blocks.values() if b.tier == "hbm")

    def host_blocks_used(self) -> int:
        return sum(1 for b in self.blocks.values() if b.tier == "host")

    def can_host(self, n_blocks: int) -> bool:
        return self.host_blocks_used() + n_blocks <= self.host_blocks

    def groups(self, tier: str | None = None) -> list[GroupView]:
        by_group: dict[object, list[BlockState]] = {}
        for b in self.blocks.values():
            by_group.setdefault(b.group, []).append(b)
        out = []
        for g, bs in by_group.items():
            if tier is not None and bs[0].tier != tier:
                continue
            out.append(GroupView(
                group=g, n_blocks=len(bs),
                nbytes=sum(b.nbytes for b in bs), tier=bs[0].tier,
                pinned=any(b.pinned for b in bs),
                priority=max(b.priority for b in bs),
                last_touch=max(b.last_touch for b in bs),
                resident_since=max(b.resident_since for b in bs)))
        return out

    # -- policy -------------------------------------------------------------

    def victims(self, need_blocks: int, *, exclude=(),
                min_priority: int | None = None) -> list[object]:
        """Groups to evict, policy-ordered, until ``need_blocks`` HBM
        blocks would be free — or every eligible victim if even that
        falls short. Pinned groups and groups inside their
        ``min_resident_rounds`` floor are never offered. ``min_priority``:
        only groups whose priority number is >= it."""
        cand = [g for g in self.groups("hbm")
                if not g.pinned and g.group not in exclude
                and self.round - g.resident_since
                >= self.min_resident_rounds
                and (min_priority is None
                     or g.priority >= min_priority)]
        chosen, freed = [], 0
        for g in self.policy.victim_order(cand, self.round):
            if freed >= need_blocks:
                break
            # host capacity is consumed CUMULATIVELY across this pass's
            # picks (freed blocks land on the host tier)
            if not self.can_host(freed + g.n_blocks):
                continue
            chosen.append(g.group)
            freed += g.n_blocks
        return chosen

    def cold_groups(self, *, exclude=()) -> list[object]:
        """Groups the policy marks proactively evictable this round."""
        return [g.group for g in self.groups("hbm")
                if not g.pinned and g.group not in exclude
                and self.round - g.resident_since
                >= self.min_resident_rounds
                and self.can_host(g.n_blocks)
                and self.policy.is_cold(g, self.round)]

    # -- rounds / gauges ----------------------------------------------------

    def begin_round(self) -> None:
        self.round += 1
        self._close_ripe_evicts()

    def update_gauges(self) -> None:
        m = metricslib.get_metrics()
        if not m.enabled:
            return
        m.gauge("mem.hbm_pages").set(self.hbm_blocks_used())
        m.gauge("mem.host_pages").set(self.host_blocks_used())
        m.gauge("mem.prefetch_bytes").set(self.prefetch_bytes)

    # -- transfers (the instrumented pipeline) ------------------------------

    @staticmethod
    def _payload_bytes(payload) -> int:
        return sum(int(a.numel() * a.element_size())
                   for a in kindslib.tree_tensors(payload))

    def _open(self):
        """Open a transfer window (the side stream must be current on a
        card); returns (window or None, track, seq)."""
        seq = self._win_seq
        self._win_seq += 1
        rec = tracelib.active()
        window = rec.open_window(self.device) if rec is not None else None
        return window, mem_track(seq), seq

    def _placements(self, payload, shardings, kind: str):
        if shardings is not None:
            return shardings
        target = kindslib.kind_sharding(self.device, kind)
        return kindslib.tree_map(lambda a: target, payload)

    def push_payload(self, payload, *, attrs: dict | None = None,
                     shardings=None):
        """HBM -> host: copy a payload tree to the host tier and open its
        ``mem.evict`` window (closed at the next round boundary —
        :meth:`begin_round` — or :meth:`drain`). ``shardings``: explicit
        per-leaf :class:`~hpc_patterns_tpu_torch.memory.kinds.
        KindPlacement` targets (the training path's); default is the
        manager's host tier. On a card the copies run on the side stream
        behind an event the compute stream records now, so everything
        the caller enqueued to produce the payload is done first; the
        returned host tensors are valid once the window closes."""
        nbytes = self._payload_bytes(payload)
        pinned = self.host_tier_is_pinned()
        target = self._placements(payload, shardings,
                                  "pinned_host" if pinned else "device")
        win_attrs = {**(attrs or {}), "bytes": nbytes}
        done = None
        if self.on_card:
            side = self.side_stream
            produced = torch.cuda.current_stream(self.device)
            side.wait_stream(produced)
            with torch.cuda.stream(side):
                window, track, seq = self._open()
                out = kindslib.tree_map(lambda a, p: p.place(a), payload,
                                        target)
                for a in kindslib.tree_tensors(payload):
                    if a.device.type == "cuda":
                        a.record_stream(side)
                window = self._dispatched("mem.evict", window, track, seq,
                                          win_attrs)
                # behind the window's end event: its completion is the
                # window's
                done = torch.cuda.Event()
                done.record(side)
            for h in kindslib.tree_tensors(out):
                if h.device.type == "cpu" and not h.is_pinned():
                    raise RuntimeError(
                        "residency host tier on the card got a pageable "
                        "tensor: every host-tier tensor must be pinned")
        else:
            window, track, seq = self._open()
            out = kindslib.tree_map(lambda a, p: p.place(a), payload,
                                    target)
            window = self._dispatched("mem.evict", window, track, seq,
                                      win_attrs)
        self.swap_outs += 1
        self.evict_bytes += nbytes
        if done is not None or window is not None:
            # the sources stay referenced until the copy is observed done
            self._open_evicts.append((window, track, seq, win_attrs, done,
                                      (payload, out)))
        self.update_gauges()
        return out

    def _dispatched(self, name, window, track, seq, attrs):
        rec = tracelib.active()
        if rec is None or window is None:
            return None
        return rec.mark_dispatch(name, {**attrs, "seq": seq}, track=track,
                                 window=window)

    def pull_payload(self, payload, *, attrs: dict | None = None,
                     shardings=None):
        """Host -> HBM: dispatch the pull of a host payload tree and open
        its ``mem.prefetch`` window. ``shardings``: explicit per-leaf
        targets (the training path's); default pulls onto the manager's
        device. Returns ``(device_payload, handle)``: the consumer calls
        :meth:`wait_pull` before its stream reads the payload and
        :meth:`complete_pull` once it OBSERVED completion. The
        ``host_transfer`` chaos site fires between the window's opening
        and the copies' dispatch, so an injected ``slow_host_transfer``
        delay widens exactly the window it claims to."""
        nbytes = self._payload_bytes(payload)
        target = self._placements(payload, shardings, "device")
        win_attrs = {**(attrs or {}), "bytes": nbytes}
        done = None
        if self.on_card:
            self.host_tier_is_pinned()
            side = self.side_stream
            consumer = torch.cuda.current_stream(self.device)
            # destinations are allocated on the consumer's stream; the
            # side stream waits for that stream's earlier use of them
            dst = kindslib.tree_map(
                lambda a, p: torch.empty(a.shape, dtype=a.dtype,
                                         device=p.device), payload, target)
            side.wait_stream(consumer)
            with torch.cuda.stream(side):
                window, track, seq = self._open()
                self._chaos()
                kindslib.tree_map(
                    lambda d, a: d.copy_(a, non_blocking=True), dst,
                    payload)
                window = self._dispatched("mem.prefetch", window, track,
                                          seq, win_attrs)
                done = torch.cuda.Event()
                done.record(side)
            out = dst
        else:
            window, track, seq = self._open()
            self._chaos()
            out = kindslib.tree_map(lambda a, p: p.place(a), payload,
                                    target)
            window = self._dispatched("mem.prefetch", window, track, seq,
                                      win_attrs)
        self.swap_ins += 1
        self.prefetch_bytes += nbytes
        self.update_gauges()
        # handle[3] is the dispatch host stamp (the engine's window floor)
        return out, (window, track, seq, time.perf_counter(), win_attrs,
                     done, payload)

    def _chaos(self) -> None:
        if chaoslib.active() is not None:
            chaoslib.maybe_inject("host_transfer", self._chaos_index)
        self._chaos_index += 1

    def wait_pull(self, handle) -> None:
        """Make the current stream wait for a pull's copies (on the
        device, no host sync) — before anything reads its payload."""
        done = handle[5] if len(handle) > 5 else None
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)

    def complete_pull(self, handle, *, chunk_windows=()) -> None:
        """Close a pull's ``mem.prefetch`` window at an OBSERVED
        completion and fold its overlap against the consumer's
        ``chunk_windows`` — host-stamp ``(t0, t1)`` pairs — into
        ``prefetch_overlap_frac``. Waits for the pull's copies first
        (the caller already synced past its consumer, so that is the
        pull's exposed remainder at most)."""
        window, track, seq, t0, attrs = handle[:5]
        done = handle[5] if len(handle) > 5 else None
        if done is not None:
            done.synchronize()
        t_done = time.perf_counter()
        span = max(t_done - t0, 1e-9)
        under = sum(max(0.0, min(t_done, e) - max(t0, s))
                    for s, e in chunk_windows)
        self._prefetch_total_s += span
        self._prefetch_overlap_s += min(under, span)
        rec = tracelib.active()
        if rec is not None and window is not None:
            rec.mark_complete("mem.prefetch", window,
                              {**attrs, "seq": seq}, track=track)

    @property
    def prefetch_overlap_frac(self) -> float | None:
        """Measured fraction of prefetch-window time spent under the
        consumer's in-flight compute windows. None until a pull
        completed."""
        if self._prefetch_total_s <= 0:
            return None
        return self._prefetch_overlap_s / self._prefetch_total_s

    def _close_ripe_evicts(self) -> None:
        """Observe every open push complete (it had a round to land) and
        close its ``mem.evict`` window; the kept tensors go with it."""
        if not self._open_evicts:
            return
        rec = tracelib.active()
        for window, track, seq, attrs, done, _kept in self._open_evicts:
            if done is not None:
                # torchlint: disable=host-sync-in-dispatch — completion of
                # a push that had a round to land (the round boundary)
                done.synchronize()
            if rec is not None and window is not None:
                rec.mark_complete("mem.evict", window,
                                  {**attrs, "seq": seq}, track=track)
        self._open_evicts.clear()

    def drain(self) -> None:
        """Close every open window (end of a run; also before a host read
        of a pushed payload)."""
        self._close_ripe_evicts()
