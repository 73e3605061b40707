"""The in-process serving plane: a router over N engine replicas — the
counterpart of ``hpc_patterns_tpu/serving_plane/router.py``.

One process, N :class:`~hpc_patterns_tpu_torch.models.serving.EngineCore`
replicas, one :class:`ServingPlane` routing an open-loop request stream
across them. The oracle: a request routed prefill -> KV migration ->
decode emits byte-identical tokens to the same request on a colocated
engine (tests/test_torch_serving_plane.py).

Placement policies (``policy=``), over the replicas that can EVER fit
the request: ``least_loaded`` (most free pages; ties: shallowest queue,
then order), ``round_robin``, ``prefill_decode`` (least-loaded among
prefill-capable replicas — a plane with any ``role="prefill"`` replica
is disaggregated, and decode replicas get work only by migration) and
``weighted`` (``placement_weights`` per replica name over present queue
pressure).

The migration pipeline per plane round:

1. each prefill replica runs an admission-only round
   (``service_round(decode=False)``): prefill and first token, no decode;
2. rows whose first token resolved are exported and their transfer
   dispatched toward a decode replica with capacity (reservations keep
   two exports from racing one slot), over the requested transport
   (``migration=``, :data:`MIGRATION_TRANSPORTS`): ``dma`` — kernel 13
   through ``comm/migration_dma.send_migration`` (replicas on two
   logical ranks of one card); ``device_put`` —
   ``migration.migrate_pages``; ``wire`` — the byte codec round trip;
3. the decode replica's round dispatches its chunk first, then installs
   arrived bundles behind it (``service_round``'s ``pre_collect``;
   ``recv_migration`` checks a ``dma`` bundle's landing first);
4. after the round the install's device work is waited for and the
   migration's host-clock window closes.

A ``dma`` request that a pair cannot serve (``dma_reachable``) or a slab
past the byte budget falls back to ``device_put`` LOUDLY — a
``RuntimeWarning`` once per distinct reason — and the per-transport
counter :attr:`ServingPlane.migration_transports` says what each bundle
really rode. A kernel fault is no fallback: it raises.

``kv_migration_overlap_frac``: Σ over migrations of the window time under
an in-flight decode chunk of the destination, over Σ window time (host
clock); ``dma_migration_overlap_frac`` the same over ``dma`` bundles
only (None when none rode it); ``migration_bytes_per_round``: payload
bytes per plane round, transport-invariant.

Chaos (``harness/chaos.py``): each live replica probes the
``replica_round`` site once per plane round at its own round counter and
ordinal (``die:replica=N,site=replica_round``). A stall sleeps; a death
marks the replica dead (every replica shares this process, so nothing is
killed) and this fixed plane SHEDS everything it held — active rows,
queued requests, bundles in flight toward it — each counted in the SLO
table and ``shed_on_death``; later arrivals no survivor can place are
shed too. ``deaths`` lists the dead replicas' names.

Observability, at the JAX router's sites: ``emit=`` receives the
``plane_route``, ``plane_transport_fallback``, ``plane_migrate``,
``plane_replica_death``, ``plane_shed`` and (with ``slo``) per-round
``plane_attainment`` records (a RunLog's ``emit`` fits); the metrics
registry gets the ``plane.routed``, ``plane.migrations``,
``plane.transport_fallbacks``, ``plane.replica_deaths`` and
``plane.shed`` counters, per
replica queue-depth and free-page gauges each round, the sliding-window
attainment gauges and the end-of-run overlap, bytes and goodput gauges;
with a flight recorder each migration is a ``plane.kv_migration`` device
window on its migration lane (export and transfer, CUDA events on a
card) and a ``kv_migration`` entry in the schedule chain (the resolved
transport as its algorithm); reqtrace tags each request's open
``migrating`` segment with the migration's ``seq``.

Elasticity: a :attr:`Replica.draining` replica serves what it holds but
receives no routing and no migrations; :meth:`ServingPlane.
_autoscale_round`, called once a plane round, is the hook the elastic
plane (``autoscaler.ElasticServingPlane``) overrides — this fixed plane
never changes shape. ``replica_rounds`` counts live replicas over plane
rounds, the denominator of :attr:`ServingPlane.goodput_per_replica_round`.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter, deque

import numpy as np
import torch

from hpc_patterns_tpu_torch.comm import migration_dma
from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib
from hpc_patterns_tpu_torch.harness import slo as slolib
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.models.serving import EngineCore
from hpc_patterns_tpu_torch.serving_plane.migration import (
    bundle_from_wire,
    bundle_to_wire,
    migrate_pages,
)

ROLES = ("both", "prefill", "decode")

#: KV-handoff transport tiers, fastest first — the fallback ladder:
#: ``dma`` = kernel 13 (comm/migration_dma.py; a reachable pair of
#: logical ranks), ``device_put`` = a ``.to`` the destination's device (a
#: device-less pair degrades to the in-place passthrough, ``local``),
#: ``wire`` = the socket codec's byte round trip
MIGRATION_TRANSPORTS = ("dma", "device_put", "wire")


class Replica:
    """One engine replica. ``role``: ``"both"`` (admit + decode),
    ``"prefill"`` (admission-prefill only; every row leaves by
    migration) or ``"decode"`` (work arrives only by migration).
    ``device``: the replica's endpoint — a :class:`~hpc_patterns_tpu_torch.
    topology.LogicalDevice` (two replicas on one card are two ranks of
    it) or a device, on which the engine must live; None = a host-shared
    replica (no DMA)."""

    def __init__(self, engine: EngineCore, *, name: str | None = None,
                 role: str = "both", device=None):
        if role not in ROLES:
            raise ValueError(f"role {role!r} not in {ROLES}")
        if engine.draft_params is not None and role != "both":
            raise ValueError(
                "draft-assisted engines cannot take a migration role "
                "(the draft cache's row state does not migrate)")
        if device is not None:
            phys = migration_dma.endpoint(device)[0]
            if migration_dma.endpoint(engine.device)[0] != phys:
                raise ValueError(
                    f"replica device {device} but its engine lives on "
                    f"{engine.device}")
        self.engine = engine
        self.role = role
        self.device = device
        self.name = name or role
        self.alive = True
        #: bundles transferred toward this replica, awaiting install
        self.pending_migrations: list = []
        #: plane-assigned ordinal: the identity ``die:replica=N`` chaos
        #: addresses
        self.index = -1
        #: replica-local round counter: the ``replica_round`` site's index
        self.rounds = 0
        #: a draining replica serves what it holds but receives no new
        #: routing and no migrations (the voluntary scale-down state)
        self.draining = False

    @property
    def can_prefill(self) -> bool:
        return self.role in ("both", "prefill")

    @property
    def can_decode(self) -> bool:
        return self.role in ("both", "decode")


def _eligible(plane: "ServingPlane", prompt_len: int,
              max_new: int) -> list[Replica]:
    return [r for r in plane.replicas
            if r.alive and not r.draining and r.can_prefill
            and r.engine.would_fit(prompt_len, max_new)]


def _least_loaded(plane, prompt_len, max_new):
    cand = _eligible(plane, prompt_len, max_new)
    if not cand:
        return None
    return max(cand, key=lambda r: (r.engine.free_page_count,
                                    -r.engine.queue_depth,
                                    -plane.replicas.index(r)))


def _round_robin(plane, prompt_len, max_new):
    cand = _eligible(plane, prompt_len, max_new)
    if not cand:
        return None
    r = cand[plane._rr % len(cand)]
    plane._rr += 1
    return r


def _weighted(plane, prompt_len, max_new):
    # the most weight per unit of present pressure; a replica with no
    # weight gets 1.0 (neutral)
    cand = _eligible(plane, prompt_len, max_new)
    if not cand:
        return None
    return max(cand, key=lambda r: (
        plane.placement_weights.get(r.name, 1.0)
        / (1.0 + r.engine.queue_depth),
        r.engine.free_page_count,
        -plane.replicas.index(r)))


PLACEMENT_POLICIES = {
    "least_loaded": _least_loaded,
    "round_robin": _round_robin,
    # role-awareness is structural: _eligible keeps prefill-capable
    # replicas only, so in a disaggregated plane least-loaded IS it
    "prefill_decode": _least_loaded,
    "weighted": _weighted,
}


def _wait_device(device: torch.device) -> None:
    """Completion of the work enqueued so far on ``device``'s current
    stream (a no-op on the CPU, where every op has completed)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ServingPlane:
    """Route a request stream across N replicas (see the module
    docstring). ``slo``: ``{priority: harness.slo.SLOTarget}`` — after
    each :meth:`run`, ``last_slo`` holds the plane-level attainment over
    the router's own stats table (a migrated request is judged once, end
    to end). ``emit``: a ``**record`` callable receiving the plane's
    records."""

    def __init__(self, replicas, *, policy: str = "least_loaded",
                 slo: dict | None = None,
                 placement_weights: dict | None = None,
                 migration: str = "device_put", emit=None):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("need at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        if policy not in PLACEMENT_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r} "
                f"(known: {', '.join(sorted(PLACEMENT_POLICIES))})")
        if migration not in MIGRATION_TRANSPORTS:
            raise ValueError(
                f"unknown migration transport {migration!r} "
                f"(known: {', '.join(MIGRATION_TRANSPORTS)})")
        self.policy_name = policy
        self.policy = PLACEMENT_POLICIES[policy]
        self.placement_weights = {
            str(k): float(v) for k, v in (placement_weights or {}).items()}
        self.disaggregated = any(r.role != "both" for r in self.replicas)
        if self.disaggregated:
            if not any(r.can_prefill for r in self.replicas):
                raise ValueError("disaggregated plane has no "
                                 "prefill-capable replica")
            if not any(r.can_decode for r in self.replicas):
                raise ValueError("disaggregated plane has no "
                                 "decode-capable replica")
        self._validate_engines()
        for i, r in enumerate(self.replicas):
            r.index = i
            if r.can_decode:  # the overlap fraction reads their chunks
                r.engine.track_chunk_windows = True
        self.slo = slo
        self._emit = emit or (lambda **kw: None)
        self.migration = migration
        self.stats: dict[int, dict] = {}
        self.finished: dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._assignment: dict[int, Replica] = {}
        self._rr = 0
        self._mig_seq = 0
        self.migrations = 0
        #: bundles dispatched per RESOLVED transport ("dma" / "device_put"
        #: / "local" / "wire"): a silent fallback cannot pass for dma
        self.migration_transports: Counter = Counter()
        self._transport_warned: set = set()
        #: Σ payload bytes over dispatched bundles (all transports)
        self.migration_bytes = 0
        #: open migration windows: seq -> (device window or None, host
        #: clock at dispatch)
        self._mig_open: dict[int, tuple] = {}
        self._mig_overlap_s = self._mig_total_s = 0.0
        self._dma_overlap_s = self._dma_total_s = 0.0
        self._serve_s = 0.0
        #: plane rounds served: the denominator of the bytes per round
        self.rounds_total = 0
        self.last_slo: dict | None = None
        self.last_kv_migration_overlap_frac: float | None = None
        self.last_dma_migration_overlap_frac: float | None = None
        #: the sliding-window attainment signal: requests judged as they
        #: resolve, emitted per plane round (gauge, trace counter, record)
        self.attain_window = slolib.AttainmentWindow()
        self._plane_rounds = 0
        self._attain_emitted = (0, 0)  # (judged, attained) last round
        #: replicas lost to chaos (by name, death order)
        self.deaths: list[str] = []
        #: requests shed BECAUSE their replica died
        self.shed_on_death = 0
        #: Σ over plane rounds of the live replicas that served them: the
        #: denominator of ``goodput_per_replica_round``
        self.replica_rounds = 0

    @classmethod
    def from_fitted(cls, replicas, fitted, *, slo: dict | None = None,
                    emit=None, **kw):
        """Build a plane from an autofit ``FittedConfig``: the fitted
        ``placement`` section picks the policy (``weighted`` routes by
        the fitted per-replica capacity shares); a config with no
        placement signal yields the default least-loaded plane. An
        explicit ``policy=`` kwarg wins over the fit."""
        from hpc_patterns_tpu_torch.harness import autofit as autofitlib

        fitted = autofitlib.validate_fitted(fitted)
        section = fitted.get("placement") or {}
        if "policy" not in kw and section.get("policy"):
            kw["policy"] = section["policy"]
        if "placement_weights" not in kw and section.get("weights"):
            kw["placement_weights"] = section["weights"]
        return cls(replicas, slo=slo, emit=emit, **kw)

    def _validate_engines(self) -> None:
        """Replicas must agree on what a request's tokens depend on
        (sampling mode, eos, and a sampling plane's seed, from which
        every replica derives the same ``request_key(sid)``), and for a
        plane that migrates on the model
        config and page size, or routing would change outputs."""
        e0 = self.replicas[0].engine
        for r in self.replicas[1:]:
            e = r.engine
            for attr in ("greedy", "top_k", "temperature", "eos_id"):
                if getattr(e, attr) != getattr(e0, attr):
                    raise ValueError(
                        f"replica {r.name!r} disagrees on {attr}: "
                        f"{getattr(e, attr)} vs {getattr(e0, attr)} — "
                        "routing would change outputs")
            if not e0.greedy and e.seed != e0.seed:
                raise ValueError(
                    f"replica {r.name!r} was built with a different seed: "
                    "request_key(sid) would differ by placement")
        if self.disaggregated:
            for r in self.replicas:
                e = r.engine
                if e.page_size != e0.page_size or e.cfg != e0.cfg:
                    raise ValueError(
                        f"replica {r.name!r}: migration needs identical "
                        "model config and page_size across replicas")

    # -- submission --------------------------------------------------------

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               deadline_s: float | None = None,
               temperature: float | None = None, key=None,
               resume_prefix=None) -> int:
        """Route one request: the policy picks a replica now, the request
        enters its queue under a plane-global id, and the plane's stats
        row opens. Raises when no replica could ever serve it."""
        prompt = np.asarray(prompt, np.int32)
        target = self.policy(self, int(prompt.size), int(max_new))
        if target is None:
            raise ValueError(
                f"no live replica can serve prompt {prompt.size} + "
                f"budget {max_new} (table width / ladder / max_seq)")
        if target.role == "prefill":
            # the row will LEAVE by migration: a decode replica must be
            # able to hold its pages, or it would park forever
            need = target.engine._pages_for(int(prompt.size), int(max_new))
            if not any(r.alive and r.can_decode
                       and need <= min(r.engine.pages_per_seq,
                                       r.engine.pool_pages)
                       for r in self.replicas):
                raise ValueError(
                    f"no decode-capable replica can hold the "
                    f"{need}-page migrated row of prompt "
                    f"{prompt.size} + budget {max_new}")
        rid = self._next_rid
        target.engine.submit(
            prompt, max_new, seq_id=rid, priority=priority,
            deadline_s=deadline_s, temperature=temperature, key=key,
            resume_prefix=resume_prefix)
        self._next_rid += 1
        self.stats[rid] = {
            "priority": int(priority), "t_submit": time.perf_counter(),
            "t_first": None, "t_finish": None, "tokens": 0,
            "outcome": None, "preemptions": 0, "replica": target.name}
        self._assignment[rid] = target
        self._emit(kind="plane_route", seq_id=rid, replica=target.name,
                   policy=self.policy_name, prompt_len=int(prompt.size),
                   budget=int(max_new), priority=int(priority))
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.routed").inc()
            m.gauge(f"plane.{target.name}.queue_depth").set(
                target.engine.queue_depth)
        return rid

    # -- the migration pipeline ------------------------------------------

    def _reserved_pages(self, r: Replica) -> int:
        return sum(b.n_pages for b in r.pending_migrations)

    def _pick_target(self, n_pages: int, src: Replica) -> Replica | None:
        """The decode replica a bundle should land on: decode-capable,
        not the donor, with room left after the bundles already in
        flight toward it. Least-loaded first."""
        cand = []
        for r in self.replicas:
            if not r.alive or not r.can_decode or r is src or r.draining:
                continue
            e = r.engine
            if e.slots - e.active_count - len(r.pending_migrations) < 1:
                continue
            if (self._reserved_pages(r) + n_pages > e.free_page_count
                    or n_pages > e.pages_per_seq):
                continue
            cand.append(r)
        if not cand:
            return None
        return max(cand, key=lambda r: (
            r.engine.free_page_count - self._reserved_pages(r),
            -r.engine.queue_depth))

    def _export_ready(self, src: Replica) -> int:
        """Export every migration-ready row of a prefill replica that has
        a destination and dispatch its transfer now, before the
        destination's decode chunk of this round. A row with no
        destination stays parked (smaller rows behind it may still go)."""
        n = 0
        for slot in src.engine.exportable_slots():
            dst = self._pick_target(len(src.engine._slots[slot].pages), src)
            if dst is None:
                continue
            self._dispatch_migration(src, slot, dst)
            n += 1
        return n

    def _transport_fallback(self, requested: str, actual: str,
                            reason: str) -> None:
        """The loud half of the ladder: a warning once per distinct
        reason — a plane asked for dma must never quietly serve on a
        slower tier."""
        key = (requested, actual, reason)
        if key not in self._transport_warned:
            self._transport_warned.add(key)
            warnings.warn(
                f"plane migration transport fell back "
                f"{requested} -> {actual}: {reason}",
                RuntimeWarning, stacklevel=3)
        self._emit(kind="plane_transport_fallback", requested=requested,
                   actual=actual, reason=reason)
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.transport_fallbacks").inc()

    def _resolve_transport(self, src: Replica, dst: Replica) -> str:
        """The transport to attempt for one (src, dst) pair: ``dma``
        needs a reachable pair (``migration_dma.dma_reachable``); the
        byte budget inside ``send_migration`` may still drop a bundle to
        ``device_put`` at dispatch."""
        if self.migration == "dma":
            ok, reason = migration_dma.dma_reachable(src.device,
                                                     dst.device)
            if ok:
                return "dma"
            self._transport_fallback("dma", "device_put", reason)
            return "device_put"
        return self.migration

    def _dispatch_migration(self, src: Replica, slot: int,
                            dst: Replica) -> None:
        """Export + transfer dispatch; opens the migration's window (and,
        with a recorder, its device window over the export and the
        transfer) and fingerprints it into the schedule chain with the
        resolved transport as its algorithm."""
        rec = tracelib.active()
        window = (rec.open_window(src.engine.device) if rec is not None
                  else None)
        bundle = src.engine.export_migration(slot)
        bundle.seq = self._mig_seq
        self._mig_seq += 1
        rtr = reqtracelib.active()
        if rtr is not None:
            # the engine opened `migrating` at export; tag it with the
            # plane seq this migration's device window carries
            rtr.annotate_open(bundle.seq_id, seq=bundle.seq)
        self.migration_bytes += sum(
            int(a.nbytes) for arrs in bundle.pages_payload.values()
            for a in arrs)
        transport = self._resolve_transport(src, dst)
        if transport == "dma":
            try:
                bundle = migration_dma.send_migration(
                    bundle, src.device, dst.device)
            except migration_dma.MigrationDmaError as e:
                self._transport_fallback("dma", "device_put", str(e))
                transport = "device_put"
        if transport == "device_put":
            bundle = migrate_pages(bundle, dst.device)
        elif transport == "wire":
            # the codec round trip IS the transport: the installed
            # payload crossed the encode/decode the socket plane ships
            w = bundle_to_wire(bundle)
            w["transport"] = "wire"
            bundle = bundle_from_wire(w)
        self.migration_transports[bundle.transport] += 1
        ps = self.stats.get(bundle.seq_id)
        if ps is not None and ps["t_first"] is None:
            ps["t_first"] = bundle.t_first
        if rec is not None:
            window = rec.mark_dispatch(
                "plane.kv_migration",
                {"seq": bundle.seq, "src": src.name, "dst": dst.name,
                 "pages": bundle.n_pages, "seq_id": bundle.seq_id},
                track=tracelib.migration_track(bundle.seq), window=window)
        if tracelib.schedule_consumer():
            kdt = str(bundle.pages_payload["k"][0].dtype)
            tracelib.record_collective(
                "kv_migration", bundle.seq,
                shape=(bundle.n_pages, bundle.page_size),
                dtype=kdt.removeprefix("torch."), axis="plane",
                algorithm=bundle.transport)
        self._mig_open[bundle.seq] = (window, time.perf_counter())
        dst.pending_migrations.append(bundle)
        self._emit(kind="plane_migrate", seq=bundle.seq,
                   seq_id=bundle.seq_id, src=src.name, dst=dst.name,
                   pages=bundle.n_pages)
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.migrations").inc()

    def _install_pending(self, r: Replica, overlapped: bool) -> list:
        """The decode side, from ``service_round``'s ``pre_collect`` —
        behind the in-flight chunk when there is one. Installs every
        arrived bundle the engine can take, in arrival order."""
        installed = []
        while r.pending_migrations and r.engine.migration_admissible(
                r.pending_migrations[0].n_pages):
            b = r.pending_migrations.pop(0)
            if b.transport == "dma":
                migration_dma.recv_migration(b, r.device)
            r.engine.install_migration(b)
            installed.append((b, overlapped))
            self.migrations += 1
            self.stats.setdefault(b.seq_id, {})["replica"] = r.name
        if r.pending_migrations:
            r.engine.request_pages(r.pending_migrations[0].n_pages)
        return installed

    def _complete_migrations(self, r: Replica, installed: list) -> None:
        """Close the installed bundles' windows once the install's device
        work is done, and fold their overlap with the destination's
        decode-chunk windows into the ledgers."""
        _wait_device(r.engine.device)
        t_done = time.perf_counter()
        rec = tracelib.active()
        # chunk windows that ended before every open migration began
        # can intersect none of them
        floor = min((t0 for _, t0 in self._mig_open.values()),
                    default=t_done)
        while r.engine.chunk_windows \
                and r.engine.chunk_windows[0][1] < floor:
            r.engine.chunk_windows.popleft()
        windows = list(r.engine.chunk_windows)
        for bundle, overlapped in installed:
            window, t0 = self._mig_open.pop(bundle.seq, (None, t_done))
            span = max(t_done - t0, 1e-9)
            under = min(span, sum(max(0.0, min(t_done, e) - max(t0, s))
                                  for s, e in windows))
            self._mig_total_s += span
            self._mig_overlap_s += under
            if bundle.transport == "dma":
                self._dma_total_s += span
                self._dma_overlap_s += under
            if rec is not None and window:
                rec.mark_complete(
                    "plane.kv_migration", window,
                    {"seq": bundle.seq, "dst": r.name,
                     "overlapped": overlapped},
                    track=tracelib.migration_track(bundle.seq))

    # -- result collection -------------------------------------------------

    def _collect_finished(self, r: Replica) -> int:
        """Pull finished/shed rows of a replica into the plane's tables
        (a migrated request keeps the t_first its prefill replica saw)."""
        eng = r.engine
        n = 0
        for sid in list(eng.finished):
            ps = self.stats.get(sid)
            if ps is None or ps.get("outcome") is not None:
                continue
            toks = eng.finished.pop(sid)
            es = eng.stats.get(sid, {})
            self.finished[sid] = toks
            if ps["t_first"] is None:
                ps["t_first"] = es.get("t_first")
            ps["t_finish"] = es.get("t_finish", time.perf_counter())
            ps["tokens"] = int(es.get("tokens") or len(toks))
            ps["outcome"] = es.get("outcome") or "ok"
            ps["preemptions"] = int(es.get("preemptions") or 0)
            ps["replica"] = r.name
            self._judge_window(ps)
            n += 1
        return n

    def _judge_window(self, ps: dict) -> None:
        """Fold one resolved stats row (served or shed) into the sliding
        attainment window, at resolution time."""
        if self.slo is not None:
            self.attain_window.judge(
                ps, self.slo.get(int(ps.get("priority") or 0),
                                 slolib.SLOTarget()))

    def _emit_attainment(self) -> None:
        """The per-round sliding-window attainment: one number as a
        metrics gauge, a trace counter and a ``plane_attainment``
        record."""
        if self.slo is None:
            return
        self._plane_rounds += 1
        snap = self.attain_window.snapshot()
        judged, attained = (self.attain_window.judged,
                            self.attain_window.attained)
        judged_round = judged - self._attain_emitted[0]
        attained_round = attained - self._attain_emitted[1]
        self._attain_emitted = (judged, attained)
        m = metricslib.get_metrics()
        if m.enabled and snap["overall"] is not None:
            m.gauge("plane.attainment").set(snap["overall"])
            for prio, frac in snap["per_class"].items():
                m.gauge(f"plane.attainment.p{prio}").set(frac)
        rec = tracelib.active()
        if rec is not None and snap["overall"] is not None:
            rec.counter("plane.attainment", {
                "overall": snap["overall"],
                **{f"p{prio}": frac
                   for prio, frac in snap["per_class"].items()}})
        self._emit(kind="plane_attainment", round=self._plane_rounds,
                   overall=snap["overall"],
                   per_class={str(p): f
                              for p, f in snap["per_class"].items()},
                   window_n=snap["n"], judged_round=judged_round,
                   attained_round=attained_round,
                   queued=sum(r.engine.queue_depth for r in self.replicas
                              if r.alive),
                   active=sum(r.engine.active_count for r in self.replicas
                              if r.alive),
                   replicas=sum(1 for r in self.replicas
                                if r.alive and not r.draining))

    def _update_gauges(self) -> None:
        m = metricslib.get_metrics()
        if not m.enabled:
            return
        for r in self.replicas:
            m.gauge(f"plane.{r.name}.queue_depth").set(
                r.engine.queue_depth)
            m.gauge(f"plane.{r.name}.free_pages").set(
                r.engine.free_page_count)

    # -- replica chaos and death -------------------------------------------

    def _probe_replica_chaos(self, r: Replica) -> bool:
        """The ``replica_round`` chaos site, probed once per live replica
        per plane round at its round counter and ordinal. Executed here,
        not by ``maybe_inject``: every replica shares this process, so a
        ``die`` marks one replica dead (:meth:`_kill_replica`) instead of
        killing the plane; a stall sleeps its delay. True when it
        died."""
        for f in chaoslib.matching("replica_round", r.rounds, r.index):
            if f.kind == "die":
                chaoslib.record_injection("replica_round", r.rounds, "die",
                                          rank=r.index)
                self._kill_replica(r)
                return True
            delay = f.delay_at("replica_round", r.rounds)
            chaoslib.record_injection("replica_round", r.rounds, f.kind,
                                      rank=r.index, delay_s=delay)
            if delay > 0.0:
                time.sleep(delay)
        return False

    def _kill_replica(self, r: Replica) -> None:
        """An involuntary replica loss: the plane never touches its engine
        again, and everything it held — active rows, queued requests,
        bundles parked toward it — goes to :meth:`_recover_casualties`."""
        if not r.alive:
            return
        r.alive = False
        self.deaths.append(r.name)
        active = [s.seq_id for s in r.engine._slots if s.active]
        queued = [req.seq_id for req in r.engine._queue]
        bundles = list(r.pending_migrations)
        r.pending_migrations.clear()
        for b in bundles:
            # the handoff died with its destination: its window never
            # completes
            self._mig_open.pop(b.seq, None)
        self._emit(kind="plane_replica_death", replica=r.name,
                   active=len(active), queued=len(queued),
                   bundles=len(bundles))
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.replica_deaths").inc()
        self._recover_casualties(r, active, queued, bundles)

    def _recover_casualties(self, r: Replica, active_sids, queued_sids,
                            bundles) -> None:
        """The fixed plane's recovery: SHED every casualty, counted (the
        elastic plane's checkpoint resume is a later slice)."""
        for sid in [*active_sids, *queued_sids,
                    *(b.seq_id for b in bundles)]:
            self._shed_request(sid, on_death=True)

    def _shed_request(self, sid: int, *, on_death: bool = False) -> None:
        """Close one request as shed on the plane's side: empty output,
        outcome ``"shed"``, judged by the attainment window."""
        ps = self.stats.get(sid)
        if ps is None or ps.get("outcome") is not None:
            return
        ps["outcome"] = "shed"
        ps["t_finish"] = time.perf_counter()
        rtr = reqtracelib.active()
        if rtr is not None:
            # the request may never have reached an engine's recorder:
            # open its queued span so the shed life still tiles
            if rtr.segments(sid) is None:
                rtr.begin_request(sid, ps["t_submit"])
            rtr.finish_request(sid, ps["t_finish"], final="shed")
        self._judge_window(ps)  # a shed never attains: it counts
        self.finished[sid] = np.zeros((0,), np.int32)
        if on_death:
            self.shed_on_death += 1
        self._emit(kind="plane_shed", seq_id=sid, on_death=on_death)
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.shed").inc()

    def _autoscale_round(self) -> bool:
        """Post-round scaling hook: this plane is fixed; the elastic plane
        overrides it. True when the plane changed shape (progress)."""
        return False

    # -- the plane loop ----------------------------------------------------

    def _round_order(self) -> list[Replica]:
        # prefill replicas first: their exports of this round must be in
        # flight before the decode replicas dispatch their chunks
        return ([r for r in self.replicas if r.role == "prefill"]
                + [r for r in self.replicas if r.role != "prefill"])

    def _has_work(self) -> bool:
        return any(r.alive and (r.engine.has_work() or r.pending_migrations)
                   for r in self.replicas)

    def _replica_round(self, r: Replica) -> bool:
        """One replica's share of a plane round; True if it progressed."""
        if r.role == "prefill":
            st = r.engine.service_round(decode=False)
            return bool(st["admitted"]) | (self._export_ready(r) > 0)
        installed: list = []
        pre = None
        if r.pending_migrations:
            def pre(overlapped):
                installed.extend(self._install_pending(r, overlapped))
        st = r.engine.service_round(pre_collect=pre)
        if installed:
            self._complete_migrations(r, installed)
        return bool(st["admitted"]) or st["active"] or bool(installed)

    def run(self, *, arrivals=None, max_rounds: int | None = None):
        """Serve until every replica's queue and slots and the (open-loop)
        arrivals drain; returns the plane's ``finished`` table.
        ``arrivals``: ``(t_rel_s, submit_kwargs)`` pairs on the
        schedule's clock, as ``ContinuousBatcher.run`` takes them.
        ``max_rounds``: park after this many plane rounds and return."""
        t_run0 = time.perf_counter()
        pending = (deque(sorted(arrivals, key=lambda a: a[0]))
                   if arrivals else None)
        rounds = 0
        while True:
            while pending and pending[0][0] <= time.perf_counter() - t_run0:
                t_arr, kw = pending.popleft()
                try:
                    rid = self.submit(**kw)
                except ValueError:
                    if not self.deaths:
                        raise  # a config error, not degradation
                    # an arrival no surviving replica can place: the
                    # degraded plane sheds it, counted
                    rid = self._next_rid
                    self._next_rid += 1
                    self.stats[rid] = {
                        "priority": int(kw.get("priority", 0)),
                        "t_submit": t_run0 + t_arr, "t_first": None,
                        "t_finish": None, "tokens": 0, "outcome": None,
                        "preemptions": 0, "replica": None}
                    self._shed_request(rid, on_death=True)
                    continue
                # the schedule's instant, end to end: the plane row, the
                # replica's queue entry and its stats row
                t_abs = t_run0 + t_arr
                self.stats[rid]["t_submit"] = t_abs
                eng = self._assignment[rid].engine
                eng._queue[-1].t_submit = t_abs
                eng.stats[rid]["t_submit"] = t_abs
                rtr = reqtracelib.active()
                if rtr is not None:
                    rtr.restamp_submit(rid, t_abs)
            if not self._has_work():
                if not pending or max_rounds is not None:
                    break
                wait = pending[0][0] - (time.perf_counter() - t_run0)
                time.sleep(min(max(wait, 0.0), 0.005))
                continue
            if max_rounds is not None and rounds >= max_rounds:
                break
            rounds += 1
            self.rounds_total += 1
            progressed = False
            chaos_on = chaoslib.active() is not None
            for r in self._round_order():
                if not r.alive:
                    continue
                if chaos_on and self._probe_replica_chaos(r):
                    progressed = True  # the death recovery moved work
                    continue
                progressed |= self._replica_round(r)
                r.rounds += 1
                self.replica_rounds += 1
                progressed |= self._collect_finished(r) > 0
            self._update_gauges()
            self._emit_attainment()
            progressed |= self._autoscale_round()
            if not progressed and not pending:
                queued = {r.name: r.engine.queue_depth
                          for r in self.replicas if r.alive}
                raise RuntimeError(
                    f"serving-plane deadlock: work remains but no replica "
                    f"can make progress (queues {queued}, pending "
                    f"migrations "
                    f"{[len(r.pending_migrations) for r in self.replicas]}"
                    ") — pools too small for the waiting requests?")
        self._serve_s += time.perf_counter() - t_run0
        if self._mig_total_s > 0:
            self.last_kv_migration_overlap_frac = (
                self._mig_overlap_s / self._mig_total_s)
        if self._dma_total_s > 0:
            self.last_dma_migration_overlap_frac = (
                self._dma_overlap_s / self._dma_total_s)
        m = metricslib.get_metrics()
        if m.enabled:
            m.gauge("plane.migrations").set(self.migrations)
            if self.last_kv_migration_overlap_frac is not None:
                m.gauge("plane.kv_migration_overlap_frac").set(
                    self.last_kv_migration_overlap_frac)
            if self.last_dma_migration_overlap_frac is not None:
                m.gauge("plane.dma_migration_overlap_frac").set(
                    self.last_dma_migration_overlap_frac)
            m.gauge("plane.migration_bytes_per_round").set(
                self.migration_bytes_per_round)
        if self.slo is not None:
            self.last_slo = slolib.attainment(self.stats, self.slo,
                                              self._serve_s)
            if m.enabled:
                tot = self.last_slo["total"]
                m.gauge("plane.tok_s").set(tot["tok_s"])
                m.gauge("plane.goodput_tok_s").set(tot["goodput_tok_s"])
                if self.replica_rounds:
                    m.gauge("plane.goodput_per_replica_round").set(
                        self.goodput_per_replica_round or 0.0)
        return self.finished

    @property
    def goodput_per_replica_round(self) -> float | None:
        """SLO-attained tokens per (live replica x plane round): a plane
        that holds attainment by over-provisioning pays here, one that
        sheds pays in the numerator. None until a run with ``slo=``."""
        if self.last_slo is None or not self.replica_rounds:
            return None
        tot = self.last_slo["total"]
        return tot["goodput_tok_s"] * self.last_slo["wall_s"] \
            / self.replica_rounds

    @property
    def migration_bytes_per_round(self) -> float:
        """Σ dispatched KV-payload bytes per plane round: the same bytes
        cross whichever transport resolved. 0.0 before any round."""
        return self.migration_bytes / max(1, self.rounds_total)
