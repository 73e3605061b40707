"""Elastic serving plane: SLO-feedback autoscaling with residency-backed
warm replica spin-up — the counterpart of
``hpc_patterns_tpu/serving_plane/autoscaler.py``.

Three pieces:

- :class:`Autoscaler` — the DECISION half, deliberately pure: it observes
  one :class:`Signals` snapshot per plane round (queue pressure,
  sliding-window SLO attainment, live replica count) and emits one
  :class:`Decision` (``up`` / ``down`` / ``hold``) under an
  :class:`AutoscalerPolicy` with hysteresis bands (``up_queue`` >
  ``down_queue``; attainment must RECOVER past ``down_attainment`` before
  a scale-down), a cooldown between actions, and min/max clamps. No
  randomness, no clock: the same signal trajectory always yields the same
  decision log. ``harness/autofit.py`` replays recorded trajectories
  through it offline to fit the bands (``fit_autoscaler``), and
  :meth:`AutoscalerPolicy.from_fitted` applies them.
- :class:`WarmParamPool` — the WARM SPIN-UP half: replica weights parked
  ONCE in the host tier through the residency manager
  (``memory/residency.ResidencyManager``: pinned host memory on the card,
  where a pageable tensor makes the push raise; a CPU clone on the CPU),
  so a scale-up pages bytes back instead of re-running ``init_params``.
- :class:`ElasticServingPlane` — the ACTUATION half over the router:
  scale-UP builds a new replica on warm-pulled weights, its acquisition
  one ``plane.spinup`` window on :func:`spinup_track` (from the pull to
  the new engine's device work observed complete); scale-DOWN drains —
  the victim stops receiving routing, its queued requests re-route, its
  in-flight rows EXPORT to survivors through the router's
  ``export_migration``/``install_migration`` path (nothing sheds on a
  voluntary drain), and it retires once empty. An involuntary death (the
  router's ``die:replica=N`` chaos) recovers from the plane's RESUME
  CHECKPOINT, refreshed at every replica round: each active row's
  observed tokens and, sampled, its sampler key (a ``.cpu()`` copy of the
  engine's keys after the chunk's readback), so a dead replica's streams
  continue on survivors exactly, greedy and sampled.

The robustness verdict lives in ``bench_serving --elastic``: a diurnal
ramp under replica-death chaos where this plane holds per-class SLO
attainment while the fixed plane sheds, with
``goodput_per_replica_round`` reported so the trajectory rewards
efficiency, not just peak.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from dataclasses import fields as dataclasses_fields

import numpy as np

from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import slo as slolib
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.serving_plane.migration import migrate_pages
from hpc_patterns_tpu_torch.serving_plane.router import (
    Replica,
    ServingPlane,
    _wait_device,
)

#: device-subtrack band for ``plane.spinup`` windows (harness/trace.py's
#: TRACK_BANDS, between the migration band and the residency band)
SPINUP_TRACK_BASE, SPINUP_TRACKS = tracelib.track_band("spinup")


def spinup_track(ordinal: int) -> int:
    """The device subtrack a replica spin-up's window lands on."""
    return SPINUP_TRACK_BASE + int(ordinal) % SPINUP_TRACKS


# ---------------------------------------------------------------------------
# the decision half (pure)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AutoscalerPolicy:
    """The control law's knobs.

    ``up_queue``/``down_queue``: queue-pressure thresholds in QUEUED
    REQUESTS PER LIVE REPLICA, averaged over the signal window. The
    gap between them IS the hysteresis band: scale up only STRICTLY
    above ``up_queue``, scale down only STRICTLY below ``down_queue``
    — a steady load sitting on either boundary holds (no flap).
    ``up_attainment``/``down_attainment``: window SLO-attainment
    thresholds — attainment below ``up_attainment`` scales up even at
    modest queues (latency is the SLO, not depth), and a scale-down
    additionally requires attainment at/above ``down_attainment``
    (capacity is only returned once the SLO has recovered past where
    the scale-up bar sits). ``cooldown_rounds``: rounds after any
    action during which only the min-clamp may act (a death must be
    replaceable immediately; ordinary scaling waits out its own
    transient). ``window``: rounds of signal smoothing."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_queue: float = 3.0
    down_queue: float = 0.5
    up_attainment: float = 0.9
    down_attainment: float = 0.98
    cooldown_rounds: int = 4
    window: int = 8

    @classmethod
    def from_fitted(cls, fitted, **overrides) -> "AutoscalerPolicy":
        """A policy from an autofit ``FittedConfig``: the fitted
        ``autoscaler`` section's hysteresis bands (picked by replaying
        the recorded attainment/queue trajectory through this very
        controller offline and keeping the non-flapping candidate) —
        defaults where the config has no trajectory. Keyword overrides
        win over the fit (deployment clamps like ``max_replicas``
        stay the operator's)."""
        from hpc_patterns_tpu_torch.harness import autofit as autofitlib

        fitted = autofitlib.validate_fitted(fitted)
        section = fitted.get("autoscaler") or {}
        kw = {f.name: section[f.name]
              for f in dataclasses_fields(cls)
              if f.name in section}
        kw.update(overrides)
        return cls(**kw)

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")
        if not 0.0 <= self.down_queue < self.up_queue:
            raise ValueError(
                f"hysteresis needs 0 <= down_queue < up_queue, got "
                f"{self.down_queue}/{self.up_queue} — equal thresholds "
                "flap at a steady boundary load")
        if not 0.0 <= self.up_attainment <= self.down_attainment <= 1.0:
            raise ValueError(
                f"need 0 <= up_attainment <= down_attainment <= 1, got "
                f"{self.up_attainment}/{self.down_attainment}")
        if self.cooldown_rounds < 0 or self.window < 1:
            raise ValueError(
                f"cooldown_rounds >= 0 and window >= 1 required, got "
                f"{self.cooldown_rounds}/{self.window}")


@dataclass(frozen=True)
class Signals:
    """One plane round's observed state — everything the controller
    is allowed to see. ``attained``/``judged``: requests resolved
    inside the policy window and how many of them met their class SLO
    (shed counts as judged-and-missed)."""

    round: int
    replicas: int        # live, non-draining
    queued: int          # total queue depth across them
    active: int          # total active rows
    #: requests resolved THIS round (a per-round delta, like every
    #: other field): the controller's own window is the ONLY
    #: smoothing — a producer must not pre-aggregate, or each
    #: judgment counts up to window× and lags decisions ~2×window
    attained: int = 0
    judged: int = 0


@dataclass(frozen=True)
class Decision:
    """One round's verdict, with the evidence that produced it — the
    decision log is the replay/determinism handle."""

    round: int
    action: str          # "up" | "down" | "hold"
    reason: str
    replicas: int        # live count the decision saw
    pressure: float      # window-mean queued-per-replica
    attainment: float | None  # window attainment (None: nothing judged)


class Autoscaler:
    """The pure controller: ``observe(signals) -> Decision``, one call
    per plane round. Holds only the signal window, the cooldown
    counter, and the decision log — a deterministic function of the
    signal sequence (pinned by tests/test_autoscaler.py)."""

    def __init__(self, policy: AutoscalerPolicy | None = None):
        self.policy = policy or AutoscalerPolicy()
        self._window: deque = deque(maxlen=self.policy.window)
        self._cooldown = 0
        self.decisions: list[Decision] = []

    def _decide(self, sig: Signals) -> tuple[str, str]:
        p = self.policy
        pressure = self.pressure
        att = self.attainment
        # the min-clamp outranks the cooldown: a replica death below
        # the floor must be replaceable THIS round, not after waiting
        # out the transient of the very action that dropped the count
        if sig.replicas < p.min_replicas:
            return "up", (f"below min_replicas "
                          f"({sig.replicas} < {p.min_replicas})")
        if self._cooldown > 0:
            return "hold", f"cooldown ({self._cooldown} round(s) left)"
        if sig.replicas < p.max_replicas:
            if pressure > p.up_queue:
                return "up", (f"queue pressure {pressure:.2f} > "
                              f"{p.up_queue}")
            if att is not None and att < p.up_attainment:
                return "up", (f"attainment {att:.2f} < "
                              f"{p.up_attainment}")
        if sig.replicas > p.min_replicas \
                and pressure < p.down_queue and sig.queued == 0 \
                and (att is None or att >= p.down_attainment):
            return "down", (f"queue pressure {pressure:.2f} < "
                            f"{p.down_queue}, attainment recovered")
        return "hold", "inside the hysteresis band"

    @property
    def pressure(self) -> float:
        """Window-mean queued requests per live replica."""
        if not self._window:
            return 0.0
        return sum(s.queued / max(1, s.replicas)
                   for s in self._window) / len(self._window)

    @property
    def attainment(self) -> float | None:
        """Window SLO-attainment fraction; None when nothing was
        judged inside the window (no verdict = no latency evidence)."""
        judged = sum(s.judged for s in self._window)
        if not judged:
            return None
        return sum(s.attained for s in self._window) / judged

    def observe(self, sig: Signals) -> Decision:
        self._window.append(sig)
        action, reason = self._decide(sig)
        if self._cooldown > 0:
            self._cooldown -= 1
        if action != "hold":
            self._cooldown = self.policy.cooldown_rounds
        dec = Decision(round=sig.round, action=action, reason=reason,
                       replicas=sig.replicas, pressure=self.pressure,
                       attainment=self.attainment)
        self.decisions.append(dec)
        return dec


# ---------------------------------------------------------------------------
# the warm spin-up half (residency-backed parked weights)
# ---------------------------------------------------------------------------


class WarmParamPool:
    """Replica weights parked in the HOST tier, pulled per spin-up.

    The params tree is pushed ONCE through the residency manager's
    instrumented pipeline (``mem.evict`` window; pinned host tensors on the
    card — a pageable one makes the push raise — a CPU clone on the CPU)
    and registered as a host-tier group of the weights' device. Each
    :meth:`pull` dispatches an independent host -> device copy
    (``mem.prefetch`` window) — a READ-THROUGH of the parked template,
    which stays for the next spin-up — and the caller closes it with
    :meth:`complete` once it observed completion. Nothing re-runs
    ``init_params``: the bytes already exist."""

    def __init__(self, params, *, manager=None):
        from hpc_patterns_tpu_torch.memory import ResidencyManager
        from hpc_patterns_tpu_torch.memory import kinds as kindslib

        leaves = kindslib.tree_tensors(params)
        nbytes = sum(a.numel() * a.element_size() for a in leaves)
        self.manager = manager or ResidencyManager(
            host_blocks=max(1, len(leaves)), device=leaves[0].device)
        self.manager.register_group(
            "warm_params", len(leaves), nbytes, tier="host")
        self.host_params = self.manager.push_payload(
            params, attrs={"what": "warm_params"})
        self.manager.drain()  # the park is complete; close its window
        self.nbytes = nbytes
        self.pulls = 0

    def pull(self):
        """Dispatch one host -> device copy of the parked weights; returns
        ``(device_params, handle)``. The current stream waits for the copy
        on the device (no host sync), so an engine built on the params
        next reads them after it lands."""
        payload, handle = self.manager.pull_payload(
            self.host_params, attrs={"what": "warm_params",
                                     "pull": self.pulls})
        self.manager.wait_pull(handle)
        self.pulls += 1
        return payload, handle

    def complete(self, handle) -> None:
        """Close the pull's ``mem.prefetch`` window at an observed
        completion (the caller just synchronized on the new engine)."""
        self.manager.complete_pull(handle)


# ---------------------------------------------------------------------------
# the actuation half: the elastic plane
# ---------------------------------------------------------------------------


class ElasticServingPlane(ServingPlane):
    """A :class:`~hpc_patterns_tpu_torch.serving_plane.router.ServingPlane`
    that changes shape under the controller (the module docstring has the
    design). ``engine_factory(params) -> EngineCore`` builds a new
    replica's engine on warm-pulled weights; its engines must agree with
    the existing ones on config, sampling mode and seed (validated on
    every spin-up).

    Death recovery: each replica round ends with a RESUME CHECKPOINT
    (observed tokens per active row, plus the row's sampler key when
    sampled); an involuntary death re-submits each in-flight row on a
    survivor as an ordinary resume (prompt = original + observed,
    ``resume_prefix``, the snapshot key) — the exactness contract
    preemption already holds. Queued requests re-route; bundles parked
    toward the dead replica re-target. Only a request NO survivor can
    hold sheds."""

    def __init__(self, replicas, *, engine_factory, warm_pool,
                 autoscaler: Autoscaler | None = None,
                 new_replica_role: str = "both", **kw):
        super().__init__(replicas, **kw)
        self.engine_factory = engine_factory
        self.warm_pool = warm_pool
        self.autoscaler = autoscaler or Autoscaler()
        self.new_replica_role = new_replica_role
        self._next_replica = len(self.replicas)
        self._round_no = 0
        #: the submit kwargs of each unresolved request: what recovery
        #: rebuilds a queued request or a resume from
        self._requests: dict[int, dict] = {}
        #: resume checkpoint: sid -> {"out": [...], "key": (2,) uint32 or
        #: None, "replica": name, "t_first": ...}, refreshed at every
        #: round boundary, dropped on resolution
        self._ckpt: dict[int, dict] = {}
        #: requests awaiting an SLO judgment (O(unresolved) per round)
        self._unjudged: set[int] = set()
        #: attained? verdicts since the last signal: ONE Signals delta a
        #: plane round
        self._judgments: deque = deque(maxlen=4096)
        #: death-resumes per sid, folded into the stats row's preemption
        #: count at resolution (the engine that held the earlier leg is
        #: gone, so the engine-side count cannot include them)
        self._death_resumes: dict[int, int] = {}
        self.spinup_s: list[float] = []
        self.resumed: list[int] = []
        self.drained: list[str] = []
        self.retired: list[str] = []

    # -- signals -----------------------------------------------------------

    def _signals(self) -> Signals:
        live = [r for r in self.replicas if r.alive and not r.draining]
        # this round's judgments only: the controller's window is the one
        # smoothing
        attained = sum(1 for a in self._judgments if a)
        judged = len(self._judgments)
        self._judgments.clear()
        return Signals(
            round=self._round_no,
            replicas=len(live),
            queued=sum(r.engine.queue_depth for r in live),
            active=sum(r.engine.active_count for r in live),
            attained=attained,
            judged=judged,
        )

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               deadline_s: float | None = None,
               temperature: float | None = None, key=None,
               resume_prefix=None) -> int:
        rid = super().submit(prompt, max_new, priority=priority,
                             deadline_s=deadline_s,
                             temperature=temperature, key=key,
                             resume_prefix=resume_prefix)
        self._requests[rid] = {
            "prompt": np.asarray(prompt, np.int32), "max_new": int(max_new),
            "priority": int(priority), "deadline_s": deadline_s,
            "temperature": temperature, "key": key}
        self._unjudged.add(rid)
        return rid

    def _shed_request(self, sid: int, *, on_death: bool = False) -> None:
        # the one resolution path that can open a stats row WITHOUT submit
        # (the unplaceable-arrival shed of the base run loop)
        if self.stats.get(sid, {}).get("outcome") is None:
            self._unjudged.add(sid)
        self._requests.pop(sid, None)  # resolved: recovery never reads it
        super()._shed_request(sid, on_death=on_death)

    def _judge_resolved(self) -> None:
        """Judge every request resolved since the last pass into the
        controller's signal (a shed is judged-and-missed), once a plane
        round, over the unresolved set only."""
        for sid in list(self._unjudged):
            ps = self.stats.get(sid)
            if ps is None or ps.get("outcome") is None:
                continue
            self._unjudged.discard(sid)
            # death-resumes fold in HERE, once, at resolution
            ps["preemptions"] = (int(ps.get("preemptions") or 0)
                                 + self._death_resumes.pop(sid, 0))
            target = (self.slo or {}).get(
                ps.get("priority", 0), slolib.SLOTarget())
            self._judgments.append(slolib.attained(ps, target))
            self._ckpt.pop(sid, None)

    def _collect_finished(self, r: Replica) -> int:
        n = super()._collect_finished(r)
        for sid in list(self._requests):
            if self.stats.get(sid, {}).get("outcome") is not None:
                del self._requests[sid]
        self._checkpoint_replica(r)
        return n

    # -- the resume checkpoint ---------------------------------------------

    def _checkpoint_replica(self, r: Replica) -> None:
        """Refresh the resume checkpoint for one replica at its round
        boundary: the chunk is collected, so each active row's ``out`` and
        its sampler key are consistent — the (tokens, key) pair a
        preemption snapshot carries."""
        eng = r.engine
        act = [(i, s) for i, s in enumerate(eng._slots) if s.active]
        if not act:
            return
        # the keys' host copy (uint32 words in int64 lanes), after the
        # chunk's readback
        keys = (None if eng.greedy
                # torchlint: disable=host-sync-in-dispatch — a deliberate
                # round-boundary key snapshot, after the chunk's readback
                else eng.keys.cpu().numpy().astype(np.uint32))
        for i, s in act:
            self._ckpt[s.seq_id] = {
                "out": list(s.out),
                "key": keys[i].copy() if keys is not None else None,
                "replica": r.name,
                # the engine-side first-token stamp: a resume keeps the
                # TTFT the user saw
                "t_first": eng.stats.get(s.seq_id, {}).get("t_first"),
            }

    # -- death recovery (overrides the static shed) ------------------------

    def _recover_casualties(self, r: Replica, active_sids, queued_sids,
                            bundles) -> None:
        for sid in active_sids:
            ck = self._ckpt.get(sid)
            req = self._requests.get(sid)
            if ck is None or req is None:
                self._shed_request(sid, on_death=True)
                continue
            out = ck["out"]
            if len(out) >= req["max_new"]:
                # fully emitted, finish report lost with the replica: the
                # observed tokens ARE the output
                ps = self.stats[sid]
                ps["outcome"], ps["tokens"] = "ok", len(out)
                if ps["t_first"] is None:
                    ps["t_first"] = ck.get("t_first")
                ps["t_finish"] = time.perf_counter()
                self.finished[sid] = np.asarray(out, np.int32)
                self._requests.pop(sid, None)
                continue
            if self._resume_request(sid, req, out, ck):
                self.resumed.append(sid)
            else:
                self._shed_request(sid, on_death=True)
        for sid in queued_sids:
            req = self._requests.get(sid)
            if req is None or not self._route_again(sid, req):
                self._shed_request(sid, on_death=True)
        for b in bundles:
            dst = self._pick_target(b.n_pages, r)
            if dst is None:
                self._shed_request(b.seq_id, on_death=True)
                continue
            self._mig_open[b.seq] = (None, time.perf_counter())
            dst.pending_migrations.append(migrate_pages(b, dst.device))

    def _resume_request(self, sid: int, req: dict, out, ck) -> bool:
        """Continue a dead replica's in-flight row on a survivor as an
        ordinary RESUME: prompt = original + observed tokens, the
        checkpoint key seeding the sampled stream."""
        key = ck.get("key")
        out_arr = np.asarray(out, np.int32)
        prompt = (np.concatenate([req["prompt"], out_arr])
                  if len(out_arr) else req["prompt"])
        remaining = req["max_new"] - len(out_arr)
        target = self._pick_survivor(int(prompt.size), remaining)
        if target is None:
            return False
        kw = {}
        if not target.engine.greedy and key is not None:
            kw["key"] = np.asarray(key, np.uint32)
        target.engine.submit(
            prompt, remaining, seq_id=sid,
            priority=req["priority"], deadline_s=req["deadline_s"],
            temperature=req["temperature"],
            resume_prefix=out_arr if len(out_arr) else None, **kw)
        self._assignment[sid] = target
        ps = self.stats[sid]
        # the row's story continues, its clocks do not restart: TTFT keeps
        # the first token the user saw on the dead replica
        if ps["t_first"] is None:
            ps["t_first"] = ck.get("t_first")
        # counted only through _death_resumes, folded in at resolution
        self._death_resumes[sid] = self._death_resumes.get(sid, 0) + 1
        ps["replica"] = target.name
        self._emit(kind="plane_resume", seq_id=sid,
                   replica=target.name, tokens=len(out_arr))
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.death_resumes").inc()
        return True

    def _route_again(self, sid: int, req: dict) -> bool:
        """Re-route a queued (no device state) casualty wholesale."""
        target = self._pick_survivor(int(req["prompt"].size),
                                     req["max_new"])
        if target is None:
            return False
        target.engine.submit(
            req["prompt"], req["max_new"], seq_id=sid,
            priority=req["priority"], deadline_s=req["deadline_s"],
            temperature=req["temperature"], key=req["key"])
        # the clocks do not restart on re-routing: the shed deadline and
        # TTFT still count from the ORIGINAL submit
        t0 = self.stats[sid]["t_submit"]
        target.engine._queue[-1].t_submit = t0
        target.engine.stats[sid]["t_submit"] = t0
        self._assignment[sid] = target
        self.stats[sid]["replica"] = target.name
        return True

    def _pick_survivor(self, prompt_len: int,
                       max_new: int) -> Replica | None:
        cand = [r for r in self.replicas
                if r.alive and not r.draining
                and r.engine.would_fit(prompt_len, max_new)]
        if not cand:
            return None
        return max(cand, key=lambda r: (r.engine.free_page_count,
                                        -r.engine.queue_depth,
                                        -r.index))

    # -- the control loop --------------------------------------------------

    def _autoscale_round(self) -> bool:
        self._round_no += 1
        self._judge_resolved()
        changed = self._drain_step()
        dec = self.autoscaler.observe(self._signals())
        if dec.action == "up":
            changed |= self._spin_up(reason=dec.reason)
        elif dec.action == "down":
            changed |= self._begin_drain(reason=dec.reason)
        return changed

    def _live_count(self) -> int:
        return sum(1 for x in self.replicas if x.alive and not x.draining)

    def _spin_up(self, *, reason: str = "") -> bool:
        """Warm scale-up: pull the parked weights from the host tier, build
        a fresh replica on them and join the plane — the whole acquisition
        one ``plane.spinup`` window (from the pull's dispatch to the new
        engine's device work observed complete), the number the bench
        compares against a cold ``init_params`` + engine build."""
        name = f"r{self._next_replica}"
        rec = tracelib.active()
        t0 = time.perf_counter()
        t_disp = (rec.mark_dispatch(
            "plane.spinup", {"replica": name, "reason": reason},
            track=spinup_track(self._next_replica))
            if rec is not None else 0.0)
        params, handle = self.warm_pool.pull()
        engine = self.engine_factory(params)
        rep = Replica(engine, name=name, role=self.new_replica_role)
        # completion: the pulled params and the engine's fresh device
        # state resolved
        _wait_device(engine.device)
        self.warm_pool.complete(handle)
        dt = time.perf_counter() - t0
        rep.index = self._next_replica
        self._next_replica += 1
        if rep.can_decode:
            engine.track_chunk_windows = True
        self.replicas.append(rep)
        try:
            self._validate_engines()
        except ValueError:
            self.replicas.pop()
            raise
        self.spinup_s.append(dt)
        if rec is not None and t_disp:
            rec.mark_complete(
                "plane.spinup", t_disp,
                {"replica": name, "spinup_s": round(dt, 6)},
                track=spinup_track(rep.index))
        self._emit(kind="plane_spinup", replica=name, spinup_s=dt,
                   reason=reason)
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.spinups").inc()
            m.gauge("plane.replicas").set(self._live_count())
        return True

    def _begin_drain(self, *, reason: str = "") -> bool:
        """Voluntary scale-down: put the emptiest live replica in DRAIN —
        no new routing, no inbound migrations; its work leaves through
        :meth:`_drain_step`. A victim whose loss would strand a role (the
        last prefill- or decode-capable replica) is never picked."""
        live = [r for r in self.replicas if r.alive and not r.draining]
        if len(live) <= self.autoscaler.policy.min_replicas:
            return False
        cand = []
        for r in live:
            rest = [x for x in live if x is not r]
            if not any(x.can_prefill for x in rest) \
                    or not any(x.can_decode for x in rest):
                continue
            cand.append(r)
        if not cand:
            return False
        victim = min(cand, key=lambda r: (
            r.engine.active_count + r.engine.queue_depth
            + len(r.pending_migrations),
            -r.index))
        victim.draining = True
        self.drained.append(victim.name)
        self._emit(kind="plane_drain", replica=victim.name, reason=reason)
        m = metricslib.get_metrics()
        if m.enabled:
            m.counter("plane.drains").inc()
        return True

    def _drain_step(self) -> bool:
        """Advance every draining replica one step: re-route its queued
        requests, EXPORT its active rows to survivors through the migration
        path (nothing sheds on a voluntary drain; a row with no destination
        this round waits), and retire the replica once empty."""
        changed = False
        for r in self.replicas:
            if not (r.alive and r.draining):
                continue
            for req in list(r.engine._queue):
                target = self._pick_survivor(int(req.prompt.size),
                                             req.max_new)
                if target is None:
                    continue  # stays queued; retried next round
                r.engine._queue = [q for q in r.engine._queue
                                   if q is not req]
                r.engine.stats.pop(req.seq_id, None)
                target.engine.submit(
                    req.prompt, req.max_new, seq_id=req.seq_id,
                    priority=req.priority, deadline_s=req.deadline_s,
                    temperature=req.temperature, key=req.key,
                    resume_prefix=req.resume_prefix)
                # clocks do not restart on a drain re-route
                target.engine._queue[-1].t_submit = req.t_submit
                target.engine.stats[req.seq_id]["t_submit"] = req.t_submit
                self._assignment[req.seq_id] = target
                self.stats[req.seq_id]["replica"] = target.name
                changed = True
            for slot in r.engine.exportable_slots():
                need = len(r.engine._slots[slot].pages)
                dst = self._pick_target(need, r)
                if dst is None:
                    continue  # parked on the donor; next round
                self._dispatch_migration(r, slot, dst)
                changed = True
            if not r.engine.has_work() and not r.pending_migrations:
                r.alive = False
                r.draining = False
                self.retired.append(r.name)
                self._emit(kind="plane_retire", replica=r.name)
                m = metricslib.get_metrics()
                if m.enabled:
                    m.gauge("plane.replicas").set(self._live_count())
                changed = True
        return changed
