"""The autoscaler's pure controller — the decision half of
``hpc_patterns_tpu/serving_plane/autoscaler.py``, copied.

:class:`Autoscaler` observes one :class:`Signals` snapshot per plane
round (queue pressure, sliding-window SLO attainment, live replica
count) and emits one :class:`Decision` (``up`` / ``down`` / ``hold``)
under an :class:`AutoscalerPolicy` with hysteresis bands (``up_queue``
> ``down_queue``; attainment must RECOVER past ``down_attainment``
before a scale-down), a cooldown between actions, and min/max clamps.
No randomness, no clock: the same signal trajectory always yields the
same decision log. ``harness/autofit.py`` replays recorded trajectories
through it offline to fit the bands (``fit_autoscaler``), and
:meth:`AutoscalerPolicy.from_fitted` applies them.

Not here yet: the JAX module's actuation halves (ROADMAP item 5, with
the launched plane). ``WarmParamPool`` parks replica weights in the host
tier through the residency manager (``memory/residency.py``), and
``ElasticServingPlane`` scales a live plane up and down over the router. :func:`spinup_track` names
the device subtrack their ``plane.spinup`` windows will use.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from dataclasses import fields as dataclasses_fields

from hpc_patterns_tpu_torch.harness import trace as tracelib

#: device-subtrack band for ``plane.spinup`` windows (harness/trace.py's
#: TRACK_BANDS, between the migration band and the residency band)
SPINUP_TRACK_BASE, SPINUP_TRACKS = tracelib.track_band("spinup")


def spinup_track(ordinal: int) -> int:
    """The device subtrack a replica spin-up's window lands on."""
    return SPINUP_TRACK_BASE + int(ordinal) % SPINUP_TRACKS


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
