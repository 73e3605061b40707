"""Chaos injection: seeded, replayable fault injectors for robustness
runs — the counterpart of ``hpc_patterns_tpu/harness/chaos.py``, copied
(stdlib only; the port imports nothing of the JAX package).

Four fault kinds, each deterministic given its spec (the same spec over
the same workload reproduces the same perturbation):

- ``straggler``: injected delay at the ``collective`` site;
- ``stall``: injected delay at the ``engine_round`` site — the serving
  loop (``models/serving.py``) checks once per scheduler round, so a
  paused host reads as a bubble in the busy/bubble rollup;
- ``die``: worker death at the ``collective`` site — ``SIGKILL``
  (default) or ``os._exit(code)``; at the ``replica_round`` site the
  in-process serving plane (``serving_plane/router.py``) marks the
  replica dead instead (:func:`matching`);
- ``slow_host_transfer``: injected delay at the ``host_transfer`` site.

The port probes ``engine_round`` (``EngineCore.service_round``),
``replica_round`` (``ServingPlane.run``), ``host_transfer``
(``memory/residency.py``'s pull, between its window's opening and the
copies' dispatch) and ``collective``: every eager ``Communicator``
collective at its sequence number before its work is enqueued
(``comm/communicator.py``), and each timed repetition of
``harness.timing.measure`` at its ``seq`` — the launched benchmarks'
collective loop (``apps/launch.py --chaos``).

Spec grammar (the ``HPCPAT_CHAOS`` env value; ``;``-separated faults)::

    kind:key=value,key=value
    straggler:rank=1,delay_ms=40            # every collective on rank 1
    straggler:rank=1,delay_ms=40,every=4    # every 4th
    stall:at=3,delay_ms=100                 # one stall at round 3
    die:rank=1,at=5                         # SIGKILL at collective 5
    die:rank=1,at=5,code=7                  # os._exit(7) instead
    die:replica=2,at=5,site=replica_round   # kill ONE serving-plane
                                            # replica at its 5th round
    slow_host_transfer:delay_ms=40          # every prefetch 40ms extra
    slow_host_transfer:at=2,delay_ms=40,every=0   # only the 3rd pull

``rank`` matches ``HPCPAT_PROCESS_ID`` (absent = rank 0; ``rank``
omitted = every rank). Delays may carry deterministic jitter
(``jitter_ms`` + ``seed``): the jitter at a given (site, index) is a
pure hash, so a replay is byte-for-byte the same perturbation.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal
import threading
import time
from dataclasses import dataclass

ENV_CHAOS = "HPCPAT_CHAOS"

#: the launcher's process-rank variable (the JAX package's name)
ENV_PROCESS_ID = "HPCPAT_PROCESS_ID"

KINDS = ("straggler", "stall", "die", "slow_host_transfer")
#: ``replica_round``: the serving plane's per-replica scheduler round —
#: ``die:replica=2,at=5,site=replica_round`` kills one REPLICA of many
#: mid-stream (``replica=`` is an alias for ``rank=``: in a launched
#: plane each replica is one process). ``host_transfer``: the tiered-
#: memory prefetch dispatch (``ResidencyManager.pull_payload``).
SITES = ("collective", "engine_round", "replica_round",
         "host_transfer")

#: default injection site per kind (overridable via ``site=``)
_DEFAULT_SITE = {"straggler": "collective", "stall": "engine_round",
                 "die": "collective",
                 "slow_host_transfer": "host_transfer"}


@dataclass(frozen=True)
class Fault:
    """One parsed injector. ``at`` is the first matching index at the
    site; ``every`` repeats every k-th index after it (0 = fire at
    ``at`` only). ``rank`` None matches every process."""
    kind: str
    site: str
    rank: int | None = None
    at: int = 0
    every: int = 1
    delay_s: float = 0.0
    jitter_s: float = 0.0
    seed: int = 0
    exit_code: int | None = None  # die: None = SIGKILL

    def matches(self, site: str, index: int, rank: int) -> bool:
        if site != self.site:
            return False
        if self.rank is not None and rank != self.rank:
            return False
        if index < self.at:
            return False
        if self.every <= 0:
            return index == self.at
        return (index - self.at) % self.every == 0

    def delay_at(self, site: str, index: int) -> float:
        """The (deterministic) injected delay for this firing: base
        delay plus a pure-hash jitter fraction — replaying the same
        spec over the same schedule reproduces the same perturbation."""
        if self.jitter_s <= 0.0:
            return self.delay_s
        h = hashlib.sha256(
            f"{self.seed}|{site}|{index}".encode()).digest()
        u = int.from_bytes(h[:4], "big") / 2**32
        return self.delay_s + self.jitter_s * u


def parse(spec: str) -> tuple[Fault, ...]:
    """Parse a ``HPCPAT_CHAOS`` spec string into faults. Raises
    ``ValueError`` on unknown kinds/sites/keys — a typo'd chaos spec
    silently injecting nothing would be the worst failure mode of a
    tool whose job is making failures visible."""
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, body = part.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {kind!r} (known: {', '.join(KINDS)})")
        kw: dict = {}
        for item in body.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if key in ("rank", "replica"):
                # one replica of a launched serving plane IS one
                # launcher process, so replica-targeting is rank-
                # targeting under the plane's spelling
                kw["rank"] = int(val)
            elif key == "at":
                kw["at"] = int(val)
            elif key == "every":
                kw["every"] = int(val)
            elif key == "delay_ms":
                kw["delay_s"] = float(val) / 1e3
            elif key == "jitter_ms":
                kw["jitter_s"] = float(val) / 1e3
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "code":
                kw["exit_code"] = int(val)
            elif key == "site":
                if val not in SITES:
                    raise ValueError(
                        f"unknown chaos site {val!r} "
                        f"(known: {', '.join(SITES)})")
                kw["site"] = val
            else:
                raise ValueError(f"unknown chaos key {key!r} in {part!r}")
        kw.setdefault("site", _DEFAULT_SITE[kind])
        if kind in ("die", "stall"):
            # death fires once definitionally; a stall is one pause at
            # ``at`` unless ``every`` asks for a recurring one — only
            # the straggler defaults to every matching index
            kw.setdefault("every", 0)
        faults.append(Fault(kind=kind, **kw))
    return tuple(faults)


# process-local state: an explicit configure() override wins; otherwise
# the env spec is parsed once per distinct value and cached. _UNSET is
# the "no override installed" sentinel (None is a real override: chaos
# explicitly OFF regardless of env).
_UNSET = object()
_override: object = _UNSET
_env_cache: tuple[str | None, tuple[Fault, ...] | None] = (None, None)
_log: list[dict] = []
_LOG_CAP = 10000


def configure(spec: str | tuple[Fault, ...] | None):
    """Install a process-local fault set overriding the env (None =
    chaos explicitly off). Clears the injection log. Returns the
    installed faults. Tests pair this with :func:`reset`."""
    global _override
    faults = parse(spec) if isinstance(spec, str) else (
        tuple(spec) if spec is not None else None)
    _override = faults
    _log.clear()
    return faults


def reset() -> None:
    """Drop any configure() override (back to env-driven) and clear
    the injection log."""
    global _override
    _override = _UNSET
    _log.clear()


def active() -> tuple[Fault, ...] | None:
    """The faults in force: the configure() override when installed,
    else the parsed ``HPCPAT_CHAOS`` env spec (cached per value), else
    None. The no-chaos fast path is this one call returning None."""
    global _env_cache
    if _override is not _UNSET:
        return _override  # type: ignore[return-value]
    spec = os.environ.get(ENV_CHAOS)
    if not spec:
        return None
    cached_spec, cached = _env_cache
    if spec != cached_spec:
        cached = parse(spec)
        _env_cache = (spec, cached)
    return cached


def _process_rank() -> int:
    try:
        return int(os.environ.get(ENV_PROCESS_ID) or 0)
    except ValueError:
        return 0


_claimed = threading.local()


@contextlib.contextmanager
def suppress(site: str):
    """Claim ``site`` for the caller's dynamic scope: probes of the
    same site underneath do not fire. ``harness.timing.measure`` claims
    ``collective`` around each timed rep AFTER probing it once — the
    rep IS the collective in the skew-fan identification, and an eager
    Communicator collective inside the rep re-probing the site would
    double the injected delay against the declared spec."""
    stack = getattr(_claimed, "sites", None)
    if stack is None:
        stack = _claimed.sites = []
    stack.append(site)
    try:
        yield
    finally:
        stack.pop()


def injections() -> tuple[dict, ...]:
    """What fired so far (site, index, kind, delay_s per event) — the
    assertion handle for tests and the scenario benchmarks ("the
    seeded stall actually fired" is part of the verdict, not assumed)."""
    return tuple(_log)


def matching(site: str, index: int,
             rank: int | None = None) -> tuple[Fault, ...]:
    """The faults that WOULD fire at (site, index, rank) — without
    executing them. For callers that implement kind-specific semantics
    themselves: the in-process serving plane runs every replica in ONE
    process, so a ``die:replica=N`` fault must mark replica N dead
    (router-visible, recoverable) instead of SIGKILLing the whole
    plane the way :func:`maybe_inject` would. ``rank`` overrides the
    process rank for the match — the plane passes the REPLICA ordinal,
    which is what ``replica=`` addresses there (in the launched plane
    each replica is its own process, so the two spellings coincide).
    The caller records what it executed via :func:`record_injection`
    so the fault-actually-fired asserts keep working."""
    faults = active()
    if not faults:
        return ()
    if site in getattr(_claimed, "sites", ()):
        return ()
    r = _process_rank() if rank is None else int(rank)
    return tuple(f for f in faults if f.matches(site, index, r))


def record_injection(site: str, index: int, kind: str, *,
                     rank: int | None = None,
                     delay_s: float = 0.0) -> None:
    """Log one caller-executed injection (the :func:`matching`
    counterpart of the log append :func:`maybe_inject` does itself)."""
    if len(_log) < _LOG_CAP:
        _log.append({
            "site": site, "index": index, "kind": kind,
            "rank": _process_rank() if rank is None else int(rank),
            "delay_s": delay_s})


def maybe_inject(site: str, index: int) -> None:
    """Fire every active fault matching (site, index, this rank).

    ``straggler``/``stall`` sleep their (deterministic) delay; ``die``
    kills the process the hard way — ``SIGKILL`` by default, so no
    Python-level cleanup runs, exactly like an OOM-killed or
    preempted worker. Call sites guard with ``active() is not None``
    so the disabled path costs one cached read."""
    faults = active()
    if not faults:
        return
    if site in getattr(_claimed, "sites", ()):
        return  # an enclosing scope (a timed rep) owns this site
    rank = _process_rank()
    for f in faults:
        if not f.matches(site, index, rank):
            continue
        if f.kind == "die":
            if len(_log) < _LOG_CAP:
                _log.append({"site": site, "index": index, "kind": f.kind,
                             "rank": rank, "delay_s": 0.0})
            if f.exit_code is not None:
                os._exit(f.exit_code)
            os.kill(os.getpid(), signal.SIGKILL)
        delay = f.delay_at(site, index)
        if len(_log) < _LOG_CAP:
            _log.append({"site": site, "index": index, "kind": f.kind,
                         "rank": rank, "delay_s": delay})
        if delay > 0.0:
            time.sleep(delay)
