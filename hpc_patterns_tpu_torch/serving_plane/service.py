"""Cross-process serving plane: socket replicas and the router client — the
counterpart of ``hpc_patterns_tpu/serving_plane/service.py``.

The in-process plane (``serving_plane/router.py``) is the oracle tier;
this module is the LAUNCHED tier: one replica per OS process under
``apps/launch.py`` (the mpirun analog), a router process driving them
over localhost TCP (newline-delimited JSON). KV bundles cross the socket
bit-identically (``migration.bundle_to_wire``), and both sides
fingerprint every handoff into their collective-schedule chains
(``harness/trace.record_collective``), so the cross-rank trace merge
proves the router and replicas agreed on the migration schedule (verdict
``consistent``) and threads KV-handoff flow arrows between the replica
lanes.

Import-light on purpose: this module imports no torch at module level.
Launcher children of the replica-chaos tests run STUB engines — a
deterministic torch-free token generator behind the same protocol,
byte-equal to the JAX package's — so the router's failure handling
(death detection, resume on a survivor, shed accounting) runs in
milliseconds. Real engines enter through :class:`RealAdapter`, which
imports torch lazily.

Protocol (one JSON object per line, request/response):

- ``hello``   -> replica identity + geometry + load
- ``submit``  -> enqueue a request (``resume_prefix`` for re-queued work
  from a dead replica)
- ``round``   -> run ONE service round (the chaos ``replica_round`` site
  fires here); the reply carries finished rows, per-row progress (the
  router's resume checkpoint), exported KV bundles and load
- ``migrate`` -> queue a KV bundle for install behind the next round's
  decode chunk
- ``stop``    -> drain the connection; the server loop returns

Replica death: a ``die`` chaos fault (or any crash) severs the socket
mid-call; the router marks the replica dead and RE-QUEUES its in-flight
requests as resumes on survivors — prompt = original + tokens observed
so far, ``resume_prefix`` carrying them, the checkpointed sampler key
handed back verbatim — or counts them SHED in the SLO table when no
survivor can take them. Nothing is dropped silently.

Port-side difference: a real replica's sampler key is the row's whole
``(2,)`` state (draws are keyed by key and position, the key does not
advance), so a death-resumed sampled row is exact within the port by
construction; the router treats the key as opaque in both packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import time
from collections import deque
from pathlib import Path

from hpc_patterns_tpu_torch.harness import budget as budgetlib
from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib
from hpc_patterns_tpu_torch.harness import slo as slolib
from hpc_patterns_tpu_torch.harness import trace as tracelib

#: the device subtrack a migration's windows land on: one formula for
#: donor, receiver and the in-process plane, or the merged timeline's flow
#: arrows stop threading
migration_track = tracelib.migration_track


class ReplicaDead(Exception):
    """The socket to a replica broke mid-protocol."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def send_msg(sock: socket.socket, obj: dict) -> int:
    """Send one message; returns its size on the wire in bytes."""
    data = (json.dumps(obj) + "\n").encode()
    try:
        sock.sendall(data)
    except OSError as e:
        raise ReplicaDead(str(e)) from e
    return len(data)


def recv_msg(rfile) -> dict | None:
    try:
        line = rfile.readline()
    except OSError as e:
        raise ReplicaDead(str(e)) from e
    if not line:
        return None
    return json.loads(line)


def _record_handoff(wire: dict, rec) -> float:
    """Fingerprint one side of a handoff into the schedule chain and open
    its device-track window; returns the window stamp (0.0 without a
    recorder). Both sides derive identical fingerprints from the bundle
    itself, so with one prefill and one decode replica the two chains must
    be EQUAL: a bundle lost, duplicated or reordered in the router reads
    as a schedule divergence naming the first bad (op, seq)."""
    tracelib.record_collective(
        "kv_migration", int(wire["seq"]),
        shape=(int(wire["n_pages"]), int(wire["page_size"])),
        dtype=wire.get("payload_dtype") or "uint8",
        axis="plane", algorithm="socket")
    if rec is None:
        return 0.0
    return rec.mark_dispatch(
        "plane.kv_migration",
        {"seq": int(wire["seq"]), "pages": int(wire["n_pages"]),
         "seq_id": int(wire["seq_id"])},
        track=migration_track(wire["seq"]))


def record_export(wire: dict, rec) -> None:
    """Donor-side handoff record: fingerprint + a closed device-track
    window at the export instant. The donor assigns ``seq`` (its export
    counter); the router carries it verbatim."""
    t_disp = _record_handoff(wire, rec)
    if rec is not None and t_disp:
        rec.mark_complete(
            "plane.kv_migration", t_disp,
            {"seq": int(wire["seq"]), "side": "export"},
            track=migration_track(wire["seq"]))


def recv_migration(wire: dict, adapter: "EngineAdapter", rec) -> None:
    """The receiver's half: fingerprint + window open on arrival, then
    queue the bundle so the install runs BEHIND the next round's decode
    chunk (the window closes when the install completes in the round)."""
    t_disp = _record_handoff(wire, rec)
    adapter.queue_install(wire, t_disp)


# ---------------------------------------------------------------------------
# engine adapters
# ---------------------------------------------------------------------------


class EngineAdapter:
    """What the replica server needs from an engine; implemented by
    :class:`StubAdapter` (torch-free, deterministic) and
    :class:`RealAdapter` (an EngineCore)."""

    role = "both"

    def describe(self) -> dict:
        raise NotImplementedError

    def submit(self, req: dict) -> None:
        raise NotImplementedError

    def queue_install(self, wire: dict, t_disp: float) -> None:
        raise NotImplementedError

    def round(self, rec) -> dict:
        """One service round; returns the ``round`` reply body."""
        raise NotImplementedError


def stub_token(orig_prompt, k: int) -> int:
    """Token ``k`` of the stub generator: a pure function of the ORIGINAL
    prompt, so a resume (prompt = original + emitted) and a migrated
    continuation reproduce the uninterrupted stream exactly."""
    key = (",".join(str(int(t)) for t in orig_prompt)).encode()
    h = hashlib.sha256(key + int(k).to_bytes(4, "little")).digest()
    return int.from_bytes(h[:4], "little") % 251


# -- the stub's SAMPLED mode (the key-stream checkpoint drill) -------------
#
# A hash CHAIN: key_0 = H(prompt), key_{k+1} = H(key_k), token_k =
# f(key_k) — so a death-resume that does NOT carry the checkpointed key
# restarts the chain at key_0 and diverges at the first resumed position.
# The router treats the key as OPAQUE (hex here, a uint32 pair for real
# engines): it checkpoints whatever the round reply reports and hands it
# back verbatim on resume.


def stub_key0(orig_prompt) -> bytes:
    key = (",".join(str(int(t)) for t in orig_prompt)).encode()
    return hashlib.sha256(key + b"|k0").digest()[:8]


def stub_next_key(key: bytes) -> bytes:
    return hashlib.sha256(key).digest()[:8]


def stub_token_keyed(key: bytes) -> int:
    return int.from_bytes(hashlib.sha256(key).digest()[4:8],
                          "little") % 251


def stub_sampled_stream(orig_prompt, n: int) -> list[int]:
    """The full n-token sampled stub stream, walked from key_0 (a correct
    resume lands on the same tokens because it continued the chain from
    the carried state)."""
    key, out = stub_key0(orig_prompt), []
    for _ in range(n):
        out.append(stub_token_keyed(key))
        key = stub_next_key(key)
    return out


class StubAdapter(EngineAdapter):
    """A deterministic torch-free engine behind the replica protocol:
    page-pool accounting, slot admission, ``chunk`` tokens per round per
    active row, prefill-role export, migration install. The launched
    plane's ROUTER mechanics (placement, death recovery, shed accounting,
    handoff fingerprints) run on it in milliseconds. ``sampled``: tokens
    come from the per-row key chain (``stub_key0``/``stub_next_key``), so
    the router's key checkpoint is exercised with teeth."""

    def __init__(self, *, slots: int = 2, pool_pages: int = 16,
                 pages_per_seq: int = 8, page_size: int = 16,
                 chunk: int = 4, role: str = "both",
                 sampled: bool = False):
        self.slots = slots
        self.pool_pages = pool_pages
        self.pages_per_seq = pages_per_seq
        self.page_size = page_size
        self.chunk = chunk
        self.role = role
        self.sampled = bool(sampled)
        self.free_pages = pool_pages
        self._queue: deque = deque()
        self._rows: list[dict] = []
        self._installs: deque = deque()
        self._round = 0
        self._mig_seq = 0
        self.finished: dict[int, list[int]] = {}
        self.outcomes: dict[int, str] = {}

    def _pages_for(self, prompt_len: int, budget: int) -> int:
        return -(-(prompt_len + budget) // self.page_size)

    def describe(self) -> dict:
        return {"role": self.role, "slots": self.slots,
                "pages_per_seq": self.pages_per_seq,
                "page_size": self.page_size, "stub": True,
                "free_pages": self.free_pages,
                "queue_depth": len(self._queue)}

    def submit(self, req: dict) -> None:
        prompt = [int(t) for t in req["prompt"]]
        prefix = [int(t) for t in req.get("resume_prefix") or []]
        need = self._pages_for(len(prompt), int(req["max_new"]))
        if need > min(self.pages_per_seq, self.pool_pages):
            raise ValueError(
                f"request needs {need} pages > capacity")
        self._queue.append({
            "rid": int(req["rid"]), "prompt": prompt,
            "orig": prompt[:len(prompt) - len(prefix)]
            if prefix else prompt,
            "prefix": prefix, "out": list(prefix),
            "budget": int(req["max_new"]), "need": need,
            "priority": int(req.get("priority") or 0),
            # sampled resumes seed the chain from the router's checkpointed
            # key; a fresh row starts its own at admission
            "key": (bytes.fromhex(req["key"])
                    if self.sampled and req.get("key") else None),
        })

    def queue_install(self, wire: dict, t_disp: float) -> None:
        self._installs.append((wire, t_disp))

    def _emit_token(self, row: dict) -> int:
        """One emitted token: greedy, the position-indexed pure function of
        the original prompt; sampled, the next link of the row's key chain
        (a resume continues from the carried state)."""
        if not self.sampled:
            return stub_token(row["orig"], len(row["out"]))
        if row.get("key") is None:
            row["key"] = stub_key0(row["orig"])
        tok = stub_token_keyed(row["key"])
        row["key"] = stub_next_key(row["key"])
        return tok

    def _admit(self) -> None:
        q = sorted(self._queue, key=lambda r: r["priority"])
        for req in q:
            if len(self._rows) >= self.slots:
                break
            if req["need"] > self.free_pages:
                continue
            self._queue.remove(req)
            self.free_pages -= req["need"]
            # admission emits the first token (the prefill pick)
            req["out"].append(self._emit_token(req))
            self._rows.append(req)

    def _install_pending(self, rec) -> None:
        while self._installs:
            wire, t_disp = self._installs[0]
            need = int(wire["n_pages"])
            if len(self._rows) >= self.slots or need > self.free_pages:
                break
            self._installs.popleft()
            self.free_pages -= need
            self._rows.append({
                "rid": int(wire["seq_id"]),
                "prompt": [int(t) for t in wire["prompt"]],
                "orig": [int(t) for t in wire["orig"]],
                "prefix": list(wire["prefix"]),
                "out": list(wire["out"]),
                "budget": int(wire["budget"]), "need": need,
                "priority": int(wire.get("priority") or 0),
                # the migrated key state continues the donor's chain
                "key": (bytes.fromhex(wire["key"])
                        if self.sampled and wire.get("key") else None),
            })
            if rec is not None and t_disp:
                rec.mark_complete(
                    "plane.kv_migration", t_disp,
                    {"seq": int(wire["seq"])},
                    track=migration_track(wire["seq"]))

    def round(self, rec) -> dict:
        chaoslib.maybe_inject("replica_round", self._round)
        self._round += 1
        self._admit()
        self._install_pending(rec)
        exports = []
        if self.role == "prefill":
            # every admitted row leaves by migration once its first token
            # exists (admission emitted it)
            for row in list(self._rows):
                if len(row["out"]) - len(row["prefix"]) \
                        >= row["budget"]:
                    continue  # finishes below instead
                self._rows.remove(row)
                self.free_pages += row["need"]
                wire = {
                    "seq_id": row["rid"], "prompt": row["prompt"],
                    "orig": row["orig"], "prefix": row["prefix"],
                    "out": row["out"], "budget": row["budget"],
                    "n_pages": row["need"],
                    "page_size": self.page_size,
                    "payload_dtype": "uint8",
                    "priority": row["priority"],
                    "key": (row["key"].hex()
                            if self.sampled and row.get("key")
                            else None),
                    # the DONOR assigns seq and fingerprints it; the
                    # router carries it verbatim
                    "seq": self._mig_seq,
                }
                self._mig_seq += 1
                record_export(wire, rec)
                exports.append(wire)
        else:
            for row in list(self._rows):
                emitted = len(row["out"]) - len(row["prefix"])
                take = min(self.chunk, row["budget"] - emitted)
                row["out"].extend(self._emit_token(row)
                                  for _ in range(take))
        for row in list(self._rows):
            if len(row["out"]) - len(row["prefix"]) >= row["budget"]:
                self._rows.remove(row)
                self.free_pages += row["need"]
                self.finished[row["rid"]] = row["out"]
                self.outcomes[row["rid"]] = "ok"
        fin = {str(r): t for r, t in self.finished.items()}
        self.finished = {}
        reply = {
            "ok": 1, "round": self._round, "finished": fin,
            "outcomes": {str(r): self.outcomes.pop(r)
                         for r in list(self.outcomes)},
            "progress": {str(r["rid"]): r["out"] for r in self._rows},
            "exports": exports,
            "free_pages": self.free_pages,
            "queue_depth": len(self._queue),
            "active": len(self._rows),
        }
        if self.sampled:
            # the key half of the router's resume checkpoint, beside the
            # tokens the progress field carries
            reply["keys"] = {str(r["rid"]): r["key"].hex()
                             for r in self._rows if r.get("key")}
        return reply


class RealAdapter(EngineAdapter):
    """An :class:`~hpc_patterns_tpu_torch.models.serving.EngineCore`
    behind the replica protocol (torch is imported lazily: only replicas
    that serve a model pay for it). The donor export runs after a
    prefill-only round; installs queue and run behind the next round's
    decode chunk through ``service_round``'s ``pre_collect`` hook.

    A round reply also carries ``export_s``: the host seconds of this
    round's exports (the rows' device -> host read and the wire encoding,
    ``migration.bundle_to_wire``)."""

    def __init__(self, engine, *, role: str = "both"):
        self.engine = engine
        self.role = role
        self._installs: deque = deque()
        self._round = 0
        self._mig_seq = 0

    def describe(self) -> dict:
        e = self.engine
        return {"role": self.role, "slots": e.slots,
                "pages_per_seq": e.pages_per_seq,
                "page_size": e.page_size, "stub": False,
                "free_pages": e.free_page_count,
                "queue_depth": e.queue_depth}

    def submit(self, req: dict) -> None:
        import numpy as np

        kw = {}
        if req.get("key") is not None and not self.engine.greedy:
            # the router's checkpointed key (a uint32 pair from an earlier
            # round reply): the resumed row samples on from it. The
            # engine takes a key on the host (``Request.key``) and uploads
            # it at admission
            kw["key"] = np.asarray(req["key"], np.uint32)
        self.engine.submit(
            np.asarray(req["prompt"], np.int32), int(req["max_new"]),
            seq_id=int(req["rid"]),
            priority=int(req.get("priority") or 0),
            deadline_s=req.get("deadline_s"),
            resume_prefix=(np.asarray(req["resume_prefix"], np.int32)
                           if req.get("resume_prefix") else None),
            **kw)

    def queue_install(self, wire: dict, t_disp: float) -> None:
        self._installs.append((wire, t_disp))

    def _install_pending(self, rec, overlapped: bool) -> None:
        from hpc_patterns_tpu_torch.serving_plane.migration import (
            bundle_from_wire,
        )

        while self._installs:
            wire, t_disp = self._installs[0]
            if not self.engine.migration_admissible(
                    int(wire["n_pages"])):
                break
            self._installs.popleft()
            self.engine.install_migration(bundle_from_wire(wire))
            if rec is not None and t_disp:
                rec.mark_complete(
                    "plane.kv_migration", t_disp,
                    {"seq": int(wire["seq"]), "overlapped": overlapped},
                    track=migration_track(wire["seq"]))

    def round(self, rec) -> dict:
        from hpc_patterns_tpu_torch.serving_plane.migration import (
            bundle_to_wire,
        )

        chaoslib.maybe_inject("replica_round", self._round)
        self._round += 1
        e = self.engine
        keys: dict[str, list[int]] = {}
        exports = []
        export_s = 0.0
        if self.role == "prefill":
            e.service_round(decode=False)
            for slot in e.exportable_slots():
                t0 = time.perf_counter()
                b = e.export_migration(slot)
                b.seq = self._mig_seq
                self._mig_seq += 1
                if not e.greedy:
                    # the exported key also seeds the router's checkpoint:
                    # a receiver dying between delivery and its first round
                    # reply must not cost the stream its continuation
                    keys[str(b.seq_id)] = [int(v) for v in b.key]
                wire = bundle_to_wire(b)
                export_s += time.perf_counter() - t0
                # the socket IS the transport on this plane
                wire["transport"] = "wire"
                wire["payload_dtype"] = str(
                    b.pages_payload["k"][0].dtype).removeprefix("torch.")
                record_export(wire, rec)
                exports.append(wire)
        else:
            pre = None
            if self._installs:
                def pre(overlapped):
                    self._install_pending(rec, overlapped)
            e.service_round(pre_collect=pre)
        fin = {}
        outcomes = {}
        for sid in list(e.finished):
            fin[str(sid)] = [int(t) for t in e.finished.pop(sid)]
            outcomes[str(sid)] = (e.stats.get(sid, {}).get("outcome")
                                  or "ok")
        progress = {str(s.seq_id): [int(t) for t in s.out]
                    for s in e._slots if s.active}
        if not e.greedy and e.active_count:
            # the key half of the resume checkpoint: the post-round per-row
            # sampler state, consistent with the progress tokens (the
            # chunk was read back before this round returned); .cpu()
            # copies it
            arr = e.keys.cpu().tolist()
            for i, s in enumerate(e._slots):
                if s.active:
                    keys[str(s.seq_id)] = [int(v) for v in arr[i]]
        reply = {
            "ok": 1, "round": self._round, "finished": fin,
            "outcomes": outcomes, "progress": progress,
            "exports": exports,
            "free_pages": e.free_page_count,
            "queue_depth": e.queue_depth,
            "active": e.active_count,
            "export_s": export_s,
        }
        if keys:
            reply["keys"] = keys
        return reply


# ---------------------------------------------------------------------------
# replica server
# ---------------------------------------------------------------------------


def addr_path(rdv_dir: str | Path, rank: int) -> Path:
    return Path(rdv_dir) / f"replica{rank:05d}.addr"


def serve_replica(adapter: EngineAdapter, *, rank: int,
                  rdv_dir: str | Path, timeout_s: float = 120.0,
                  rec=None) -> int:
    """One replica process: bind an ephemeral localhost port, publish it
    under ``rdv_dir`` (every child of a launch gets the same directory —
    the hostfile analog), then serve the router's protocol until ``stop``
    or an idle timeout (an orphaned replica must not outlive a dead
    router; the launcher's own timeout is the backstop)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(timeout_s)
    host, port = srv.getsockname()
    p = addr_path(rdv_dir, rank)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(f"{host}:{port}")
    os.replace(tmp, p)
    print(f"replica {rank} ({adapter.role}) listening on {host}:{port}",
          flush=True)
    try:
        conn, _ = srv.accept()
    except socket.timeout:
        print(f"replica {rank}: no router within {timeout_s}s",
              flush=True)
        return 1
    finally:
        srv.close()
    conn.settimeout(timeout_s)
    rfile = conn.makefile("r")
    served_rounds = 0
    try:
        while True:
            msg = recv_msg(rfile)
            if msg is None:
                print(f"replica {rank}: router hung up", flush=True)
                return 0
            op = msg.get("op")
            if op == "hello":
                send_msg(conn, {"ok": 1, "rank": rank,
                                **adapter.describe()})
            elif op == "submit":
                try:
                    adapter.submit(msg)
                    send_msg(conn, {"ok": 1})
                except Exception as e:  # noqa: BLE001 — protocol reply
                    send_msg(conn, {"ok": 0, "error": str(e)})
            elif op == "migrate":
                recv_migration(msg["bundle"], adapter, rec)
                send_msg(conn, {"ok": 1})
            elif op == "round":
                reply = adapter.round(rec)
                served_rounds += 1
                send_msg(conn, reply)
            elif op == "stop":
                send_msg(conn, {"ok": 1, "rounds": served_rounds})
                print(f"replica {rank}: served {served_rounds} "
                      "round(s)", flush=True)
                return 0
            else:
                send_msg(conn, {"ok": 0, "error": f"bad op {op!r}"})
    except (ReplicaDead, socket.timeout) as e:
        print(f"replica {rank}: connection lost ({e})", flush=True)
        return 0
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# router client
# ---------------------------------------------------------------------------


class ReplicaHandle:
    def __init__(self, rank: int, addr: str, *,
                 timeout_s: float = 120.0):
        # the recv timeout doubles as the death detector: it must track the
        # operator's --plane-timeout, or a slow replica round (a real
        # engine's first round on a card: context, handles, kernel loads)
        # is misread as a death and its work served twice
        self.rank = rank
        host, port = addr.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout_s)
        self.rfile = self.sock.makefile("r")
        self.alive = True
        self.info: dict = {}
        self.load: dict = {"free_pages": 0, "queue_depth": 0,
                           "active": 0}
        self.assigned: set[int] = set()
        #: bytes sent to this replica (the request lines)
        self.sent_bytes = 0

    def call(self, msg: dict) -> dict:
        self.sent_bytes += send_msg(self.sock, msg)
        reply = recv_msg(self.rfile)
        if reply is None:
            raise ReplicaDead(f"EOF from replica {self.rank}")
        return reply

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()

    @property
    def role(self) -> str:
        return self.info.get("role", "both")

    @property
    def can_prefill(self) -> bool:
        return self.role in ("both", "prefill")

    @property
    def can_decode(self) -> bool:
        return self.role in ("both", "decode")


def connect_replicas(rdv_dir: str | Path, ranks, *,
                     wait_s: float = 60.0,
                     timeout_s: float = 120.0) -> list[ReplicaHandle]:
    """Wait for every replica's address file, then connect and handshake.
    Order = rank order. ``timeout_s`` becomes each handle's recv timeout
    (the death detector)."""
    deadline = time.monotonic() + wait_s
    handles = []
    for rank in ranks:
        p = addr_path(rdv_dir, rank)
        while not p.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {rank} never published {p}")
            time.sleep(0.02)
        h = ReplicaHandle(rank, p.read_text().strip(),
                          timeout_s=timeout_s)
        h.info = h.call({"op": "hello"})
        h.load = {k: h.info.get(k, 0)
                  for k in ("free_pages", "queue_depth", "active")}
        handles.append(h)
    return handles


class PlaneRouter:
    """The router process of the launched plane: admits the open-loop
    stream across the replica handles, forwards KV handoffs from prefill
    to decode replicas, detects replica death, re-queues the dead
    replica's in-flight requests as resumes on survivors (or counts them
    shed), and rolls the SLO table up at the end. All timing is stamped
    at the ROUTER (one clock): TTFT is when the router first observes
    tokens.

    Handoff timings: ``export_s`` (each donor round's export seconds, as
    the replica reports them) and ``handoff_s`` / ``handoff_bytes`` (each
    forwarded bundle's ``migrate`` call on the router's clock — the socket
    both ways and the receiver's parse — and its line's size)."""

    def __init__(self, handles: list[ReplicaHandle], *,
                 policy: str = "least_loaded", slo_targets=None,
                 emit=None, placement_weights: dict | None = None):
        if not handles:
            raise ValueError("no replicas")
        self.handles = handles
        self.policy = policy
        #: fitted per-replica capacity shares keyed by str(rank) — read by
        #: the "weighted" policy; empty = neutral (every weight 1.0)
        self.placement_weights = {
            str(k): float(v)
            for k, v in (placement_weights or {}).items()}
        self.slo_targets = slo_targets or {}
        self._emit = emit or (lambda **kw: None)
        #: the sliding-window SLO-attainment signal (the in-process
        #: plane's, same record format), judged at resolution, emitted
        #: once per router round
        self.attain_window = slolib.AttainmentWindow()
        self._plane_rounds = 0
        self._attain_emitted = (0, 0)  # (judged, attained) last emit
        self.stats: dict[int, dict] = {}
        self.finished: dict[int, list[int]] = {}
        self.requests: dict[int, dict] = {}
        self.progress: dict[int, list[int]] = {}
        #: the key half of the resume checkpoint: per-row sampler key
        #: state from the replicas' round replies, OPAQUE to the router,
        #: handed back verbatim on a death-resume
        self.key_ckpt: dict[int, object] = {}
        self.pending_bundles: deque = deque()
        self._next_rid = 0
        self._rr = 0
        self.migrations = 0
        self.deaths: list[int] = []
        self.resumed: list[int] = []
        self.shed: list[int] = []
        self.last_slo: dict | None = None
        self.export_s: list[float] = []
        self.handoff_s: list[float] = []
        self.handoff_bytes: list[int] = []

    @classmethod
    def from_fitted(cls, handles, fitted, *, slo_targets=None,
                    emit=None, **kw):
        """A router from an autofit ``FittedConfig``: the fitted
        ``placement`` section picks the policy and the per-replica weights
        (keyed by rank in the launched plane) — defaults when the config
        carries no placement signal. An explicit ``policy=`` wins."""
        from hpc_patterns_tpu_torch.harness import autofit as autofitlib

        fitted = autofitlib.validate_fitted(fitted)
        section = fitted.get("placement") or {}
        if "policy" not in kw and section.get("policy"):
            kw["policy"] = section["policy"]
        if "placement_weights" not in kw and section.get("weights"):
            kw["placement_weights"] = section["weights"]
        return cls(handles, slo_targets=slo_targets, emit=emit, **kw)

    # -- placement ---------------------------------------------------------

    def _alive(self, pred=None):
        return [h for h in self.handles
                if h.alive and (pred is None or pred(h))]

    def _pick(self, cand: list[ReplicaHandle]) -> ReplicaHandle | None:
        if not cand:
            return None
        if self.policy == "round_robin":
            h = cand[self._rr % len(cand)]
            self._rr += 1
            return h
        if self.policy == "weighted":
            # the fitted capacity share per unit of present pressure (a
            # replica the fit never saw is neutral at 1.0)
            return max(cand, key=lambda h: (
                self.placement_weights.get(str(h.rank), 1.0)
                / (1.0 + h.load["queue_depth"]),
                h.load["free_pages"]))
        return max(cand, key=lambda h: (h.load["free_pages"],
                                        -h.load["queue_depth"]))

    # -- submission --------------------------------------------------------

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               deadline_s=None, t_submit: float | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        self.requests[rid] = {
            "prompt": [int(t) for t in prompt],
            "max_new": int(max_new), "priority": int(priority),
            "deadline_s": deadline_s,
        }
        self.stats[rid] = {
            "priority": int(priority),
            "t_submit": t_submit if t_submit is not None else now,
            "t_first": None, "t_finish": None, "tokens": 0,
            "outcome": None, "preemptions": 0,
        }
        rtr = reqtracelib.active()
        if rtr is not None:
            # router-stamped segments (one clock): queued until assigned,
            # prefill until the first observed token, decode after
            rtr.begin_request(rid, self.stats[rid]["t_submit"])
        if not self._assign(rid, resume_prefix=None):
            self._shed(rid)
        return rid

    def _assign(self, rid: int, *, resume_prefix) -> bool:
        """Place one (possibly resumed) request: try candidates in policy
        order until one accepts. Fresh work goes to prefill-capable
        replicas; a RESUME re-enters through any survivor's ordinary
        admission path (a decode-role engine still admits)."""
        req = self.requests[rid]
        prompt = list(req["prompt"])
        if resume_prefix:
            prompt = prompt + list(resume_prefix)
        tried: set[int] = set()
        while True:
            cand = self._alive(
                lambda h: h.rank not in tried
                and (h.can_prefill or resume_prefix is not None))
            h = self._pick(cand)
            if h is None:
                return False
            tried.add(h.rank)
            try:
                reply = h.call({
                    "op": "submit", "rid": rid, "prompt": prompt,
                    "max_new": req["max_new"] - len(resume_prefix or []),
                    "priority": req["priority"],
                    "deadline_s": req["deadline_s"],
                    "resume_prefix": list(resume_prefix or []) or None,
                    # a resume carries the checkpointed key state; fresh
                    # work derives its own request key
                    "key": (self.key_ckpt.get(rid)
                            if resume_prefix is not None else None),
                })
            except ReplicaDead:
                self._on_death(h)
                continue
            if not reply.get("ok"):
                continue  # this replica cannot fit it; try the next
            h.assigned.add(rid)
            rtr = reqtracelib.active()
            if rtr is not None:
                rtr.stamp_transition(rid, "prefill")
            # bump the local load estimate NOW: a burst of submits between
            # rounds must spread, not pile onto one snapshot
            h.load["queue_depth"] += 1
            self._emit(kind="plane_route", seq_id=rid,
                       replica=h.rank, resumed=bool(resume_prefix))
            return True

    def _shed(self, rid: int) -> None:
        rec = self.stats[rid]
        rec["outcome"] = "shed"
        rec["t_finish"] = time.perf_counter()
        rtr = reqtracelib.active()
        if rtr is not None:
            rtr.finish_request(rid, rec["t_finish"], final="shed")
        self._judge_window(rec)  # a shed never attains — it counts
        self.finished[rid] = []
        self.shed.append(rid)
        self._emit(kind="plane_shed", seq_id=rid)

    def _judge_window(self, rec: dict) -> None:
        """Fold one resolved stats row into the sliding attainment window
        (a class with no declared target judges trivially when served)."""
        target = self.slo_targets.get(int(rec.get("priority") or 0),
                                      slolib.SLOTarget())
        self.attain_window.judge(rec, target)

    def _emit_attainment(self) -> None:
        """The per-round sliding-window attainment of the launched plane:
        the in-process plane's gauge, trace counter and
        ``kind=plane_attainment`` record."""
        self._plane_rounds += 1
        snap = self.attain_window.snapshot()
        judged, attained = (self.attain_window.judged,
                            self.attain_window.attained)
        judged_round = judged - self._attain_emitted[0]
        attained_round = attained - self._attain_emitted[1]
        self._attain_emitted = (judged, attained)
        alive = self._alive()
        queued = sum(int(h.load.get("queue_depth") or 0)
                     for h in alive)
        active = sum(int(h.load.get("active") or 0) for h in alive)
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
                   attained_round=attained_round, queued=queued,
                   active=active, replicas=len(alive))

    # -- failure handling --------------------------------------------------

    def _on_death(self, h: ReplicaHandle) -> None:
        """A replica died mid-protocol: every in-flight request it held is
        re-queued as a RESUME on a survivor — prompt = original + the
        tokens the router already observed — or counted shed."""
        if not h.alive:
            return
        h.alive = False
        self.deaths.append(h.rank)
        print(f"router: replica {h.rank} died; re-queueing "
              f"{len(h.assigned)} in-flight request(s)", flush=True)
        orphans = sorted(h.assigned)
        h.assigned.clear()
        for rid in orphans:
            if self.stats[rid].get("outcome") is not None:
                continue
            emitted = list(self.progress.get(rid, []))
            if len(emitted) >= self.requests[rid]["max_new"]:
                # everything was emitted; the finish report died with the
                # replica — the observed tokens ARE the output
                self._finish(rid, emitted, "ok")
                continue
            rtr = reqtracelib.active()
            if rtr is not None:
                # death to re-admission is a preemption
                rtr.stamp_transition(rid, "preempted")
            if self._assign(rid, resume_prefix=emitted):
                self.stats[rid]["preemptions"] += 1
                self.resumed.append(rid)
                self._emit(kind="plane_resume", seq_id=rid,
                           from_rank=h.rank, tokens=len(emitted))
            else:
                self._shed(rid)

    # -- result plumbing ---------------------------------------------------

    def _finish(self, rid: int, tokens: list[int],
                outcome: str) -> None:
        rec = self.stats[rid]
        if rec.get("outcome") is not None:
            return
        rec["outcome"] = outcome
        rec["t_finish"] = time.perf_counter()
        rec["tokens"] = len(tokens)
        if rec["t_first"] is None and tokens:
            rec["t_first"] = rec["t_finish"]
        rtr = reqtracelib.active()
        if rtr is not None:
            rtr.finish_request(rid, rec["t_finish"])
        self._judge_window(rec)
        self.finished[rid] = tokens
        self.progress.pop(rid, None)
        # the key checkpoint resolves with the request, like the progress
        self.key_ckpt.pop(rid, None)

    def _merge_round(self, h: ReplicaHandle, reply: dict) -> None:
        now = time.perf_counter()
        h.load = {k: reply.get(k, 0)
                  for k in ("free_pages", "queue_depth", "active")}
        if reply.get("exports"):
            self.export_s.append(float(reply.get("export_s") or 0.0))
        rtr = reqtracelib.active()
        for rid_s, toks in reply.get("progress", {}).items():
            rid = int(rid_s)
            self.progress[rid] = list(toks)
            rec = self.stats.get(rid)
            if rec is not None and rec["t_first"] is None and toks:
                rec["t_first"] = now
                if rtr is not None:
                    rtr.stamp_transition(rid, "decode", now)
        for rid_s, key in reply.get("keys", {}).items():
            self.key_ckpt[int(rid_s)] = key
        outcomes = reply.get("outcomes", {})
        for rid_s, toks in reply.get("finished", {}).items():
            rid = int(rid_s)
            h.assigned.discard(rid)
            self._finish(rid, list(toks),
                         outcomes.get(rid_s, "ok"))
            if outcomes.get(rid_s) == "shed":
                self.shed.append(rid)
        for wire in reply.get("exports", []):
            # seq was assigned (and fingerprinted) by the donor; the
            # router carries it verbatim
            h.assigned.discard(int(wire["seq_id"]))
            # the wire carries the prefill-side tokens: seed the resume
            # checkpoint now, so a receiver that dies between delivery and
            # its next round reply does not cost them
            rid = int(wire["seq_id"])
            if len(wire.get("out", [])) > len(self.progress.get(rid,
                                                                ())):
                self.progress[rid] = list(wire["out"])
                rec = self.stats.get(rid)
                if rec is not None and rec["t_first"] is None:
                    rec["t_first"] = now
            if rtr is not None:
                # in plane transit until a decode replica accepts it
                rtr.stamp_transition(rid, "migrating", now)
                if isinstance(wire.get("seq"), int):
                    rtr.annotate_open(rid, seq=wire["seq"])
            self.pending_bundles.append(wire)

    def _forward_bundles(self) -> None:
        still: deque = deque()
        while self.pending_bundles:
            wire = self.pending_bundles.popleft()
            need = int(wire["n_pages"])
            cand = self._alive(
                lambda h: h.can_decode
                and h.load["free_pages"] >= need
                # table width too (hello carries it): an oversized bundle
                # delivered to a replica that can never install it would
                # wedge that replica's whole install queue
                and need <= int(h.info.get("pages_per_seq", need)))
            h = self._pick(cand)
            if h is None:
                still.append(wire)
                continue
            t0, sent0 = time.perf_counter(), h.sent_bytes
            try:
                h.call({"op": "migrate", "bundle": wire})
            except ReplicaDead:
                self._on_death(h)
                still.append(wire)
                continue
            self.handoff_s.append(time.perf_counter() - t0)
            self.handoff_bytes.append(h.sent_bytes - sent0)
            h.assigned.add(int(wire["seq_id"]))
            h.load["free_pages"] -= int(wire["n_pages"])
            rtr = reqtracelib.active()
            if rtr is not None:
                # delivered: the row decodes on the receiver
                rtr.stamp_transition(int(wire["seq_id"]), "decode")
            self.migrations += 1
        self.pending_bundles = still

    # -- the loop ----------------------------------------------------------

    def _unresolved(self) -> list[int]:
        return [rid for rid, rec in self.stats.items()
                if rec.get("outcome") is None]

    def run(self, arrivals, *, timeout_s: float = 300.0) -> dict:
        """Admit the open-loop schedule, drive replica rounds until every
        request resolves (finished, resumed-and-finished, or shed), and
        return the report."""
        t0 = time.perf_counter()
        pending = deque(sorted(arrivals, key=lambda a: a[0]))
        deadline = t0 + timeout_s
        while True:
            now_rel = time.perf_counter() - t0
            while pending and pending[0][0] <= now_rel:
                t_arr, kw = pending.popleft()
                self.submit(t_submit=t0 + t_arr, **kw)
            if not pending and not self._unresolved():
                break
            if time.perf_counter() > deadline:
                for rid in self._unresolved():
                    self._shed(rid)
                print("router: timeout — remaining in-flight "
                      "requests counted shed", flush=True)
                break
            if not self._alive():
                for rid in self._unresolved():
                    self._shed(rid)
                print("router: no replicas left alive", flush=True)
                break
            if pending and not self._unresolved():
                # nothing in flight, next arrival in the future: wait on
                # the schedule's clock, boundedly
                wait = pending[0][0] - (time.perf_counter() - t0)
                time.sleep(min(max(wait, 0.0), 0.005))
                continue
            for h in list(self._alive()):
                try:
                    reply = h.call({"op": "round"})
                except ReplicaDead:
                    self._on_death(h)
                    continue
                self._merge_round(h, reply)
            self._forward_bundles()
            self._emit_attainment()
        for h in self._alive():
            try:
                h.call({"op": "stop"})
            except ReplicaDead:
                h.alive = False
        for h in self.handles:
            h.close()
        wall = time.perf_counter() - t0
        self.last_slo = slolib.attainment(
            self.stats, self.slo_targets, wall)
        # segment SLO budgets: when the run was request-traced AND judged
        # against targets, say which lifecycle segment blew them
        self.last_budget: list = []
        rtr = reqtracelib.active()
        if rtr is not None and self.slo_targets:
            self.last_budget = budgetlib.evaluate(
                rtr.snapshot(self.stats), self.slo_targets)
            budgetlib.publish(self.last_budget, emit=self._emit)
        return {
            "wall_s": wall,
            "n": len(self.stats),
            "served": sum(1 for r in self.stats.values()
                          if r.get("outcome") == "ok"),
            "shed": sorted(set(self.shed)),
            "deaths": list(self.deaths),
            "resumed": sorted(set(self.resumed)),
            "migrations": self.migrations,
            "slo": self.last_slo,
            "budget_breaches": len(self.last_budget),
        }
