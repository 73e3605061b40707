"""Array-level communicator over logical ranks — the counterpart of
``hpc_patterns_tpu/comm/communicator.py``.

The JAX ``Communicator`` binds one axis of a device mesh and exposes
collectives over global arrays whose leading dimension is sharded on that
axis: row r is rank r's buffer. The port keeps exactly that view on one
card: a mesh is a ``{name: size}`` shape, the ranks of its axis are
logical, and a "global array" is one ``(size, ...)`` tensor on the
communicator's device. The host-driven algorithms (``collective``,
``ring``, ``ring_chunked``) are PyTorch ops over rows; ``fused`` runs the
whole ring inside one CUDA kernel (:mod:`.fused`).

Every operation keeps a closure cached per (shape, dtype, axis,
algorithm), as the JAX one caches its jitted closures, so a sweep that
races algorithms at one shape builds each route once.

Observability, as the JAX module's: every eager collective runs in a
``comm.<op>`` span, takes a per-communicator sequence number, is
fingerprinted into the schedule chain when anything consumes it, and —
while something records — waits inside its span for an event recorded
behind its work, so the span measures completion; with a flight recorder
the collective is also a ``comm.<op>.<algorithm>`` device window. With
nothing recording the path stays asynchronous and unchanged.

Chaos (``harness/chaos.py``): every eager collective probes the
``collective`` site at its sequence number before its work is enqueued,
so a seeded straggler's collective genuinely starts late and a seeded
death happens at the named collective. One cached read with no chaos.

A communicator may span processes (``block``, a
:class:`~.processes.RankBlock`): its tensors then hold this process's
rows, ``(block.local, ...)``, and the host-driven algorithms exchange
rows with the other processes through gloo (:mod:`.processes`). The
fused routes refuse across processes (:data:`.processes.
FUSED_ACROSS_PROCESSES`): this is a refusal, not a fallback.
"""

from __future__ import annotations

from typing import Literal

import torch

from hpc_patterns_tpu_torch.comm import collectives, fused, processes, ring
from hpc_patterns_tpu_torch.harness import chaos as chaoslib
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness import trace as tracelib
from hpc_patterns_tpu_torch.topology import resolve_device

Algorithm = Literal["collective", "ring", "ring_chunked", "fused"]


def _open_window(device):
    """A device window opened before a collective's work is enqueued,
    or None with no recorder."""
    rec = tracelib.active()
    return rec.open_window(device) if rec is not None else None


def _ready_in_span(result, device, window=None, op: str = "collective",
                   seq: int | None = None, axis: str | None = None,
                   algorithm: str | None = None):
    """Complete the collective inside its open span when a span records:
    with a recorder, close the ``comm.<op>`` device window (its end event
    behind the work), wait for it and draw it, ``seq`` in its args; with
    only metrics (or a profiler mirror), record one event behind the work
    and wait for it. Every eager collective is also fingerprinted into
    the schedule chain before the wait whenever anything consumes it.
    With nothing recording the result returns unready: the disabled path
    stays asynchronous."""
    m = metricslib.get_metrics()
    rec = tracelib.active()
    if seq is not None and tracelib.schedule_consumer():
        tracelib.record_collective(
            op, seq, shape=tuple(result.shape),
            dtype=str(result.dtype).removeprefix("torch."), axis=axis,
            algorithm=algorithm)
    if rec is not None:
        attrs = None if seq is None else {"seq": seq}
        rec.mark_dispatch(f"comm.{op}", args=attrs, window=window)
        rec.wait_window(window)
        rec.mark_complete(f"comm.{op}", window, args=attrs)
    elif (m.enabled or m.mirror_traces) and device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        # torchlint: disable=host-sync-in-dispatch — measures completion,
        # only when metrics or trace mirroring asked for the timing
        done.synchronize()
    return result


def _inject_chaos(seq: int) -> None:
    """Chaos injection, straggler site — called by every collective
    method before its work is enqueued, so the injected delay precedes
    the dispatch itself: the straggler's collective ``seq`` genuinely
    starts late, and the skew in the cross-rank merge is the real
    perturbation. One cached-config read when no chaos is active."""
    if chaoslib.active() is not None:
        chaoslib.maybe_inject("collective", seq)


def record_collective_bandwidth(op: str, nbytes: int, seconds: float,
                                **attrs) -> None:
    """Per-collective bandwidth gauge + latency histogram in the metrics
    registry (no-op when disabled), so a sweep's ``kind=metrics``
    snapshot carries the numbers its ``kind=result`` records do.
    ``attrs`` become gauges too (``busbw_gbps=...``)."""
    m = metricslib.get_metrics()
    if not m.enabled or seconds <= 0:
        return
    m.gauge(f"comm.{op}.bandwidth_gbps").set(nbytes / seconds / 1e9)
    m.histogram(f"comm.{op}.s").observe(seconds)
    for key, value in attrs.items():
        m.gauge(f"comm.{op}.{key}").set(value)

# allreduce algorithm table: library collective vs hand-built rings vs the
# device-initiated fused ring (SURVEY.md §2.3(b))
_ALLREDUCE = {
    "collective": lambda x, block: collectives.allreduce(x, "sum",
                                                         block=block),
    "ring": lambda x, block: ring.ring_allreduce(x, block=block),
    # chunk over the trailing (data) axis of each rank's shard
    "ring_chunked": lambda x, block: ring.ring_allreduce_chunked(
        x, scatter_axis=x.dim() - 2, block=block),
}


class Communicator:
    """Collectives over one named axis of a logical mesh.

    ``Communicator({"x": 4}, "x")`` plays ``MPI_COMM_WORLD`` over 4 ranks;
    ``size`` is ``MPI_Comm_size``. Tensors passed in have a leading
    dimension equal to :attr:`local_size` (one row per rank this process
    holds: ``size`` in one process) and are moved to the communicator's
    device (``cuda`` unless ``device="cpu"``). ``block``: the ranks this
    process holds when the communicator spans processes (a 1-D mesh
    only)."""

    def __init__(self, mesh_shape: dict, axis: str = "x", device=None,
                 block: processes.RankBlock | None = None):
        if axis not in mesh_shape:
            raise ValueError(
                f"axis {axis!r} not in mesh axes {tuple(mesh_shape)}")
        self.mesh_shape = {k: int(v) for k, v in mesh_shape.items()}
        self.axis = axis
        self.device = resolve_device(device)
        if block is not None and (len(self.mesh_shape) != 1
                                  or block.world != self.size):
            raise ValueError(
                f"a communicator across processes is a 1-D mesh of the "
                f"block's {block.world} ranks, got {self.mesh_shape}")
        self.block = block if processes.spans(block) else None
        self._jit_allreduce_cache: dict = {}
        self._agmm_cache: dict = {}
        # per-communicator collective counter: the SPMD ranks issue the
        # same sequence, so (span name, seq) names one collective
        self._seq = 0

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _eager(self, name: str, op: str, run, route=None, **attrs):
        """One eager collective: the chaos probe, then ``run()`` enqueues
        it inside a ``comm.<name>`` span (``attrs`` its args), then
        :func:`_ready_in_span`; ``route`` is the fingerprint's
        algorithm."""
        seq = self._next_seq()
        _inject_chaos(seq)
        with metricslib.span(f"comm.{name}", **attrs):
            window = _open_window(self.device)
            return _ready_in_span(run(), self.device, window, op=op,
                                  seq=seq, axis=self.axis,
                                  algorithm=route)

    @property
    def size(self) -> int:
        return self.mesh_shape[self.axis]

    @property
    def local_size(self) -> int:
        """The ranks this process holds: ``size`` in one process."""
        return self.block.local if self.block is not None else self.size

    @property
    def rank_offset(self) -> int:
        """The global rank of this process's first row."""
        return self.block.start if self.block is not None else 0

    def _refuse_fused(self, what: str) -> None:
        if self.block is not None:
            raise ValueError(
                f"{what} across {self.block.num_processes} processes is "
                f"refused: {processes.FUSED_ACROSS_PROCESSES}")

    def shard(self, x) -> torch.Tensor:
        """A ``(local_size, ...)`` tensor on the communicator's device —
        each rank's buffer allocated and initialized
        (allreduce-mpi-sycl.cpp:154-164)."""
        x = torch.as_tensor(x)
        if x.shape[0] != self.local_size:
            raise ValueError(
                f"leading dim {x.shape[0]} != the {self.local_size} "
                "rank(s) this process holds")
        return x.to(self.device)

    # -- the fused route over the mesh's flat rank order -------------------

    def _geometry(self) -> fused.RingGeometry | None:
        """``None`` on a 1-D mesh (the identity ring); else the ring of
        :attr:`axis` inside the row-major flat rank order, whose replicas
        run the same schedule (the JAX ``_fused_route``)."""
        if len(self.mesh_shape) == 1:
            return None
        return fused.mesh_ring_geometry(self.mesh_shape, self.axis)

    def _fused_call(self, fn, *xs):
        """``fn(*operands, geometry=...)`` over the flat rank order: a 1-D
        mesh runs as is; a multi-axis mesh expands every operand's rows to
        the flat ranks (row f = ring position pos(f)), runs, and folds one
        representative row per position back (JAX ``_fused_shmap``)."""
        self._refuse_fused("the fused route")
        g = self._geometry()
        if g is None:
            return fn(*xs, geometry=None)
        idx = torch.tensor(g.positions(), device=self.device)
        sel = torch.tensor(g.ring_ids(), device=self.device)
        return fn(*(v[idx] for v in xs), geometry=g)[sel]

    # -- collectives over (size, ...) tensors ------------------------------

    def allreduce(self, x, algorithm: Algorithm = "collective"
                  ) -> torch.Tensor:
        """Elementwise sum across ranks; every row of the result holds the
        sum (MPI_Allreduce semantics; the hand ring of
        allreduce-mpi-sycl.cpp:173-182 for ``"ring"``; the two-phase ring
        for ``"ring_chunked"``; the same ring inside one kernel for
        ``"fused"``)."""
        x = self.shard(x)
        fn = self.jit_allreduce(x, algorithm)
        return self._eager("allreduce", f"allreduce.{algorithm}",
                           lambda: fn(x), algorithm, algorithm=algorithm)

    def jit_allreduce(self, x, algorithm: Algorithm = "collective"):
        """The allreduce closure for ``x``'s shape — what a benchmark
        times. Cached per (shape, dtype, axis, algorithm)."""
        if algorithm not in ("collective", "ring", "ring_chunked", "fused"):
            raise ValueError(f"unknown allreduce algorithm {algorithm!r}")
        key = (tuple(x.shape), str(x.dtype).removeprefix("torch."),
               self.axis, algorithm)
        fn = self._jit_allreduce_cache.get(key)
        if fn is None:
            if algorithm == "fused":
                self._refuse_fused("allreduce 'fused'")

                def fn(v):
                    return self._fused_call(
                        lambda a, geometry: fused.fused_allreduce(
                            a, geometry=geometry), v)
            else:
                impl, block = _ALLREDUCE[algorithm], self.block

                def fn(v):
                    return impl(v, block)
            self._jit_allreduce_cache[key] = fn
        return fn

    def pingpong(self, x, algorithm: str = "collective") -> torch.Tensor:
        """Pairwise even/odd exchange: row r swaps with row r^1 — the
        pt2pt ping-pong config of BASELINE.json."""
        x = self.shard(x)
        fn = self.jit_pingpong(x, algorithm)
        return self._eager("pingpong", "pingpong", lambda: fn(x))

    def jit_pingpong(self, x, algorithm: str = "collective"):
        """The pairwise-exchange closure (for timing loops):
        ``"collective"`` permutes the rows with PyTorch ops
        (``ring.pairwise_exchange``); ``"fused"`` has the device issue the
        copies (:func:`fused.fused_permute`)."""
        if algorithm == "collective":
            block = self.block
            if block is None:
                return ring.pairwise_exchange
            return lambda v: ring.pairwise_exchange(v, block=block)
        if algorithm != "fused":
            raise ValueError(f"pingpong algorithm {algorithm!r} not in "
                             "('collective', 'fused')")
        self._refuse_fused("pingpong 'fused'")
        pairs = [(r, r ^ 1) for r in range(self.size)]

        def fn(v):
            return self._fused_call(
                lambda a, geometry: fused.fused_permute(
                    a, pairs, geometry=geometry), v)
        return fn

    def sendrecv_ring(self, x, shift: int = 1) -> torch.Tensor:
        """One ring hop: row r moves to row (r+shift) % size
        (SendRecvRing, allreduce-mpi-sycl.cpp:43-59)."""
        x = self.shard(x)
        return self._eager("sendrecv_ring", "sendrecv_ring",
                           lambda: ring.ring_shift(x, shift,
                                                   block=self.block),
                           shift=shift)

    def all_gather(self, x) -> torch.Tensor:
        """Every rank receives every row: (size, n) -> (size, size, n)."""
        x = self.shard(x)
        return self._eager(
            "all_gather", "all_gather",
            lambda: collectives.all_gather(x, tiled=False,
                                           block=self.block))

    def reduce_scatter(self, x) -> torch.Tensor:
        """(size, size*n) rows -> (size, n): rank r gets chunk r of the
        sum."""
        x = self.shard(x)
        return self._eager(
            "reduce_scatter", "reduce_scatter",
            lambda: collectives.reduce_scatter(x, scatter_axis=x.dim() - 2,
                                               block=self.block))

    def all_to_all(self, x) -> torch.Tensor:
        """Row r's chunk c goes to row c's chunk r (MPI_Alltoall)."""
        x = self.shard(x)
        return self._eager(
            "all_to_all", "all_to_all",
            lambda: collectives.all_to_all(x, split_axis=x.dim() - 2,
                                           concat_axis=x.dim() - 2,
                                           block=self.block))

    # -- fused collective + consumer ops -----------------------------------

    def allgather_matmul(self, x, w, algorithm: str = "fused"
                         ) -> torch.Tensor:
        """``all_gather(x) @ w`` with per-rank weight panels: ``x``
        (size, m, k), ``w`` (size, k, n); row r of the result is
        ``gathered_x @ w[r]``, shape (size*m, n). ``"fused"`` runs the
        gather ring inside one kernel, each arriving shard feeding a
        matmul tile; ``"collective"`` gathers first, then computes the
        tiles (f32 accumulation, cast back) — the plain version."""
        if algorithm not in ("fused", "collective"):
            raise ValueError(
                f"allgather_matmul algorithm {algorithm!r} not in "
                "('fused', 'collective')")
        x, w = self.shard(x), self.shard(w)
        if x.dim() != 3 or w.dim() != 3:
            raise ValueError(
                f"want x (size, m, k) and w (size, k, n), got "
                f"{tuple(x.shape)} and {tuple(w.shape)}")
        key = (tuple(x.shape), str(x.dtype), tuple(w.shape), str(w.dtype),
               self.axis, algorithm)
        fn = self._agmm_cache.get(key)
        if fn is None:
            if algorithm == "fused":
                self._refuse_fused("allgather_matmul 'fused'")

                def fn(a, b):
                    return self._fused_call(fused.allgather_matmul, a, b)
            elif self.block is not None:
                block = self.block

                def fn(a, b):
                    # every rank's x through gloo, then this process's
                    # panels: the plain version's f32 products
                    g = processes.gather_rows(a, block)
                    return torch.matmul(
                        g.reshape(-1, g.shape[2]).float()[None],
                        b.float()).to(a.dtype)
            else:
                fn = fused.allgather_matmul_reference
            self._agmm_cache[key] = fn
        return self._eager("allgather_matmul",
                           f"allgather_matmul.{algorithm}",
                           lambda: fn(x, w), algorithm, algorithm=algorithm)

    def allreduce_into(self, x, bias=None, epilogue=None,
                       algorithm: str = "fused") -> torch.Tensor:
        """Allreduce(sum) with its consumer fused in: every row holds
        ``epilogue(sum_ranks(x) + bias)`` in ``x``'s dtype. On ``"fused"``
        the bias and epilogue apply to each reduced chunk as it lands (the
        kernel takes epilogue None or ``"relu"``); ``"collective"`` sums,
        then applies them as ordinary ops."""
        if algorithm not in ("fused", "collective"):
            raise ValueError(
                f"allreduce_into algorithm {algorithm!r} not in "
                "('fused', 'collective')")
        if algorithm == "fused":
            self._refuse_fused("allreduce_into 'fused'")
        x = self.shard(x)
        row_bias = (None if bias is None else
                    torch.as_tensor(bias, device=self.device).to(x.dtype))

        def run():
            if algorithm == "fused":
                return self._fused_call(
                    lambda a, geometry: fused.allreduce_into(
                        a, bias=row_bias, epilogue=epilogue,
                        geometry=geometry), x)
            out = collectives.allreduce(x, "sum", block=self.block)
            if row_bias is not None:
                out = out + row_bias
            # the same dtype contract as the fused route
            return fused._apply_epilogue(out, epilogue).to(x.dtype)

        return self._eager("allreduce_into", f"allreduce_into.{algorithm}",
                           run, algorithm, algorithm=algorithm)

    # -- miniapp-style buffer init -----------------------------------------

    def rank_filled(self, n: int, dtype="float32") -> torch.Tensor:
        """The miniapp's ``Initialize``: rank r's buffer filled with r
        (allreduce-mpi-sycl.cpp:33-41), so the allreduce oracle is
        ``size*(size-1)/2``. Built on the device."""
        from hpc_patterns_tpu_torch.dtypes import get_traits

        dt = get_traits(dtype).dtype
        ranks = torch.arange(self.rank_offset,
                             self.rank_offset + self.local_size,
                             device=self.device).to(dt)
        return ranks[:, None].expand(self.local_size, n).contiguous()

    def expected_allreduce_value(self) -> float:
        """The analytic oracle: Σ ranks = size(size-1)/2."""
        return self.size * (self.size - 1) / 2

    def synchronize(self) -> None:
        """Wait for the card and raise if a fused ring launch timed out
        (:func:`fused.synchronize`); nothing to wait for on the CPU."""
        if self.device.type == "cuda":
            fused.synchronize(self.device)
