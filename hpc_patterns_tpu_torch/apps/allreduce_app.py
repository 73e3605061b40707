"""Allreduce miniapp: ring vs library collective over logical ranks — the
counterpart of ``hpc_patterns_tpu/apps/allreduce_app.py`` (the reference's
allreduce-mpi-sycl.cpp and its OpenMP twins).

Reproduced semantics:

- ``-a`` switches from the hand ring to the library collective
  (allreduce-mpi-sycl.cpp:122-124); ``--algorithm`` picks any of ring,
  ring_chunked (the two-phase ring), collective, fused (the two-phase ring
  inside one CUDA kernel, ``comm/fused.py``);
- ``-p N`` → 2**N elements per rank, default 25 (:99,125-128);
- ``-H/-D/-S`` allocator axis (:104-131): ``-D``/``-S`` run in device
  memory; with ``-H`` the operand and the result live in pinned host
  memory between repetitions, and each timed step copies the operand to
  the card, runs the algorithm there and copies the result back, all on
  the stream (``memory/kinds.py``'s transfer callables) — equal bit for
  bit to ``-D``. Where pinned host memory is unusable (the CPU) it prints
  JAX's note and runs on the device memory;
- rank-valued init (:33-41), the analytic oracle size(size−1)/2 checked
  elementwise, per-rank "Passed r" lines (:192-206); rows past 256 MiB
  are checked on the card as a mismatch count;
- min over repetitions after warm-up, each timed call ending in a
  synchronize (:170-190);
- ``--dtype`` ≙ the typed CTest variants; ``--world`` logical ranks on one
  card (default 4, the CTest's ``mpirun -np 4``);
- ``--sweep`` runs every algorithm over ``--min-p..-p``, one validated
  JSONL result per point — the busbw-vs-size curve.

On one card the "wire" is device memory, so these bandwidths measure a
ring's traffic on the card, not a link. Under the launcher each process
holds a block of the ranks and the collectives cross processes over gloo
through host memory (a line says so); each process validates the rows
it holds and the verdicts are ANDed across processes. ``fused`` runs
every rank in one cooperative launch, so across processes it is refused
(``--algorithm fused`` exits 2) and a sweep runs the other three.

    python -m hpc_patterns_tpu_torch.apps.allreduce_app --sweep --min-p 3 -p 25
    python -m hpc_patterns_tpu_torch.apps.allreduce_app -p 5 --world 8 --device cpu
    python -m hpc_patterns_tpu_torch.apps.launch -np 2 -- \
        python -m hpc_patterns_tpu_torch.apps.allreduce_app -p 8 --device cpu
"""

from __future__ import annotations

import sys

import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.comm import processes
from hpc_patterns_tpu_torch.comm.communicator import (
    record_collective_bandwidth,
)
from hpc_patterns_tpu_torch.dtypes import get_traits
from hpc_patterns_tpu_torch.harness.cli import (
    add_memory_kind_args,
    add_msg_size_args,
    add_sweep_args,
    base_parser,
)
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.timing import (
    blocking,
    max_across_processes,
    measure,
)
from hpc_patterns_tpu_torch.harness.verdict import Verdict, correctness_verdict
from hpc_patterns_tpu_torch.memory import kinds as kindslib

ALGORITHMS = ("ring", "ring_chunked", "collective", "fused")
#: rows larger than this are checked on the card (a mismatch count), not
#: read back (allreduce_app.py's GB-scale rule)
HOST_CHECK_BYTES = 256 << 20
#: live copies of the global tensor a point may need (input, output, the
#: fused route's two slot arrays, the host rings' temporaries)
WORKING_SET_COPIES = 6


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    add_msg_size_args(p)
    add_memory_kind_args(p)
    p.add_argument("-a", "--allreduce", action="store_true",
                   help="use the library collective (reference -a → "
                        "MPI_Allreduce)")
    p.add_argument("--algorithm", default=None, choices=ALGORITHMS,
                   help="explicit algorithm (overrides -a; default ring, "
                        "like the reference; 'fused' = the ring inside one "
                        "CUDA kernel)")
    p.add_argument("--world", type=int, default=-1,
                   help=f"logical ranks; -1 = {common.DEFAULT_WORLD}")
    p.add_argument("--sweep", action="store_true",
                   help="sweep message sizes --min-p..-p for each algorithm "
                        "(all four unless --algorithm/-a narrows it), one "
                        "validated JSONL result per point")
    add_sweep_args(p)
    return p


def resolve_algorithm(args) -> str:
    if args.algorithm:
        return args.algorithm
    return "collective" if args.allreduce else "ring"


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    comm = common.make_communicator(args.device, args.world, even=True)
    wire = common.wire_line(comm)
    if wire:
        log.print(wire)
        if args.algorithm == "fused":
            log.print("ERROR: --algorithm fused across processes is "
                      f"refused: {processes.FUSED_ACROSS_PROCESSES}")
            log.print("FAILURE")
            return 2
    if args.sweep:
        return run_sweep(args, log, comm)
    return _run_point(args, log, comm, resolve_algorithm(args),
                      args.log2_elements)


def _memory_budget_bytes(comm) -> int | None:
    """Card memory a point can use: free on the card
    (``torch.cuda.mem_get_info``) plus what PyTorch's allocator holds
    cached but unused; None on the CPU. Read before every point, so the
    buffers and fused-ring scratch that earlier points left are counted."""
    if comm.device.type != "cuda":
        return None
    cached = (torch.cuda.memory_reserved(comm.device)
              - torch.cuda.memory_allocated(comm.device))
    return torch.cuda.mem_get_info(comm.device)[0] + cached


def run_sweep(args, log, comm) -> int:
    """Message-size sweep per algorithm: every point is a full validated
    run and emits one JSONL result — together the busbw-vs-size curve."""
    if args.min_p > args.log2_elements:
        log.print(f"ERROR: --min-p {args.min_p} > -p {args.log2_elements}")
        log.print("FAILURE")
        return 1
    algorithms = ([resolve_algorithm(args)]
                  if args.algorithm or args.allreduce else list(ALGORITHMS))
    if comm.block is not None and "fused" in algorithms:
        algorithms.remove("fused")
        log.print("fused: not run across processes: "
                  f"{processes.FUSED_ACROSS_PROCESSES}")
    n_ok = n_total = 0
    kind_cache: dict = {}  # the memory kind's probe, resolved once
    for algorithm in algorithms:
        for p in range(args.min_p, args.log2_elements + 1):
            need = (WORKING_SET_COPIES * comm.size * (1 << p)
                    * get_traits(args.dtype).itemsize)
            budget = _memory_budget_bytes(comm)
            if budget and need > budget:
                # a curve that silently stops reads as "measured everything"
                log.print(f"skipped {algorithm} p={p}: ~{need >> 20} MiB "
                          f"working set exceeds free memory {budget >> 20} MiB")
                continue
            n_total += 1
            n_ok += _run_point(args, log, comm, algorithm, p,
                               kind_cache) == 0
    ok = n_ok == n_total and n_total > 0
    log.print(f"sweep: {n_ok}/{n_total} points passed "
              f"(world={comm.size}, p={args.min_p}..{args.log2_elements}, "
              f"algorithms={','.join(algorithms)})")
    log.print("SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


def device_mismatches(row: torch.Tensor, expected: float, traits) -> int:
    """Elements of ``row`` off the oracle, counted where the row lives
    (the tolerance rule of ``dtypes.validate_allreduce``)."""
    if traits.exact_sum:
        return int((row != expected).sum())
    tol = traits.tolerance + 1e-6 * abs(expected)
    return int(((row.double() - expected).abs() > tol).sum())


def host_resident(step, device):
    """``step`` over an operand in pinned host memory: copy it to the
    card, run ``step`` there and copy the result into pinned host memory,
    all enqueued on the current stream (the caller's synchronize is the
    fence) — the ``-H`` route."""
    to_dev = kindslib.move_to_kind(device, "device")
    to_host = kindslib.move_to_kind(device, "pinned_host")
    return lambda xh: to_host(step(to_dev(xh)))


def _memory_kind(log, comm, want: str, kind_cache: dict | None):
    """The memory kind a point runs in: ``want``, or None (device memory)
    with JAX's note where pinned host transfers do not work here."""
    if want == "device":
        return None
    if kind_cache is not None and "kind" in kind_cache:
        return kind_cache["kind"]
    kind = want
    if comm.device.type != "cuda" \
            or not kindslib.memory_kind_transfers_work(comm.device):
        log.print(f"note: memory kind {want!r} unsupported here (no "
                  f"page-locked memory on {comm.device.type}); using device")
        kind = None
    if kind_cache is not None:
        kind_cache["kind"] = kind
    return kind


def _run_point(args, log, comm, algorithm: str, log2_elements: int,
               kind_cache: dict | None = None) -> int:
    world = comm.size
    n = 1 << log2_elements
    traits = get_traits(args.dtype)
    if algorithm == "ring_chunked" and n % world:
        # the chunked ring needs size | n: pad up like a real collective
        n += world - n % world
    memory_kind = _memory_kind(log, comm, args.memory_kind, kind_cache)
    x = comm.rank_filled(n, traits.dtype)
    step = comm.jit_allreduce(x, algorithm)
    if memory_kind == "pinned_host":
        step = host_resident(step, comm.device)
        x = kindslib.move_to_kind(comm.device, "pinned_host")(x)
        comm.synchronize()
    result = measure(blocking(step, x), repetitions=args.repetitions,
                     warmup=args.warmup, label=f"allreduce.{algorithm}")
    elapsed = max_across_processes(result.min_s)

    out = step(x)
    comm.synchronize()  # raises if a fused launch timed out
    del x
    expected = comm.expected_allreduce_value()
    ok_local = True
    if n * traits.itemsize > HOST_CHECK_BYTES:
        for r, row in common.local_rows(out, comm):
            bad = device_mismatches(row, expected, traits)
            log.print(f"Passed {r}" if bad == 0 else
                      f"rank {r}: {bad}/{n} elements wrong (device-side "
                      "oracle)")
            ok_local &= bad == 0
    else:
        for r, row in common.local_rows(out.cpu(), comm):
            v = correctness_verdict(row, expected, dtype=traits.dtype, rank=r)
            log.print(f"Passed {r}" if v.success else v.messages[0])
            ok_local &= v.success
    ok = common.all_processes_agree(ok_local)
    verdict = Verdict(success=ok, messages=("SUCCESS" if ok else "FAILURE",))

    nbytes = n * traits.itemsize
    busbw = common.allreduce_bus_bandwidth_gbps(nbytes, elapsed, world)
    record_collective_bandwidth(f"allreduce.{algorithm}", nbytes, elapsed,
                                busbw_gbps=busbw)
    log.result(f"allreduce[{algorithm}]", verdict, world=world, elements=n,
               dtype=traits.name, bytes_per_rank=nbytes, elapsed_s=elapsed,
               algbw_gbps=nbytes / elapsed / 1e9 if elapsed > 0 else
               float("inf"),
               busbw_gbps=busbw, memory_kind=memory_kind or "device",
               device=comm.device.type)
    log.print(f"{algorithm} world={world} n=2^{log2_elements} {traits.name}: "
              f"{elapsed * 1e3:.3f} ms, busbw {busbw:.2f} GB/s")
    log.print(verdict.summary_line())
    return verdict.exit_code


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
