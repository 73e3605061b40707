"""Point-to-point ping-pong between rank pairs — the counterpart of
``hpc_patterns_tpu/apps/pingpong_app.py``.

The BASELINE.json "2-rank device-buffer ping-pong" config: the
reference's paired blocking ``MPI_Send/MPI_Recv`` (allreduce-mpi-sycl.cpp:
50-58) as a standalone benchmark. Over logical ranks on one card the pair
exchange r <-> r^1 is one permutation of rows: ``--algorithm collective``
(the default) permutes them with PyTorch ops, ``--algorithm fused`` has
the device issue the copies inside one kernel (``comm/fused.py``).

Sweeps message sizes ``--min-p .. -p`` (default 3..25), reporting per-size
exchange latency and per-rank bandwidth. Oracle: ``rank_filled`` makes
row r the constant r, so after one exchange row r holds r^1 everywhere.
Under the launcher each process checks the pairs it holds and the
verdicts are ANDed across processes; ``fused`` is refused there (exit 2).

    python -m hpc_patterns_tpu_torch.apps.pingpong_app --min-p 3 -p 25
    python -m hpc_patterns_tpu_torch.apps.pingpong_app --algorithm fused
    python -m hpc_patterns_tpu_torch.apps.pingpong_app -p 6 --device cpu
"""

from __future__ import annotations

import sys

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.comm import processes
from hpc_patterns_tpu_torch.comm.communicator import (
    record_collective_bandwidth,
)
from hpc_patterns_tpu_torch.dtypes import get_traits
from hpc_patterns_tpu_torch.harness.cli import (
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
from hpc_patterns_tpu_torch.harness.verdict import Verdict


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    add_msg_size_args(p)
    add_sweep_args(p)
    p.add_argument("--world", type=int, default=-1,
                   help=f"logical ranks; -1 = {common.DEFAULT_WORLD}")
    p.add_argument("--algorithm", default="collective",
                   choices=("collective", "fused"),
                   help="'fused' = the exchange inside one CUDA kernel")
    return p


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    if args.min_p > args.log2_elements:
        # an empty sweep must not be a vacuous SUCCESS
        log.print(f"ERROR: --min-p {args.min_p} > -p {args.log2_elements}")
        log.print("FAILURE")
        return 1
    comm = common.make_communicator(args.device, args.world, even=True)
    wire = common.wire_line(comm)
    if wire:
        log.print(wire)
        if args.algorithm == "fused":
            log.print("ERROR: --algorithm fused across processes is "
                      f"refused: {processes.FUSED_ACROSS_PROCESSES}")
            log.print("FAILURE")
            return 2
    if comm.size < 2:
        log.print("SKIP: ping-pong needs >= 2 ranks (even ranks, "
                  "allreduce-mpi-sycl.cpp:95-97)")
        log.print("SUCCESS")  # precondition skip, not a failure
        return 0
    traits = get_traits(args.dtype)
    partner = [r ^ 1 for r in range(comm.size)]
    all_ok = True
    for p in range(args.min_p, args.log2_elements + 1):
        n = 1 << p
        x = comm.rank_filled(n, traits.dtype)
        exchange = comm.jit_pingpong(x, args.algorithm)
        result = measure(blocking(exchange, x), repetitions=args.repetitions,
                         warmup=args.warmup, label="pingpong")
        elapsed = max_across_processes(result.min_s)
        out = exchange(x)
        comm.synchronize()  # raises if a fused launch timed out
        ok = all(bool((row == partner[r]).all())
                 for r, row in common.local_rows(out, comm))
        ok = common.all_processes_agree(ok)
        all_ok &= ok
        nbytes = n * traits.itemsize
        bw = nbytes / elapsed / 1e9 if elapsed > 0 else float("inf")
        record_collective_bandwidth("pingpong", nbytes, elapsed,
                                    latency_us=elapsed * 1e6)
        log.emit(kind="result", name=f"pingpong[p={p}]", success=ok,
                 algorithm=args.algorithm, elements=n,
                 bytes_per_rank=nbytes, world=comm.size,
                 latency_us=elapsed * 1e6, bandwidth_gbps=bw,
                 device=comm.device.type)
        log.print(f"pingpong n=2^{p}: {elapsed * 1e6:.2f} us, {bw:.3f} GB/s "
                  f"{'ok' if ok else 'MISMATCH'}")
    verdict = Verdict(success=all_ok,
                      messages=("SUCCESS" if all_ok else "FAILURE",))
    log.print(verdict.summary_line())
    return verdict.exit_code


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
