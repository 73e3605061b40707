"""Stencil miniapp: distributed 1-D diffusion with halo exchange — the
counterpart of ``hpc_patterns_tpu/apps/stencil_app.py``.

The BASELINE.json config "SYCL+OMP shared-USM stencil with halo
exchange" as a self-validating benchmark: a periodic 3-point Jacobi
diffusion, the domain split over ``--world`` logical ranks (a
rank-stacked tensor, row r = rank r's shard), ghost cells exchanged every
step by two ring shifts (``comm/halo.py``), the step loop run eagerly.
Under the launcher (``apps/launch.py``) each process holds a block of
the ranks and the shifts cross processes over gloo.

Validation oracles (SURVEY.md §4.2 style):
1. conservation — periodic diffusion preserves the domain sum (rtol
   1e-4);
2. single-device replay — the sharded result equals a plain loop over
   the whole domain with ``torch.roll`` (atol 1e-5; the app also says
   whether the two are equal bit for bit).

The initial field comes from a seeded ``torch.Generator`` (``--seed``),
not JAX's threefry stream, so the app prints the seed. Reports the
per-step time (the cross-process MAX), the halo bandwidth and the
domain's effective GB/s (read once and written once a step).

    python -m hpc_patterns_tpu_torch.apps.stencil_app -p 22 --steps 64
    python -m hpc_patterns_tpu_torch.apps.stencil_app --device cpu -p 10
"""

from __future__ import annotations

import sys

import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.comm import halo
from hpc_patterns_tpu_torch.comm.communicator import (
    record_collective_bandwidth,
)
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness.cli import add_msg_size_args, base_parser
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.timing import (
    blocking,
    max_across_processes,
    measure,
)
from hpc_patterns_tpu_torch.harness.verdict import Verdict

CONSERVE_RTOL = 1e-4
DENSE_ATOL = 1e-5


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    add_msg_size_args(p)
    p.set_defaults(log2_elements=22)  # stencil default: 4M cells
    p.add_argument("--steps", type=int, default=64, help="Jacobi steps per run")
    p.add_argument("--world", type=int, default=-1,
                   help=f"logical ranks; -1 = {common.DEFAULT_WORLD} "
                        "(processes x ranks each under the launcher)")
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the initial field's torch.Generator")
    return p


def initial_field(n: int, seed: int) -> torch.Tensor:
    """The whole domain's initial values: uniform [0, 1) f32 from a CPU
    ``torch.Generator`` seeded with ``seed``, the same on every process
    and every device."""
    return torch.rand(n, generator=torch.Generator().manual_seed(seed),
                      dtype=torch.float32)


def dense_replay(u0: torch.Tensor, steps: int, alpha: float
                 ) -> torch.Tensor:
    """Oracle 2: the same diffusion on the whole domain at once."""
    v = u0
    for _ in range(steps):
        v = (1 - 2 * alpha) * v + alpha * (torch.roll(v, 1)
                                           + torch.roll(v, -1))
    return v


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    comm = common.make_communicator(args.device, args.world)
    wire = common.wire_line(comm)
    if wire:
        log.print(wire)
    world, block, dev = comm.size, comm.block, comm.device
    n = 1 << args.log2_elements  # global domain size (2**p, like -p)
    n += (-n) % world
    steps, alpha = args.steps, args.alpha
    per_rank = n // world
    log.print(f"stencil initial field: torch.Generator seed {args.seed}, "
              f"uniform [0, 1) f32, {n} cells")

    u0 = initial_field(n, args.seed).to(dev)
    start, local = comm.rank_offset, comm.local_size
    u0_local = u0[start * per_rank:(start + local) * per_rank].reshape(
        local, per_rank)

    def stepper(u):
        for _ in range(steps):
            u = halo.jacobi_step(u, alpha=alpha, block=block)
        return u

    result = measure(blocking(stepper, u0_local),
                     repetitions=args.repetitions, warmup=args.warmup,
                     label="stencil")
    out = stepper(u0_local)
    want = dense_replay(u0, steps, alpha).reshape(world, per_rank)

    # oracles over this process's ranks, as the reference's per-rank
    # asserts; u0 and the dense replay are the same on every process
    mine = want[start:start + local]
    matches = bool(torch.allclose(out, mine, rtol=0.0, atol=DENSE_ATOL))
    bitwise = common.all_processes_agree(bool(torch.equal(out, mine)))
    total = common.reduce_across_processes(
        float(out.double().sum()), sum)
    conserved = abs(total - float(u0.double().sum())) \
        <= CONSERVE_RTOL * abs(float(u0.double().sum()))

    ok = common.all_processes_agree(conserved and matches)
    per_step = max_across_processes(result.min_s) / steps
    halo_bytes = 2 * 4 * world  # 2 directions x f32 per rank, per step
    domain_gbps = 2 * 4 * n / per_step / 1e9 if per_step > 0 else 0.0
    record_collective_bandwidth("halo", halo_bytes, per_step)
    metricslib.get_metrics().gauge("stencil.step_us").set(per_step * 1e6)
    log.emit(
        kind="result", name="stencil", success=ok, world=world,
        elements=n, steps=steps, per_step_us=per_step * 1e6,
        conserved=conserved, matches_dense=matches, bitwise_dense=bitwise,
        domain_gbps=domain_gbps, seed=args.seed, device=dev.type,
        processes=block.num_processes if block is not None else 1,
    )
    log.print(
        f"stencil world={world} n={n} steps={steps}: "
        f"{per_step * 1e6:.2f} us/step "
        f"(halo {halo_bytes}B/step, domain {domain_gbps:.2f} GB/s) "
        f"conserved={conserved} dense-match={matches} "
        f"dense-bitwise={bitwise}")
    if ok:
        for r in range(start, start + local):
            log.print(f"Passed {r}")
    verdict = Verdict(success=ok, messages=("SUCCESS" if ok else "FAILURE",))
    log.print(verdict.summary_line())
    return verdict.exit_code


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
