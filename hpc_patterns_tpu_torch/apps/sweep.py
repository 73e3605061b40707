"""Concurrency sweep harness — the counterpart of
``hpc_patterns_tpu/apps/sweep.py`` (the reference's ``concurency/run.sh``).

run.sh:4-15 sweeps the command matrix {C C, C M2D, C D2M, M2D D2M} over
its modes, re-runs each passing configuration with
``--enable_profiling``, tees everything to ``run.log`` and greps a
SUCCESS/FAILURE summary (:17-18). Same here, with a JSONL log beside the
grep-able stdout. The default modes are ``async`` and ``threads``: on
the card both can overlap (each command has its own stream).

    python -m hpc_patterns_tpu_torch.apps.sweep --log sweep.jsonl
"""

from __future__ import annotations

import sys

from hpc_patterns_tpu_torch.apps import common, concurrency_app
from hpc_patterns_tpu_torch.harness.cli import base_parser
from hpc_patterns_tpu_torch.harness.runlog import RunLog

# run.sh:4's command matrix
DEFAULT_MATRIX = [["C", "C"], ["C", "M2D"], ["C", "D2M"], ["M2D", "D2M"]]


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--modes", nargs="*", default=["async", "threads"],
                   help="dispatch modes to sweep (run.sh sweeps "
                        "out_of_order, in_order)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "dispatch", "onchip"],
                   help="passed through to the concurrency app")
    p.add_argument("--copy-elements", type=int, default=-1)
    p.add_argument("--tripcount", type=int, default=-1)
    p.add_argument("--rule", default="sycl", choices=["sycl", "omp"])
    p.add_argument("--profile-on-success", action="store_true",
                   help="re-run passing configs under the profiler "
                        "(run.sh:10-12)")
    return p


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)  # owns the log
    app_parser = concurrency_app.build_parser()
    for commands in DEFAULT_MATRIX:
        for mode in args.modes:
            argv = [mode, *commands,
                    "--engine", args.engine,
                    "--copy-elements", str(args.copy_elements),
                    "--tripcount", str(args.tripcount),
                    "--rule", args.rule,
                    "--repetitions", str(args.repetitions),
                    "--warmup", str(args.warmup)]
            if args.device:
                argv += ["--device", args.device]
            if args.log:
                argv += ["--log", args.log, "--log-append"]  # share our log
            log.print(f"=== {mode} {' '.join(commands)} ===")
            code = concurrency_app.run(app_parser.parse_args(argv))
            log.emit(kind="result", name=f"sweep[{mode}:{'+'.join(commands)}]",
                     success=code == 0, mode=mode, commands=commands)
            if code == 0 and args.profile_on_success:
                log.print(f"=== {mode} {' '.join(commands)} (profiling) ===")
                concurrency_app.run(
                    app_parser.parse_args(argv + ["--enable_profiling"]))
    _, bad = log.summary()
    return 0 if bad == 0 else 1


def main(argv=None) -> int:
    # one registry for the whole sweep: the sub-runs go through
    # concurrency_app.run in-process, so their spans and gauges land in
    # the sweep's one closing kind=metrics snapshot
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
