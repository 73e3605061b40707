"""torchlint CLI: ``python -m hpc_patterns_tpu_torch.analysis [paths] [--ci]``.

With no paths, analyzes the ``hpc_patterns_tpu_torch`` package — its
Python and its ``csrc/`` — the tree CI gates on. ``--ci`` exits 1 on
any unsuppressed, unbaselined finding (0 on a clean tree); the default
mode always exits 0 and just reports. A bad ``--select`` or an
unreadable baseline exits 2.

``--log FILE`` appends the verdict as a ``kind=analysis`` RunLog record
(rule counts, suppression count, the shared-memory rollup) to a JSONL
log, where ``python -m hpc_patterns_tpu_torch.harness.report`` shows it
next to the metrics and trace rollups.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from hpc_patterns_tpu_torch.analysis.core import (
    AnalysisConfig,
    load_baseline,
    registered_rules,
    run_paths,
    write_baseline,
)

_PACKAGE_ROOT = Path(__file__).resolve().parents[1]

#: --list-rules order: Python-level, SPMD, in-kernel, cross-module
FAMILIES = ("torchlint", "shardlint", "cudalint", "contractlint")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hpc_patterns_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    p.add_argument(
        "paths", nargs="*",
        help=f"files/directories to analyze (default: {_PACKAGE_ROOT})")
    p.add_argument(
        "--ci", action="store_true",
        help="exit 1 on any unsuppressed finding (the gate mode)")
    p.add_argument(
        "--select", action="append", metavar="RULE",
        help="run only these rules (repeatable)")
    p.add_argument(
        "--baseline", metavar="FILE",
        help="tolerate findings recorded in this baseline JSON")
    p.add_argument(
        "--write-baseline", metavar="FILE",
        help="write current findings as a baseline and exit 0 "
             "(adoption escape hatch; repo policy is fix-or-suppress)")
    p.add_argument(
        "--log", metavar="FILE",
        help="append the verdict as a kind=analysis RunLog record")
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    p.add_argument(
        "--smem-report", action="store_true",
        help="print the per-kernel shared-memory table (every kernel "
             "instantiation in csrc/: static __shared__ plus the "
             "launcher's dynamic bytes; analysis/smem.py)")
    p.add_argument(
        "--contract-report", action="store_true",
        help="print the whole-tree producer/consumer tables the "
             "contractlint rules judge (analysis/contracts.py)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        rules = registered_rules()
        families = list(FAMILIES) + sorted(
            {r.family for r in rules.values()} - set(FAMILIES))
        for family in families:
            members = sorted((name, rule) for name, rule
                             in rules.items() if rule.family == family)
            if not members:
                continue
            print(f"{family}:")
            for name, rule in members:
                print(f"  {name:<26} {rule.summary}")
        return 0
    paths = args.paths or [_PACKAGE_ROOT]
    if args.select:
        # a typo'd --select would run ZERO rules and read as a clean tree
        unknown = sorted(set(args.select) - set(registered_rules()))
        if unknown:
            print(f"ERROR: unknown rule(s) in --select: "
                  f"{', '.join(unknown)}; registered: "
                  f"{', '.join(sorted(registered_rules()))}",
                  file=sys.stderr)
            return 2
    config = AnalysisConfig(
        select=frozenset(args.select) if args.select else None)
    baseline = None
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"ERROR: unreadable baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
    t0 = time.perf_counter()
    try:
        report = run_paths(paths, config, baseline)
    except OSError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    seconds = time.perf_counter() - t0
    if report.n_files == 0:
        print("ERROR: no source files under "
              + ", ".join(map(str, paths)), file=sys.stderr)
        return 2
    if args.write_baseline:
        write_baseline(args.write_baseline, report.findings)
        print(f"torchlint: baselined {len(report.findings)} finding(s) "
              f"-> {args.write_baseline}")
        return 0
    smem_stats = None
    if args.smem_report or args.log:
        # the estimator is cheap (a tokenizer pass); computing it with
        # every log keeps the kind=analysis record's smem section present
        from hpc_patterns_tpu_torch.analysis import smem

        estimates = smem.estimate_paths(paths)
        smem_stats = smem.smem_summary(estimates)
        if args.smem_report:
            print(smem.format_smem_table(estimates, root=_PACKAGE_ROOT))
    if args.contract_report:
        from hpc_patterns_tpu_torch.analysis import contracts

        print(contracts.format_contract_report(
            contracts.tables_for_paths(paths)))
    for f in report.findings:
        print(f.format())
    counts = report.by_rule()
    by_rule = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(
        f"torchlint: {len(report.findings)} finding(s)"
        + (f" [{by_rule}]" if counts else "")
        + f", {len(report.suppressed)} suppressed"
        + (f", {len(report.baselined)} baselined"
           if report.baselined else "")
        + f" across {report.n_files} file(s) in {seconds:.2f} s"
    )
    if args.log:
        from hpc_patterns_tpu_torch.harness.runlog import RunLog

        log = RunLog(args.log, truncate=False)
        log.emit(
            kind="analysis",
            tool="torchlint",
            ok=report.ok,
            findings=len(report.findings),
            suppressed=len(report.suppressed),
            baselined=len(report.baselined),
            files=report.n_files,
            seconds=seconds,
            by_rule=counts,
            smem=smem_stats,
        )
    if args.ci and report.findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
