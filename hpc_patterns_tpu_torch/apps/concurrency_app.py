"""Concurrency benchmark app — the counterpart of
``hpc_patterns_tpu/apps/concurrency_app.py`` (the reference's
``sycl_con`` / ``omp_con``).

Measures whether independent device commands (compute ``C``, host ->
device ``M2D``, device -> host ``D2M``) overlap, as the reference does
(sycl_con.cpp:163-297):

- positional mode + command list CLI (:184-232), with the reference's
  mode names accepted as aliases (``out_of_order``/``in_order`` ->
  ``async``, ``host_threads`` -> ``threads``, omp_con's ``nowait``);
- ``-1`` = autotune sentinels for sizes/tripcount (:179-232);
- serial baseline -> theoretical max speedup -> concurrent run ->
  verdict (:274-296), with the SYCL speedup rule or the OMP absolute
  rule (omp_con.cpp:238-244) via ``--rule``;
- ``--engine dispatch`` runs the commands on their own CUDA streams
  (pinned host buffers); ``--engine onchip`` runs the whole experiment
  inside one kernel (``concurrency/pipeline.py``); ``auto`` picks onchip
  on a card for a listed pair with mode serial/async and one queue;
- ``--enable_profiling`` wraps the concurrent run in ``torch.profiler``.

    python -m hpc_patterns_tpu_torch.apps.concurrency_app async C M2D
    python -m hpc_patterns_tpu_torch.apps.concurrency_app async C M2D \\
        --engine dispatch --device cpu --tripcount 2 --copy-elements 1024
"""

from __future__ import annotations

import sys

import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.concurrency import autotune, engine
from hpc_patterns_tpu_torch.concurrency import commands as cmds
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness.cli import AUTO, base_parser
from hpc_patterns_tpu_torch.harness.profiling import maybe_trace
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.verdict import concurrency_verdict
from hpc_patterns_tpu_torch.topology import resolve_device

DEFAULT_COPY_ELEMENTS = 1 << 22  # 16 MiB float32


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="async",
                   help="dispatch mode: serial | async | threads (aliases: "
                        "out_of_order, in_order, nowait, host_threads)")
    p.add_argument("commands", nargs="*", default=["C", "M2D"],
                   help="command list, e.g. C M2D (default) — sycl_con.cpp "
                        "positional list")
    p.add_argument("--tripcount", type=int, default=AUTO,
                   help="compute trips; -1 = autotune to mean copy time")
    p.add_argument("--copy-elements", type=int, default=AUTO,
                   help="copy size in float32 elements; -1 = default + "
                        "balance")
    p.add_argument("--compute-elements", type=int, default=8 * 128,
                   help="compute buffer elements")
    p.add_argument("--n-queues", type=int, default=1,
                   help="cards to round-robin commands over (queue pool "
                        "analog)")
    p.add_argument("--rule", default="sycl", choices=["sycl", "omp"],
                   help="verdict rule: sycl speedup (sycl_con) or omp "
                        "absolute (omp_con)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "dispatch", "onchip"],
                   help="overlap mechanism: 'dispatch' runs each command on "
                        "its own CUDA stream; 'onchip' runs the whole "
                        "experiment inside one kernel (TMA copies vs the "
                        "FMA chain); 'auto' picks onchip on a card "
                        "(n_queues<=1, supported pair)")
    p.add_argument("--target-s", type=float, default=1.0,
                   help="onchip engine: device seconds each per-pass "
                        "measurement aims at")
    p.add_argument("--enable_profiling", action="store_true",
                   help="torch.profiler trace around the concurrent run")
    p.add_argument("--trace-dir", default=None, help="profiler output dir")
    return p


def _devices(args) -> list[torch.device]:
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.n_queues > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def build_commands(args, devices) -> tuple[list[cmds.Command], dict]:
    kinds = [k.upper() for k in args.commands]
    for k in kinds:
        if k not in ("C", "M2D", "D2M"):
            raise SystemExit(f"unknown command {k!r} (want C, M2D, or D2M)")

    m2d_elems = d2m_elems = (DEFAULT_COPY_ELEMENTS
                             if args.copy_elements == AUTO
                             else args.copy_elements)
    tune_info = {}
    if args.copy_elements == AUTO and "M2D" in kinds and "D2M" in kinds:
        m2d_elems, d2m_elems, info = autotune.balance_copy_sizes(
            m2d_elems, d2m_elems, devices[0])
        tune_info["balance"] = info

    tripcount = args.tripcount
    if tripcount == AUTO and "C" in kinds:
        copy_cmds = []
        if "M2D" in kinds:
            copy_cmds.append(cmds.CopyM2DCommand(m2d_elems, devices[0]))
        if "D2M" in kinds:
            copy_cmds.append(cmds.CopyD2MCommand(d2m_elems, devices[0]))
        if copy_cmds:
            tripcount, info = autotune.tune_tripcount_to_copies(
                copy_cmds, compute_elements=args.compute_elements,
                device=devices[0])
            tune_info["tripcount"] = info
        else:
            tripcount = 1000
    elif tripcount == AUTO:
        tripcount = 1000

    built = []
    for i, k in enumerate(kinds):
        dev = devices[i % max(1, args.n_queues) % len(devices)]
        if k == "C":
            built.append(cmds.ComputeCommand(args.compute_elements, tripcount,
                                             dev))
        elif k == "M2D":
            built.append(cmds.CopyM2DCommand(m2d_elems, dev))
        else:
            built.append(cmds.CopyD2MCommand(d2m_elems, dev))
    return built, tune_info


# on-card engine: command pair -> ((command, baseline mode) per command,
# serial mode, overlap mode). Resources: C occupies the SMs, copies share
# the memory bandwidth — the verdict floor is resource-aware.
_ONCHIP_PAIRS = {
    ("C", "M2D"): (
        (("M2D", "dma"), ("C", "compute")), "serial", "overlap"),
    ("C", "D2M"): (
        (("D2M", "dma_out"), ("C", "compute")), "serial_out", "overlap_out"),
    ("D2M", "M2D"): (
        (("M2D", "dma"), ("D2M", "dma_out")), "pair_serial", "pair_overlap"),
    ("C", "C"): (
        (("C", "compute"), ("C", "compute")), "compute2", "compute2"),
}
_RESOURCE = {"C": "core", "M2D": "hbm", "D2M": "hbm"}
_ONCHIP_CHUNKS = 16


def _record_overlap_metrics(engine_name, names, serial_s, concurrent_s,
                            verdict) -> None:
    """Overlap outcome gauges (no-op when --metrics is off): the serial /
    concurrent pair and the achieved speedup, keyed by ``<engine>.<mode>``
    and the command pair, so a sweep over modes keeps the whole matrix."""
    m = metricslib.get_metrics()
    if not m.enabled:
        return
    pair = "+".join(names)
    m.gauge(f"concurrency.{engine_name}.{pair}.serial_s").set(serial_s)
    m.gauge(f"concurrency.{engine_name}.{pair}.concurrent_s").set(
        concurrent_s)
    if verdict.speedup is not None:
        m.gauge(f"concurrency.{engine_name}.{pair}.speedup").set(
            verdict.speedup)


def _onchip_supported(args, mode, device) -> bool:
    kinds = tuple(sorted(k.upper() for k in args.commands))
    return (kinds in _ONCHIP_PAIRS and mode in ("serial", "async")
            and args.n_queues <= 1 and device.type == "cuda")


def run_onchip(args, log, mode, device) -> int:
    """The experiment as ONE kernel: the copy commands are global <->
    shared bulk copies, the compute command is the FMA chain, and overlap
    is double buffering inside the kernel."""
    from hpc_patterns_tpu_torch.concurrency import pipeline

    kinds = tuple(sorted(k.upper() for k in args.commands))
    baselines, serial_mode, overlap_mode = _ONCHIP_PAIRS[kinds]
    (name_a, base_a), (name_b, base_b) = baselines
    names = [name_a, name_b]

    elems = (_ONCHIP_CHUNKS * 2048 * 128 if args.copy_elements == AUTO
             else args.copy_elements)
    rows = max(8, (elems // (_ONCHIP_CHUNKS * 128) + 7) // 8 * 8)
    x = pipeline.make_hbm_array(_ONCHIP_CHUNKS, rows, device=device)

    def per_pass(m, t):
        return pipeline.per_pass_seconds(x, m, t, repetitions=5,
                                         target_s=args.target_s)

    # balance: tripcount so the chain matches the copy baseline
    # (pipeline.balance_tripcount); pure-copy and pure-compute pairs skip it
    trips = args.tripcount if args.tripcount != AUTO else 64
    t_a = per_pass(base_a, trips)
    t_b = per_pass(base_b, trips)
    if args.tripcount == AUTO and "C" in kinds and base_a != base_b:
        trips, t_b = pipeline.balance_tripcount(per_pass, t_a, base_b, trips)
        log.emit(kind="autotune", which="onchip_tripcount", tripcount=trips,
                 t_copy_us=t_a * 1e6, t_compute_us=t_b * 1e6)
        log.print(f"autotune[onchip_tripcount]: trips={trips} "
                  f"copy {t_a * 1e6:.2f} us vs compute {t_b * 1e6:.2f} us")

    per_times = [t_a, t_b]
    for name, t in zip(names, per_times):
        log.print(f"serial {name}: {t * 1e6:.3f} us/pass")

    if mode == "serial":
        log.emit(kind="result", name="concurrency[onchip:serial]",
                 success=True, commands=names,
                 per_command_us=[t * 1e6 for t in per_times])
        log.print("SUCCESS")
        return 0

    # C C maps serial_mode == overlap_mode == "compute2": two chains on
    # the same SMs at the baselines' per-chain tripcount, speedup ~1.0
    # against the resource floor
    t_serial = per_pass(serial_mode, trips)
    t_concurrent = (t_serial if overlap_mode == serial_mode
                    else per_pass(overlap_mode, trips))
    log.print(f"measured serial total: {t_serial * 1e6:.3f} us/pass")

    with maybe_trace(args.enable_profiling, args.trace_dir) as trace_dir:
        if trace_dir:
            # one traced run so the profiler artifact shows the kernel
            pipeline.overlap_run(x, mode=overlap_mode, tripcount=trips,
                                 passes=100).cpu()
    if trace_dir:
        log.print(f"profiler trace: {trace_dir}")

    resources = [_RESOURCE[k] for k in names]
    verdict = concurrency_verdict(per_times, t_concurrent, rule=args.rule,
                                  resources=resources)
    _record_overlap_metrics(f"onchip.{mode}", names, t_serial, t_concurrent,
                            verdict)
    log.result(
        f"concurrency[onchip:{'+'.join(names)}]", verdict,
        commands=names, mode=mode, engine="onchip", rule=args.rule,
        resources=resources, tripcount=trips, serial_us=t_serial * 1e6,
        concurrent_us=t_concurrent * 1e6,
        per_command_us=[t * 1e6 for t in per_times])
    return verdict.exit_code


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    mode = engine.canonical_mode(args.mode)
    devices = _devices(args)
    if args.engine == "onchip" or (
            args.engine == "auto"
            and _onchip_supported(args, mode, devices[0])):
        if not _onchip_supported(args, mode, devices[0]):
            log.print("ERROR: --engine onchip needs a CUDA device, mode "
                      "serial/async (aliases included), n_queues<=1, and a "
                      f"supported command pair {sorted(_ONCHIP_PAIRS)}")
            log.print("FAILURE")
            return 1
        return run_onchip(args, log, mode, devices[0])
    command_list, tune_info = build_commands(args, devices)
    names = [c.name for c in command_list]
    for key, info in tune_info.items():
        log.emit(kind="autotune", which=key, **info)
        log.print(f"autotune[{key}]: {info}")

    serial = engine.bench("serial", command_list,
                          repetitions=args.repetitions, warmup=args.warmup)
    per_times = [t.min_s for t in serial.per_command]
    for name, t in zip(names, per_times):
        log.print(f"serial {name}: {t * 1e3:.3f} ms")
    log.print(f"best serial total: {serial.best_serial_total_s * 1e3:.3f} ms")

    if mode == "serial":
        log.emit(kind="result", name="concurrency[serial]", success=True,
                 commands=names, per_command_ms=[t * 1e3 for t in per_times])
        log.print("SUCCESS")
        return 0

    with maybe_trace(args.enable_profiling, args.trace_dir) as trace_dir:
        concurrent = engine.bench(mode, command_list,
                                  repetitions=args.repetitions,
                                  warmup=args.warmup)
    if trace_dir:
        log.print(f"profiler trace: {trace_dir}")

    verdict = concurrency_verdict(per_times, concurrent.total.min_s,
                                  rule=args.rule)
    _record_overlap_metrics(f"dispatch.{mode}", names,
                            serial.best_serial_total_s,
                            concurrent.total.min_s, verdict)
    log.result(
        f"concurrency[{mode}:{'+'.join(names)}]", verdict,
        commands=names, mode=mode, engine="dispatch", rule=args.rule,
        serial_total_ms=serial.best_serial_total_s * 1e3,
        concurrent_total_ms=concurrent.total.min_s * 1e3,
        per_command_ms=[t * 1e3 for t in per_times], trace_dir=trace_dir)
    return verdict.exit_code


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
