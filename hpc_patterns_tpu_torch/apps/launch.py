"""Process launcher: the ``mpirun -np N`` analog (SURVEY.md §4, C11) —
the counterpart of ``hpc_patterns_tpu/apps/launch.py``.

The reference registers every miniapp as ``mpirun -np 4 ./app`` under
CTest (aurora.mpich.miniapps/src/CMakeLists.txt:39-50). Here the same
role is played by N local processes joined through ``torch.distributed``
on gloo: each child gets a shared coordinator address plus its process
id via the ``HPCPAT_*`` env protocol (topology.init_distributed_from_env
— the MPI_Init analog), and ``--cpu-devices-per-proc`` K (the JAX flag's
name, kept) logical ranks to hold (``HPCPAT_LOCAL_RANKS``), so an ``-np
2`` launch of the allreduce miniapp is a real 4-rank SPMD run across two
OS processes — cross-process collectives, cross-process MAX timing and
per-process validation run for real. On one card both processes share
it; their collectives cross over gloo through host memory (NCCL refuses
two ranks on one device), and each app prints a line saying so.

This module is host code: it imports no torch (its children do).

Usage:
    python -m hpc_patterns_tpu_torch.apps.launch -np 2 -- \
        python -m hpc_patterns_tpu_torch.apps.allreduce_app -p 10

Exit 0 iff every rank exits 0 (the ctest contract); per-rank output is
echoed with a ``[r]`` prefix and a grep-able summary line closes the
run (run.sh:17-18 style). On timeout the hung ranks are named with
each one's last output line (what a deadlocked-collective debug needs
first: which rank never arrived).

Distributed flight recorder (``--trace-out merged.json``): the
launcher exports ``HPCPAT_TRACE_DIR``, every child run with
``--trace`` hands off its per-rank recorder snapshot there, and at
exit — clean, failed, or timed out — the launcher merges whatever rank
files exist into one clock-aligned Perfetto timeline with cross-rank
skew/straggler rollups (harness/collect.py, rung 4 of the
observability ladder; docs/observability.md).

Chaos runs (round 8): ``--chaos SPEC`` exports ``HPCPAT_CHAOS`` so
every child runs under the seeded fault injectors (harness/chaos.py —
straggler rank, stalled host, mid-stream worker death). A rank that
exits nonzero — killed included — lands in the rank report with its
FAULT KIND, last output line, and last collective fingerprint, and the
surviving ranks' trace files still merge (the ``trace_merged`` record
carries ``faults``). ``--retry N --retry-backoff S`` relaunches a
failed run with doubling backoff — bounded retry for transient and
injected faults.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from hpc_patterns_tpu_torch import topology


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-np", "--num-processes", type=int, default=2,
                   help="processes to launch (mpirun -np)")
    p.add_argument("--cpu-devices-per-proc", type=int, default=2,
                   help="logical ranks each process holds "
                        "(HPCPAT_LOCAL_RANKS; the JAX launcher's flag "
                        "name, where it counts virtual CPU devices)")
    p.add_argument("--slices", type=int, default=0,
                   help="treat the processes as this many equal slices "
                        "(sets HPCPAT_SLICE_GROUPING, which stamps each "
                        "rank's trace with its slice); 0 = no slice "
                        "override")
    p.add_argument("--port", type=int, default=0,
                   help="coordinator port (0 = pick a free one)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-run timeout in seconds")
    p.add_argument("--retry", type=int, default=0,
                   help="relaunch a failed run (nonzero/killed rank or "
                        "timeout) up to N more times with backoff — "
                        "bounded retry for chaos runs where a worker "
                        "death is an injected or transient fault")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   help="seconds to wait before the first retry "
                        "(doubles per attempt)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="export HPCPAT_CHAOS=SPEC to every child — the "
                        "seeded fault injectors of harness/chaos.py "
                        "(e.g. 'straggler:rank=1,delay_ms=40' or "
                        "'die:rank=1,at=5'); the rank report records "
                        "the fault kind and partial trace sets still "
                        "merge")
    p.add_argument("--trace-out", default=None, metavar="MERGED.json",
                   help="distributed flight recorder: export the "
                        "launcher env (HPCPAT_TRACE_DIR) so every "
                        "child run with --trace hands off its per-rank "
                        "snapshot, then collect, clock-align, and "
                        "merge them into this Perfetto JSON (one pid "
                        "lane per rank, flow arrows per collective) "
                        "and print the skew/straggler rollup "
                        "(harness/collect.py)")
    p.add_argument("--trace-dir", default=None,
                   help="keep the per-rank trace files here instead of "
                        "a temporary directory (implies they survive "
                        "the run; default: tmpdir, removed on success)")
    p.add_argument("--log", default=None,
                   help="append launcher records (kind=trace_merged "
                        "under --trace-out) to this runlog JSONL; "
                        "default: <trace-out>.rollup.jsonl")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to launch, after --")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(base: dict, coord: str, nprocs: int, pid: int,
               cpu_devices: int, slices: int = 0) -> dict:
    env = topology.worker_env(base, cpu_devices, nprocs)
    env[topology.ENV_COORDINATOR] = coord
    env[topology.ENV_NUM_PROCESSES] = str(nprocs)
    env[topology.ENV_PROCESS_ID] = str(pid)
    if slices:
        # contiguous equal groups of processes per slice; the SAME value
        # goes to every child so each computes the identical grouping
        mapping = ",".join(str(q * slices // nprocs) for q in range(nprocs))
        env[topology.ENV_SLICE_GROUPING] = "process:" + mapping
    # children must resolve `-m hpc_patterns_tpu_torch...` regardless of
    # cwd
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = env.get("PYTHONPATH", "")
    if pkg_root not in paths.split(os.pathsep):
        env["PYTHONPATH"] = (
            f"{pkg_root}{os.pathsep}{paths}" if paths else pkg_root
        )
    return env


_pump = topology.pump_lines


class _LastLineTee:
    """Stdout sink that remembers the most recent non-empty line per
    rank, so the timeout path can say WHAT each hung rank last printed
    (a rank stuck compiling vs. stuck in a collective read very
    differently) without re-parsing the interleaved launcher output."""

    def __init__(self, sink, store: dict, pid: int):
        self._sink, self._store, self._pid = sink, store, pid

    def write(self, text: str) -> None:
        self._sink.write(text)
        stripped = text.strip()
        if stripped:
            self._store[self._pid] = stripped

    def flush(self) -> None:
        self._sink.flush()


def _read_sched_progress(trace_dir: str) -> dict[int, dict]:
    """Per-rank collective-fingerprint progress files
    (``rank<id>.sched.json``, written by
    ``harness.trace.record_collective`` on EVERY collective): the
    hang forensics. A rank stuck inside a collective never reaches its
    trace-snapshot handoff, but the fingerprint of the collective it
    entered is already on disk — so a timeout report can say which
    collective each rank is at instead of just that it hung."""
    out: dict[int, dict] = {}
    for f in sorted(Path(trace_dir).glob("rank*.sched.json")):
        try:
            rec = json.loads(f.read_text())
            out[int(rec["process_id"])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def _fault_kind(code: int | None) -> str:
    """One rank's exit classified for the rank report: ``clean``,
    ``exit N`` (error), ``killed (SIGNAME)`` (a negative returncode —
    the mid-stream worker-death shape: SIGKILLed, OOMed, preempted),
    or ``timeout`` (never exited)."""
    if code is None:
        return "timeout"
    if code == 0:
        return "clean"
    if code < 0:
        import signal

        try:
            return f"killed ({signal.Signals(-code).name})"
        except ValueError:
            return f"killed (signal {-code})"
    return f"exit {code}"


def _harvest_traces(trace_dir: str, out: str, log: str | None,
                    nprocs: int, faults: dict | None = None) -> None:
    """Collect whatever per-rank trace files exist under ``trace_dir``
    (ALL of them after a clean run; any partial set after a timeout or
    a killed worker — the surviving ranks are still debuggable), merge
    them clock-aligned into ``out``, print the skew/straggler rollup,
    and append the ``kind=trace_merged`` record to ``log``.
    ``faults``: the per-rank fault kinds of a failed run — recorded on
    the rollup so the merged record says WHY a lane is missing."""
    from hpc_patterns_tpu_torch.harness import collect as collectlib
    from hpc_patterns_tpu_torch.harness.runlog import RunLog

    files = sorted(Path(trace_dir).glob("rank*.trace.json"))
    if not files:
        print(f"trace: no per-rank snapshots under {trace_dir} — did "
              "the launched command include --trace?")
        return
    if len(files) < nprocs:
        have = ", ".join(f.name for f in files)
        print(f"trace: only {len(files)}/{nprocs} rank snapshot(s) "
              f"harvested ({have}) — merging what exists")
    rollup = collectlib.collect_to_file(files, out)
    if rollup is None:
        print(f"trace: rank files under {trace_dir} held no snapshots")
        return
    if faults:
        rollup["faults"] = {str(r): k for r, k in sorted(faults.items())}
    print(collectlib.format_rollup(rollup))
    print(f"merged trace: {out} (open in Perfetto / chrome://tracing)")
    log = log or f"{out}.rollup.jsonl"
    RunLog(log, truncate=False).emit(kind="trace_merged", **rollup)


def _attempt(cmd, base_env, nprocs, args, trace_dir) -> tuple[
        list, bool, dict]:
    """One launch attempt: spawn the ranks, wait them out, print the
    timeout forensics when they hang. Returns ``(codes, timed_out,
    last_lines)`` where ``codes[pid]`` is None for a rank that never
    exited (killed after the timeout)."""
    coord = f"127.0.0.1:{args.port or _free_port()}"
    procs, pumps = [], []
    last_lines: dict[int, str] = {}
    for pid in range(nprocs):
        proc = subprocess.Popen(
            cmd,
            env=_child_env(base_env, coord, nprocs, pid,
                           args.cpu_devices_per_proc, args.slices),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        t = threading.Thread(
            target=_pump,
            args=(f"[{pid}] ", proc.stdout,
                  _LastLineTee(sys.stdout, last_lines, pid)),
            daemon=True,
        )
        t.start()
        procs.append(proc)
        pumps.append(t)

    timed_out = False
    stuck: list[int] = []
    deadline = time.monotonic() + args.timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
        # name the hung ranks BEFORE killing them: rank id + the last
        # line each printed is the first thing a debugger wants from a
        # deadlocked collective (which rank never arrived?)
        stuck = [pid for pid, proc in enumerate(procs)
                 if proc.poll() is None]
        for proc in procs:
            proc.kill()
        for proc in procs:
            # reap the kills: un-waited children stay zombies for the
            # launcher's lifetime, and --retry would stack nprocs more
            # per timed-out attempt
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        print(f"FAILURE: timeout after {args.timeout}s — "
              f"{len(stuck)}/{nprocs} rank(s) had not exited:")
        fps = _read_sched_progress(trace_dir) if trace_dir else {}
        for pid in stuck:
            last = last_lines.get(pid, "<no output>")
            print(f"  rank {pid}: last output: {last}")
            e = fps.get(pid)
            if e:
                # the collective-schedule fingerprint: a hang now reads
                # as "rank 2 is at allreduce#17, rank 0 at
                # sendrecv_ring#17" instead of a dead tunnel
                print(f"  rank {pid}: is at {e['last']['op']}"
                      f"#{e['last']['seq']} ({e['n']} collective(s) "
                      f"issued, digest {e['digest']})")
        for pid, e in sorted(fps.items()):
            if pid not in stuck:
                print(f"  rank {pid} (exited): was at "
                      f"{e['last']['op']}#{e['last']['seq']} "
                      f"({e['n']} issued)")
    finally:
        for t in pumps:
            t.join(timeout=5)
    codes = [proc.poll() for proc in procs]
    if timed_out:
        # a killed-on-timeout rank reports None ("timeout"), not the
        # SIGKILL code of the launcher's OWN kill — by the time poll()
        # runs, the kill has been reaped and returncode reads -9, the
        # chaos worker-death signature; membership in the pre-kill
        # stuck list is what distinguishes a hang from a death
        codes = [None if pid in stuck else c
                 for pid, c in enumerate(codes)]
    return codes, timed_out, last_lines


def run(args) -> int:
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("ERROR: no command given (put it after --)")
        return 2
    nprocs = args.num_processes
    if nprocs < 1:
        print("ERROR: -np must be >= 1")
        return 2
    if args.slices and nprocs % args.slices:
        print(f"ERROR: -np {nprocs} must divide by --slices {args.slices}")
        return 2
    if args.chaos:
        # validate NOW: a typo'd chaos spec injecting nothing would
        # fake a healthy run out of a chaos scenario
        from hpc_patterns_tpu_torch.harness import chaos as chaoslib

        try:
            chaoslib.parse(args.chaos)
        except ValueError as e:
            print(f"ERROR: bad --chaos spec: {e}")
            return 2
    # distributed-trace handoff: children see HPCPAT_TRACE_DIR and (if
    # run with --trace) write rank<id>.trace.json there at exit; the
    # path is absolute because children may chdir. Without --trace-out
    # nothing is exported and the launch is byte-identical to before.
    trace_dir = made_trace_dir = None
    if args.trace_out:
        if args.trace_dir:
            trace_dir = os.path.abspath(args.trace_dir)
            os.makedirs(trace_dir, exist_ok=True)
        else:
            trace_dir = made_trace_dir = tempfile.mkdtemp(
                prefix="hpcpat_trace_")
    elif args.trace_dir or args.log:
        print("note: --trace-dir/--log do nothing without --trace-out "
              "(the distributed-trace pipeline is off)")
    base_env = dict(os.environ)
    if trace_dir:
        base_env[topology.ENV_TRACE_DIR] = trace_dir
    if args.chaos:
        from hpc_patterns_tpu_torch.harness import chaos as chaoslib

        base_env[chaoslib.ENV_CHAOS] = args.chaos
    attempts = max(0, args.retry) + 1
    backoff = max(0.0, args.retry_backoff)
    ok = False
    faults: dict[int, str] = {}
    try:
        for attempt in range(attempts):
            if attempt:
                print(f"retrying launch (attempt {attempt + 1}/"
                      f"{attempts}) after {backoff:.1f}s backoff")
                time.sleep(backoff)
                backoff *= 2
            if trace_dir:
                # each attempt starts clean: a prior run's (or failed
                # attempt's) rank files must not stand in for ranks
                # that crashed before writing, nor its collective
                # fingerprints leak into this attempt's hang report
                for pattern in ("rank*.trace.json", "rank*.sched.json"):
                    for stale in Path(trace_dir).glob(pattern):
                        stale.unlink()
            codes, timed_out, last_lines = _attempt(
                cmd, base_env, nprocs, args, trace_dir)
            faults = {pid: _fault_kind(c) for pid, c in enumerate(codes)}
            ok = not timed_out and all(c == 0 for c in codes)
            if timed_out:
                continue
            print(f"launch -np {nprocs}: exit codes {codes}")
            if not ok:
                # the rank report, fault-kind edition: a worker that
                # DIED mid-stream (negative returncode — SIGKILLed,
                # OOMed, chaos-injected death) is named with what
                # killed it, its last output, and the collective it
                # was at (the same forensics the timeout path prints)
                fps = (_read_sched_progress(trace_dir)
                       if trace_dir else {})
                for pid, c in enumerate(codes):
                    if c == 0:
                        continue
                    last = last_lines.get(pid, "<no output>")
                    print(f"  rank {pid}: fault: {faults[pid]} — "
                          f"last output: {last}")
                    e = fps.get(pid)
                    if e:
                        print(f"  rank {pid}: was at {e['last']['op']}"
                              f"#{e['last']['seq']} ({e['n']} "
                              f"collective(s) issued)")
            print("SUCCESS" if ok else "FAILURE")
            if ok:
                break
    finally:
        if trace_dir:
            # harvest even after a timeout or a killed worker: ranks
            # that finished (or crashed cleanly) already wrote their
            # snapshots — the partial set is the surviving evidence
            try:
                _harvest_traces(trace_dir, args.trace_out, args.log,
                                nprocs,
                                faults=None if ok else faults)
            finally:
                if made_trace_dir and ok:
                    shutil.rmtree(made_trace_dir, ignore_errors=True)
                elif made_trace_dir:
                    print(f"per-rank trace files kept: {made_trace_dir}")
    return 0 if ok else 1


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
