"""Serving-plane app: a router + N engine replicas under the launcher — the
counterpart of ``hpc_patterns_tpu/apps/plane_app.py``.

The launched tier of the disaggregated serving plane
(``hpc_patterns_tpu_torch/serving_plane/``): ``apps/launch.py -np K``
starts K processes of this app; rank 0 becomes the ROUTER, ranks 1..K-1
become REPLICAS (roles from ``--roles``, e.g. ``prefill,decode`` for the
disaggregated 1p/1d shape). Replicas publish ephemeral localhost ports
under ``--rdv`` (the hostfile analog), the router connects, admits a
seeded open-loop loadgen stream across them, forwards KV handoffs from
prefill- to decode-role replicas, and prints the SLO table with GOODPUT
next to raw tok/s plus a grep-able summary line.

Two engine tiers behind one protocol:

- ``--stub``: deterministic torch-free token generators (byte-equal to
  the JAX package's) — the plane's ROUTER mechanics (placement, migration
  forwarding, replica-death recovery, shed accounting) in milliseconds;
  the router byte-checks every served stream against the stub's pure
  function, so even the failure drills are oracle-checked;
- real engines (default): each replica builds the model of the model
  flags from ONE seeded generator on its device (identical weights and
  ``request_key`` on every replica: a request's tokens must not depend
  on its placement) and serves through
  :class:`~hpc_patterns_tpu_torch.models.serving.EngineCore` on
  ``--device`` (default ``cuda``).

Port-side differences: the model flags (``--vocab``, ``--d-model``,
``--n-heads``, ``--n-layers``, ``--d-ff``, ``--dtype``,
``--decode-attn``; JAX hard-codes their defaults), ``--device``, a
default ladder that covers prompt + budget (so a death-resume re-admits)
with rungs of multiples of 128 on the flash route (every prefill through
the flash prefill kernel), and sampled keys that do not advance (``serving_plane/service.py``). A
real replica's last line is a JSON object of its engine's admissions,
decode steps and prefill rungs beside kernel 1's and kernel 6's launches.

Chaos composes through the launcher: ``--chaos
'die:replica=2,at=5,site=replica_round'`` kills ONE replica of many
mid-stream; the router re-queues its in-flight requests as resumes on
survivors (or counts them shed — never a silent drop), and the rank
report names the lost replica with its fault kind. Under ``--trace`` +
``--trace-out``, both sides of every KV handoff record matched
``plane.kv_migration`` windows and ``kv_migration`` schedule
fingerprints, which the launcher's merge checks. ``--autofit CONFIG``
applies fitted placement on the router (``PlaneRouter.from_fitted``) and
the fitted ladder on real replicas.

Usage::

    python -m hpc_patterns_tpu_torch.apps.launch -np 3 -- \\
        python -m hpc_patterns_tpu_torch.apps.plane_app --stub \\
        --roles prefill,decode --rdv /tmp/rdv --requests 6 --device cpu
    python -m hpc_patterns_tpu_torch.apps.launch -np 3 -- \\
        python -m hpc_patterns_tpu_torch.apps.plane_app \\
        --roles prefill,decode --rdv /tmp/rdv --vocab 32768 \\
        --d-model 1024 --n-heads 8 --n-layers 8 --d-ff 4096 \\
        --dtype bfloat16 --decode-attn flash --page-size 256 \\
        --prompt-len 256 --budget 64 --plane-timeout 300
"""

from __future__ import annotations

import os
import sys
import time

from hpc_patterns_tpu_torch.harness.cli import (
    add_autofit_arg,
    add_explain_args,
    base_parser,
    explain_enabled,
)

#: JAX's replica model (``plane_app.py``'s TransformerConfig), the model
#: flags' defaults
REPLICA_MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     dtype="float32", decode_attn="gather")


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    add_autofit_arg(p)
    add_explain_args(p)
    p.add_argument("--rdv", required=True,
                   help="rendezvous directory replicas publish their "
                        "listen addresses under (shared by all ranks)")
    p.add_argument("--roles", default="both",
                   help="comma-separated replica roles for ranks 1..N "
                        "(both|prefill|decode; short lists repeat "
                        "their last entry): 'prefill,decode' is the "
                        "disaggregated 1p/1d shape")
    p.add_argument("--stub", action="store_true",
                   help="torch-free deterministic stub engines (router-"
                        "mechanics tier; tokens byte-checked against "
                        "the stub's pure function)")
    p.add_argument("--policy", default="least_loaded",
                   choices=["least_loaded", "round_robin"],
                   help="router placement policy")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--rate", type=float, default=200.0,
                   help="open-loop Poisson arrival rate (req/s)")
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--budget", type=int, default=12,
                   help="max new tokens per request")
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--pool-pages", type=int, default=0,
                   help="per-replica arena (0 = slots * pages/seq)")
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampled serving (> 0): real replicas sample "
                        "per-row keyed streams; stub replicas run the "
                        "keyed hash chain — either way the round "
                        "replies carry per-row key state, so a replica "
                        "death resumes SAMPLED streams byte-exact on "
                        "survivors")
    p.add_argument("--plane-timeout", type=float, default=120.0,
                   help="router drain deadline / replica idle timeout "
                        "(also the router's death detector: give a real "
                        "replica's first round on a card room)")
    g = p.add_argument_group("the real replicas' model (JAX's by default)")
    g.add_argument("--vocab", type=int, default=REPLICA_MODEL["vocab"])
    g.add_argument("--d-model", type=int, default=REPLICA_MODEL["d_model"])
    g.add_argument("--n-heads", type=int, default=REPLICA_MODEL["n_heads"])
    g.add_argument("--n-layers", type=int,
                   default=REPLICA_MODEL["n_layers"])
    g.add_argument("--d-ff", type=int, default=REPLICA_MODEL["d_ff"])
    g.add_argument("--dtype", default=REPLICA_MODEL["dtype"],
                   choices=["float32", "bfloat16"])
    g.add_argument("--decode-attn", default=REPLICA_MODEL["decode_attn"],
                   choices=["gather", "flash", "paged_flash"])
    return p


def _roles_for(nreplicas: int, spec: str) -> list[str]:
    roles = [r.strip() for r in spec.split(",") if r.strip()]
    if not roles:
        roles = ["both"]
    for r in roles:
        if r not in ("both", "prefill", "decode"):
            raise ValueError(f"bad role {r!r}")
    while len(roles) < nreplicas:
        roles.append(roles[-1])
    return roles[:nreplicas]


def _schedule(args):
    """The seeded open-loop stream: Poisson arrivals over two priority
    classes (harness/loadgen.py), prompt CONTENT from a separate seeded
    rng — deterministic end to end, so the stub oracle and a chaos replay
    both see the exact same traffic (JAX's stream, draw for draw)."""
    import numpy as np

    from hpc_patterns_tpu_torch.harness import loadgen

    classes = (
        loadgen.PriorityClass("interactive", 0, weight=0.5,
                              ttft_slo_s=30.0),
        loadgen.PriorityClass("batch", 1, weight=0.5),
    )
    sched = loadgen.make_schedule(
        args.requests, rate_rps=args.rate, classes=classes,
        prompt_lens=(max(1, args.prompt_len // 2), args.prompt_len),
        budgets=(max(1, args.budget // 2), args.budget),
        process="poisson", seed=args.seed)
    rng = np.random.RandomState(args.seed + 13)
    prompts = {r.index: [int(t) for t in rng.randint(0, 64,
                                                     size=r.prompt_len)]
               for r in sched.requests}
    arrivals = [
        (r.t_arrival_s, dict(prompt=prompts[r.index],
                             max_new=r.max_new,
                             priority=r.priority,
                             deadline_s=r.deadline_s))
        for r in sched.requests
    ]
    return sched, prompts, arrivals, classes


def replica_model(args, device):
    """``(cfg, params)`` of a real replica: the model flags' config and
    random weights from one seeded generator on ``device``'s own
    generator (the same on every replica, and for an oracle that rebuilds
    them)."""
    import torch

    from hpc_patterns_tpu_torch.dtypes import torch_dtype
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    cfg = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_seq=max(64, replica_ladder(args)[-1]),
        dtype=args.dtype, decode_attn=args.decode_attn)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, generator=gen, device=device,
                            dtype=torch_dtype(cfg.dtype))


def replica_ladder(args) -> tuple[int, ...]:
    """A real replica's default ladder. It covers prompt + budget, since a
    death-resume's prompt is the original plus what it emitted (JAX's
    covers the prompt only, and sheds such a resume as off the ladder);
    on the flash route its rungs are multiples of 128
    (``serving.prefill_ladder``)."""
    from hpc_patterns_tpu_torch.models.serving import prefill_ladder

    return prefill_ladder(args.prompt_len + args.budget, args.decode_attn)


def replica_engine_kw(args, ladder=None) -> dict:
    """The replica engine's geometry and sampling (JAX's); its pages
    cover ``ladder``'s top rung too when one is given."""
    span = max(args.prompt_len + args.budget, ladder[-1] if ladder else 0)
    pages_per_seq = -(-span // args.page_size)
    return dict(
        slots=args.slots, pool_pages=args.pool_pages
        or args.slots * pages_per_seq,
        pages_per_seq=pages_per_seq, page_size=args.page_size,
        chunk=args.chunk, temperature=args.temperature,
        top_k=8 if args.temperature > 0 else 0, seed=0)


def _run_router(args, nprocs: int) -> int:
    from hpc_patterns_tpu_torch.harness import slo as slolib
    from hpc_patterns_tpu_torch.harness.runlog import RunLog
    from hpc_patterns_tpu_torch.serving_plane import service

    sched, prompts, arrivals, classes = _schedule(args)
    handles = service.connect_replicas(
        args.rdv, range(1, nprocs), wait_s=args.plane_timeout,
        timeout_s=args.plane_timeout)
    print(f"router: {len(handles)} replica(s) connected "
          f"(roles {[h.role for h in handles]}, "
          f"policy {args.policy})", flush=True)
    emit = (RunLog(args.log, truncate=False).emit
            if args.log else None)
    if args.fitted is not None:
        # fitted placement (policy + per-replica weights) applies unless
        # the user picked a non-default --policy explicitly
        kw = ({"policy": args.policy}
              if args.policy != "least_loaded" else {})
        router = service.PlaneRouter.from_fitted(
            handles, args.fitted,
            slo_targets=slolib.targets_from_classes(classes),
            emit=emit, **kw)
        print(f"router: autofit placement from {args.autofit} "
              f"(policy {router.policy})", flush=True)
    else:
        router = service.PlaneRouter(
            handles, policy=args.policy,
            slo_targets=slolib.targets_from_classes(classes),
            emit=emit)
    if explain_enabled(args):
        # router-stamped request tracing: one recorder, one clock
        from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib

        reqtracelib.configure(enabled=True)
    report = router.run(arrivals, timeout_s=args.plane_timeout)

    ok = True
    if args.stub:
        # the stub oracle: every served stream equals the pure token
        # function of its ORIGINAL prompt, resumed rows included; sampled
        # mode walks the key chain from key_0
        for rid, toks in sorted(router.finished.items()):
            if router.stats[rid].get("outcome") != "ok":
                continue
            if args.temperature > 0:
                want = service.stub_sampled_stream(prompts[rid],
                                                   len(toks))
            else:
                want = [service.stub_token(prompts[rid], k)
                        for k in range(len(toks))]
            if list(toks) != want:
                print(f"ORACLE FAIL: rid {rid} tokens diverge "
                      f"(got {list(toks)[:6]}.., want {want[:6]}..)",
                      flush=True)
                ok = False
    for rid, rec in sorted(router.stats.items()):
        if rec.get("outcome") == "ok" \
                and rec["tokens"] != sched.requests[rid].max_new:
            print(f"ORACLE FAIL: rid {rid} served {rec['tokens']} "
                  f"!= budget {sched.requests[rid].max_new}",
                  flush=True)
            ok = False
    unresolved = [rid for rid, rec in router.stats.items()
                  if rec.get("outcome") is None]
    if unresolved:
        print(f"ORACLE FAIL: unresolved requests {unresolved}",
              flush=True)
        ok = False

    tot = report["slo"]["total"]
    print(slolib.format_slo(report["slo"]), flush=True)
    if explain_enabled(args):
        from hpc_patterns_tpu_torch.harness import explain as explainlib
        from hpc_patterns_tpu_torch.harness import reqtrace as reqtracelib

        rtr = reqtracelib.active()
        if rtr is not None:
            snap = rtr.snapshot(router.stats)
            if emit is not None:
                emit(kind="reqtrace", **snap)
            dig = explainlib.digest([snap])
            print(explainlib.format_explain(dig), flush=True)
            if args.explain_out:
                import json

                from pathlib import Path

                Path(args.explain_out).write_text(
                    json.dumps(dig) + "\n")
                print(f"explain digest -> {args.explain_out}",
                      flush=True)
    print(f"plane: served {report['served']}/{report['n']} "
          f"shed={report['shed']} deaths={report['deaths']} "
          f"resumed={report['resumed']} "
          f"migrations={report['migrations']} "
          f"goodput_tok_s={tot['goodput_tok_s']:.1f}", flush=True)
    print("PLANE SUCCESS" if ok else "PLANE FAILURE", flush=True)
    return 0 if ok else 1


def _run_replica(args, rank: int, role: str) -> int:
    from hpc_patterns_tpu_torch.harness import trace as tracelib
    from hpc_patterns_tpu_torch.serving_plane import service

    kw = replica_engine_kw(args)
    if args.stub:
        adapter = service.StubAdapter(
            slots=kw["slots"], pool_pages=kw["pool_pages"],
            pages_per_seq=kw["pages_per_seq"], page_size=kw["page_size"],
            chunk=kw["chunk"], role=role, sampled=args.temperature > 0)
    else:
        from hpc_patterns_tpu_torch.models.serving import EngineCore
        from hpc_patterns_tpu_torch.topology import resolve_device

        dev = resolve_device(args.device)
        cfg, params = replica_model(args, dev)
        ladder = replica_ladder(args)
        kw = dict(replica_engine_kw(args, ladder), device=dev)
        engine = None
        if args.fitted is not None:
            # the fitted ladder when present; the default ladder otherwise
            engine = EngineCore.from_fitted(params, cfg, args.fitted, **kw)
            if engine.prompt_buckets is None:
                engine = None
        if engine is None:
            engine = EngineCore(params, cfg, prompt_buckets=ladder, **kw)
        adapter = service.RealAdapter(engine, role=role)
    rc = service.serve_replica(
        adapter, rank=rank, rdv_dir=args.rdv,
        timeout_s=args.plane_timeout, rec=tracelib.active())
    if not args.stub:
        # what this replica's engine ran, beside the kernel launches its
        # wrappers counted (0 on the CPU, where the plain versions run)
        import json

        from hpc_patterns_tpu_torch.ops import flash_attention as fa
        from hpc_patterns_tpu_torch.ops import flash_decode as fd

        print(json.dumps({
            "replica": rank, "role": role, "n_layers": cfg.n_layers,
            "admissions": engine.admissions,
            "decode_steps": engine.decode_steps,
            "prefill_rungs": sorted(engine.prefill_rungs),
            "flash_prefill": fa.launches["fwd"],
            "paged_decode": fd.launches["paged_decode"]}), flush=True)
    return rc


def run(args) -> int:
    pid = int(os.environ.get("HPCPAT_PROCESS_ID") or 0)
    nprocs = int(os.environ.get("HPCPAT_NUM_PROCESSES") or 1)
    if nprocs < 2:
        print("ERROR: plane_app needs a launcher (-np >= 2: one "
              "router + at least one replica)")
        return 2
    # one load point for every rank: the router applies fitted placement,
    # real replicas the fitted ladder
    args.fitted = None
    if args.autofit:
        from hpc_patterns_tpu_torch.harness.cli import load_autofit

        try:
            args.fitted = load_autofit(args.autofit)
        except (OSError, ValueError) as e:
            print(f"ERROR: bad --autofit {args.autofit}: {e}")
            return 2
    os.makedirs(args.rdv, exist_ok=True)
    roles = _roles_for(nprocs - 1, args.roles)
    t0 = time.perf_counter()
    if pid == 0:
        # replica roles arrive with the hello handshake; the router only
        # needs to know how many replicas to expect
        rc = _run_router(args, nprocs)
    else:
        rc = _run_replica(args, pid, roles[pid - 1])
    print(f"rank {pid} done in {time.perf_counter() - t0:.2f}s rc={rc}",
          flush=True)
    return rc


def main(argv=None) -> int:
    from hpc_patterns_tpu_torch.apps import common

    args = build_parser().parse_args(argv)
    return common.run_instrumented(run, args)


if __name__ == "__main__":
    sys.exit(main())
