"""Trainer app: the transformer trained end to end on one device — the
counterpart of ``hpc_patterns_tpu/apps/train_app.py``, with its dp,
fsdp, sp, tp and ep mesh axes as logical ranks of that device.

Self-validating: the loss must be finite every step (the run halts at
the first non-finite one) and fall over the run on one static batch;
with ``--resume-check`` the state is checkpointed, restored, and one
step from each is compared bit for bit. ``--generate N`` then decodes N
tokens greedily from the trained params. Reports the steady-state step
time (min over steps after the first) and tokens/s. Prints
SUCCESS/FAILURE (exit 0/1).

    python -m hpc_patterns_tpu_torch.apps.train_app --device cpu \\
        --steps 3 --batch 2 --seq 64 --d-model 64 --n-layers 2 \\
        --n-heads 4 --vocab 256 --attention flash --resume-check
    python -m hpc_patterns_tpu_torch.apps.train_app --attention flash \\
        --steps 8 --batch 8 --seq 2048 --d-model 1024 --n-layers 8 \\
        --n-heads 8 --vocab 32768 --resume-check --generate 16

``--mlp-impl fused`` runs the fused MLP kernels (``ops/fused_mlp.py``);
``--remat`` checkpoints each layer under ``--remat-policy`` (JAX's
policies, on ``torch.utils.checkpoint``):

    python -m hpc_patterns_tpu_torch.apps.train_app --attention flash \
        --steps 8 --batch 8 --seq 2048 --d-model 1024 --n-layers 8 \
        --n-heads 8 --vocab 32768 --mlp-impl fused --remat \
        --remat-policy split

``--offload-opt`` parks the AdamW moments in pinned host memory between
steps and streams them through a ``memory.ResidencyManager`` (the pull on
its side stream under the gradient accumulation, the push after the
update); it prints the pull's measured overlap. On the CPU it prints JAX's
note and trains with the moments in place:

    python -m hpc_patterns_tpu_torch.apps.train_app --attention flash \
        --steps 8 --batch 8 --seq 2048 --d-model 1024 --n-layers 8 \
        --n-heads 8 --vocab 32768 --offload-opt

MoE layers (``--n-experts E --n-experts-top-k k``, ``--moe-dispatch``)
route through ``parallel/moe.py``; ``--drop-rate-every N`` adds the
routing drop rate to every N-th step record. ``--sp P`` runs the
``ring``/``ring_flash``/``ulysses``/``ulysses_flash`` attentions over P
sequence blocks and ``--ep P`` the expert-parallel MoE over P batch
shards, as logical ranks of the one device (rank-stacked tensors, the
all-to-alls and ring hops between them); every result line on a mesh
says so. ``--generate`` decodes an MoE model drop-free:

    python -m hpc_patterns_tpu_torch.apps.train_app --attention ring_flash \
        --sp 4 --n-experts 8 --n-experts-top-k 2 --ep 4 --steps 8 \
        --batch 8 --seq 2048 --d-model 1024 --n-layers 8 --n-heads 8 \
        --vocab 32768 --generate 16

``--dp``, ``--fsdp`` and ``--tp`` shard the batch, the params (and
moments) and the heads/features as logical ranks too (JAX's mesh: dp,
fsdp, sp, tp, ep; ``models/sharding.py``): the result line carries
JAX's labels (``dp=``, ``fsdp=``, ``tp=``) and ``--resume-check`` holds
bit for bit on the sharded state; ``--generate`` gathers the trained
params and decodes unsharded:

    python -m hpc_patterns_tpu_torch.apps.train_app --attention flash \
        --dp 2 --fsdp 2 --tp 2 --steps 5 --batch 8 --seq 2048 \
        --d-model 1024 --n-layers 8 --n-heads 8 --vocab 32768 \
        --mlp-impl fused --resume-check

Under ``apps/launch.py`` each process holds a block of the dp ranks and
their rows of the batch; the gradient mean across processes is one flat
allreduce over the gloo wire (the line says so). ``--dcn-dp`` lays dp
across slices (``launch.py --slices``: one slice a process) and every
other axis inside one; ``--dp -1`` takes the slice count, which in one
process is 1:

    python -m hpc_patterns_tpu_torch.apps.launch -np 2 \
        --cpu-devices-per-proc 2 --slices 2 -- python -m \
        hpc_patterns_tpu_torch.apps.train_app --dcn-dp --dp -1 --tp 2 \
        --steps 2 --batch 4 --seq 32 --d-model 32 --n-layers 1 \
        --vocab 128 --device cpu

``--pp P --microbatches M`` trains through the 1F1B pipeline
(``models/pp.py``: P stages as logical ranks, M microbatches a step),
composing with ``--dp`` (and ``--dcn-dp``), ``--fsdp`` (ZeRO-3 stage
weights), ``--tp`` inside the stages (dense MLPs only), ``--n-experts``
(stage-local experts) and ``--mlp-impl fused``; the result line carries
JAX's label ``pp=P 1f1b [tp= fsdp= dcn-dp=]``, ``--resume-check`` holds
bit for bit, and ``--generate`` is skipped with JAX's note. It refuses
sp/ep axes, ring and Ulysses attention and ``--accum``, as JAX does:

    python -m hpc_patterns_tpu_torch.apps.train_app --attention flash \
        --pp 4 --microbatches 8 --steps 5 --batch 8 --seq 2048 \
        --d-model 1024 --n-layers 8 --n-heads 8 --vocab 32768 \
        --mlp-impl fused
    python -m hpc_patterns_tpu_torch.apps.launch -np 2 --slices 2 -- \
        python -m hpc_patterns_tpu_torch.apps.train_app --pp 2 \
        --dcn-dp --dp -1 --steps 2 --batch 8 --seq 32 --d-model 32 \
        --n-layers 2 --vocab 128 --device cpu
"""

from __future__ import annotations

import math
import sys
import tempfile
import time
from pathlib import Path

import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.harness.cli import base_parser
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.verdict import Verdict
from hpc_patterns_tpu_torch.models.train import (
    init_train_state,
    make_batch,
    make_optimizer,
    make_train_step,
    record_step_metrics,
)
from hpc_patterns_tpu_torch.models.transformer import (
    ATTENTION_IMPLS,
    TransformerConfig,
)
from hpc_patterns_tpu_torch.topology import resolve_device


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=0,
                   help="grouped-query attention KV heads (0 = MHA)")
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--attention", default="full",
                   choices=list(ATTENTION_IMPLS))
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing: recompute each layer's "
                        "activations in the backward, keeping what "
                        "--remat-policy names")
    p.add_argument("--remat-policy", default="split",
                   choices=["nothing", "attn", "dots", "dots_attn", "split"])
    p.add_argument("--loss-chunk", type=int, default=0, metavar="C",
                   help="online-logsumexp cross-entropy over vocab chunks "
                        "of C (must divide --vocab): the (B,T,V) f32 logits "
                        "never materialize (0 = dense)")
    p.add_argument("--pos-embed", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (logical ranks; the batch's "
                        "row blocks; -1 with --dcn-dp = the slice count)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fully-sharded data parallelism (ZeRO-3): params, "
                        "grads and moments shard over this many ranks, "
                        "the batch over dp*fsdp")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (Megatron column/row)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (1F1B over logical ranks)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (logical ranks of one "
                        "device) for the ring/ulysses attentions")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ranks (logical ranks of one "
                        "device; requires --n-experts)")
    p.add_argument("--dcn-dp", action="store_true",
                   help="multi-slice placement: dp across slices (one "
                        "slice a launched process), every other axis "
                        "within one; --dp must equal the slice count "
                        "(-1 = auto, which in one process is dp=1)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="microbatches per step for --pp")
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts per layer (0 = dense)")
    p.add_argument("--n-experts-top-k", type=int, default=1)
    p.add_argument("--moe-dispatch", default="auto",
                   choices=["auto", "einsum", "scatter"])
    p.add_argument("--mlp-impl", default="dense", choices=["dense", "fused"],
                   help="dense-layer MLP: two library GEMMs, or the fused "
                        "matmul-gelu-matmul kernels (the d_ff activation "
                        "never in device memory in the forward)")
    p.add_argument("--drop-rate-every", type=int, default=10, metavar="N",
                   help="MoE routing-drop telemetry period (MoE only)")
    p.add_argument("--prefetch", type=int, default=0, metavar="DEPTH",
                   help="stream fresh synthetic batches through the async "
                        "prefetch loader (0 = one static batch)")
    p.add_argument("--data", default=None, metavar="TOKENS.bin",
                   help="raw binary token file (--data-dtype) streamed via "
                        "np.memmap instead of synthetic batches; implies "
                        "--prefetch 2 unless set")
    p.add_argument("--data-dtype", default="uint16",
                   choices=["uint16", "uint32", "int32"])
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation micro-steps per update "
                        "(batch must divide by it)")
    p.add_argument("--offload-opt", action="store_true",
                   help="host-resident optimizer moments, streamed through "
                        "the residency manager each step")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume-check", action="store_true",
                   help="save+restore after the run and verify one step "
                        "from each gives the same loss, bit for bit")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedy-decode N tokens from the "
                        "first half of the batch with the trained params")
    return p


def _ici_axes(args) -> dict:
    """JAX's axes inside a slice, in its order: fsdp (when > 1), sp, tp,
    ep (when > 1)."""
    axes = {"fsdp": args.fsdp} if args.fsdp > 1 else {}
    axes.update(sp=args.sp, tp=args.tp)
    if args.ep > 1:
        axes["ep"] = args.ep
    return axes


def _mesh(args, nprocs: int):
    """(global mesh or None, label) — JAX's mesh (``train_app.py:
    556-590``): dp, fsdp, sp, tp, ep, or with ``--dcn-dp`` dp across the
    slices (``topology.make_hybrid_mesh``); None when every axis is 1
    and the attention needs no mesh. Raises ``topology.TopologyError``
    with JAX's messages."""
    from hpc_patterns_tpu_torch import topology

    if args.dcn_dp:
        ici = _ici_axes(args)
        ici_size = math.prod(ici.values())
        # one process holds as many logical ranks as a slice needs; a
        # launched one holds its --cpu-devices-per-proc
        local = topology.local_ranks_from_env() if nprocs > 1 else ici_size
        groups = topology.group_by_slice(local)
        n_slices = len(groups)
        dp = n_slices if args.dp == -1 else args.dp
        if dp != n_slices:
            raise topology.TopologyError(
                f"--dcn-dp places dp across slices: --dp {args.dp} != "
                f"slice count {n_slices} (use -1 for auto)")
        picked = {s: r[:ici_size] for s, r in groups.items()}
        try:
            mesh = topology.make_hybrid_mesh({"dp": dp}, ici, picked)
        except topology.TopologyError as e:
            raise topology.TopologyError(f"--dcn-dp: {e}") from None
        return mesh, f" dcn-dp={dp}"
    axes = {"dp": args.dp, **_ici_axes(args)}
    if math.prod(axes.values()) == 1 \
            and args.attention in ("full", "flash"):
        return None, ""
    # the axes of size 1 other than sp carry nothing
    mesh = {a: n for a, n in topology.make_mesh(axes).items()
            if n > 1 or a == "sp"}
    return mesh, f" dp={args.dp}" if args.dp > 1 else ""


def _local_mesh(mesh, nprocs: int, batch: int):
    """This process's block of ``mesh``: the dp ranks divide over the
    processes (tp, fsdp, sp and ep stay inside a process, as JAX's
    dcn-dp keeps them inside a slice). Raises ValueError."""
    if nprocs == 1:
        return mesh
    dp = (mesh or {}).get("dp", 1)
    if dp % nprocs or batch % nprocs:
        raise ValueError(
            f"dp {dp} and --batch {batch} must divide over the {nprocs} "
            "processes (each holds a block of the dp ranks; tp, fsdp, sp "
            "and ep stay inside a process)")
    return {**mesh, "dp": dp // nprocs}


def _config(args) -> TransformerConfig:
    return TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model, max_seq=args.seq,
        attention=args.attention, n_kv_heads=args.n_kv_heads,
        pos_embed=args.pos_embed, loss_chunk=args.loss_chunk,
        remat=args.remat, remat_policy=args.remat_policy,
        mlp_impl=args.mlp_impl, n_experts=args.n_experts,
        n_experts_top_k=args.n_experts_top_k,
        moe_dispatch=args.moe_dispatch, fsdp=args.fsdp > 1)


def _optimizer(args):
    return make_optimizer(args.lr, schedule=args.schedule,
                          warmup_steps=args.warmup_steps,
                          total_steps=args.steps)


def _fail(log, msg) -> int:
    log.print(f"ERROR: {msg}")
    log.print("FAILURE")
    return 1


def _batches(args, cfg, dev):
    """The prefetched batch stream, or None for one static batch."""
    prefetch = args.prefetch or (2 if args.data else 0)
    if not prefetch:
        return None
    from hpc_patterns_tpu_torch.utils.data import (
        PrefetchLoader,
        device_placer,
        memmap_tokens,
        synthetic_tokens,
    )

    if args.data:
        source = memmap_tokens(args.data, batch=args.batch, seq=args.seq,
                               dtype=args.data_dtype, steps=args.steps,
                               vocab=cfg.vocab)
    else:
        source = synthetic_tokens(1, batch=args.batch, seq=args.seq,
                                  vocab=cfg.vocab, steps=args.steps)
    return iter(PrefetchLoader(source, depth=prefetch,
                               place=device_placer(dev)))


def _train_loop(args, log, cfg, dev, params, opt_state, step_fn,
                residency=None, mesh=None, label="", procs=(0, 1),
                name="train", layout=None, result_extra=None) -> int:
    """The steps, the resume check, checkpoints and ``--generate``.
    ``name``: the result record's ("train_pp" labels the line with
    ``label`` alone, as JAX's). ``layout``: the stored state's (shard,
    unshard) pair (default: ``models/sharding.state_layout`` on
    ``mesh``)."""
    pid, nprocs = procs
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = make_batch(gen, cfg, args.batch, args.seq, device=dev)
    if nprocs > 1:  # this process's dp ranks' rows of the global batch
        rows = args.batch // nprocs
        tokens = tokens[pid * rows:(pid + 1) * rows]
    batch_iter = _batches(args, cfg, dev)
    losses, t_steps = [], []
    ckpt_path = None
    diverged = False
    for i in range(args.steps):
        t0 = time.perf_counter()
        batch = next(batch_iter) if batch_iter is not None else tokens
        if batch_iter is not None and nprocs > 1:
            rows = batch.shape[0] // nprocs
            batch = batch[pid * rows:(pid + 1) * rows]
        loss, params, opt_state = step_fn(params, opt_state, batch)
        loss_val = float(loss)  # blocks: the readback is the fence
        t_steps.append(time.perf_counter() - t0)
        losses.append(loss_val)
        extra = {}
        if cfg.n_experts and args.pp <= 1 and args.drop_rate_every > 0 \
                and i % args.drop_rate_every == 0:
            # capacity drops are otherwise invisible in training: one
            # diagnostic forward on the step's batch, outside its time
            from hpc_patterns_tpu_torch.models.transformer import (
                moe_drop_rates,
            )

            drops = moe_drop_rates(params, batch, cfg, mesh)
            extra["moe_drop_rate"] = round(float(drops.max()), 4)
        log.emit(kind="step", step=i, loss=loss_val, dt_s=t_steps[-1],
                 **extra)
        record_step_metrics(i, loss_val, t_steps[-1],
                            args.batch * args.seq)
        if loss_val != loss_val or abs(loss_val) == float("inf"):
            log.print(f"ERROR: non-finite loss {loss_val} at step {i} — "
                      f"halting early ({args.steps - 1 - i} steps skipped)")
            diverged = True
            break

    offload = {}
    if residency is not None:
        residency.drain()  # the last push lands before anything reads it
        offload = {"prefetch_overlap_frac": residency.prefetch_overlap_frac,
                   "prefetch_bytes": residency.prefetch_bytes,
                   "evict_bytes": residency.evict_bytes}
        log.print(f"offload: moments pulled {residency.swap_ins}x, "
                  f"{residency.prefetch_bytes / 2**20:.1f} MiB in, "
                  f"{residency.evict_bytes / 2**20:.1f} MiB out, prefetch "
                  f"overlap {residency.prefetch_overlap_frac or 0.0:.1%}")
    finite = all(x == x and abs(x) != float("inf") for x in losses)
    # one step has nothing to compare, and prefetched batches are fresh
    # i.i.d. draws each step: finiteness is the check in those modes
    learned = (args.steps < 2 or batch_iter is not None
               or losses[-1] < losses[0])
    if diverged and (args.resume_check or args.checkpoint_dir
                     or args.generate):
        log.print("note: checkpoint/resume/generate legs skipped "
                  "(diverged state)")

    resume_ok = True
    # a sharded state saves its global tensors, restores into its layout
    if layout is None and name == "train":
        from hpc_patterns_tpu_torch.models.sharding import state_layout

        layout = state_layout(mesh, cfg)
    if diverged:
        pass
    elif args.resume_check:
        from hpc_patterns_tpu_torch.utils.checkpoint import (
            restore_checkpoint,
            save_checkpoint,
        )

        ckdir = _ckdir(args, pid, nprocs) or tempfile.mkdtemp(
            prefix="hpcpat_ckpt_")
        ckpt_path = save_checkpoint(ckdir, params, opt_state, step=args.steps,
                                    layout=layout)
        r_params, r_opt, r_step = restore_checkpoint(ckdir, params, opt_state,
                                                     layout=layout)
        if residency is not None:
            from hpc_patterns_tpu_torch.models.train import offload_opt_state

            r_opt = offload_opt_state(r_opt)  # restored onto the card
        loss_a = float(step_fn(params, opt_state, tokens)[0])
        loss_b = float(step_fn(r_params, r_opt, tokens)[0])
        resume_ok = loss_a == loss_b and r_step == args.steps
        del r_params, r_opt
        log.print(f"resume-check: saved {ckpt_path}, losses {loss_a:.6f} vs "
                  f"{loss_b:.6f}")
    elif args.checkpoint_dir:
        from hpc_patterns_tpu_torch.utils.checkpoint import save_checkpoint

        ckpt_path = save_checkpoint(_ckdir(args, pid, nprocs), params,
                                    opt_state, step=args.steps,
                                    layout=layout)
        log.print(f"saved {ckpt_path}")

    generate_ok = True
    if diverged:
        pass
    elif args.generate and name != "train":
        log.print("note: --generate skipped (pp params are stage-local; "
                  "decode serves the unpipelined flagship)")
    elif args.generate and nprocs > 1:
        log.print("note: --generate skipped (multi-process run)")
    elif args.generate and args.seq // 2 + args.generate > cfg.max_seq:
        log.print(f"note: --generate {args.generate} skipped (prompt "
                  f"{args.seq // 2} + N > max_seq {cfg.max_seq})")
    elif args.generate:
        from hpc_patterns_tpu_torch.models.decode import greedy_generate

        prompt = tokens[:, :args.seq // 2]
        with torch.no_grad():
            # sharded params are gathered first, as JAX decodes them
            p_local = layout[1](params) if layout else params
            toks = greedy_generate(p_local, prompt, cfg, args.generate,
                                   device=dev)
            del p_local
        generate_ok = (tuple(toks.shape) == (prompt.shape[0], args.generate)
                       and int(toks.min()) >= 0
                       and int(toks.max()) < cfg.vocab)
        log.print(f"generate: {toks.shape[0]}x{args.generate} tokens, "
                  f"sample {toks[0, :8].tolist()}")

    ok = finite and learned and resume_ok and generate_ok
    steady = t_steps[1:] or t_steps  # the first step builds the kernels
    step_s = min(steady)
    tokens_per_s = args.batch * args.seq / step_s
    ranks = {} if mesh is None else {
        "mesh_ranks": "logical ranks of one device"}
    if nprocs > 1:
        from hpc_patterns_tpu_torch.comm.processes import wire

        ranks = {"mesh_ranks": f"logical ranks of one device, a block of "
                               f"the dp ranks in each of {nprocs} "
                               "processes",
                 "grad_mean": wire(dev), "losses": losses}
    log.emit(kind="result", name=name, success=ok, steps=args.steps,
             loss_first=losses[0], loss_last=losses[-1], step_time_s=step_s,
             tokens_per_s=tokens_per_s, mesh=mesh, **ranks,
             attention=args.attention, n_experts=cfg.n_experts,
             checkpoint=ckpt_path, device=str(dev), **offload,
             **(result_extra or {}))
    on_mesh = ("" if mesh is None else
               f" on mesh {mesh} (logical ranks of one device)")
    if nprocs > 1:
        log.print(f"process {pid} of {nprocs}: dp ranks {mesh} here; the "
                  f"gradient mean across processes: one flat allreduce "
                  f"over {ranks['grad_mean']}; losses {losses}")
    tag = label if name != "train" else f"{args.attention}{label}"
    log.print(f"train[{tag}] {args.steps} steps{on_mesh}: "
              f"loss {losses[0]:.4f}->{losses[-1]:.4f}, "
              f"{step_s * 1e3:.1f} ms/step, {tokens_per_s:,.0f} tok/s")
    verdict = Verdict(success=ok, messages=("SUCCESS" if ok else "FAILURE",))
    log.print(verdict.summary_line())
    return verdict.exit_code


def _run_pp(args, log, pid: int, nprocs: int) -> int:
    """--pp: 1F1B pipeline training (``models/pp.py``; JAX ``_run_pp``),
    with dp (``--dcn-dp`` included: a process holds every pp rank of its
    dp block, the dp mean crossing gloo), fsdp stage weights, tp inside
    the stages (dense MLPs only), the moments offloaded, and MoE."""
    from hpc_patterns_tpu_torch import topology
    from hpc_patterns_tpu_torch.models import pp as pplib

    if args.sp > 1 or args.ep > 1:
        return _fail(log, "--pp composes with --dp/--tp/--fsdp/--dcn-dp/"
                          "--offload-opt and --n-experts only (no sp/ep "
                          "axes inside pipeline stages — MoE experts "
                          "route densely per stage)")
    try:
        cfg = _config(args)
        optimizer = _optimizer(args)
    except ValueError as e:
        return _fail(log, str(e))
    tp = args.tp if args.tp > 1 else 1
    if tp > 1:
        try:
            pplib.check_tp(cfg, tp)
        except ValueError as e:
            return _fail(log, f"--pp --tp: {e}")
    if args.attention not in ("full", "flash"):
        return _fail(log, "--pp needs a stage-local attention "
                          "(--attention full or flash)")
    if args.microbatches < 1:
        return _fail(log, f"--microbatches must be >= 1, got "
                          f"{args.microbatches}")
    if args.n_layers % args.pp:
        return _fail(log, f"--n-layers {args.n_layers} must divide by "
                          f"--pp {args.pp}")
    fs = args.fsdp if args.fsdp > 1 else 1
    ici = ({"fsdp": fs} if fs > 1 else {}) | {"pp": args.pp}
    if tp > 1:
        ici["tp"] = tp  # innermost, as JAX's
    if args.dcn_dp:
        ici_size = math.prod(ici.values())
        local = topology.local_ranks_from_env() if nprocs > 1 else ici_size
        groups = topology.group_by_slice(local)
        dp = len(groups) if args.dp == -1 else args.dp
        if dp != len(groups):
            return _fail(log, f"--dcn-dp places dp across slices: --dp "
                              f"{args.dp} != slice count {len(groups)} "
                              "(use -1 for auto)")
        try:
            mesh = topology.make_hybrid_mesh(
                {"dp": dp}, ici, {s: r[:ici_size] for s, r in
                                  groups.items()})
        except topology.TopologyError as e:
            return _fail(log, f"--dcn-dp: {e}")
    else:
        dp = args.dp
        if dp < 1:
            return _fail(log, f"--dp {dp} must be >= 1 (-1 only with "
                              "--dcn-dp)")
        mesh = ({"dp": dp} if dp > 1 else {}) | ici
    if args.batch % (args.microbatches * dp * fs):
        return _fail(log, f"--batch {args.batch} must divide by "
                          f"--microbatches*--dp*--fsdp = "
                          f"{args.microbatches * dp * fs}")
    try:
        local = _local_mesh(mesh, nprocs, args.batch)
    except ValueError as e:
        return _fail(log, str(e))
    dev = resolve_device(args.device)
    axis_fsdp = "fsdp" if fs > 1 else None
    params, opt_state = pplib.init_pp_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, optimizer,
        device=dev, mesh=local, axis_fsdp=axis_fsdp)
    offload_example = None
    if args.offload_opt:
        from hpc_patterns_tpu_torch.models.train import offload_opt_state

        hosted = offload_opt_state(opt_state)
        if hosted is opt_state:
            log.print("note: pinned_host unusable on this backend; "
                      "optimizer state left in place")
        else:
            opt_state = offload_example = hosted
            log.print("optimizer state offloaded to pinned_host")
    step_fn = pplib.make_pp_train_step(
        cfg, local, microbatches=args.microbatches,
        axis_dp="dp" if local.get("dp", 1) > 1 else None,
        axis_fsdp=axis_fsdp, axis_tp="tp" if tp > 1 else None,
        optimizer=optimizer, offload_opt_example=offload_example)
    label = f"pp={args.pp} 1f1b"
    if tp > 1:
        label += f" tp={tp}"
    if fs > 1:
        label += f" fsdp={fs}"
    if args.dcn_dp:
        label += f" dcn-dp={dp}"
    return _train_loop(args, log, cfg, dev, params, opt_state, step_fn,
                       mesh=local, label=label, procs=(pid, nprocs),
                       name="train_pp",
                       layout=pplib.state_layout(cfg, axis_fsdp, fs),
                       result_extra={"microbatches": args.microbatches,
                                     "label": label})


def _ckdir(args, pid: int, nprocs: int):
    """``--checkpoint-dir``, a subdirectory a process when launched."""
    if not args.checkpoint_dir or nprocs == 1:
        return args.checkpoint_dir
    return str(Path(args.checkpoint_dir) / f"process_{pid}")


def run(args) -> int:
    from hpc_patterns_tpu_torch import topology

    topology.init_distributed_from_env()  # no-op unless launched
    pid, nprocs, _ = topology.process_env_info()
    log = RunLog(args.log, truncate=not args.log_append)
    if args.prefetch < 0:
        return _fail(log, f"--prefetch must be >= 0, got {args.prefetch}")
    if args.steps < 1:
        return _fail(log, f"--steps must be >= 1, got {args.steps}")
    if args.accum > 1 and args.pp > 1:
        return _fail(log, "--accum composes with the sharded-train path; "
                          "--pp already micro-batches via --microbatches")
    if args.remat_policy != "split" and not args.remat:
        return _fail(log, "--remat-policy has no effect without --remat (no "
                          "checkpointing happens; all activations are saved)")
    if args.accum > 1 and args.batch % args.accum:
        return _fail(log, f"--batch {args.batch} must divide by --accum "
                          f"{args.accum}")
    if args.ep > 1 and not args.n_experts:
        return _fail(log, "--ep requires --n-experts")
    if args.n_experts and args.n_experts % max(args.ep, 1):
        return _fail(log, f"--n-experts {args.n_experts} must divide by "
                          f"--ep {args.ep}")
    if args.pp > 1:
        return _run_pp(args, log, pid, nprocs)
    if args.attention == "flash" and args.sp > 1:
        return _fail(log, "attention='flash' needs the sequence unsharded "
                          "(--sp 1); use ring_flash for a sharded sequence")
    if args.seq % args.sp:
        return _fail(log, f"--seq {args.seq} must divide by --sp {args.sp}")
    if args.dp != 1 and not (args.dcn_dp and args.dp == -1) and args.dp < 1:
        return _fail(log, f"--dp {args.dp} must be >= 1 (-1 only with "
                          "--dcn-dp)")
    try:
        mesh, label = _mesh(args, nprocs)
        dp = (mesh or {}).get("dp", 1)
        if args.batch % (dp * args.fsdp):
            raise ValueError(f"--batch {args.batch} must divide by dp*fsdp "
                             f"({dp}*{args.fsdp})")
        if args.tp > 1 and args.n_heads % args.tp:
            raise ValueError(f"--n-heads {args.n_heads} must divide by "
                             f"--tp {args.tp}")
        if args.tp > 1 and (4 * args.d_model) % args.tp:
            raise ValueError(f"d_ff {4 * args.d_model} must divide by "
                             f"--tp {args.tp}")
        if args.tp > 1 and args.vocab % args.tp:
            raise ValueError(f"--vocab {args.vocab} must divide by "
                             f"--tp {args.tp}")
        label += (f" fsdp={args.fsdp}" if args.fsdp > 1 else "") + (
            f" tp={args.tp}" if args.tp > 1 else "")
        local = _local_mesh(mesh, nprocs, args.batch)
    except ValueError as e:
        return _fail(log, str(e))
    try:
        cfg = _config(args)
        optimizer = _optimizer(args)
        step_fn = make_train_step(cfg, optimizer=optimizer,
                                  accum_steps=args.accum, mesh=local)
    except ValueError as e:
        return _fail(log, str(e))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt_state = init_train_state(gen, cfg, optimizer, device=dev,
                                         mesh=local)
    residency = None
    if args.offload_opt:
        from hpc_patterns_tpu_torch.memory import ResidencyManager
        from hpc_patterns_tpu_torch.memory.kinds import tree_tensors
        from hpc_patterns_tpu_torch.models.train import offload_opt_state

        hosted = offload_opt_state(opt_state)
        if hosted is opt_state:
            # the probe-gated identity fallback: say so instead of
            # logging an offload that did not happen
            log.print("note: pinned_host unusable on this backend; "
                      "optimizer state left in place")
        else:
            opt_state = hosted
            residency = ResidencyManager(
                host_blocks=len(tree_tensors(opt_state)), device=dev)
            step_fn = make_train_step(cfg, optimizer=optimizer,
                                      accum_steps=args.accum,
                                      offload_opt_example=opt_state,
                                      residency=residency, mesh=local)
            log.print("optimizer state offloaded to pinned_host")
    return _train_loop(args, log, cfg, dev, params, opt_state, step_fn,
                       residency, local, label, (pid, nprocs))


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
