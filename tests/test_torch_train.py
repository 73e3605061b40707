"""The port's training path (``hpc_patterns_tpu_torch.models.train``,
``models.transformer`` loss, ``utils/``, ``apps/train_app.py``,
``apps/eval_app.py``) against the JAX package on the CPU.

Inputs come from seeds through numpy; JAX params cross with
``params_from_jax`` and optax state with ``opt_state_from_jax``. JAX's
flash route runs its Pallas kernels in interpret mode. Tolerances (f32
on both sides; only the summation order differs): loss rtol 1e-5,
gradients atol 1e-5 (XLA:CPU and torch sum matmuls in different orders
across two layers; measured ~1e-6), one optimizer update 1e-6 (optax's
arithmetic, term for term), a 3-step loss trajectory rtol 1e-5.
"""

import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import train as jtrain  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu.utils import data as jdata  # noqa: E402
from hpc_patterns_tpu_torch.apps import eval_app, train_app  # noqa: E402
from hpc_patterns_tpu_torch.models import train as ttrain  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    opt_state_from_jax,
    params_from_jax,
)
from hpc_patterns_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from hpc_patterns_tpu_torch.utils import data as tdata  # noqa: E402

SMALL = dict(vocab=128, d_model=32, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, dtype="float32")
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
UPDATE_ATOL = 1e-6


def _pair(**kw):
    fields = {**SMALL, **kw}
    return jtf.TransformerConfig(**fields), ttf.TransformerConfig(**fields)


def _params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, B=2, T=64, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (B, T), np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kw", [
    {}, {"loss_chunk": 32}, {"pos_embed": "rope", "n_kv_heads": 2},
    {"attention": "flash"},
    {"attention": "flash", "n_kv_heads": 2, "loss_chunk": 64,
     "pos_embed": "rope"},
], ids=["dense", "chunked", "rope-gqa", "flash", "flash-gqa-rope-chunked"])
def test_loss_and_grads_match_jax(kw):
    jcfg, tcfg = _pair(**kw)
    jp, tp = _params(jcfg)
    tokens = _tokens(1)
    jl, jg = jax.value_and_grad(jtf.loss_fn)(jp, jnp.asarray(tokens), jcfg)
    leaves = ttrain.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = ttf.loss_fn(tp, torch.from_numpy(tokens), tcfg)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    for a, b in zip(tg, jax.tree.leaves(jg)):  # both in sorted-key order
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


def test_chunked_loss_equals_dense_and_checks_the_chunk():
    _, tcfg = _pair()
    jcfg, _ = _pair()
    _, tp = _params(jcfg)
    tokens = torch.from_numpy(_tokens(2))
    x, aux = ttf.forward_hidden(tp, tokens, tcfg)
    assert aux.item() == 0.0
    head = ttf.matmul_weight(tp, "lm_head", x.dtype)
    dense = ttf.masked_causal_nll(ttf.forward(tp, tokens, tcfg), tokens)
    chunked = ttf.chunked_masked_causal_nll(x, head, tokens, chunk=16)
    np.testing.assert_allclose(chunked.item(), dense.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        ttf.chunked_masked_causal_nll(x, head, tokens, chunk=48)


def _advance(opt, state, params, n, seed):
    """``n`` optax updates with seeded gradients: a mid-run state."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape, dtype=np.float32) * 0.01), params)
        _, state = opt.update(g, state, params)
    return state


@pytest.mark.parametrize("schedule,warmup", [("constant", 0),
                                             ("constant", 3),
                                             ("cosine", 2)],
                         ids=["constant", "warmup", "cosine"])
@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("mid_run", [0, 2], ids=["first", "mid-run"])
def test_one_update_matches_optax(schedule, warmup, clip, mid_run):
    jcfg, _ = _pair()
    jp, _ = _params(jcfg)
    kw = dict(warmup_steps=warmup, total_steps=10, schedule=schedule)
    jopt = jtrain.make_optimizer(1e-2, grad_clip=clip, **kw)
    jstate = _advance(jopt, jopt.init(jp), jp, mid_run, seed=5)
    rng = np.random.default_rng(6)
    grads = jax.tree.map(lambda p: rng.standard_normal(
        p.shape, dtype=np.float32), _np(jp))
    upd, jnew = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
    want = jax.tree.map(np.asarray, jtrain.optax.apply_updates(jp, upd))

    tp = params_from_jax(_np(jp), device="cpu")
    tstate = opt_state_from_jax(_np(jstate), device="cpu")
    assert tstate["count"] == mid_run
    topt = ttrain.make_optimizer(1e-2, grad_clip=clip, **kw)
    tg = [torch.from_numpy(g) for g in jax.tree.leaves(grads)]
    topt.update(tg, tstate, tp)
    assert tstate["count"] == mid_run + 1
    for a, b in zip(ttrain.tree_leaves(tp), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, atol=UPDATE_ATOL)
    got_mu = opt_state_from_jax(_np(jnew), device="cpu")["mu"]
    for a, b in zip(ttrain.tree_leaves(tstate["mu"]),
                    ttrain.tree_leaves(got_mu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=UPDATE_ATOL)


def test_schedules_match_optax_and_validate():
    for kw in (dict(schedule="constant", warmup_steps=4),
               dict(schedule="cosine", warmup_steps=3, total_steps=12),
               dict(schedule="cosine", warmup_steps=0, total_steps=5)):
        jlr = jtrain.optax.warmup_cosine_decay_schedule(
            0.0, 0.5, kw["warmup_steps"], kw["total_steps"], 0.05) \
            if kw["schedule"] == "cosine" else \
            jtrain.optax.linear_schedule(0.0, 0.5, kw["warmup_steps"])
        lr = ttrain.make_optimizer(0.5, **kw).lr
        for c in range(15):
            np.testing.assert_allclose(lr(c), float(jlr(c)), rtol=1e-6,
                                       atol=1e-9)
    assert ttrain.make_optimizer(0.5, warmup_steps=4).lr(0) == 0.0
    with pytest.raises(ValueError, match="total_steps"):
        ttrain.make_optimizer(schedule="cosine", warmup_steps=10,
                              total_steps=5)
    with pytest.raises(ValueError, match="schedule"):
        ttrain.make_optimizer(schedule="linear")
    with pytest.raises(ValueError, match="adam"):
        opt_state_from_jax(({}, ()), device="cpu")


def _state(tcfg, seed=0):
    return ttrain.init_train_state(torch.Generator().manual_seed(seed), tcfg,
                                   device="cpu")


def test_accumulation_equals_one_big_batch():
    _, tcfg = _pair()
    tokens = torch.from_numpy(_tokens(7, B=8, T=32))
    p1, s1 = _state(tcfg)
    p2, s2 = copy.deepcopy((p1, s1))
    loss_a, pa, _ = ttrain.make_train_step(tcfg)(p1, s1, tokens)
    loss_b, pb, _ = ttrain.make_train_step(tcfg, accum_steps=2)(p2, s2,
                                                                 tokens)
    np.testing.assert_allclose(loss_a.item(), loss_b.item(), rtol=1e-5)
    for a, b in zip(ttrain.tree_leaves(pa), ttrain.tree_leaves(pb)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="accum_steps"):
        ttrain.make_train_step(tcfg, accum_steps=0)
    with pytest.raises(ValueError, match="divide"):
        ttrain.make_train_step(tcfg, accum_steps=3)(pa, s1, tokens)
    # the streamed step needs a host-resident example; on the CPU the
    # offload is JAX's identity fallback (no page-locked memory)
    with pytest.raises(ValueError, match="offload_opt_example"):
        ttrain.make_train_step(tcfg, residency=object())
    assert ttrain.offload_opt_state(s1) is s1


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_three_step_trajectory_matches_jax(attention):
    jcfg, tcfg = _pair(attention=attention)
    jp, tp = _params(jcfg)
    tokens = _tokens(8)
    jopt = jtrain.make_optimizer(1e-2)
    jstep = jtrain.make_train_step(jcfg, optimizer=jopt)
    jstate = jopt.init(jp)
    tstate = opt_state_from_jax(_np(jstate), device="cpu")
    tstep = ttrain.make_train_step(tcfg, optimizer=ttrain.make_optimizer(1e-2))
    jl, tl = [], []
    for _ in range(3):
        loss, jp, jstate = jstep(jp, jstate, jnp.asarray(tokens))
        jl.append(float(loss))
        loss, tp, tstate = tstep(tp, tstate, torch.from_numpy(tokens))
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_make_batch_and_synthetic_tokens():
    _, tcfg = _pair()
    a = ttrain.make_batch(torch.Generator().manual_seed(1), tcfg, 3, 16,
                          device="cpu")
    b = ttrain.make_batch(torch.Generator().manual_seed(1), tcfg, 3, 16,
                          device="cpu")
    assert a.dtype == torch.int32 and a.shape == (3, 16)
    assert torch.equal(a, b) and 0 <= a.min() and a.max() < 128
    batches = list(tdata.synthetic_tokens(0, batch=2, seq=8, vocab=100,
                                          steps=3))
    assert len(batches) == 3 and all(x.shape == (2, 8) for x in batches)
    assert all(0 <= x.min() and x.max() < 100 for x in batches)


@pytest.mark.parametrize("sequential", [False, True])
def test_memmap_windows_equal_jax(tmp_path, sequential):
    path = tmp_path / "toks.bin"
    toks = np.random.default_rng(9).integers(0, 60000, 5000)
    tdata.write_token_file(path, toks, "uint16")
    kw = dict(batch=4, seq=96, steps=5, seed=3, sequential=sequential,
              vocab=60000)
    got = list(tdata.memmap_tokens(path, **kw))
    want = list(jdata.memmap_tokens(path, **kw))
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="range"):
        tdata.write_token_file(tmp_path / "x.bin", [70000], "uint16")
    with pytest.raises(ValueError, match="vocab"):
        next(tdata.memmap_tokens(path, batch=2, seq=8, vocab=5))


def test_prefetch_loader_order_errors_and_early_exit():
    batches = [np.full((4,), i, np.int32) for i in range(10)]
    out = list(tdata.PrefetchLoader(batches, depth=3,
                                    place=tdata.device_placer("cpu")))
    assert [int(b[0]) for b in out] == list(range(10))
    assert all(isinstance(b, torch.Tensor) for b in out)

    def bad():
        yield np.zeros(2)
        raise RuntimeError("corrupt shard")

    with pytest.raises(RuntimeError, match="corrupt shard"):
        list(tdata.PrefetchLoader(bad(), place=torch.from_numpy))
    # a consumer that stops early must not wedge the worker on a full queue
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield np.full((2,), i)
            i += 1

    it = iter(tdata.PrefetchLoader(endless(), depth=2,
                                   place=torch.from_numpy))
    assert int(next(it)[0]) == 0
    it.close()
    n = len(pulled)
    assert n <= 5  # depth 2 + the one in hand + the one being placed
    with pytest.raises(ValueError):
        tdata.PrefetchLoader([], depth=0)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    _, tcfg = _pair()
    params, state = _state(tcfg)
    step = ttrain.make_train_step(tcfg)
    tokens = torch.from_numpy(_tokens(10, B=2, T=32))
    step(params, state, tokens)
    path = tckpt.save_checkpoint(tmp_path, params, state, step=1)
    assert path.endswith("step_1") and tckpt.latest_step(tmp_path) == 1
    tckpt.save_checkpoint(tmp_path, params, state, step=1)  # replaces
    r_params, r_state, r_step = tckpt.restore_checkpoint(tmp_path, params,
                                                         state)
    assert r_step == 1 and r_state["count"] == 1
    live = {"p": params, "m": state["mu"], "n": state["nu"]}
    back = {"p": r_params, "m": r_state["mu"], "n": r_state["nu"]}
    for a, b in zip(ttrain.tree_leaves(live), ttrain.tree_leaves(back)):
        assert torch.equal(a.detach(), b)
    la = step(params, state, tokens)[0]
    lb = step(r_params, r_state, tokens)[0]
    assert la.item() == lb.item()
    # restore_params reads the params file only, never the moments
    (tmp_path / "step_1" / "opt_state.pt").unlink()
    only, s = tckpt.restore_params(tmp_path)
    assert s == 1 and set(only) == set(params)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_params(tmp_path / "nothing")
    wrong = copy.deepcopy(params)
    wrong["embed"] = wrong["embed"][:, :8]
    tckpt.save_checkpoint(tmp_path, params, state, step=2)
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_checkpoint(tmp_path, wrong, state)


APP = ["--device", "cpu", "--batch", "2", "--seq", "64", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--vocab", "128"]


def test_train_app_success_resume_check_and_eval(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert train_app.main(APP + ["--steps", "3", "--attention", "flash",
                                 "--resume-check", "--checkpoint-dir", ck,
                                 "--generate", "4", "--log",
                                 str(tmp_path / "t.jsonl")]) == 0
    out = capsys.readouterr().out
    assert "resume-check" in out and "generate: 2x4" in out
    assert out.strip().endswith("SUCCESS")
    ev = APP[:2] + ["--checkpoint-dir", ck, "--batches", "2"] + APP[2:]
    assert eval_app.main(ev + ["--attention", "flash"]) == 0
    assert "restored step 3" in capsys.readouterr().out
    assert eval_app.main(APP + ["--batches", "2"]) == 0  # fresh params
    bad = ev[:]
    bad[bad.index("--d-model") + 1] = "64"
    assert eval_app.main(bad) == 1
    assert "do not match" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--accum", "2", "--loss-chunk", "32", "--pos-embed", "rope",
     "--n-kv-heads", "2", "--schedule", "cosine", "--warmup-steps", "1"],
    ["--prefetch", "2"],
], ids=["accum-chunk-rope-gqa-cosine", "prefetch"])
def test_train_app_options(extra, capsys):
    assert train_app.main(APP + ["--steps", "3"] + extra) == 0
    assert capsys.readouterr().out.strip().endswith("SUCCESS")


def test_train_app_data_file(tmp_path, capsys):
    path = tmp_path / "toks.bin"
    tdata.write_token_file(path, np.arange(4096) % 128, "uint16")
    assert train_app.main(APP + ["--steps", "2", "--data", str(path)]) == 0
    assert capsys.readouterr().out.strip().endswith("SUCCESS")


@pytest.mark.parametrize("flag", [["--pp", "2", "--accum", "2"]])
def test_train_app_unported_flags_fail(flag, capsys):
    # --pp runs now (tests/test_torch_pp.py); what it refuses is JAX's
    # refusal of --accum beside it
    assert train_app.main(APP + ["--steps", "1"] + flag) == 1
    out = capsys.readouterr().out
    assert "ERROR:" in out and "--pp already micro-batches" in out
    assert out.strip().endswith("FAILURE")


@pytest.mark.parametrize("flag,label", [
    (["--tp", "2"], "tp=2"), (["--dp", "2", "--fsdp", "2"], "fsdp=2"),
    (["--dcn-dp", "--dp", "-1"], "dcn-dp=1")], ids=["tp", "dp-fsdp", "dcn"])
def test_train_app_mesh_flags_pass(flag, label, capsys):
    # JAX's labels; on one process --dcn-dp --dp -1 degenerates to dp 1
    assert train_app.main(APP + ["--steps", "2", "--batch", "4"]
                          + flag) == 0
    out = capsys.readouterr().out
    assert label in out and "logical ranks of one device" in out
    assert out.strip().endswith("SUCCESS")


def test_train_app_dcn_dp_refuses_dp_2_in_one_process(capsys):
    assert train_app.main(APP + ["--steps", "1", "--dcn-dp", "--dp",
                                 "2"]) == 1
    out = capsys.readouterr().out
    assert ("ERROR: --dcn-dp places dp across slices: --dp 2 != slice "
            "count 1 (use -1 for auto)") in out
    assert out.strip().endswith("FAILURE")


# ------------------------------------------------------------ offloaded state

def test_offload_opt_state_cpu_contract(capsys, monkeypatch):
    _, tcfg = _pair()
    _, s1 = _state(tcfg)
    # no page-locked memory on the CPU: JAX's note, the input unchanged
    assert ttrain.offload_opt_state(s1) is s1
    assert "no usable 'pinned_host'" in capsys.readouterr().out
    # with the probe green every moment leaf moves through the cached
    # transfer callable to the kind; the count stays a host int
    from hpc_patterns_tpu_torch.memory import kinds

    seen = []
    monkeypatch.setattr(kinds, "memory_kind_placement_works",
                        lambda device=None, kind="pinned_host": True)
    monkeypatch.setattr(kinds, "move_to_kind", lambda device, kind: (
        lambda x: seen.append(kind) or x.clone()))
    moved = ttrain.offload_opt_state(s1)
    n = len(ttrain.tree_leaves(s1["mu"])) * 2
    assert seen == ["pinned_host"] * n and moved["count"] == s1["count"]
    assert moved is not s1 and all(
        a is not b for a, b in zip(ttrain.tree_leaves(moved["mu"]),
                                   ttrain.tree_leaves(s1["mu"])))


@pytest.mark.parametrize("accum", [1, 2])
def test_streamed_step_equals_resident_moments_bitwise(accum):
    # the offloaded step on the CPU's collapsed tiers runs the same update
    # on the same numbers: losses and params bit-equal over two steps; the
    # manager pulled and pushed once a step and measured the pull
    from hpc_patterns_tpu_torch.memory import ResidencyManager

    _, tcfg = _pair()
    tokens = torch.from_numpy(_tokens(5, B=4, T=32))
    p1, s1 = _state(tcfg)
    p2, s2 = copy.deepcopy((p1, s1))
    plain = ttrain.make_train_step(tcfg, accum_steps=accum)
    mgr = ResidencyManager(host_blocks=64)
    hosted = ttrain.offload_opt_state(s2)
    streamed = ttrain.make_train_step(tcfg, accum_steps=accum,
                                      offload_opt_example=hosted,
                                      residency=mgr)
    for _ in range(2):
        la, p1, s1 = plain(p1, s1, tokens)
        lb, p2, hosted = streamed(p2, hosted, tokens)
        assert la.item() == lb.item()
    mgr.drain()
    for a, b in zip(ttrain.tree_leaves(p1), ttrain.tree_leaves(p2)):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(ttrain.tree_leaves(s1[k]),
                        ttrain.tree_leaves(hosted[k])):
            assert torch.equal(a, b)
    assert hosted["count"] == s1["count"] == 2
    assert mgr.swap_ins == mgr.swap_outs == 2 and mgr.prefetch_bytes > 0
    assert 0.0 <= mgr.prefetch_overlap_frac <= 1.0
    # the non-residency offloaded step (pull, update, push in the step)
    p3, s3 = _state(tcfg)
    inline = ttrain.make_train_step(tcfg, accum_steps=accum,
                                    offload_opt_example=s3)
    lc, _, _ = inline(p3, s3, tokens)
    p4, s4 = _state(tcfg)
    assert lc.item() == plain(p4, s4, tokens)[0].item()


def test_streamed_step_matches_jax_streamed_step():
    from hpc_patterns_tpu.memory import ResidencyManager as JManager
    from hpc_patterns_tpu_torch.memory import ResidencyManager

    jcfg, tcfg = _pair()
    jp, tp = _params(jcfg)
    tokens = _tokens(9)
    jopt = jtrain.make_optimizer(1e-2)
    jstate = jopt.init(jp)
    tstate = opt_state_from_jax(_np(jstate), device="cpu")
    jstep = jtrain.make_train_step(jcfg, optimizer=jopt,
                                   offload_opt_example=jstate,
                                   residency=JManager(host_blocks=64))
    tstep = ttrain.make_train_step(
        tcfg, optimizer=ttrain.make_optimizer(1e-2),
        offload_opt_example=tstate,
        residency=ResidencyManager(host_blocks=64))
    jl, tl = [], []
    for _ in range(3):
        loss, jp, jstate = jstep(jp, jstate, jnp.asarray(tokens))
        jl.append(float(loss))
        loss, tp, tstate = tstep(tp, tstate, torch.from_numpy(tokens))
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_train_app_offload_opt_on_the_cpu(capsys):
    assert train_app.main(APP + ["--steps", "2", "--offload-opt"]) == 0
    out = capsys.readouterr().out
    assert "note: pinned_host unusable on this backend" in out
    assert out.strip().endswith("SUCCESS")
