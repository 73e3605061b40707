"""Pipeline parallelism on logical ranks (``parallel/pipeline.py``,
``models/pp.py``, ``train_app --pp``) against JAX on the CPU.

- ``schedule_1f1b`` equals JAX's tick table dict for dict, with its
  invariants (JAX ``test_parallel.py::TestPipeline1F1B``).
- ``pipeline_forward`` and ``pipeline_train_1f1b`` equal JAX's under
  ``shard_map`` on the 8-device CPU mesh (the tanh net of JAX's fast-tier
  test), plain and with ``loss_params``, ``return_input_grads`` and
  ``stage_aux_weight``; every stage's peak stash stays within
  ``min(P - r, M)``.
- ``pp_loss_and_grads`` equals JAX's single-device
  ``jax.value_and_grad(loss_fn)``, the oracle of JAX's own
  ``test_pp_model.py``, in each of its cases (its refusals too); JAX's
  tolerances: the loss rtol 1e-5, the gradients atol 2e-5 (5e-4 for the
  fused MLP).
- ``tp_permute_wqkv`` and its inverse are bit-equal to JAX's.
- Two ``make_pp_train_step`` steps equal two of JAX's unsharded
  ``make_train_step`` (with fsdp the moments stored sharded); the app's
  ``--pp`` legs and refusals, and one launched ``--pp --dcn-dp`` run
  against one process.

JAX's tiny config (``test_pp_model.py``'s ``CFG``), f32, weights carried
across by ``models/convert.py``, inputs from seeds through numpy.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu import parallel as jpar  # noqa: E402
from hpc_patterns_tpu import topology as jtopo  # noqa: E402
from hpc_patterns_tpu.models import pp as jpp  # noqa: E402
from hpc_patterns_tpu.models import train as jtrain  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu.topology import shard_map  # noqa: E402
from hpc_patterns_tpu_torch.apps import train_app  # noqa: E402
from hpc_patterns_tpu_torch.models import pp as tpp  # noqa: E402
from hpc_patterns_tpu_torch.models import train as ttrain  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import params_from_jax  # noqa: E402
from hpc_patterns_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab=32, d_model=16, n_heads=2, n_layers=4, d_ff=32,
           max_seq=8, dtype="float32")
LOSS_RTOL = 1e-5
GRAD_ATOL = 2e-5
FUSED_ATOL = 5e-4
NET_ATOL = 1e-5  # the tanh net's f32 values and gradients


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (its models are tiny; see
    test_torch_sharding's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the schedule


@pytest.mark.parametrize("P_,M", [(2, 2), (4, 8), (8, 8), (3, 7)])
def test_schedule_equals_jax_and_keeps_its_invariants(P_, M):
    fwd, bwd = tpipe.schedule_1f1b(P_, M)
    assert (fwd, bwd) == jpar.schedule_1f1b(P_, M)
    for r in range(P_):
        ticks = [fwd[(r, m)] for m in range(M)] + \
                [bwd[(r, m)] for m in range(M)]
        assert len(set(ticks)) == len(ticks)
        for m in range(M):
            if r + 1 < P_:
                assert fwd[(r, m)] < fwd[(r + 1, m)]
            if r > 0:
                assert bwd[(r, m)] < bwd[(r - 1, m)]
        live = peak = 0
        for _, d in sorted([(fwd[(r, m)], 1) for m in range(M)]
                           + [(bwd[(r, m)], -1) for m in range(M)]):
            live += d
            peak = max(peak, live)
        assert peak <= min(P_ - r, M)


# ----------------------------------------------- the schedules vs JAX's


def _net(seed=8, M=8, B=2, F=8):
    """JAX's fast-tier tanh net: (M, B, F) inputs and targets, 8 stage
    weights (F, F)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, B, F)).astype(np.float32)
    tgt = rng.standard_normal((M, B, F)).astype(np.float32)
    ws = (rng.standard_normal((8, F, F)) / 3).astype(np.float32)
    return x, tgt, ws


def _jstage(w, h):
    return jnp.tanh(jnp.dot(h, w))


def _tstage(w, h):
    return torch.tanh(h @ w)


def test_pipeline_forward_matches_jax(mesh8):
    x, _, ws = _net(M=6)
    want = jax.jit(shard_map(
        lambda x, w: jpar.pipeline_forward(_jstage, w[0], x, "x")[None],
        mesh=mesh8, in_specs=(P(), P("x", None, None)),
        out_specs=P("x")))(x, ws)
    got = tpipe.pipeline_forward(_tstage, list(torch.from_numpy(ws)),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), atol=NET_ATOL)
    assert not got[:-1].any()  # valid on the last rank only


def _jloss(y, t):
    return jnp.mean((y - t) ** 2)


def _jloss_p(lp, y, t):
    return jnp.mean((y * lp - t) ** 2)


def _jstage_aux(w, h):
    y = jnp.tanh(jnp.dot(h, w))
    return y, jnp.mean(y ** 2)


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "extras"])
def test_pipeline_1f1b_matches_jax(mesh8, extras):
    x, tgt, ws = _net()
    M = x.shape[0]
    lp = np.linspace(0.5, 1.5, x.shape[-1], dtype=np.float32)
    kw = (dict(loss_params=lp, return_input_grads=True,
               stage_aux_weight=0.3) if extras else {})

    def local(x, t, w, lp):
        if not extras:
            loss, g = jpar.pipeline_train_1f1b(_jstage, w[0], x, t, _jloss,
                                               "x")
            return loss[None], g[None], lp[None], x[None], loss[None]
        loss, g, ex = jpar.pipeline_train_1f1b(
            _jstage_aux, w[0], x, t, _jloss_p, "x", **{**kw, "loss_params":
                                                         lp})
        return (loss[None], g[None], ex["loss_grads"][None],
                ex["input_grads"][None], ex["aux_sum"][None])

    want = jax.jit(shard_map(
        local, mesh=mesh8,
        in_specs=(P(), P(), P("x", None, None), P()),
        out_specs=(P("x"),) * 5, check_vma=False))(x, tgt, ws, lp)
    want = [np.asarray(a) for a in want]
    stats = {}
    t = [torch.from_numpy(a) for a in (x, tgt, ws, lp)]
    if extras:
        loss, grads, ex = tpipe.pipeline_train_1f1b(
            lambda w, h: (torch.tanh(h @ w), torch.tanh(h @ w).square()
                          .mean()),
            list(t[2]), t[0], t[1],
            lambda p, y, g: ((y * p - g) ** 2).mean(),
            **{**kw, "loss_params": t[3]}, stats=stats)
        np.testing.assert_allclose(ex["loss_grads"].numpy(), want[2][-1],
                                   atol=NET_ATOL)
        np.testing.assert_allclose(ex["input_grads"].numpy(), want[3][0],
                                   atol=NET_ATOL)
        np.testing.assert_allclose(ex["aux_sum"].numpy(), want[4],
                                   atol=NET_ATOL)
    else:
        loss, grads = tpipe.pipeline_train_1f1b(
            _tstage, list(t[2]), t[0], t[1],
            lambda y, g: ((y - g) ** 2).mean(), stats=stats)
    np.testing.assert_allclose(loss.numpy(), want[0], atol=NET_ATOL)
    np.testing.assert_allclose(torch.stack(grads).numpy(),
                               want[1].reshape(8, *ws.shape[1:]),
                               atol=NET_ATOL)
    assert stats["peak_stash"] == [min(8 - r, M) for r in range(8)]


def test_pipeline_1f1b_stash_is_the_1f1b_bound():
    # fewer microbatches than stages: the slots are min(P, M), and a
    # stage never holds more than min(P - r, M)
    for P_, M in ((4, 2), (3, 7), (2, 5)):
        stats = {}
        ws = [torch.eye(4) * 0.5 for _ in range(P_)]
        tpipe.pipeline_train_1f1b(
            _tstage, ws, torch.ones(M, 2, 4), torch.zeros(M, 2, 4),
            lambda y, g: ((y - g) ** 2).mean(), stats=stats)
        assert stats["peak_stash"] == [min(P_ - r, M) for r in range(P_)]
        assert stats["ticks"] == 2 * M + 2 * P_ - 2


# ------------------------------------------------- the model vs the oracle


@functools.lru_cache(maxsize=None)
def _oracle(over: tuple = (), seed=0, tok_seed=1, batch=4, mb_oracle=0):
    """JAX's single-device loss and gradients (numpy) on the config with
    ``over``, its params and tokens; ``mb_oracle``: the mean of loss_fn
    over that many microbatch slices (JAX's MoE oracle)."""
    over = dict(over)
    jcfg = jtf.TransformerConfig(**{**CFG, **over})
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    toks = np.random.default_rng(tok_seed).integers(
        0, jcfg.vocab, (batch, 8), np.int32)
    tokens = jnp.asarray(toks)
    if mb_oracle:
        def fn(p):
            mbs = tokens.reshape(mb_oracle, -1, tokens.shape[-1])
            return sum(jtf.loss_fn(p, mb, jcfg) for mb in mbs) / mb_oracle
    else:
        def fn(p):
            return jtf.loss_fn(p, tokens, jcfg)
    loss, grads = jax.jit(jax.value_and_grad(fn))(jp)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return as_np(jp), toks, float(loss), as_np(grads)


PP_CASES = {
    # name: (config over, oracle over, mesh, microbatches, axes, kw)
    "pure_pp": ((), (), {"pp": 4}, 2, {}, {}),
    "dp_pp": ((), (), {"dp": 2, "pp": 2}, 2, {"axis_dp": "dp"}, {}),
    "fsdp_pp": ((), (), {"fsdp": 2, "pp": 2}, 2, {"axis_fsdp": "fsdp"}, {}),
    "dp_fsdp_pp": ((), (), {"dp": 2, "fsdp": 2, "pp": 2}, 1,
                   {"axis_dp": "dp", "axis_fsdp": "fsdp"}, {}),
    "gqa_pp": ((("n_heads", 4), ("n_kv_heads", 2)),) * 2
    + ({"pp": 2}, 2, {}, {}),
    "tp_pp": ((), (), {"pp": 2, "tp": 2}, 2, {"axis_tp": "tp"}, {}),
    "dp_tp_pp": ((), (), {"dp": 2, "pp": 2, "tp": 2}, 2,
                 {"axis_dp": "dp", "axis_tp": "tp"}, {}),
    "gqa_tp_pp": ((("n_heads", 4), ("n_kv_heads", 2)),) * 2
    + ({"pp": 2, "tp": 2}, 2, {"axis_tp": "tp"}, {}),
    "fsdp_tp_pp": ((), (), {"fsdp": 2, "pp": 2, "tp": 2}, 2,
                   {"axis_fsdp": "fsdp", "axis_tp": "tp"}, {}),
    "head_fallback_chunk16": ((("loss_chunk", 16),),) * 2
    + ({"pp": 2, "tp": 2}, 2, {"axis_tp": "tp"}, {}),
    "head_fallback_vocab33": ((("vocab", 33),),) * 2
    + ({"pp": 2, "tp": 2}, 2, {"axis_tp": "tp"}, {}),
    "fused_mlp": ((("mlp_impl", "fused"),), (), {"pp": 2}, 2, {},
                  {"atol": FUSED_ATOL}),
    "rope": ((("pos_embed", "rope"),),) * 2 + ({"pp": 2}, 2, {}, {}),
    "chunked_loss": ((("loss_chunk", 8),), (), {"pp": 4}, 2, {}, {}),
    "moe": ((("n_layers", 2), ("n_experts", 2), ("capacity_factor", 2.0)),)
    * 2 + ({"pp": 2}, 2, {}, {"seed": 2, "tok_seed": 3, "batch": 8,
                                "mb_oracle": 2}),
    "moe_dp": ((("n_layers", 2), ("n_experts", 2),
                ("capacity_factor", 2.0)),) * 2
    + ({"dp": 2, "pp": 2}, 2, {"axis_dp": "dp"},
       {"seed": 2, "tok_seed": 3, "batch": 8, "mb_oracle": 4}),
}


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pp_loss_and_grads_match_single_device_oracle(name):
    over, oracle_over, mesh, M, axes, kw = PP_CASES[name]
    kw = dict(kw)
    atol = kw.pop("atol", GRAD_ATOL)
    jp, toks, want_loss, want_g = _oracle(oracle_over, **kw)
    cfg = ttf.TransformerConfig(**{**CFG, **dict(over)})
    params = params_from_jax(jp, device="cpu")
    if "axis_fsdp" in axes:  # the stored form init_pp_train_state gives
        params["layers"] = tpp._place_fsdp(params["layers"], cfg, "fsdp",
                                           mesh["fsdp"])
        assert params["layers"]["wqkv"].shape[0] == mesh["fsdp"]
    stats = {}
    loss, grads = tpp.pp_loss_and_grads(
        params, torch.from_numpy(toks), cfg, mesh, microbatches=M,
        stats=stats, **axes)
    if "axis_fsdp" in axes:
        assert grads["layers"]["wqkv"].shape == \
            params["layers"]["wqkv"].shape
        grads["layers"] = tpp._gather_fsdp(grads["layers"], cfg, "fsdp",
                                           mesh["fsdp"])
    if cfg.pos_embed == "rope":
        assert "pos_embed" not in grads
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    for a, b in zip(ttrain.tree_leaves(grads), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), b, atol=atol)
    pp = mesh["pp"]
    assert stats["peak_stash"] == [min(pp - r, M) for r in range(pp)]


@pytest.mark.parametrize("over,mesh,match", [
    ({"n_experts": 2}, {"pp": 2, "tp": 2}, "MoE"),
    ({"n_heads": 1}, {"pp": 2, "tp": 2}, "divide"),
    ({"n_layers": 6}, {"pp": 4}, "divide")],
    ids=["moe_tp", "tp_indivisible", "layers_must_divide"])
def test_pp_refusals_in_jax_words(over, mesh, match):
    cfg = ttf.TransformerConfig(**{**CFG, **over})
    params = ttf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    axes = {"axis_tp": "tp"} if "tp" in mesh else {}
    with pytest.raises(ValueError, match=match):
        tpp.pp_loss_and_grads(params, toks, cfg, mesh, microbatches=2,
                              **axes)
    jcfg = jtf.TransformerConfig(**{**CFG, **over})
    jmesh = jtopo.make_mesh(mesh, jax.devices()[:int(np.prod(
        list(mesh.values())))])
    with pytest.raises(ValueError, match=match):
        jpp.pp_loss_and_grads(jtf.init_params(jax.random.PRNGKey(0), jcfg),
                              jnp.asarray(toks.numpy()), jcfg, jmesh,
                              microbatches=2, **axes)


def test_tp_permute_bit_equal_to_jax():
    jcfg = jtf.TransformerConfig(vocab=32, d_model=8, n_heads=4,
                                 n_kv_heads=2, n_layers=2, d_ff=16,
                                 max_seq=8, dtype="float32")
    cfg = ttf.TransformerConfig(**{k: getattr(jcfg, k) for k in (
        "vocab", "d_model", "n_heads", "n_kv_heads", "n_layers", "d_ff",
        "max_seq", "dtype")})
    w = np.random.default_rng(0).standard_normal(
        (2, 8, 8 + 2 * 4)).astype(np.float32)
    want = np.asarray(jpp.tp_permute_wqkv(jnp.asarray(w), jcfg, 2))
    got = tpp.tp_permute_wqkv(torch.from_numpy(w), cfg, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpp.tp_unpermute_wqkv(got, cfg, 2)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpp.tp_unpermute_wqkv(jnp.asarray(want),
                                                       jcfg, 2)))
    np.testing.assert_array_equal(back.numpy(), w)


@functools.lru_cache(maxsize=None)
def _jax_two_steps():
    """Two of JAX's unsharded train steps from the oracle's params."""
    jp, toks, _, _ = _oracle()
    jcfg = jtf.TransformerConfig(**CFG)
    opt = jtrain.make_optimizer()
    step = jtrain.make_train_step(jcfg, None, optimizer=opt)
    p = jax.tree.map(jnp.asarray, jp)
    state = opt.init(p)
    losses = []
    for _ in range(2):
        loss, p, state = step(p, state, jnp.asarray(toks))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("mesh,axes", [
    ({"pp": 2}, {}), ({"fsdp": 2, "pp": 2}, {"axis_fsdp": "fsdp"})],
    ids=["pp", "fsdp_pp"])
def test_two_pp_steps_match_jax_no_mesh_steps(mesh, axes):
    want_losses, want_p = _jax_two_steps()
    jp, toks, _, _ = _oracle()
    cfg = ttf.TransformerConfig(**CFG)
    params = params_from_jax(jp, device="cpu")
    if axes:
        params["layers"] = tpp._place_fsdp(params["layers"], cfg, "fsdp", 2)
    opt = ttrain.make_optimizer()
    state = opt.init(params)
    if axes:  # the moments live sharded, as the params
        assert state["mu"]["layers"]["w1"].shape == (2, 4, 8, 32)
        assert state["nu"]["layers"]["wo"].shape == (2, 4, 16, 8)
    step = tpp.make_pp_train_step(cfg, mesh, microbatches=2,
                                  optimizer=opt, **axes)
    losses = [step(params, state, torch.from_numpy(toks))[0].item()
              for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    if axes:
        params["layers"] = tpp._gather_fsdp(params["layers"], cfg, "fsdp",
                                            2)
    for a, b in zip(ttrain.tree_leaves(params), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=GRAD_ATOL)


# ------------------------------------------------------------- the app


APP = ["--device", "cpu", "--batch", "8", "--seq", "32", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--vocab", "64", "--attention",
       "flash"]


@pytest.mark.parametrize("flags,label", [
    (["--pp", "2", "--microbatches", "2", "--resume-check", "--generate",
      "4"], "train[pp=2 1f1b]"),
    (["--pp", "2", "--tp", "2", "--fsdp", "2", "--microbatches", "2",
      "--resume-check"], "train[pp=2 1f1b tp=2 fsdp=2]"),
    (["--pp", "2", "--dp", "2", "--mlp-impl", "fused"], "train[pp=2 1f1b]"),
    (["--pp", "2", "--n-experts", "4", "--microbatches", "2"],
     "train[pp=2 1f1b]")], ids=["pp", "pp-tp-fsdp", "dp-pp-fused", "moe"])
def test_train_app_pp(flags, label, tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    assert train_app.main(APP + ["--steps", "3", "--log", str(log)]
                          + flags) == 0
    out = capsys.readouterr().out
    assert label in out and out.strip().endswith("SUCCESS")
    if "--resume-check" in flags:
        (line,) = [ln for ln in out.splitlines() if "resume-check" in ln]
        a, b = line.rsplit("losses ", 1)[1].split(" vs ")
        assert a == b
    if "--generate" in flags:
        assert "--generate skipped (pp params are stage-local" in out
    (res,) = [json.loads(x) for x in log.read_text().splitlines()
              if '"result"' in x]
    assert res["name"] == "train_pp" and res["label"] == label[6:-1]


@pytest.mark.parametrize("flags,msg", [
    (["--pp", "2", "--accum", "2"], "--pp already micro-batches"),
    (["--pp", "3"], "--n-layers 2 must divide by --pp 3"),
    (["--pp", "2", "--microbatches", "3"],
     "must divide by --microbatches*--dp*--fsdp = 3"),
    (["--pp", "2", "--attention", "ring"], "stage-local attention"),
    (["--pp", "2", "--tp", "2", "--n-experts", "4"], "--pp --tp: pp x tp "
     "with MoE"),
    (["--pp", "2", "--sp", "2"], "no sp/ep axes")],
    ids=["accum", "layers", "batch", "ring", "tp-moe", "sp"])
def test_train_app_pp_refusals(flags, msg, capsys):
    assert train_app.main(APP + ["--steps", "1"] + flags) == 1
    out = capsys.readouterr().out
    assert "ERROR:" in out and msg in out and out.strip().endswith("FAILURE")


def test_launched_pp_dcn_dp_matches_one_process(tmp_path, capsys):
    # each process holds every pp rank of its dp block; the dp mean
    # crosses gloo, and the losses equal one process of dp 2 x pp 2
    argv = ["--steps", "2", "--batch", "8", "--seq", "32", "--d-model",
            "32", "--n-layers", "2", "--vocab", "128", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "hpc_patterns_tpu_torch.apps.launch",
           "-np", "2", "--cpu-devices-per-proc", "2", "--slices", "2", "--",
           sys.executable, "-m", "hpc_patterns_tpu_torch.apps.train_app",
           *argv, "--pp", "2", "--dcn-dp", "--dp", "-1"]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=240).stdout
    losses = [json.loads(ln.split("losses ", 1)[1]) for ln in
              out.splitlines() if "one flat allreduce" in ln]
    assert out.count("SUCCESS") >= 3 and len(losses) == 2, out
    assert losses[0] == losses[1] and "dcn-dp=2" in out
    log = tmp_path / "one.jsonl"
    assert train_app.main(argv + ["--pp", "2", "--dp", "2", "--log",
                                  str(log)]) == 0
    capsys.readouterr()
    (res,) = [json.loads(x) for x in log.read_text().splitlines()
              if '"result"' in x]
    np.testing.assert_allclose(losses[0], [res["loss_first"],
                                           res["loss_last"]], rtol=1e-4)
