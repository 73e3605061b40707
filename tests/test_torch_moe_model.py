"""The port's MoE transformer and its logical-rank meshes against the JAX
package on the CPU: parameters carried across by ``models/convert.py``,
``loss_fn`` and its gradients with no mesh, on ``{"ep": 4}`` and on
``{"sp": 2, "ep": 2}`` with each sharded attention, ``moe_drop_rates``,
greedy ``generate`` / ``paged_generate`` tokens, one optimizer step,
training that learns, and ``train_app``'s MoE and mesh flags (and the ones
that still refuse).

JAX runs its meshes over the 8-device CPU mesh (conftest), its flash
routes in interpret mode; the port runs the same ranks stacked on one
tensor. Tolerances (f32 on both sides, only summation orders differ;
capacities are computed per local shard on both, so the same tokens
drop): loss rtol 2e-5 (JAX's own bound between its ep and dense losses),
gradients atol 2e-5, drop rates exactly (counts over the same totals),
greedy tokens equal, one update atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu import topology as jtopo  # noqa: E402
from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import train as jtrain  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.apps import train_app  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import train as ttrain  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    opt_state_from_jax,
    params_from_jax,
)

MOE_TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=32, dtype="float32", n_experts=4)
LOSS_RTOL = 2e-5
GRAD_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its models are tiny,
    and under a parallel test run a worker's thread pool spinning on
    cores the other workers hold made each op milliseconds long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**kw):
    fields = {**MOE_TINY, **kw}
    jcfg = jtf.TransformerConfig(**fields)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, ttf.TransformerConfig(**fields), jp,
            params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))


def _tokens(B, T=16, seed=1, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, T), np.int32)


def _jmesh(mesh):
    n = int(np.prod(list(mesh.values())))
    return jtopo.make_mesh(mesh, jax.devices()[:n])


def _jloss(jp, tokens, jcfg, mesh=None):
    m = None if mesh is None else _jmesh(mesh)
    return jax.jit(lambda p, t: jtf.loss_fn(p, t, jcfg, m))(
        jp, jnp.asarray(tokens))


def test_convert_carries_expert_leaves():
    jcfg, tcfg, jp, tp = _pair(n_experts_top_k=2)
    L, D, F, E = 2, 32, 64, 4
    for name, shape in (("router", (L, D, E)), ("w1", (L, E, D, F)),
                        ("w2", (L, E, F, D))):
        assert tuple(tp["layers"][name].shape) == shape
        np.testing.assert_array_equal(tp["layers"][name].numpy(),
                                      np.asarray(jp["layers"][name]))
    fresh = ttf.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh["layers"].items()} == \
        {k: tuple(v.shape) for k, v in tp["layers"].items()}
    # the draws keep JAX's scales
    for name in ("router", "w1", "w2"):
        assert fresh["layers"][name].std().item() == pytest.approx(
            tp["layers"][name].std().item(), rel=0.1)


@pytest.mark.parametrize("mesh,attention,B,kw,grads", [
    (None, "full", 2, {}, True),
    (None, "flash", 2, {"n_experts_top_k": 2, "moe_dispatch": "scatter"},
     True),
    (None, "full", 2, {"capacity_factor": 0.5}, False),
    ({"ep": 4}, "full", 4, {}, False),
    ({"ep": 4}, "full", 4, {"n_experts_top_k": 2, "capacity_factor": 0.5,
                            "moe_dispatch": "scatter"}, False),
    ({"sp": 2, "ep": 2}, "ring", 4, {}, False),
    ({"sp": 2, "ep": 2}, "ring_flash", 4, {"n_experts_top_k": 2}, True),
    ({"sp": 2, "ep": 2}, "ulysses", 4, {"capacity_factor": 0.5}, False),
    ({"sp": 2, "ep": 2}, "ulysses_flash", 2, {"pos_embed": "rope"}, False),
])
def test_loss_and_grads_match_jax(mesh, attention, B, kw, grads):
    jcfg, tcfg, jp, tp = _pair(attention=attention, **kw)
    tokens = _tokens(B)
    jm = None if mesh is None else _jmesh(mesh)
    leaves = ttrain.tree_leaves(tp)
    if not grads:
        want = jax.jit(lambda p, t: jtf.loss_fn(p, t, jcfg, jm))(
            jp, jnp.asarray(tokens))
        got = ttf.loss_fn(tp, torch.from_numpy(tokens), tcfg, mesh)
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
        return
    want, jg = jax.jit(jax.value_and_grad(
        lambda p, t: jtf.loss_fn(p, t, jcfg, jm)))(jp, jnp.asarray(tokens))
    for p in leaves:
        p.requires_grad_(True)
    got = ttf.loss_fn(tp, torch.from_numpy(tokens), tcfg, mesh)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for g, w in zip(torch.autograd.grad(got, leaves), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL)


def test_ep_only_mesh_matches_dense_oracle():
    # drop-free capacity: the routing cannot depend on the token sharding
    _, tcfg, _, tp = _pair(capacity_factor=8.0, n_experts_top_k=2)
    tokens = torch.from_numpy(_tokens(4))
    want = ttf.loss_fn(tp, tokens, tcfg).item()
    for mesh in ({"ep": 4}, {"ep": 2}, {"ep": 1, "sp": 1}):
        got = ttf.loss_fn(tp, tokens, tcfg, mesh).item()
        # the aux is averaged over shards, the NLL is not touched
        tx, _ = ttf.forward_hidden(tp, tokens, tcfg, mesh)
        wx, _ = ttf.forward_hidden(tp, tokens, tcfg)
        torch.testing.assert_close(tx, wx, rtol=2e-5, atol=2e-5)
        assert abs(got - want) < 0.01 * 0.1  # moe_aux_weight x aux drift


def test_replicated_routing_warns():
    jcfg, tcfg, jp, tp = _pair(capacity_factor=8.0)
    tokens = _tokens(2)
    with pytest.warns(UserWarning, match="routing runs replicated"):
        want = float(_jloss(jp, tokens, jcfg, {"ep": 4}))
    with pytest.warns(UserWarning, match="routing runs replicated"):
        got = ttf.loss_fn(tp, torch.from_numpy(tokens), tcfg, {"ep": 4})
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", [None, {"ep": 4}, {"sp": 2, "ep": 2}])
def test_drop_rates_match_jax(mesh):
    tokens = _tokens(4)
    for cf in (0.3, 8.0):
        jcfg, tcfg, jp, tp = _pair(
            capacity_factor=cf, n_experts_top_k=2,
            attention="ring" if mesh and "sp" in mesh else "full")
        m = None if mesh is None else _jmesh(mesh)
        want = np.asarray(jax.jit(lambda p, t: jtf.moe_drop_rates(
            p, t, jcfg, m))(jp, jnp.asarray(tokens)))
        got = ttf.moe_drop_rates(tp, torch.from_numpy(tokens), tcfg, mesh)
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
        assert (want.max() > 0) == (cf < 1)
    with pytest.raises(ValueError, match="MoE"):
        ttf.moe_drop_rates(tp, torch.from_numpy(tokens),
                           dataclasses.replace(tcfg, n_experts=0))


@pytest.mark.parametrize("top_k", [1, 2])
def test_generate_tokens_equal_jax(top_k):
    jcfg, tcfg, jp, tp = _pair(n_experts_top_k=top_k, max_seq=64)
    prompt = _tokens(2, 20, seed=top_k)
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                           10))
    got = tdec.greedy_generate(tp, torch.from_numpy(prompt), tcfg, 10,
                               device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    paged = tdec.paged_generate(tp, torch.from_numpy(prompt), tcfg, 10,
                                page_size=16, device="cpu")
    np.testing.assert_array_equal(paged.numpy(), want)
    jpaged = np.asarray(jdec.paged_generate(
        jp, jnp.asarray(prompt), dataclasses.replace(
            jcfg, decode_attn="gather"), 10, page_size=16))
    np.testing.assert_array_equal(jpaged, want)


def test_one_step_matches_jax():
    jcfg, tcfg, jp, tp = _pair(n_experts_top_k=2)
    tokens = _tokens(4)
    jopt = jtrain.make_optimizer(1e-2)
    jstate = jopt.init(jp)
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    jstep = jtrain.make_train_step(jcfg, optimizer=jopt)  # donates
    jloss, jp2, _ = jstep(jp, jstate, jnp.asarray(tokens))
    opt = ttrain.make_optimizer(1e-2)
    leaves = ttrain.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    g = torch.autograd.grad(ttf.loss_fn(tp, torch.from_numpy(tokens), tcfg),
                            leaves)  # held to JAX's by the test above
    loss, tp2, _ = ttrain.make_train_step(tcfg, optimizer=opt)(
        tp, state, torch.from_numpy(tokens))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    # Adam's first step is lr * g / (|g| + 1e-8): where |g| is within a
    # few 1e-8 of zero (an expert few tokens reach), f32 summation noise
    # in g moves the step by up to lr; elsewhere it moves it by < 1e-6
    for a, b, gj in zip(ttrain.tree_leaves(tp2), jax.tree.leaves(jp2), g):
        a, b, big = a.detach().numpy(), np.asarray(b), gj.abs().numpy() > 1e-5
        np.testing.assert_allclose(a[big], b[big], atol=1e-6)
        np.testing.assert_allclose(a, b, atol=2e-2)


@pytest.mark.parametrize("mesh,attention", [
    ({"sp": 2, "ep": 2}, "ring"), ({"ep": 2}, "full")])
def test_training_learns(mesh, attention):
    cfg = ttf.TransformerConfig(**{**MOE_TINY, "attention": attention,
                                   "n_experts_top_k": 2})
    gen = torch.Generator().manual_seed(0)
    params, opt = ttrain.init_train_state(gen, cfg, device="cpu", mesh=mesh)
    step = ttrain.make_train_step(cfg, mesh=mesh)
    tokens = ttrain.make_batch(gen, cfg, 4, 16, device="cpu")
    losses = []
    for _ in range(4):
        loss, params, opt = step(params, opt, tokens)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("mesh,err", [
    ({"dp": 2}, None), ({"tp": 2}, None), ({"fsdp": 2, "sp": 2}, None),
    ({"data": 2}, ValueError)])
def test_unported_meshes_raise(mesh, err):
    # dp, tp and fsdp now run as logical ranks; an undeclared axis still
    # raises. dp: each row block routes alone (capacity per shard), so
    # the loss is the mean of the halves' losses; tp leaves the MoE
    # routing whole; fsdp without cfg.fsdp replicates (the sp loss)
    _, tcfg, _, tp = _pair()
    tokens = torch.from_numpy(_tokens(2))
    if err is not None:
        with pytest.raises(err):
            ttf.loss_fn(tp, tokens, tcfg, mesh)
        with pytest.raises(err):
            ttrain.make_train_step(tcfg, mesh=mesh)
        return
    with torch.no_grad():
        got = ttf.loss_fn(tp, tokens, tcfg, mesh).item()
        if "dp" in mesh:
            want = np.mean([ttf.loss_fn(tp, tokens[i:i + 1], tcfg).item()
                            for i in range(tokens.shape[0])])
        else:
            want = ttf.loss_fn(tp, tokens, tcfg,
                               {"sp": mesh.get("sp", 1)}).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ttrain.make_train_step(tcfg, mesh=mesh)


def test_flash_refuses_a_sharded_sequence():
    _, tcfg, _, tp = _pair(attention="flash")
    with pytest.raises(ValueError, match="ring_flash"):
        ttf.loss_fn(tp, torch.from_numpy(_tokens(2)), tcfg, {"sp": 2})


APP = ["--device", "cpu", "--batch", "4", "--seq", "16", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--vocab", "64"]


def test_train_app_moe_on_a_mesh(tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    rc = train_app.main(APP + [
        "--steps", "3", "--n-experts", "4", "--ep", "2", "--sp", "2",
        "--attention", "ring", "--drop-rate-every", "2", "--generate", "4",
        "--log", str(log)])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("SUCCESS"), out
    assert "logical ranks of one device" in out
    import json

    recs = [json.loads(x) for x in log.read_text().splitlines()]
    steps = [r for r in recs if r.get("kind") == "step"]
    assert [("moe_drop_rate" in r) for r in steps] == [True, False, True]
    (res,) = [r for r in recs if r.get("kind") == "result"]
    assert res["mesh"] == {"sp": 2, "ep": 2}
    assert res["mesh_ranks"] == "logical ranks of one device"


@pytest.mark.parametrize("flag", [
    ["--n-experts", "4", "--n-experts-top-k", "2", "--moe-dispatch",
     "scatter"],
    ["--attention", "ulysses_flash", "--sp", "4"],
    ["--attention", "ring_flash", "--sp", "2", "--n-experts", "4",
     "--ep", "4"]])
def test_train_app_runs(flag, capsys):
    assert train_app.main(APP + ["--steps", "2"] + flag) == 0
    assert capsys.readouterr().out.strip().endswith("SUCCESS")


@pytest.mark.parametrize("flag,msg", [
    (["--dp", "3"], "divide"), (["--fsdp", "3"], "divide"),
    (["--tp", "3"], "divide"),
    (["--pp", "2", "--n-experts", "4", "--ep", "2"], "no sp/ep axes"),
    (["--dcn-dp", "--dp", "2"], "slice count 1"), (["--ep", "2"], "requires"),
    (["--n-experts", "3", "--ep", "2"], "divide"),
    (["--attention", "flash", "--sp", "2"], "ring_flash")])
def test_train_app_refusals(flag, msg, capsys):
    # dp/fsdp/tp/dcn-dp run as logical ranks now: what they refuse is a
    # size that does not divide (batch 4, heads 4) and, in one process,
    # --dcn-dp with a dp other than the one slice
    assert train_app.main(APP + ["--steps", "1"] + flag) == 1
    out = capsys.readouterr().out
    assert "ERROR:" in out and msg in out and out.strip().endswith("FAILURE")
    if msg == "no sp/ep axes":  # JAX's refusal of ep inside pp stages
        assert "--pp composes with" in out
