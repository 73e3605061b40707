"""dp, fsdp and tp as logical ranks of one device (``models/sharding.py``,
the mesh branches of ``models/transformer.py`` and ``models/train.py``,
``utils/checkpoint.py``'s sharded state, ``topology``'s meshes,
``train_app --dp/--fsdp/--tp/--dcn-dp`` in one process and across
launched processes) against the JAX package on the CPU; MoE on dp/ep and
dp/fsdp meshes against JAX's per-shard routing.

The JAX side runs its UNSHARDED path (its own tests hold that equal to
its mesh), so no JAX mesh is compiled; the layout check places JAX params
with ``device_put`` on the 8-device CPU mesh and compiles nothing.
Inputs come from seeds through numpy. Tolerances (f32 on both sides; the
tp ranks' partial products are summed in another order than one GEMM's,
the vocab-sharded log-sum-exp in another association): loss rtol 1e-5,
gradients atol 1e-5, one train step's params atol 2e-6 (a step of lr
3e-4 times Adam's g/|g|, from gradients within 1e-5; where |g| <= 1e-4
that ratio is not pinned by the gradients' tolerance, and the step's
size, 2 lr, bounds it), the global norm
rtol 1e-6; layouts, the sharded resume and every in-port equality bit
for bit. Launched runs: each process's losses against one process's on
the same global batch within rtol 1e-4 (the gradient mean crosses gloo
as a sum of two process means, in another order than one GEMM's rows;
Adam's first update is g/|g| elementwise, so a near-zero element's
rounding moves a whole lr-sized step).
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
import optax  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu import topology as jtopo  # noqa: E402
from hpc_patterns_tpu.models import sharding as jsh  # noqa: E402
from hpc_patterns_tpu.models import train as jtrain  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch import topology as ttopo  # noqa: E402
from hpc_patterns_tpu_torch.apps import train_app  # noqa: E402
from hpc_patterns_tpu_torch.models import sharding as tsh  # noqa: E402
from hpc_patterns_tpu_torch.models import train as ttrain  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import params_from_jax  # noqa: E402
from hpc_patterns_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab=256, d_model=64, n_heads=8, n_layers=2, d_ff=256,
             max_seq=32, dtype="float32")
B, T = 8, 32
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
STEP_ATOL = 2e-6
LR = 3e-4  # make_optimizer's default, both sides
LAUNCH_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its models are small,
    and under a parallel test run a thread pool spun across cores the
    other workers hold slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (B, T),
                                                np.int32)


@functools.lru_cache(maxsize=None)
def _jax_ref(n_kv_heads=0):
    """JAX's dense unsharded loss, gradients and one train step (cached:
    every mesh case of a config shares them), as numpy, with the params
    they start from."""
    jcfg = jtf.TransformerConfig(**SMALL, n_kv_heads=n_kv_heads)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = jnp.asarray(_tokens())
    loss, grads = jax.value_and_grad(jtf.loss_fn)(jp, tokens, jcfg)
    opt = jtrain.make_optimizer()
    step = jtrain.make_train_step(jcfg, None, optimizer=opt)
    copy = jax.tree.map(jnp.array, jp)
    _, new_p, _ = step(copy, opt.init(copy), tokens)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return (as_np(jp), float(loss), as_np(grads), as_np(new_p),
            float(optax.global_norm(grads)))


def _port(jp_np, mesh, **kw):
    """The port's config, and the JAX params as the port's sharded tree
    (requiring grad)."""
    cfg = ttf.TransformerConfig(**SMALL, **kw)
    params = tsh.shard_params(params_from_jax(jp_np, device="cpu"), mesh,
                              cfg)
    for p in ttrain.tree_leaves(params):
        p.requires_grad_(True)
    return cfg, params


# ------------------------------------------------------------- the table

@pytest.mark.parametrize("fsdp", [False, True], ids=["no-fsdp", "fsdp"])
@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_param_specs_equal_jax_table(fsdp, moe):
    kw = dict(SMALL, fsdp=fsdp, n_experts=moe)
    want = jax.tree.map(tuple, jsh.param_specs(jtf.TransformerConfig(**kw)),
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))
    assert tsh.param_specs(ttf.TransformerConfig(**kw)) == want
    cfg = ttf.TransformerConfig(**kw)
    assert tsh.batch_spec(cfg) == ((("dp", "fsdp") if fsdp else ("dp",)),
                                   "sp")


def test_shard_params_equal_jax_addressable_shards():
    mesh = {"dp": 2, "fsdp": 2, "tp": 2}
    kw = dict(SMALL, fsdp=True)
    jcfg = jtf.TransformerConfig(**kw)
    jmesh = jtopo.make_mesh(mesh, jax.devices()[:8])
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    placed = jsh.shard_params(jp, jmesh, jcfg)
    cfg = ttf.TransformerConfig(**kw)
    tp = tsh.shard_params(params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu"), mesh, cfg)
    names = list(jmesh.axis_names)
    for dev in jmesh.devices.flat:
        coord = dict(zip(names, np.argwhere(jmesh.devices == dev)[0]))
        mine = tsh.param_shard_at(tp, mesh, cfg, coord)
        for (path, arr), got in zip(
                jax.tree_util.tree_flatten_with_path(placed)[0],
                ttrain.tree_leaves(mine)):
            (shard,) = [s for s in arr.addressable_shards
                        if s.device == dev]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{path} at {coord}")
    # stored once: a dp replica is no copy, the shards hold each element
    assert tp["layers"]["wqkv"].shape == (2, 2, 2, 32, 96)
    assert tp["ln_f_scale"].shape == (64,)
    back = tsh.unshard_params(tp, mesh, cfg)
    for a, b in zip(ttrain.tree_leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------- loss, gradients, one step

MESHES = [
    ({"dp": 2, "sp": 2, "tp": 2}, dict(attention="ring")),
    ({"dp": 2, "sp": 2, "tp": 2}, dict(attention="ulysses")),
    ({"dp": 2, "fsdp": 2, "tp": 2}, dict(attention="flash", fsdp=True,
                                         mlp_impl="fused", loss_chunk=64)),
    ({"fsdp": 8}, dict(attention="flash", fsdp=True)),
]


@pytest.mark.parametrize("mesh,kw", MESHES,
                         ids=["dp-sp-tp-ring", "dp-sp-tp-ulysses",
                              "dp-fsdp-tp", "fsdp8"])
def test_loss_grads_and_step_match_jax_dense(mesh, kw):
    jp, jloss, jgrads, jnew, _ = _jax_ref()
    cfg, params = _port(jp, mesh, **kw)
    tokens = torch.from_numpy(_tokens())
    leaves = ttrain.tree_leaves(params)
    loss = ttf.loss_fn(params, tokens, cfg, mesh)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    g_tree = ttrain.tree_map(lambda p: grads[id(p)], params)
    for a, b in zip(ttrain.tree_leaves(tsh.unshard_params(g_tree, mesh,
                                                          cfg)),
                    jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL)
    # one step on the sharded state: moments in the params' layout
    opt = ttrain.make_optimizer()
    state = opt.init(params)
    assert state["mu"]["layers"]["w1"].shape == \
        params["layers"]["w1"].shape
    step = ttrain.make_train_step(cfg, opt, mesh=mesh)
    step_loss, params, _ = step(params, state, tokens)
    np.testing.assert_allclose(step_loss.item(), jloss, rtol=LOSS_RTOL)
    for a, b, g in zip(ttrain.tree_leaves(tsh.unshard_params(params, mesh,
                                                             cfg)),
                       jax.tree.leaves(jnew), jax.tree.leaves(jgrads)):
        # Adam's first step is lr g/(|g| + eps): where |g| is within ten
        # gradient tolerances of 0, only the step's size bounds it
        tol = np.where(np.abs(g) > 10 * GRAD_ATOL, STEP_ATOL, 2 * LR)
        assert np.all(np.abs(a.detach().numpy() - b) <= tol)


@pytest.mark.parametrize("n_kv,tp", [(2, 2), (4, 2), (2, 4)],
                         ids=["kv2-tp2", "kv4-tp2", "kv2-tp4-expanded"])
def test_gqa_under_tp_matches_jax_dense(n_kv, tp):
    # tp 4 does not divide kv_heads 2: K/V expand to every head first
    jp, jloss, jgrads, _, _ = _jax_ref(n_kv)
    mesh = {"tp": tp}
    cfg, params = _port(jp, mesh, attention="flash", n_kv_heads=n_kv)
    leaves = ttrain.tree_leaves(params)
    loss = ttf.loss_fn(params, torch.from_numpy(_tokens()), cfg, mesh)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    grads = torch.autograd.grad(loss, leaves)
    g_tree = ttrain.tree_map(dict(zip(map(id, leaves), grads)).__getitem__,
                             ttrain.tree_map(id, params))
    for a, b in zip(ttrain.tree_leaves(tsh.unshard_params(g_tree, mesh,
                                                          cfg)),
                    jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL)


MOE = dict(n_experts=4, n_experts_top_k=2, capacity_factor=1.0)
MOE_BLOCKS = 4  # the token shards of both MoE meshes: B / 4 rows each


@functools.lru_cache(maxsize=None)
def _jax_moe_blocks():
    """JAX's MoE loss and gradients on a dp/fsdp mesh, as numpy: its
    ``_moe_block`` routes each token shard alone (capacity per shard)
    and means the aux loss over the batch axes, and every other op is
    per row, so its mesh loss is the mean of its unsharded loss over the
    row blocks of the shards (the same to 1.5e-7 in the gradients against
    JAX's shard_map on the 8-device mesh at this config; the unsharded
    loss over all 8 rows differs by 0.04). One compile, every block."""
    jcfg = jtf.TransformerConfig(**SMALL, **MOE)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    f = jax.jit(jax.value_and_grad(lambda p, t: jtf.loss_fn(p, t, jcfg)))
    tokens = _tokens()
    rows = B // MOE_BLOCKS
    outs = [f(jp, jnp.asarray(tokens[i * rows:(i + 1) * rows]))
            for i in range(MOE_BLOCKS)]
    grads = [np.mean([np.asarray(jax.tree.leaves(o[1])[j]) for o in outs],
                     axis=0) for j in range(len(jax.tree.leaves(jp)))]
    whole = float(jax.jit(lambda p, t: jtf.loss_fn(p, t, jcfg))(
        jp, jnp.asarray(tokens)))
    return (jax.tree.map(np.asarray, jp),
            float(np.mean([float(o[0]) for o in outs])), grads, whole)


@pytest.mark.parametrize("mesh,kw", [
    ({"dp": 2, "ep": 2}, {}), ({"dp": 2, "fsdp": 2}, dict(fsdp=True))],
    ids=["dp-ep", "dp-fsdp"])
def test_moe_on_data_meshes_matches_jax(mesh, kw):
    # the token shards range over the batch axes x ep: four shards of
    # two rows, each with its own capacity, as JAX's mesh routes them
    jp, jloss, jgrads, jwhole = _jax_moe_blocks()
    cfg, params = _port(jp, mesh, **MOE, **kw)
    leaves = ttrain.tree_leaves(params)
    loss = ttf.loss_fn(params, torch.from_numpy(_tokens()), cfg, mesh)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    assert abs(loss.item() - jwhole) > 100 * LOSS_RTOL * jloss
    grads = torch.autograd.grad(loss, leaves)
    g_tree = ttrain.tree_map(dict(zip(map(id, leaves), grads)).__getitem__,
                             ttrain.tree_map(id, params))
    got = ttrain.tree_leaves(tsh.unshard_params(g_tree, mesh, cfg))
    assert len(got) == len(jgrads)
    for a, b in zip(got, jgrads):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL)


def test_global_clip_norm_counts_each_element_once():
    jp, _, _, _, jnorm = _jax_ref()
    mesh = {"dp": 2, "fsdp": 2, "tp": 2}
    cfg, params = _port(jp, mesh, fsdp=True)
    leaves = ttrain.tree_leaves(params)
    grads = torch.autograd.grad(
        ttf.loss_fn(params, torch.from_numpy(_tokens()), cfg, mesh), leaves)
    norm = ttrain.global_sq_norm(list(grads)).sqrt().item()
    np.testing.assert_allclose(norm, jnorm, rtol=1e-6)
    # the layout stores each element once: a leaf replicated over dp (or
    # tp) has no rank dim, so the stored gradients hold the model's count
    assert sum(g.numel() for g in grads) == \
        sum(np.size(a) for a in jax.tree.leaves(jp))
    # ... and a shard-local norm (rank 0's shards only) is not the norm
    g_tree = ttrain.tree_map(dict(zip(map(id, leaves), grads)).__getitem__,
                             ttrain.tree_map(id, params))
    local = ttrain.tree_leaves(tsh.param_shard_at(g_tree, mesh, cfg, {}))
    assert ttrain.global_sq_norm(local).sqrt().item() < 0.9 * norm


def test_sharded_checkpoint_round_trip_bit_for_bit(tmp_path):
    mesh = {"dp": 2, "fsdp": 2, "tp": 2}
    cfg = ttf.TransformerConfig(**SMALL, fsdp=True, attention="flash")
    gen = torch.Generator().manual_seed(0)
    params, state = ttrain.init_train_state(gen, cfg, device="cpu",
                                            mesh=mesh)
    step = ttrain.make_train_step(cfg, mesh=mesh)
    tokens = torch.from_numpy(_tokens())
    step(params, state, tokens)
    layout = tsh.state_layout(mesh, cfg)
    path = tckpt.save_checkpoint(tmp_path, params, state, step=1,
                                 layout=layout)
    saved, _ = tckpt.restore_params(tmp_path)
    assert saved["layers"]["wqkv"].shape == (2, 64, 192)  # global
    r_params, r_state, r_step = tckpt.restore_checkpoint(
        tmp_path, params, state, layout=layout)
    assert r_step == 1 and Path(path).is_dir()
    for a, b in zip(ttrain.tree_leaves({"p": params, **state}),
                    ttrain.tree_leaves({"p": r_params, **r_state})):
        if torch.is_tensor(a):
            assert a.shape == b.shape and torch.equal(a.detach(), b.detach())
        else:
            assert a == b  # the update count
    la = step(params, state, tokens)[0].item()
    lb = step(r_params, r_state, tokens)[0].item()
    assert la == lb


def test_topology_meshes_and_slices():
    assert ttopo.make_mesh({"dp": -1, "tp": 2}, 8) == {"dp": 4, "tp": 2}
    with pytest.raises(ttopo.TopologyError, match="do not divide"):
        ttopo.make_mesh({"tp": 3}, 8)
    env = {ttopo.ENV_PROCESS_ID: "1", ttopo.ENV_NUM_PROCESSES: "2",
           ttopo.ENV_SLICE_GROUPING: "process:0,1"}
    groups = ttopo.group_by_slice(2, env)
    assert groups == {0: [0, 1], 1: [2, 3]}
    assert ttopo.make_hybrid_mesh({"dp": -1}, {"sp": 1, "tp": 2}, groups) \
        == {"dp": 2, "sp": 1, "tp": 2}
    assert ttopo.group_by_slice(4, {}) == {0: [0, 1, 2, 3]}


# ------------------------------------------------ launched processes

LAUNCH_APP = ["--steps", "2", "--seq", "32", "--d-model", "32",
              "--n-layers", "1", "--vocab", "128", "--device", "cpu"]


def _launched(flags, tmp_path, slices=0):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "hpc_patterns_tpu_torch.apps.launch",
           "-np", "2", "--cpu-devices-per-proc", "2"]
    if slices:
        cmd += ["--slices", str(slices)]
    cmd += ["--", sys.executable, "-m",
            "hpc_patterns_tpu_torch.apps.train_app", *LAUNCH_APP, *flags]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=240).stdout
    losses = [json.loads(ln.split("losses ", 1)[1]) for ln in
              out.splitlines() if "one flat allreduce" in ln]
    return out, losses


@pytest.mark.parametrize("flags,slices,one", [
    (["--dp", "4", "--batch", "8"], 0, ["--dp", "4", "--batch", "8"]),
    (["--dcn-dp", "--dp", "-1", "--tp", "2", "--batch", "4"], 2,
     ["--dp", "2", "--tp", "2", "--batch", "4"])], ids=["dp4", "dcn-dp"])
def test_launched_dp_matches_one_process(flags, slices, one, tmp_path,
                                         capsys):
    out, losses = _launched(flags, tmp_path, slices)
    assert out.count("SUCCESS") >= 3 and len(losses) == 2, out
    assert losses[0] == losses[1]  # every process applies one update
    assert "gloo over host memory" in out
    if slices:
        assert "dcn-dp=2" in out
    log = tmp_path / "one.jsonl"
    assert train_app.main(LAUNCH_APP + one + ["--log", str(log)]) == 0
    capsys.readouterr()
    (res,) = [json.loads(x) for x in log.read_text().splitlines()
              if '"result"' in x]
    np.testing.assert_allclose(losses[0], [res["loss_first"],
                                           res["loss_last"]],
                               rtol=LAUNCH_RTOL)
