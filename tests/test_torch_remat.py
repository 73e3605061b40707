"""The fused MLP and activation checkpointing on the port's training path
(``hpc_patterns_tpu_torch.models.transformer``: ``mlp_impl``, ``remat``,
``remat_policy``) against the JAX package on the CPU, and decode of a
fused-MLP config.

Inputs come from seeds through numpy; JAX params cross with
``params_from_jax``. The JAX side runs its Pallas kernels (flash, fused
MLP) in interpret mode. Tolerances as ``tests/test_torch_train.py``: f32
on both sides, loss rtol 1e-5, gradients atol 1e-5, a 3-step trajectory
rtol 1e-5. Within the port every policy equals the run without
checkpointing bit for bit (the recompute repeats the same CPU ops on the
same inputs).

Where the forward reruns: a checkpointed region recomputes in the
backward, and a kernel inside one always reruns (its outputs are no op a
policy can keep), so ``fused_mlp`` and ``flash_attention`` run their
forward twice per layer and gradient pass under "nothing", "attn", "dots"
and "dots_attn", and once under "split", which keeps both outside every
region — JAX's documented behaviour, shown here with the ``calls``
counters.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

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
from hpc_patterns_tpu_torch.ops import flash_attention as fa  # noqa: E402
from hpc_patterns_tpu_torch.ops import fused_mlp as fm  # noqa: E402

SMALL = dict(vocab=128, d_model=32, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, dtype="float32")
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
POLICIES = [None, "nothing", "attn", "dots", "dots_attn", "split"]
MLPS = ["dense", "fused"]


def _remat_kw(policy):
    return ({} if policy is None
            else {"remat": True, "remat_policy": policy})


def _pair(**kw):
    fields = {**SMALL, **kw}
    return jtf.TransformerConfig(**fields), ttf.TransformerConfig(**fields)


def _params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, B=2, T=64, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (B, T), np.int32)


def _port_loss_grads(tp, tokens, tcfg):
    leaves = ttrain.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttf.loss_fn(tp, torch.from_numpy(tokens), tcfg)
    return loss, torch.autograd.grad(loss, leaves)


CASES = ([(m, p, "full") for m in MLPS for p in POLICIES]
         + [(m, "split", "flash") for m in MLPS])


@pytest.mark.parametrize("mlp,policy,attention", CASES,
                         ids=[f"{m}-{p or 'no_remat'}-{a}"
                              for m, p, a in CASES])
def test_loss_and_grads_match_jax(mlp, policy, attention):
    jcfg, tcfg = _pair(mlp_impl=mlp, attention=attention,
                       **_remat_kw(policy))
    jp, tp = _params(jcfg)
    tokens = _tokens(1)
    jl, jg = jax.value_and_grad(jtf.loss_fn)(jp, jnp.asarray(tokens), jcfg)
    tl, tg = _port_loss_grads(tp, tokens, tcfg)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    for a, b in zip(tg, jax.tree.leaves(jg)):  # both in sorted-key order
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


class _CountOps(TorchDispatchMode):
    """Counts the ops that actually execute (a policy's saved outputs
    come from the checkpoint's cache and never reach this mode)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mlp", MLPS)
@pytest.mark.parametrize("attention", ["full", "flash"])
def test_each_policy_equals_no_remat_and_reruns_where_jax_does(mlp,
                                                               attention):
    jcfg, tcfg = _pair(mlp_impl=mlp, attention=attention)
    _, tp = _params(jcfg)
    tokens = _tokens(2)
    L = tcfg.n_layers
    want = None
    mm = torch.ops.aten.mm.default
    tag = torch.ops.hpcpat.attn_out.default
    backward_ops = {}
    for policy in POLICIES:
        cfg = ttf.TransformerConfig(**{**SMALL, "mlp_impl": mlp,
                                       "attention": attention,
                                       **_remat_kw(policy)})
        before = (fm.calls["forward"], fa.calls["forward"])
        leaves = ttrain.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = ttf.loss_fn(tp, torch.from_numpy(tokens), cfg)
        with _CountOps() as ops:
            grads = torch.autograd.grad(loss, leaves)
        backward_ops[policy] = ops.counts
        got = (loss, grads)
        if want is None:
            want = got
        assert torch.equal(got[0], want[0]), policy
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), \
            policy
        reruns = 1 if policy in (None, "split") else 2
        ran = (fm.calls["forward"] - before[0], fa.calls["forward"] - before[1])
        assert ran == (L * reruns if mlp == "fused" else 0,
                       L * reruns if attention == "flash" else 0), policy
    # the policies keep what they name: "dots" recomputes no 2-D product
    # (the cache hands them back), "attn" does not rerun the named copy
    assert backward_ops["dots"].get(mm, 0) < backward_ops["nothing"][mm]
    assert backward_ops["dots"].get(mm, 0) == backward_ops[None].get(mm, 0)
    assert backward_ops["dots_attn"].get(mm, 0) == backward_ops["dots"].get(
        mm, 0)
    assert tag not in backward_ops["attn"]
    assert tag not in backward_ops[None] and tag not in backward_ops["split"]


def test_remat_is_off_without_gradients():
    jcfg, _ = _pair()
    _, tp = _params(jcfg)
    cfg = ttf.TransformerConfig(**SMALL, remat=True, remat_policy="attn")
    tokens = torch.from_numpy(_tokens(3))
    with _CountOps() as ops, torch.no_grad():
        x, _ = ttf.forward_hidden(tp, tokens, cfg)
    assert torch.ops.hpcpat.attn_out.default not in ops.counts
    assert torch.equal(x, ttf.forward_hidden(
        tp, tokens, ttf.TransformerConfig(**SMALL))[0])


def test_three_step_trajectory_fused_split_matches_jax():
    jcfg, tcfg = _pair(attention="flash", mlp_impl="fused", remat=True,
                       remat_policy="split")
    jp, tp = _params(jcfg)
    tokens = _tokens(8)
    jopt = jtrain.make_optimizer(1e-2)
    jstep = jtrain.make_train_step(jcfg, optimizer=jopt)
    jstate = jopt.init(jp)
    tstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    tstep = ttrain.make_train_step(tcfg, optimizer=ttrain.make_optimizer(1e-2))
    jl, tl = [], []
    for _ in range(3):
        loss, jp, jstate = jstep(jp, jstate, jnp.asarray(tokens))
        jl.append(float(loss))
        loss, tp, tstate = tstep(tp, tstate, torch.from_numpy(tokens))
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


APP = ["--device", "cpu", "--batch", "2", "--seq", "64", "--d-model", "32",
       "--n-layers", "2", "--n-heads", "4", "--vocab", "128", "--steps", "3"]


@pytest.mark.parametrize("extra", [
    ["--mlp-impl", "fused"],
    ["--remat", "--remat-policy", "split"],
    ["--remat", "--remat-policy", "nothing", "--mlp-impl", "fused",
     "--generate", "4"],
    ["--remat", "--remat-policy", "dots_attn", "--attention", "flash",
     "--mlp-impl", "fused"],
], ids=["fused", "remat-split", "remat-nothing-fused-generate",
        "remat-dots_attn-flash-fused"])
def test_train_app_fused_and_remat_succeed(extra, capsys):
    assert train_app.main(APP + extra) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("SUCCESS")
    if "--generate" in extra:
        assert "generate: 2x4" in out


def test_train_app_remat_policy_without_remat_fails(capsys):
    assert train_app.main(APP + ["--remat-policy", "dots"]) == 1
    out = capsys.readouterr().out
    assert "--remat-policy has no effect without --remat" in out
    assert out.strip().endswith("FAILURE")


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_fused_mlp_config_decodes_like_dense(paged):
    # JAX decode runs the dense MLP whatever mlp_impl says; so does the port
    jcfg, dense = _pair(max_seq=64)
    _, tp = _params(jcfg, seed=4)
    fused = ttf.TransformerConfig(**SMALL, mlp_impl="fused")
    prompt = torch.from_numpy(_tokens(5, B=2, T=16))
    if paged:
        run = lambda c: tdec.paged_generate(tp, prompt, c, 6, page_size=8,
                                            device="cpu")
    else:
        run = lambda c: tdec.generate(tp, prompt, c, 6, device="cpu")
    n = fm.calls["forward"]
    got = run(fused)
    assert torch.equal(got, run(dense)) and got.shape == (2, 6)
    assert fm.calls["forward"] == n
