"""The port's fused MLP (``hpc_patterns_tpu_torch.ops.fused_mlp``) and its
block-fitting helper against the JAX package on the CPU.

Inputs come from a numpy seed and go to both sides. The JAX side runs the
Pallas kernels of ``hpc_patterns_tpu.ops.fused_mlp`` in interpret mode
(as ``tests/test_ops.py::TestFusedMLP`` does); the port runs its plain
route. Tolerances: the forward 2e-5 (JAX's own; measured 7e-7) and the
gradients 5e-5 (tighter than JAX's 5e-4; f32 on both sides, only the
summation order differs — measured up to 1e-5 on gradients of order 37),
bf16 against f32 within JAX's 0.05 of max|y|. Each backward mode is set
on both sides through ``HPCPAT_FUSED_MLP_BWD``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.ops import fused_mlp as jfm  # noqa: E402
from hpc_patterns_tpu.ops.tiling import fit_block_divisor as jfit  # noqa: E402
from hpc_patterns_tpu_torch.ops import fused_mlp as tfm  # noqa: E402
from hpc_patterns_tpu_torch.ops.tiling import fit_block_divisor  # noqa: E402

FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5
BF16_REL = 0.05


def _inputs(N=16, D=8, F=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D), dtype=np.float32)
    w1 = rng.standard_normal((D, F), dtype=np.float32) * 0.3
    w2 = rng.standard_normal((F, D), dtype=np.float32) * 0.3
    return x, w1, w2


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("shape,lead,blocks", [
    ((16, 8, 32), (16,), (4, 8)),
    ((16, 8, 32), (2, 8), (4, 8)),
    ((6, 8, 12), (6,), (4, 8)),
    ((16, 8, 32), (16,), (512, 512)),
], ids=["grid4x4", "leading-dims", "off-size", "default-blocks"])
def test_forward_matches_jax(shape, lead, blocks):
    x, w1, w2 = _inputs(*shape)
    x = x.reshape(*lead, shape[1])
    (jx, jw1, jw2), (tx, tw1, tw2) = _pair(x, w1, w2)
    bt, bf = blocks
    want = jfm.fused_mlp(jx, jw1, jw2, block_t=bt, block_f=bf)
    got = tfm.fused_mlp(tx, tw1, tw2, block_t=bt, block_f=bf)
    assert got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("mode", tfm.BWD_MODES)
@pytest.mark.parametrize("shape", [(16, 8, 32), (6, 8, 12)],
                         ids=["grid4x4", "off-size"])
def test_grads_match_jax_in_each_backward_mode(monkeypatch, mode, shape):
    monkeypatch.setenv("HPCPAT_FUSED_MLP_BWD", mode)
    x, w1, w2 = _inputs(*shape, seed=1)
    (jx, jw1, jw2), (tx, tw1, tw2) = _pair(x, w1, w2)

    def jloss(x, w1, w2):
        return jnp.sum(jfm.fused_mlp(x, w1, w2, block_t=4, block_f=8) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jx, jw1, jw2)
    ins = [t.requires_grad_() for t in (tx, tw1, tw2)]
    before = dict(tfm.launches)
    loss = (tfm.fused_mlp(*ins, block_t=4, block_f=8) ** 2).sum()
    got = torch.autograd.grad(loss, ins)
    for g, w, name in zip(got, want, ("dx", "dw1", "dw2")):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=f"{name} ({mode})")
    assert tfm.launches == before  # CPU tensors: the plain versions only


def test_mode_is_read_once_per_forward(monkeypatch):
    # residuals and backward follow the mode of the forward, whatever the
    # knob says by the time the backward runs
    x, w1, w2 = _inputs(seed=2)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    monkeypatch.setenv("HPCPAT_FUSED_MLP_BWD", "xla_a")
    y = tfm._FusedMLP.apply(*ins, 512, 512)
    assert len(y.grad_fn.saved_tensors) == 4  # x, a, w1, w2
    monkeypatch.setenv("HPCPAT_FUSED_MLP_BWD", "kernel")
    got = torch.autograd.grad(y.square().sum(), ins)
    monkeypatch.setenv("HPCPAT_FUSED_MLP_BWD", "xla_a")
    want = torch.autograd.grad(tfm.fused_mlp(*ins).square().sum(), ins)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    monkeypatch.setenv("HPCPAT_FUSED_MLP_BWD", "atomic")
    with pytest.raises(ValueError, match="HPCPAT_FUSED_MLP_BWD"):
        tfm.fused_mlp(*ins)


def test_save_a_forward_matches_jax():
    x, w1, w2 = _inputs(seed=3)
    (jx, jw1, jw2), (tx, tw1, tw2) = _pair(x, w1, w2)
    jy, ja = jfm._forward(jx, jw1, jw2, 4, 8, None, save_a=True)
    ty, ta = tfm.fused_mlp_forward(tx, tw1, tw2, save_a=True, block_t=4,
                                   block_f=8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FWD_ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=FWD_ATOL)


def test_bwd_kernels_plain_versions_match_jax_kernel_9():
    # the two backward kernels' plain versions together give kernel 9's
    # (dx, dW1, dW2) on the same residuals and cotangent
    x, w1, w2 = _inputs(seed=4)
    dy = np.random.default_rng(5).standard_normal(x.shape, dtype=np.float32)
    (jx, jw1, jw2, jdy), (tx, tw1, tw2, tdy) = _pair(x, w1, w2, dy)
    want = jfm._backward(jx, jw1, jw2, jdy, 4, 8, None)
    dx, g, da = tfm.fused_mlp_bwd_dx(tx, tw1, tw2, tdy, block_t=4,
                                     block_f=8)
    dw1, dw2 = tfm.fused_mlp_bwd_dw(tx, g, da, tdy, block_t=4)
    whole = tfm.fused_mlp_backward_reference(tx, tw1, tw2, tdy, block_t=4,
                                             block_f=8)
    for got, w in zip((dx, dw1, dw2), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL)
    for a, b in zip(whole, (dx, dw1, dw2)):
        assert torch.equal(a, b)
    a = tx @ tw1
    assert torch.equal(g, tfm._gelu(a))


@pytest.mark.parametrize("N,D,F", [(300, 384, 264), (1, 128, 8)],
                         ids=["ragged-d384", "one-token-f8"])
def test_plain_versions_match_jax_at_the_card_cases(N, D, F):
    # the shapes the card kernels are held at beside these plain versions:
    # ragged tokens and d_ff (clusters of 3 CTAs there), one token with
    # d_ff 8; weights scaled by fan-in, so values stay of order 1
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D), dtype=np.float32)
    w1 = rng.standard_normal((D, F), dtype=np.float32) * D ** -0.5
    w2 = rng.standard_normal((F, D), dtype=np.float32) * F ** -0.5
    dy = rng.standard_normal((N, D), dtype=np.float32)
    (jx, jw1, jw2, jdy), (tx, tw1, tw2, tdy) = _pair(x, w1, w2, dy)
    np.testing.assert_allclose(
        tfm.fused_mlp_forward_reference(tx, tw1, tw2).numpy(),
        np.asarray(jfm.fused_mlp(jx, jw1, jw2)), atol=FWD_ATOL)
    want = jfm._backward(jx, jw1, jw2, jdy, 512, 512, None)
    got = tfm.fused_mlp_backward_reference(tx, tw1, tw2, tdy)
    for g, w, name in zip(got, want, ("dx", "dw1", "dw2")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=name)


def test_gelu_matches_torch_and_jax():
    a = np.linspace(-6, 6, 101, dtype=np.float32)
    ta = torch.from_numpy(a).requires_grad_()
    g = tfm._gelu(ta)
    np.testing.assert_allclose(
        g.detach().numpy(),
        torch.nn.functional.gelu(ta, approximate="tanh").detach().numpy(),
        atol=1e-6)
    np.testing.assert_allclose(g.detach().numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(a))),
                               atol=1e-6)
    (dg,) = torch.autograd.grad(g.sum(), ta)
    np.testing.assert_allclose(tfm._dgelu(ta.detach()).numpy(), dg.numpy(),
                               atol=1e-5)


def test_bf16_close_to_f32():
    x, w1, w2 = _inputs(seed=6)
    want = tfm.fused_mlp(*(torch.from_numpy(a) for a in (x, w1, w2)))
    got = tfm.fused_mlp(*(torch.from_numpy(a).bfloat16()
                          for a in (x, w1, w2)), block_t=8, block_f=16)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err < BF16_REL, err
    jgot = jfm.fused_mlp(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w2)),
                         block_t=8, block_f=16)
    jerr = np.abs(np.asarray(jgot, np.float32) - want.numpy()).max() \
        / np.abs(want.numpy()).max()
    assert jerr < BF16_REL, jerr


def test_shape_checks_and_no_grad_path():
    x, w1, w2 = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="shape mismatch"):
        tfm.fused_mlp(x, w1, w1)
    with pytest.raises(ValueError, match="blocks"):
        tfm.fused_mlp(x, w1, w2, block_t=0)
    n = tfm.calls["forward"]
    with torch.no_grad():
        y = tfm.fused_mlp(x.requires_grad_(), w1, w2)
    assert y.grad_fn is None and tfm.calls["forward"] == n + 1
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_mlp_forward(x.detach().to("meta"), w1.to("meta"),
                              w2.to("meta"))


@pytest.mark.parametrize("n", [1, 2, 6, 7, 12, 16, 100, 4096, 16384])
def test_fit_block_divisor_matches_jax(n):
    for cap in (1, 3, 4, 8, 64, 512, 20000):
        b = fit_block_divisor(n, cap)
        assert b == jfit(n, cap) and n % b == 0 and b <= max(cap, 1)
