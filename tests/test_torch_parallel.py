"""The port's parallel layer (``hpc_patterns_tpu_torch/parallel/``: ring
and Ulysses attention, tensor parallelism; ``models/sharding_util.py``)
against the JAX package on the CPU.

The JAX functions run rank-local inside ``shard_map`` on the 8-device CPU
mesh (conftest), the JAX flash route through its Pallas kernel in
interpret mode; the port runs the same 8 ranks stacked on a leading dim
of one tensor. Inputs come from numpy seeds. Tolerances, f32 on both
sides (only the summation order differs): attention outputs and their
gradients atol 2e-5 (JAX's own ring tests hold the ring to the dense
oracle at 2e-5), the tensor-parallel MLP 1e-4 (as JAX's), bf16 inputs
3e-2 (bf16's 2^-8 on values of order 1, JAX's bound).
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from hpc_patterns_tpu import parallel as jpar  # noqa: E402
from hpc_patterns_tpu.models import sharding_util as jsu  # noqa: E402
from hpc_patterns_tpu.topology import shard_map  # noqa: E402
from hpc_patterns_tpu_torch import parallel as tpar  # noqa: E402
from hpc_patterns_tpu_torch.models import sharding_util as tsu  # noqa: E402
from hpc_patterns_tpu_torch.parallel.ring_attention import (  # noqa: E402
    _kv_rotate,
    full_attention,
    ring_attention,
)
from hpc_patterns_tpu_torch.parallel import tensor as ttp  # noqa: E402

B, T, H, D = 2, 32, 8, 16  # the sequence over 8 ranks: 4 a rank
R = 8
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its models are tiny,
    and under a parallel test run a worker's thread pool spinning on
    cores the other workers hold made each op milliseconds long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _qkv(seed, hkv=H, h=H):
    return _arrays(seed, [(B, T, h, D), (B, T, hkv, D), (B, T, hkv, D)])


def _ranks(x):
    """(B, T, ...) numpy -> the port's (ranks, B, T / ranks, ...)."""
    return torch.from_numpy(x).unflatten(1, (R, -1)).movedim(1, 0)


def _joined(y):
    return y.movedim(0, 1).flatten(1, 2).detach().numpy()


def _jax_seq(mesh, fn, *arrays):
    spec = P(None, "x", None, None)
    mapped = shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                       out_specs=spec)
    return np.asarray(jax.jit(mapped)(*map(jnp.asarray, arrays)))


# ------------------------------------------------------------------ ring


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(mesh8, impl, causal):
    q, k, v = _qkv(0)
    want = _jax_seq(mesh8, lambda q, k, v: jpar.ring_attention(
        q, k, v, "x", causal=causal, impl=impl), q, k, v)
    got = ring_attention(*map(_ranks, (q, k, v)), causal=causal,
                              impl=impl)
    np.testing.assert_allclose(_joined(got), want, atol=ATOL)
    oracle = full_attention(*map(torch.from_numpy, (q, k, v)),
                            causal=causal)
    np.testing.assert_allclose(_joined(got), oracle.numpy(), atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ring_gqa_narrow_kv(mesh8, impl):
    q, k, v = _qkv(1, hkv=2)
    want = _jax_seq(mesh8, lambda q, k, v: jpar.ring_attention(
        q, k, v, "x", causal=True, impl=impl), q, k, v)
    got = ring_attention(*map(_ranks, (q, k, v)), causal=True,
                              impl=impl)
    np.testing.assert_allclose(_joined(got), want, atol=ATOL)


def test_ring_bf16_inputs(mesh8):
    q, k, v = _qkv(2)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = _jax_seq(mesh8, lambda q, k, v: jpar.ring_attention(q, k, v, "x"),
                    *bf)
    got = ring_attention(
        *(_ranks(np.asarray(a, np.float32)).bfloat16() for a in bf))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_joined(got.float()),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("hkv", [H, 2])
def test_ring_flash_grad_matches_jax(mesh8, hkv):
    q, k, v = _qkv(3, hkv=hkv)
    spec = P(None, "x", None, None)
    ringed = shard_map(
        lambda q, k, v: jpar.ring_attention(q, k, v, "x", causal=True,
                                            impl="flash"),
        mesh=mesh8, in_specs=(spec,) * 3, out_specs=spec)
    want = jax.jit(jax.grad(lambda q, k, v: ringed(q, k, v).sum(),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [_ranks(a).requires_grad_(True) for a in (q, k, v)]
    ring_attention(*ts, causal=True, impl="flash").sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(_joined(t.grad), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fused_and_ppermute_shifts_equal(impl):
    q, k, v = _qkv(4, hkv=4)
    stacked = [_ranks(a) for a in (q, k, v)]
    kv = tuple(stacked[1:])
    for a, b in zip(_kv_rotate("fused")(kv),
                    _kv_rotate("ppermute")(kv)):
        assert torch.equal(a, b)
    got = {s: ring_attention(*stacked, causal=True, impl=impl,
                                  shift_impl=s)
           for s in ("fused", "ppermute")}
    assert torch.equal(got["fused"], got["ppermute"])


def test_fused_shift_has_no_backward():
    q, k, v = (_ranks(a).requires_grad_(True) for a in _qkv(5))
    out = ring_attention(q, k, v, causal=True, shift_impl="fused")
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


def test_flash_ring_skips_future_blocks(monkeypatch):
    from hpc_patterns_tpu_torch.ops import flash_attention as fa

    calls = []
    orig = fa.flash_attention_block

    def counting(*a, **kw):
        calls.append(a[3:5])
        return orig(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_block", counting)
    stacked = [_ranks(a) for a in _qkv(6)]
    ring_attention(*stacked, causal=True, impl="flash")
    assert len(calls) == R * (R + 1) // 2
    assert all(k_off <= q_off for q_off, k_off in calls)
    calls.clear()
    ring_attention(*stacked, causal=False, impl="flash")
    assert len(calls) == R * R


@pytest.mark.parametrize("kw,match", [
    ({"impl": "nope"}, "impl"), ({"shift_impl": "smoke"}, "shift_impl")])
def test_ring_rejects_bad_options(kw, match):
    q = torch.zeros(R, B, 4, H, D)
    with pytest.raises(ValueError, match=match):
        ring_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        ring_attention(q[0], q[0], q[0])


# --------------------------------------------------------------- ulysses


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(mesh8, impl, causal):
    q, k, v = _qkv(7)
    want = _jax_seq(mesh8, lambda q, k, v: jpar.ulysses_attention(
        q, k, v, "x", causal=causal, impl=impl), q, k, v)
    got = tpar.ulysses_attention(*map(_ranks, (q, k, v)), causal=causal,
                                 impl=impl)
    np.testing.assert_allclose(_joined(got), want, atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ulysses_narrow_kv_scatter(mesh8, impl):
    q, k, v = _qkv(8, hkv=8, h=16)
    want = _jax_seq(mesh8, lambda q, k, v: jpar.ulysses_attention(
        q, k, v, "x", causal=True, impl=impl), q, k, v)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*expanding K/V.*")
        got = tpar.ulysses_attention(*map(_ranks, (q, k, v)), causal=True,
                                     impl=impl)
    np.testing.assert_allclose(_joined(got), want, atol=ATOL)


def test_ulysses_expands_kv_loudly(mesh8):
    q, k, v = _qkv(9, hkv=2)
    with pytest.warns(UserWarning, match="expanding K/V"):
        want = _jax_seq(mesh8, lambda q, k, v: jpar.ulysses_attention(
            q, k, v, "x", causal=True), q, k, v)
    with pytest.warns(UserWarning, match="expanding K/V"):
        got = tpar.ulysses_attention(*map(_ranks, (q, k, v)), causal=True)
    np.testing.assert_allclose(_joined(got), want, atol=ATOL)


def test_ulysses_flash_grad_matches_ring():
    stacked = [_ranks(a) for a in _qkv(10)]
    grads = []
    for fn in (tpar.ulysses_attention, ring_attention):
        ts = [t.clone().requires_grad_(True) for t in stacked]
        fn(*ts, causal=True, impl="flash").square().sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_ulysses_heads_must_divide():
    q = torch.zeros(R, B, 4, 4, D)
    with pytest.raises(ValueError, match="divisible"):
        tpar.ulysses_attention(q, q, q)


# ------------------------------------------------------ tensor parallelism


@pytest.mark.parametrize("algorithm", ["collective", "ring"])
def test_tp_mlp_matches_jax(mesh8, algorithm):
    x, w1, w2 = _arrays(11, [(4, 16), (16, 64), (64, 16)])
    w1, w2 = w1 / 4, w2 / 8
    want = np.asarray(jax.jit(shard_map(
        lambda x, a, b: jpar.tp_mlp(x, a, b, axis="x", algorithm=algorithm),
        mesh=mesh8, in_specs=(P(), P(None, "x"), P("x", None)),
        out_specs=P(), check_vma=(algorithm == "collective")))(x, w1, w2))
    tx = torch.from_numpy(x).expand(R, *x.shape)
    tw1 = torch.from_numpy(w1).unflatten(1, (R, -1)).movedim(1, 0)
    tw2 = torch.from_numpy(w2).unflatten(0, (R, -1))
    got = ttp.tp_mlp(tx, tw1, tw2, algorithm=algorithm)
    for r in range(R):  # every rank holds the replicated result
        np.testing.assert_allclose(got[r].numpy(), want, atol=1e-4)


def test_row_parallel_scatter_matches_jax(mesh8):
    x, w = _arrays(12, [(8, 64), (64, 32)])
    w = w / 8
    want = np.asarray(jax.jit(shard_map(
        lambda xl, wl: jpar.tensor.row_parallel_scatter(xl, wl, axis="x"),
        mesh=mesh8, in_specs=(P(None, "x"), P("x", None)),
        out_specs=P(None, "x")))(x, w))
    tx = torch.from_numpy(x).unflatten(1, (R, -1)).movedim(1, 0)
    tw = torch.from_numpy(w).unflatten(0, (R, -1))
    got = ttp.row_parallel_scatter(tx, tw)  # (R, 8, 32 / R)
    np.testing.assert_allclose(got.movedim(0, 1).flatten(1).numpy(), want,
                               atol=1e-4)


def test_column_parallel_bias_and_bad_algorithm():
    x, w, b = (torch.from_numpy(a) for a in _arrays(
        13, [(R, 3, 16), (R, 16, 4), (R, 4)]))
    got = ttp.column_parallel(x, w, b)
    for r in range(R):
        torch.testing.assert_close(got[r], x[r] @ w[r] + b[r])
    with pytest.raises(ValueError, match="unknown algorithm"):
        ttp.row_parallel(x, w, algorithm="smoke_signals")


# ------------------------------------------------------------ mesh specs


@pytest.mark.parametrize("spec,mesh", [
    ((("dp", "fsdp"), "sp", None), {"sp": 2, "ep": 2}),
    ((("dp", "ep"), "sp", None), {"sp": 2, "ep": 4}),
    (("ep", None, None), {"dp": 2}),
    ((("dp",), "sp", "tp", None), {"dp": 1, "sp": 4, "tp": 1}),
])
def test_resolve_spec_matches_jax(spec, mesh):
    allowed = {"dp", "fsdp", "sp", "tp", "ep"}
    jmesh = jax.make_mesh(tuple(mesh.values()), tuple(mesh),
                          devices=jax.devices()[:int(np.prod(list(
                              mesh.values())))])
    want = tuple(jsu.resolve_spec(P(*spec), jmesh, allowed))
    assert tsu.resolve_spec(spec, mesh, allowed) == want
    for ax in ("dp", "sp", "ep", "tp"):
        assert tsu.mesh_axis_size(mesh, ax) == jsu.mesh_axis_size(jmesh, ax)
    with pytest.raises(ValueError, match="axis-name"):
        tsu.resolve_spec(("data",), mesh, allowed)


def test_to_ranks_round_trip_and_shards():
    mesh = {"sp": 2, "ep": 4}
    x = torch.arange(8 * 6 * 3).reshape(8, 6, 3)
    spec = ("ep", "sp", None)
    y = tsu.to_ranks(x, spec, mesh, ("sp", "ep"))
    assert y.shape == (2, 4, 2, 3, 3)
    assert torch.equal(y[1, 3], x[6:8, 3:6])
    assert torch.equal(tsu.from_ranks(y, spec, mesh, ("sp", "ep")), x)
    # a rank axis that shards nothing holds the same shard on every rank
    z = tsu.to_ranks(x, (None, "sp", None), mesh, ("sp", "ep"))
    assert z.shape == (2, 4, 8, 3, 3) and torch.equal(z[0, 0], z[0, 3])
    assert torch.equal(
        tsu.from_ranks(z, (None, "sp", None), mesh, ("sp", "ep")), x)
    with pytest.raises(ValueError, match="outside the rank axes"):
        tsu.to_ranks(x, spec, mesh, ("sp",))
