"""The port's mixture-of-experts layer (``hpc_patterns_tpu_torch/parallel/
moe.py``) against the JAX package on the CPU.

Inputs from numpy seeds go through JAX's ``moe`` functions (``moe_ep``
inside ``shard_map`` on the 8-device CPU mesh) and the port's (``moe_ep``
over 8 rank-stacked shards). Both assign slots in token order, choice
major, so at capacities that drop tokens the same ones drop: the outputs
must agree to f32 rounding (atol 2e-5, JAX's own bound between its ep and
dense forms), kept fractions exactly (counts over the same total), aux to
rtol 1e-6, gradients to 3e-5 (JAX's bound between its dispatch forms).

At top-3 the scatter dispatch sums three terms a token: the port sums
them by expert id, the order XLA's CPU scatter-add applies JAX's
``.at[src_tok].add``, so on the same gates, expert outputs and cotangent
the combine and the gather's backward equal JAX's bit for bit (inputs
spread over 2^±8 so that another order would show); the whole layer at
top-3 is held within the tolerances above.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from hpc_patterns_tpu.parallel import moe as jmoe  # noqa: E402
from hpc_patterns_tpu.topology import shard_map  # noqa: E402
from hpc_patterns_tpu_torch.parallel import moe as tmoe  # noqa: E402

E, D, F = 8, 16, 32  # 8 experts over 8 ranks: one a rank
N_LOCAL = 16
ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((D, E)).astype(np.float32),
            (rng.standard_normal((E, D, F)) / 4).astype(np.float32),
            (rng.standard_normal((E, F, D)) / 6).astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny,
    and under a parallel test run a worker's thread pool spinning on
    cores the other workers hold made each op milliseconds long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [1, 3, 8, 64])
def test_moe_dense_matches_jax(weights, dispatch, top_k, capacity):
    x = _x(1, 32)
    yj, auxj, keptj = jmoe.moe_dense(
        jnp.asarray(x), *map(jnp.asarray, weights), capacity=capacity,
        top_k=top_k, with_stats=True, dispatch=dispatch)
    yt, auxt, keptt = tmoe.moe_dense(
        *_t(x, *weights), capacity=capacity, top_k=top_k, with_stats=True,
        dispatch=dispatch)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
    assert float(keptt) == float(keptj)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    if capacity * E < top_k * 32:
        assert float(keptt) < 1.0  # this capacity drops


def test_dispatch_tensors_match_jax(weights):
    x = _x(2, 32)
    for top_k in (1, 2):
        want = jmoe._dispatch_combine(jnp.asarray(x), jnp.asarray(weights[0]),
                                      E, 2, top_k=top_k)
        got = tmoe._dispatch_combine(*_t(x, weights[0]), E, 2, top_k=top_k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-6)


def test_top2_first_choices_never_evicted(weights):
    x, router = _t(_x(3, 32), weights[0])
    d1, _, _, kept1 = tmoe._dispatch_combine(x, router, E, 1, top_k=1)
    d2, _, _, _ = tmoe._dispatch_combine(x, router, E, 1, top_k=2)
    oh = torch.nn.functional.one_hot(
        torch.softmax(x @ router, -1).argmax(-1), E).float()
    torch.testing.assert_close(torch.einsum("nec,ne->nc", d1, oh),
                               torch.einsum("nec,ne->nc", d2, oh),
                               rtol=0, atol=0)
    assert 0.0 < float(kept1) <= 1.0


def test_scatter_grads_match_einsum(weights):
    x = _x(4, 32)

    def grads(disp):
        ts = [t.clone().requires_grad_(True) for t in _t(x, *weights)]
        y, aux = tmoe.moe_dense(*ts, capacity=4, top_k=2, dispatch=disp)
        ((y * y).sum() + 0.01 * aux).backward()
        return [t.grad for t in ts]

    def jgrads(disp):
        def f(x, r, a, b):
            y, aux = jmoe.moe_dense(x, r, a, b, capacity=4, top_k=2,
                                    dispatch=disp)
            return jnp.sum(y * y) + 0.01 * aux
        return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
            *map(jnp.asarray, (x, *weights)))

    scatter, einsum = grads("scatter"), grads("einsum")
    for a, b, j in zip(scatter, einsum, jgrads("einsum")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(j), atol=3e-5)


def test_aux_uniform_router_is_near_one(weights):
    x = _x(5, 1024)
    _, aux = tmoe.moe_dense(*_t(x, weights[0] * 1e-3, *weights[1:]),
                            capacity=256)
    assert float(aux) == pytest.approx(1.0, rel=0.2)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ep_matches_jax(mesh8, weights, dispatch, top_k):
    router, w1, w2 = weights
    cap = jmoe.default_capacity(N_LOCAL * top_k, E)
    assert tmoe.default_capacity(N_LOCAL * top_k, E) == cap
    x = _x(6 + top_k, 8 * N_LOCAL)
    yj, auxj, keptj = jax.jit(shard_map(
        lambda xl, wa, wb: jmoe.moe_ep(
            xl, jnp.asarray(router), wa, wb, axis="x", capacity=cap,
            top_k=top_k, with_stats=True, dispatch=dispatch),
        mesh=mesh8,
        in_specs=(P("x", None), P("x", None, None), P("x", None, None)),
        out_specs=(P("x", None), P(), P()), check_vma=False))(
            jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    tx, tr, tw1, tw2 = _t(x, router, w1, w2)
    yt, auxt, keptt = tmoe.moe_ep(
        tx.reshape(8, N_LOCAL, D), tr, tw1.reshape(8, 1, D, F),
        tw2.reshape(8, 1, F, D), capacity=cap, top_k=top_k,
        with_stats=True, dispatch=dispatch)
    np.testing.assert_allclose(yt.reshape(-1, D).numpy(), np.asarray(yj),
                               atol=ATOL)
    # every rank holds the mean over ranks
    assert torch.equal(auxt, auxt[:1].expand(8))
    np.testing.assert_allclose(auxt[0].item(), float(auxj), rtol=1e-6)
    np.testing.assert_allclose(keptt[0].item(), float(keptj), rtol=1e-6)
    # per token equal to the dense form on its own shard
    want = torch.cat([tmoe.moe_dense(tx[r * N_LOCAL:(r + 1) * N_LOCAL], tr,
                                     tw1, tw2, capacity=cap, top_k=top_k,
                                     dispatch=dispatch)[0]
                      for r in range(8)])
    np.testing.assert_allclose(yt.reshape(-1, D).numpy(), want.numpy(),
                               atol=ATOL)


def test_moe_ep_two_experts_a_rank(weights):
    router, w1, w2 = _t(*weights)
    x = torch.from_numpy(_x(9, 4 * N_LOCAL))
    cap = tmoe.default_capacity(N_LOCAL, E)
    y, aux = tmoe.moe_ep(x.reshape(4, N_LOCAL, D), router,
                         w1.reshape(4, 2, D, F), w2.reshape(4, 2, F, D),
                         capacity=cap)
    want = [tmoe.moe_dense(x[r * N_LOCAL:(r + 1) * N_LOCAL], router, w1, w2,
                           capacity=cap) for r in range(4)]
    np.testing.assert_allclose(y.reshape(-1, D).numpy(),
                               torch.cat([w[0] for w in want]).numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(
        aux[0].item(), torch.stack([w[1] for w in want]).mean().item(),
        rtol=1e-6)


def test_bad_dispatch_rejected(weights):
    x = torch.from_numpy(_x(10, 8))
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_dense(x, *_t(*weights), capacity=2, dispatch="magic")


def test_default_capacity():
    for n, e in ((128, 8), (4, 64), (16384 * 2, 8)):
        assert tmoe.default_capacity(n, e) == jmoe.default_capacity(n, e)
    assert tmoe.default_capacity(128, 8) == 20


@pytest.mark.parametrize("capacity", [2, 64])
def test_scatter_sums_at_top3_equal_jax_bit_for_bit(capacity):
    n, k = 64, 3
    rng = np.random.default_rng(11)

    def spread(*shape):
        return (rng.standard_normal(shape)
                * np.exp(rng.uniform(-8, 8, shape))).astype(np.float32)

    x = spread(n, D)
    # each token's top three gates are dyadic and sum to 1, so the
    # normalized gates are exact under jit and op by op alike: what is
    # held is the order of the three-term sums alone
    gates = rng.uniform(0.0, 0.125, (n, E)).astype(np.float32)
    for t in range(n):
        gates[t, rng.permutation(E)[:k]] = (0.5, 0.3125, 0.1875)
    out, cot = spread(E, capacity, D), spread(E, capacity, D)
    jg = jnp.asarray(gates)
    jcomb = jax.jit(lambda v, o: jmoe._scatter_dispatch(
        v, jg, E, capacity, k)[1](o))
    _, tcomb, _, _ = tmoe._scatter_dispatch(
        torch.from_numpy(x), torch.from_numpy(gates), E, capacity, k)
    np.testing.assert_array_equal(
        tcomb(torch.from_numpy(out)).numpy(),
        np.asarray(jcomb(jnp.asarray(x), jnp.asarray(out))))
    want = jax.jit(jax.grad(lambda v: jnp.sum(
        jmoe._scatter_dispatch(v, jg, E, capacity, k)[0] * cot)))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmoe._scatter_dispatch(xt, torch.from_numpy(gates), E, capacity, k)[0]
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_dense_top3_matches_jax_with_grads(weights, dispatch):
    x = _x(12, 32)

    def f(*args):
        y, aux = jmoe.moe_dense(*args, capacity=8, top_k=3,
                                dispatch=dispatch)
        return jnp.sum(y * y) + 0.01 * aux, y

    (_, yj), gj = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                             has_aux=True))(
        *map(jnp.asarray, (x, *weights)))
    ts = [t.clone().requires_grad_(True) for t in _t(x, *weights)]
    y, aux = tmoe.moe_dense(*ts, capacity=8, top_k=3, dispatch=dispatch)
    ((y * y).sum() + 0.01 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), atol=ATOL)
    for t, w in zip(ts, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=3e-5)
