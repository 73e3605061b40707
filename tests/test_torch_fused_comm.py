"""The port's fused ring collectives (plain versions, CPU) against the JAX
reference's Pallas kernels (``hpc_patterns_tpu/comm/fused.py``) in
interpret mode on the conftest's 8-device CPU mesh.

On this tree's jax the JAX fused kernels trace only under a
``shard_map(..., check_vma=False)`` (the default raises the ``vma on
jax.ShapeDtypeStruct`` error), so the JAX side is called that way,
directly — never through its ``Communicator``. Both sides get the same
numpy-seeded inputs. The port's plain allreduce runs the chunked ring over
the same chunk layout as JAX's interpret mode (lane 1), so they agree bit
for bit for float32, bfloat16 and int32; ``allgather_matmul`` is held to
rtol 1e-5 (float32; CPU XLA and PyTorch may order a dot's sums apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hpc_patterns_tpu.comm import fused as jfused
from hpc_patterns_tpu.topology import make_mesh, shard_map
from hpc_patterns_tpu_torch.comm import fused, ring
from hpc_patterns_tpu_torch.comm.communicator import Communicator

WORLD = 8


def jmesh(size):
    return Mesh(np.asarray(jax.devices()[:size]), ("x",))


def jrun(fn, mesh, *xs, axis="x"):
    specs = tuple(P(axis, *([None] * (np.ndim(v) - 1))) for v in xs)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=specs[0],
                          check_vma=False))
    return f(*xs)


def rand(rng, shape, dtype):
    x = (rng.normal(size=shape) * 8).astype(np.float32)
    if dtype == "int32":
        return x.astype(np.int32)
    return x


def to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def to_torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(getattr(torch, dtype))


def as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def jax_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("n", [40, 64, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("size", [2, 3, 4, 5, 6, 7, 8])
def test_plain_fused_allreduce_equals_jax_kernel(size, dtype, n):
    x = rand(np.random.default_rng(size * 100 + n), (size, n), dtype)
    want = jrun(lambda l: jfused.fused_allreduce(l, "x"), jmesh(size),
                to_jax(x, dtype))
    got = fused.fused_allreduce(to_torch(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(as_np(got), jax_np(want))


def test_ring_layout_matches_the_reference():
    for shape in ((1, 40), (3, 65), (2, 4, 7), (64,)):
        for size in (2, 3, 8):
            assert fused.ring_layout(shape, size) == jfused.ring_layout(
                shape, size, interpret=True)
    assert fused.ring_layout((1, 65), 8, lane=8) == (1, 65, 16, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_allreduce_into_bias_relu_equals_jax(dtype):
    rng = np.random.default_rng(5)
    x = rand(rng, (WORLD, 40), dtype)
    bias = rand(rng, (40,), dtype) / 4
    jb = to_jax(bias, dtype)
    want = jrun(lambda l: jfused.allreduce_into(l, "x", bias=jb,
                                                epilogue=jax.nn.relu),
                jmesh(WORLD), to_jax(x, dtype))
    got = fused.allreduce_into(to_torch(x, dtype),
                               bias=to_torch(bias, dtype), epilogue="relu")
    np.testing.assert_array_equal(as_np(got), jax_np(want))
    # a callable epilogue runs on the CPU plain path
    got_c = fused.allreduce_into(to_torch(x, dtype),
                                 bias=to_torch(bias, dtype),
                                 epilogue=torch.relu)
    np.testing.assert_array_equal(as_np(got_c), jax_np(want))


def test_allgather_matmul_equals_jax_to_tolerance():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(WORLD, 3, 16)).astype(np.float32)
    w = rng.normal(size=(WORLD, 16, 8)).astype(np.float32)
    want = jrun(lambda a, b: jfused.allgather_matmul(a[0], b[0], "x")[None],
                jmesh(WORLD), jnp.asarray(x), jnp.asarray(w))
    got = fused.allgather_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (WORLD, WORLD * 3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ref = fused.allgather_matmul_reference(torch.from_numpy(x),
                                           torch.from_numpy(w))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_allgather_matmul_dtypes_equal_jax(dtype):
    rng = np.random.default_rng(8)
    x = np.clip(np.round(rng.normal(size=(4, 2, 16)) * 2), -4, 4)
    w = np.clip(np.round(rng.normal(size=(4, 16, 8)) * 2), -4, 4)
    x, w = x.astype(np.float32), w.astype(np.float32)
    if dtype == "int32":
        x, w = x.astype(np.int32), w.astype(np.int32)
    want = jrun(lambda a, b: jfused.allgather_matmul(a[0], b[0], "x")[None],
                jmesh(4), to_jax(x, dtype), to_jax(w, dtype))
    got = fused.allgather_matmul(to_torch(x, dtype), to_torch(w, dtype))
    # small integers: every product and sum is exact in f32
    np.testing.assert_array_equal(as_np(got), jax_np(want))


def _round_to_tf32(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties up)."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_allgather_matmul_tolerance_admits_f32_orders_and_rejects_tf32():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(4, 32, 512)).astype(np.float32)
    w = rng.normal(size=(4, 512, 24)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = fused.allgather_matmul_reference(xt, wt)
    tol = fused.allgather_matmul_tolerance(xt, wt, want)
    # another f32 summation order (JAX's kernel) and the exact sum, rounded
    jax_out = torch.from_numpy(np.array(jrun(
        lambda a, b: jfused.allgather_matmul(a[0], b[0], "x")[None],
        jmesh(4), jnp.asarray(x), jnp.asarray(w))))
    exact = torch.from_numpy(np.einsum(
        "jmk,rkn->rjmn", x.astype(np.float64), w.astype(np.float64)
    ).reshape(4, 4 * 32, 24).astype(np.float32))
    for other in (jax_out, exact):
        assert bool(((other - want).abs() <= tol).all())
    # the same product from TF32-rounded inputs fails the bound
    tf32 = np.einsum("jmk,rkn->rjmn",
                     _round_to_tf32(x).astype(np.float64),
                     _round_to_tf32(w).astype(np.float64))
    tf32 = torch.from_numpy(tf32.reshape(4, 4 * 32, 24).astype(np.float32))
    assert not bool(((tf32 - want).abs() <= tol).all())
    xi = torch.ones(4, 2, 8, dtype=torch.int32)
    assert not fused.allgather_matmul_tolerance(
        xi, xi.transpose(1, 2), torch.ones(4, 8, 2, dtype=torch.int32)).any()


@pytest.mark.parametrize("kind", ["pairs", "shift+1", "shift-1", "shift+3"])
def test_fused_permute_equals_jax(kind):
    x = rand(np.random.default_rng(9), (WORLD, 24), "float32")
    if kind == "pairs":
        perm = [(i, i ^ 1) for i in range(WORLD)]
        want = jrun(lambda l: jfused.fused_permute(l, "x", perm),
                    jmesh(WORLD), jnp.asarray(x))
        got = fused.fused_permute(torch.from_numpy(x), perm)
        np.testing.assert_array_equal(got.numpy(), x[[r ^ 1 for r in
                                                      range(WORLD)]])
    else:
        shift = int(kind[5:])
        want = jrun(lambda l: jfused.fused_ring_shift(l, "x", shift),
                    jmesh(WORLD), jnp.asarray(x))
        got = fused.fused_ring_shift(torch.from_numpy(x), shift)
        assert torch.equal(got, ring.ring_shift(torch.from_numpy(x), shift))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_permute_rejects_what_jax_rejects():
    x = torch.ones(WORLD, 8)
    with pytest.raises(ValueError, match="duplicate"):
        fused.fused_permute(x, [(i, 0) for i in range(WORLD)])
    with pytest.raises(ValueError, match="partial"):
        fused.fused_permute(x, [(0, 1), (1, 0)])
    with pytest.raises(ValueError, match="duplicate"):
        jrun(lambda l: jfused.fused_permute(l, "x",
                                            [(i, 0) for i in range(WORLD)]),
             jmesh(WORLD), jnp.ones((WORLD, 8), jnp.float32))


class TestMultiAxis:
    """``{"a": 2, "b": 4}`` over ``b``: the flat-rank geometry and the
    Communicator's expand/fold route against JAX's flat-mesh route."""

    def test_geometry_matches_the_reference(self):
        mesh = make_mesh({"a": 2, "b": 4})
        for axis in ("a", "b"):
            jg = jfused.mesh_ring_geometry(mesh, axis)
            g = fused.mesh_ring_geometry({"a": 2, "b": 4}, axis)
            assert (g.size, g.stride, g.total) == (jg.size, jg.stride,
                                                   jg.total)
            assert g.positions() == jg.positions()
            assert g.ring_ids() == jg.ring_ids()
            assert g.flat_dst_table([1, 0, 3, 2][:g.size] if g.size == 4
                                    else [1, 0]) == jg.flat_dst_table(
                [1, 0, 3, 2][:g.size] if g.size == 4 else [1, 0])

    def test_fused_allreduce_and_shift_equal_jax(self):
        mesh = make_mesh({"a": 2, "b": 4})
        jg = jfused.mesh_ring_geometry(mesh, "b")
        fm = jfused.flat_mesh(mesh)
        x = rand(np.random.default_rng(4), (4, 40), "float32")
        xf = np.take(x, jg.positions(), axis=0)
        spec = P(jfused.FLAT_AXIS, None)
        xj = jax.device_put(jnp.asarray(xf), NamedSharding(fm, spec))
        want = np.asarray(jrun(lambda l: jfused.fused_allreduce(
            l, jfused.FLAT_AXIS, geometry=jg), fm, xj,
            axis=jfused.FLAT_AXIS))
        g = fused.mesh_ring_geometry({"a": 2, "b": 4}, "b")
        got = fused.fused_allreduce(torch.from_numpy(xf), geometry=g)
        np.testing.assert_array_equal(got.numpy(), want)
        c = Communicator({"a": 2, "b": 4}, "b", device="cpu")
        np.testing.assert_array_equal(
            c.allreduce(torch.from_numpy(x), "fused").numpy(),
            want[jg.ring_ids()])
        want_s = np.asarray(jrun(lambda l: jfused.fused_ring_shift(
            l, jfused.FLAT_AXIS, geometry=jg), fm, xj,
            axis=jfused.FLAT_AXIS))
        got_s = fused.fused_ring_shift(torch.from_numpy(xf), geometry=g)
        np.testing.assert_array_equal(got_s.numpy(), want_s)

    def test_allgather_matmul_multi_axis(self):
        c = Communicator({"a": 2, "b": 4}, "b", device="cpu")
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.normal(size=(4, 2, 8)).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=(4, 8, 4)).astype(np.float32))
        got = c.allgather_matmul(x, w, "fused")
        ref = c.allgather_matmul(x, w, "collective")
        assert torch.equal(got, ref)
        with pytest.raises(ValueError, match="size, m, k"):
            c.allgather_matmul(torch.ones(4, 4), torch.ones(4, 4, 4))
        with pytest.raises(ValueError, match="not in"):
            c.allgather_matmul(x, w, algorithm="ring")


def test_kernel_epilogue_codes():
    assert fused._kernel_epilogue(None) == 0
    assert fused._kernel_epilogue("relu") == 1
    assert fused._kernel_epilogue(torch.relu) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused._kernel_epilogue(torch.tanh)
    with pytest.raises(ValueError, match="unknown epilogue"):
        fused._kernel_epilogue("gelu")


def test_agmm_plan_is_one_wave_at_the_bench_shape():
    # 4 ranks x (256/128) x (1024/64) tiles = 128 CTAs on an H100's 132
    # SMs: a CTA per tile, each walking one tile a ring step
    assert fused.agmm_plan(4, 256, 1024, 132) == (128, 64, 32, 1)
    assert fused.agmm_plan(4, 256, 1024, 264) == (128, 64, 32, 1)
    # ragged edges count a tile each
    assert fused.agmm_plan(2, 129, 65, 132) == (128, 64, 4, 1)
    assert fused.agmm_plan(8, 3, 8, 132) == (128, 64, 1, 1)


def test_agmm_plan_walks_tiles_when_capacity_is_short():
    assert fused.agmm_plan(4, 256, 1024, 64) == (128, 64, 16, 2)
    assert fused.agmm_plan(8, 256, 1024, 40) == (128, 64, 5, 7)
    assert fused.agmm_plan(8, 129, 1000, 8) == (128, 64, 1, 32)
    with pytest.raises(ValueError, match="co-resident"):
        fused.agmm_plan(8, 256, 1024, 7)


# the allreduce kernel's FIFO plan: co-resident CTAs an H100 holds at 8, 4
# and 2 of them an SM (132 SMs), at the bench shape (2^25 f32 a rank) and
# a small one
CAPACITIES = (132 * 8, 132 * 4, 132 * 2)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("world", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("n", [1 << 25, 65, 100_003])
def test_allreduce_fifo_plan_fits_the_l2_budget(world, capacity, n):
    m, _, cn, _ = fused.ring_layout((n,), world, fused.CARD_LANE)
    M = m * cn // 4  # 16-byte f32 vectors a chunk
    plan = fused.allreduce_plan(world, M, capacity)
    # every link's slots together fit the stated L2 budget
    assert plan.fifo_bytes <= fused.ALLREDUCE_FIFO_BUDGET
    assert world * plan.ctas_a_rank <= capacity
    # the kernel's stripes (CTA g takes vectors [g per, (g + 1) per) of
    # every chunk) cover each vector once, in order, each in at most
    # plan.tiles tiles (the longest in exactly that many)
    per = -(-M // plan.ctas_a_rank)
    stripes = [(min(c * per, M), min((c + 1) * per, M))
               for c in range(plan.ctas_a_rank)]
    assert stripes[0][0] == 0 and stripes[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(stripes, stripes[1:]))
    tiles = [-(-(hi - lo) // fused.ALLREDUCE_TILE_VECTORS)
             for lo, hi in stripes]
    assert max(tiles) == plan.tiles and min(tiles) >= 1
    # the scratch it allocates: the FIFO, two counters a link at 0, and
    # the abort word
    s = fused.allreduce_scratch(plan, "cpu")
    assert s["fifo"].numel() * s["fifo"].element_size() == plan.fifo_bytes \
        == (world * plan.ctas_a_rank * fused.ALLREDUCE_SLOTS
            * fused.ALLREDUCE_TILE_VECTORS * 16)
    assert s["flags"].numel() == plan.flag_words \
        == world * plan.ctas_a_rank * 2 * fused.FIFO_FLAG_WORDS
    assert not bool(s["flags"].any()) and s["abort"].numel() == 1
    if n == 1 << 25 and capacity == CAPACITIES[0]:
        # the bench shape spends most of the budget on many stripes of a
        # few dozen tiles each: the slots do not scale with the tensor
        assert plan.fifo_bytes > fused.ALLREDUCE_FIFO_BUDGET // 2
        assert plan.ctas_a_rank >= 64 and plan.tiles <= 64


def test_allreduce_fifo_plan_forced_counts_and_limits():
    plan = fused.allreduce_plan(4, 100_000, 1056, ctas_a_rank=3)
    assert plan.ctas_a_rank == 3
    assert plan.tiles == -(-(-(-100_000 // 3)) // fused.ALLREDUCE_TILE_VECTORS)
    # on a card of any size the budget caps the CTAs: 8 ranks x 64 CTAs x
    # 4 slots of 8 KiB fill the 16 MiB
    big = fused.allreduce_plan(8, 1 << 22, 1 << 20)
    assert big.ctas_a_rank == 64
    assert big.fifo_bytes == fused.ALLREDUCE_FIFO_BUDGET
    # a two-rank geometry of four replicas counts every flat rank's links
    geo = fused.allreduce_plan(8, 1 << 20, 1056)
    assert geo.flag_words == 8 * geo.ctas_a_rank * 2 * fused.FIFO_FLAG_WORDS
    with pytest.raises(ValueError, match="co-resident"):
        fused.allreduce_plan(8, 1 << 20, 7)
