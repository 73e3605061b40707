"""The port's ring engine, collectives, communicator and comm apps against
the JAX reference (``hpc_patterns_tpu/comm``) on the same seeded inputs.

The JAX side runs rank-local functions under ``shard_map`` on the
conftest's 8-device CPU mesh (a submesh for smaller rings); the port runs
the same ring over the rows of one global CPU tensor. The ring routes do
the same adds in the same chunk order, so they agree bit for bit for
float32 and int32 at every ring size 2-8.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from hpc_patterns_tpu.comm import ring as jring
from hpc_patterns_tpu.topology import shard_map
from hpc_patterns_tpu_torch.apps import allreduce_app, common, pingpong_app
from hpc_patterns_tpu_torch.comm import collectives, fused, ring
from hpc_patterns_tpu_torch.comm.communicator import Communicator

SIZES = [2, 3, 4, 5, 6, 7, 8]
DTYPES = ["float32", "int32"]


def submesh(size):
    return Mesh(np.asarray(jax.devices()[:size]), ("x",))


def jax_run(fn, size, x, out_ndim=2):
    spec_in = P("x", *([None] * (x.ndim - 1)))
    spec_out = P("x", *([None] * (out_ndim - 1)))
    f = jax.jit(shard_map(fn, mesh=submesh(size), in_specs=spec_in,
                          out_specs=spec_out))
    return np.asarray(f(x))


def data(size, n, dtype, seed=0):
    x = (np.random.default_rng(seed + size).normal(size=(size, n)) * 8
         ).astype(np.float32)
    return x.astype(np.int32) if dtype == "int32" else x


def port(fn, x):
    return fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", SIZES)
class TestRingParity:
    def test_ring_allreduce(self, size, dtype):
        x = data(size, 24, dtype)
        want = jax_run(lambda l: jring.ring_allreduce(l, "x"), size, x)
        np.testing.assert_array_equal(port(ring.ring_allreduce, x), want)

    def test_ring_allreduce_chunked(self, size, dtype):
        x = data(size, 5 * size, dtype)
        want = jax_run(lambda l: jring.ring_allreduce_chunked(
            l, "x", scatter_axis=1), size, x)
        got = port(lambda t: ring.ring_allreduce_chunked(t, scatter_axis=0),
                   x)
        np.testing.assert_array_equal(got, want)

    def test_ring_reduce_scatter_and_all_gather(self, size, dtype):
        x = data(size, 3 * size, dtype)
        want = jax_run(lambda l: jring.ring_reduce_scatter(l[0], "x")[None],
                       size, x)
        got = port(ring.ring_reduce_scatter, x)
        np.testing.assert_array_equal(got, want)
        c = data(size, 3, dtype, seed=7)
        want_t = jax_run(lambda l: jring.ring_all_gather(
            l[0], "x", tiled=True)[None], size, c)
        np.testing.assert_array_equal(
            port(lambda t: ring.ring_all_gather(t, tiled=True), c), want_t)
        want_s = jax_run(lambda l: jring.ring_all_gather(l[0], "x")[None],
                         size, c, out_ndim=3)
        np.testing.assert_array_equal(port(ring.ring_all_gather, c), want_s)

    def test_ring_shift_and_pairwise_exchange(self, size, dtype):
        x = data(size, 6, dtype)
        for shift in (1, -1, 3):
            want = jax_run(lambda l: jring.ring_shift(l, "x", shift), size, x)
            np.testing.assert_array_equal(
                port(lambda t: ring.ring_shift(t, shift), x), want)
        if size % 2:
            with pytest.raises(ValueError, match="even axis size"):
                ring.pairwise_exchange(torch.from_numpy(x))
            return
        want = jax_run(lambda l: jring.pairwise_exchange(l, "x"), size, x)
        np.testing.assert_array_equal(port(ring.pairwise_exchange, x), want)


def test_check_permutation_rejections_match_the_reference():
    bad = [([(0, 0), (1, 0)], "duplicate"), ([(0, 1)], "partial"),
           ([(0, 5), (1, 0)], "out of range")]
    for pairs, msg in bad:
        for mod in (ring, jring):
            with pytest.raises(ValueError, match=msg):
                mod.check_permutation(pairs, 2)
    ring.check_permutation([(0, 1)], 2, allow_partial=True)
    assert ring._ring_perm(5, -2) == jring._ring_perm(5, -2)


def test_ring_schedule_generic_combine():
    x = torch.from_numpy(data(8, 16, "float32"))
    out = ring.ring_schedule(x, lambda acc, inc, _s: torch.maximum(acc, inc))
    assert torch.equal(out, x.amax(0, keepdim=True).expand_as(x))


def test_collectives_match_their_definitions():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    for op, ref in (("sum", x.sum(0)), ("max", x.amax(0)),
                    ("min", x.amin(0)), ("mean", x.sum(0) / 4),
                    ("prod", x.prod(0))):
        out = collectives.allreduce(x, op)
        assert out.shape == x.shape and torch.equal(out[2], ref), op
    with pytest.raises(ValueError, match="unknown reduce op"):
        collectives.allreduce(x, "xor")
    assert torch.equal(collectives.broadcast(x, root=3)[0], x[3])
    g = collectives.all_gather(x)
    assert g.shape == (4, 32) and torch.equal(g[1], x.reshape(-1))
    assert collectives.all_gather(x, tiled=False).shape == (4, 4, 8)
    rs = collectives.reduce_scatter(x)
    assert torch.equal(rs, x.sum(0).reshape(4, 2))
    a2a = collectives.all_to_all(torch.arange(16.).reshape(4, 4))
    assert torch.equal(a2a, torch.arange(16.).reshape(4, 4).T)


def test_fused_prod_is_refused_and_host_prod_is_exact():
    x = torch.arange(1, 9, dtype=torch.int32).reshape(4, 2)
    with pytest.raises(ValueError, match="prod"):
        fused._check_op("prod")
    with pytest.raises(ValueError, match="prod"):
        fused.fused_allreduce(x, op="prod")
    assert torch.equal(collectives.allreduce(x, "prod")[0],
                       torch.tensor([105, 384], dtype=torch.int32))


class TestCommunicator:
    def test_allreduce_algorithms_hit_the_oracle(self):
        c = Communicator({"x": 8}, "x", device="cpu")
        for dtype in ("float32", "int32", "bfloat16"):
            x = c.rank_filled(64, dtype)
            for alg in ("collective", "ring", "ring_chunked", "fused"):
                out = c.allreduce(x, alg)
                assert out.shape == (8, 64)
                assert bool((out.float() == 28).all()), (dtype, alg)
        assert c.expected_allreduce_value() == 28

    def test_jit_allreduce_one_closure_per_key(self):
        c = Communicator({"x": 8}, "x", device="cpu")
        x = c.shard(torch.ones(8, 32))
        fns = {}
        for alg in ("fused", "collective", "ring", "ring_chunked"):
            assert c.jit_allreduce(x, alg) is c.jit_allreduce(x, alg), alg
            fns[alg] = c.jit_allreduce(x, alg)
        assert len(set(map(id, fns.values()))) == 4
        y = c.shard(torch.ones(8, 16))
        assert c.jit_allreduce(y, "fused") is not fns["fused"]
        assert c.jit_allreduce(x, "fused") is fns["fused"]
        assert ((8, 32), "float32", "x", "fused") in c._jit_allreduce_cache
        with pytest.raises(ValueError, match="algorithm"):
            c.jit_allreduce(x, "bogus")

    def test_multi_axis_cache_keys_per_axis(self):
        for axis in ("a", "b"):
            c = Communicator({"a": 2, "b": 4}, axis, device="cpu")
            x = c.shard(torch.ones(c.size, 32))
            f1 = c.jit_allreduce(x, "fused")
            assert c.jit_allreduce(x, "fused") is f1
            assert ((c.size, 32), "float32", axis, "fused") in \
                c._jit_allreduce_cache

    def test_point_to_point_and_gathers(self):
        c = Communicator({"x": 8}, "x", device="cpu")
        rows = c.rank_filled(4)
        assert torch.equal(c.pingpong(rows)[:, 0],
                           torch.tensor([r ^ 1 for r in range(8)]).float())
        assert torch.equal(c.sendrecv_ring(rows, 1)[:, 0],
                           ((torch.arange(8) - 1) % 8).float())
        assert c.all_gather(rows).shape == (8, 8, 4)
        assert c.reduce_scatter(torch.ones(8, 32)).shape == (8, 4)
        with pytest.raises(ValueError, match="leading dim"):
            c.shard(torch.ones(9, 4))
        with pytest.raises(ValueError, match="not in mesh"):
            Communicator({"x": 8}, "nope", device="cpu")

    def test_pingpong_fused_route_equals_the_collective(self):
        for mesh, axis in (({"x": 8}, "x"), ({"a": 2, "b": 4}, "b")):
            c = Communicator(mesh, axis, device="cpu")
            rows = c.shard(torch.arange(c.size * 6.0).reshape(c.size, 6))
            assert torch.equal(c.pingpong(rows, "fused"), c.pingpong(rows))
            assert c.jit_pingpong(rows) is ring.pairwise_exchange
        with pytest.raises(ValueError, match="algorithm"):
            c.jit_pingpong(rows, "bogus")

    def test_allreduce_into_routes_agree(self):
        c = Communicator({"x": 8}, "x", device="cpu")
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        got = c.allreduce_into(x, bias=bias, epilogue="relu")
        ref = c.allreduce_into(x, bias=bias, epilogue="relu",
                               algorithm="collective")
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        widen = lambda v: v.float() * 1.5  # noqa: E731
        xi = x.to(torch.int32)
        a = c.allreduce_into(xi, epilogue=widen)
        b = c.allreduce_into(xi, epilogue=widen, algorithm="collective")
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)


def test_bus_bandwidth_normalization():
    assert common.allreduce_bus_bandwidth_gbps(1e9, 1.0, 2) == pytest.approx(1)
    assert common.allreduce_bus_bandwidth_gbps(1e9, 1.0, 8) == pytest.approx(
        1.75)
    assert common.allreduce_bus_bandwidth_gbps(1e9, 1.0, 1) == 0.0


def test_make_communicator_world_guards():
    assert common.make_communicator("cpu").size == common.DEFAULT_WORLD == 4
    assert common.make_communicator("cpu", 8).size == 8
    assert common.make_communicator("cpu", 5, even=True).size == 4
    with pytest.raises(ValueError, match="world"):
        common.make_communicator("cpu", 0)


def test_allreduce_app_size_sweep(tmp_path, capsys):
    log = tmp_path / "sweep.jsonl"
    rc = allreduce_app.main(["--sweep", "--min-p", "3", "-p", "5",
                             "--device", "cpu", "--world", "8",
                             "--repetitions", "2", "--warmup", "1",
                             "--log", str(log)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "sweep: 12/12 points passed" in out
    records = [json.loads(ln) for ln in log.read_text().splitlines()
               if '"result"' in ln]
    assert len(records) == 12  # 4 algorithms x p in {3,4,5}
    assert {r["name"] for r in records} == {
        "allreduce[ring]", "allreduce[ring_chunked]",
        "allreduce[collective]", "allreduce[fused]"}
    assert all(r["success"] and r["world"] == 8 for r in records)
    assert sorted(r["elements"] for r in records
                  if r["name"] == "allreduce[collective]") == [8, 16, 32]


@pytest.mark.parametrize("extra", [[], ["-a"], ["--algorithm", "fused"],
                                   ["--dtype", "int32"],
                                   ["--dtype", "bfloat16", "-S"]])
def test_allreduce_app_single_point(capsys, extra):
    rc = allreduce_app.main(["-p", "6", "--device", "cpu", "--world", "8",
                             "--repetitions", "2", "--warmup", "1"] + extra)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Passed 0" in out and "Passed 7" in out and "SUCCESS" in out


def test_allreduce_app_guards(capsys):
    assert allreduce_app.main(["--sweep", "--min-p", "9", "-p", "5",
                               "--device", "cpu"]) == 1
    assert "FAILURE" in capsys.readouterr().out
    # -H on the CPU: JAX's note, then the device memory
    assert allreduce_app.main(["-p", "4", "-H", "--device", "cpu",
                               "--repetitions", "1"]) == 0
    assert "note: memory kind 'pinned_host' unsupported here" in \
        capsys.readouterr().out
    # an odd world drops to even, as the reference's precondition asks
    assert allreduce_app.main(["-p", "4", "--device", "cpu", "--world", "5",
                               "--repetitions", "1"]) == 0
    assert "world=4" in capsys.readouterr().out


def test_allreduce_app_host_kind_sweep_on_the_cpu(tmp_path, capsys):
    # -H where pinned host memory is unusable: JAX's note once for the
    # whole sweep, every point validated in device memory and logged so
    log = tmp_path / "h.jsonl"
    assert allreduce_app.main(["--sweep", "--min-p", "3", "-p", "4", "-H",
                               "--algorithm", "fused", "--device", "cpu",
                               "--repetitions", "1", "--log",
                               str(log)]) == 0
    out = capsys.readouterr().out
    assert out.count("note: memory kind 'pinned_host' unsupported") == 1
    results = [json.loads(line) for line in log.read_text().splitlines()
               if '"kind": "result"' in line]
    assert len(results) == 2
    assert all(r["memory_kind"] == "device" and r["success"]
               for r in results)


def test_device_mismatch_count():
    from hpc_patterns_tpu_torch.dtypes import get_traits

    row = torch.full((100,), 6.0)
    row[7] = 6.5
    assert allreduce_app.device_mismatches(row, 6.0, get_traits("float32")) == 1
    assert allreduce_app.device_mismatches(row.int(), 6.0,
                                           get_traits("int32")) == 0


def test_pingpong_app_sweep(capsys):
    rc = pingpong_app.main(["--min-p", "3", "-p", "6", "--device", "cpu",
                            "--world", "8", "--repetitions", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("pingpong n=2^") == 4
    assert "SUCCESS" in out and "MISMATCH" not in out
    assert pingpong_app.main(["--min-p", "7", "-p", "3",
                              "--device", "cpu"]) == 1


def test_pingpong_app_fused_route(tmp_path, capsys):
    log = tmp_path / "pp.jsonl"
    rc = pingpong_app.main(["--min-p", "3", "-p", "5", "--device", "cpu",
                            "--world", "8", "--repetitions", "2",
                            "--algorithm", "fused", "--log", str(log)])
    out = capsys.readouterr().out
    assert rc == 0 and "SUCCESS" in out and "MISMATCH" not in out, out
    recs = [json.loads(ln) for ln in log.read_text().splitlines()
            if '"result"' in ln]
    assert [r["algorithm"] for r in recs] == ["fused"] * 3
    assert all(r["success"] and r["world"] == 8 for r in recs)


def test_bench_collective_keys_on_cpu():
    from hpc_patterns_tpu_torch import bench

    d = bench.fused_collective_detail(torch.device("cpu"))
    assert d["comm_world"] == 4
    assert d["fused_allreduce_gbps"] > 0 and d["allreduce_busbw_gbps"] > 0
    assert set(d["allreduce_gbps_by_algorithm"]) == {
        "fused", "collective", "ring_chunked"}
    assert 0.0 <= d["allreduce_overlap_frac"] < 1.0


def test_dtype_registry_matches_the_reference():
    from hpc_patterns_tpu import dtypes as jdtypes
    from hpc_patterns_tpu_torch import dtypes

    assert set(dtypes.REGISTRY) == set(jdtypes.REGISTRY)
    for name, t in dtypes.REGISTRY.items():
        j = jdtypes.REGISTRY[name]
        assert (t.itemsize, t.exact_sum, t.tolerance) == (
            j.itemsize, j.exact_sum, j.tolerance), name
        assert t.name == name and dtypes.get_traits(t.dtype) is t
    assert dtypes.get_traits(torch.complex64).exact_sum  # the byte default
    with pytest.raises(ValueError, match="unknown dtype"):
        dtypes.get_traits("float7")
    assert dtypes.validate_allreduce(torch.full((4,), 6.0), 6, "float32")
    assert not dtypes.validate_allreduce(torch.tensor([6, 7]), 6, "int32")
