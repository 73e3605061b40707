"""The port's halo exchange (``hpc_patterns_tpu_torch/comm/halo.py``) and
stencil app against the JAX package on the CPU.

Inputs from numpy seeds go through JAX's ``halo_exchange`` and
``jacobi_step`` inside ``shard_map`` on the 8-device CPU mesh and through
the port's over the same 8 shards stacked on one tensor. The exchange
moves data only, so it is held bit for bit in f32 and bf16 at halo 1 and
2. The Jacobi loop is held over 64 steps bit for bit at alpha 0.25 (its
products are exact, by powers of two) and within atol 4e-6 at alpha 0.1,
where XLA's fused step and the port's eager one round the products
differently: at most about one f32 ulp of |u| <= 1 a step, 64 x 2^-24 in
all (5.4e-7 seen). The app runs at ``-p 10`` with both oracles true and its
sharded result equal to its dense replay bit for bit.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from hpc_patterns_tpu.comm import halo as jhalo  # noqa: E402
from hpc_patterns_tpu.topology import shard_map  # noqa: E402
from hpc_patterns_tpu_torch.apps import stencil_app  # noqa: E402
from hpc_patterns_tpu_torch.comm import halo as thalo  # noqa: E402

R, N_LOCAL = 8, 4


def _jax_halo(mesh, x, halo):
    fn = shard_map(lambda l: jhalo.halo_exchange(l, "x", halo=halo),
                   mesh=mesh, in_specs=P("x"), out_specs=P("x"))
    return jax.jit(fn)(x)


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_exchange_equals_jax_bit_for_bit(mesh8, halo, dtype):
    x = np.random.default_rng(halo).standard_normal(
        (R * N_LOCAL, 3)).astype(np.float32)
    want = _jax_halo(mesh8, jnp.asarray(x, dtype=getattr(jnp, dtype)), halo)
    got = thalo.halo_exchange(
        torch.from_numpy(x).to(getattr(torch, dtype)).reshape(R, N_LOCAL, 3),
        halo=halo)
    assert got.shape == (R, N_LOCAL + 2 * halo, 3)
    np.testing.assert_array_equal(
        got.float().reshape(-1, 3).numpy(),
        np.asarray(want.astype(jnp.float32)))
    # the periodic layout: rank 0's left ghosts are rank R-1's last rows
    torch.testing.assert_close(got[0, :halo].float(),
                               torch.from_numpy(x[-halo:]).to(
                                   getattr(torch, dtype)).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("alpha,atol", [(0.25, 0.0), (0.1, 4e-6)])
def test_jacobi_64_steps_match_jax(mesh8, alpha, atol):
    u0 = np.random.default_rng(7).uniform(size=R * N_LOCAL * 8).astype(
        np.float32)
    fn = shard_map(lambda l: lax.fori_loop(
        0, 64, lambda _, v: jhalo.jacobi_step(v, "x", alpha=alpha), l),
        mesh=mesh8, in_specs=P("x"), out_specs=P("x"))
    want = np.asarray(jax.jit(fn)(jnp.asarray(u0)))
    u = torch.from_numpy(u0).reshape(R, -1)
    for _ in range(64):
        u = thalo.jacobi_step(u, alpha=alpha)
    np.testing.assert_allclose(u.reshape(-1).numpy(), want, rtol=0,
                               atol=atol)


def test_validation_errors_are_jaxs(mesh8):
    x = torch.zeros(R, 2)
    for halo in (0, -1):
        with pytest.raises(ValueError, match="halo must be >= 1"):
            thalo.halo_exchange(x, halo=halo)
        with pytest.raises(ValueError, match="halo must be >= 1"):
            _jax_halo(mesh8, jnp.zeros((R * 2,)), halo)
    with pytest.raises(ValueError, match="smaller than halo 3"):
        thalo.halo_exchange(x, halo=3)
    with pytest.raises(ValueError, match="smaller than halo 3"):
        _jax_halo(mesh8, jnp.zeros((R * 2,)), 3)


def test_stencil_app_passes_with_both_oracles(tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    rc = stencil_app.main(["--device", "cpu", "-p", "10", "--steps", "64",
                           "--repetitions", "2", "--warmup", "1",
                           "--log", str(log)])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("SUCCESS"), out
    assert "torch.Generator seed 0" in out
    assert all(f"Passed {r}" in out for r in range(4))
    (res,) = [json.loads(x) for x in log.read_text().splitlines()
              if json.loads(x).get("kind") == "result"]
    assert res["conserved"] and res["matches_dense"]
    assert res["bitwise_dense"]  # the sharded loop IS the dense replay
    assert res["world"] == 4 and res["elements"] == 1024
    assert res["per_step_us"] > 0
