"""The port's on-card overlap pipeline (``hpc_patterns_tpu_torch.
concurrency.pipeline``) against the JAX Pallas ``overlap_run`` in
interpret mode, on the CPU, plus the timing protocol around it.

On CPU tensors ``overlap_run`` computes its plain version. Every chain
step rounds once, as the CUDA kernel's ``fmaf`` and the JAX kernel's
fused multiply-add do, and the checksum is summed in the same order, so
the eight modes whose JAX checksum is defined (overlap, serial, dma,
overlap_out, serial_out, dma_out, pair_overlap, pair_serial) are
compared bit for bit. ``compute``/``compute2`` run on scratch the JAX
kernel never fills (its checksum is undefined there); the port seeds
that scratch with 0.25 / 0.75, so those two are compared with JAX on
shape only and held to determinism within the port.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.concurrency import pipeline as jax_pipeline  # noqa: E402
from hpc_patterns_tpu_torch.concurrency import pipeline  # noqa: E402
from hpc_patterns_tpu_torch.harness import timing  # noqa: E402

SHAPE, TRIPS, PASSES = (4, 8, 128), 3, 2
DEFINED = ("overlap", "serial", "dma", "overlap_out", "serial_out",
           "dma_out", "pair_overlap", "pair_serial")


@pytest.fixture(scope="module")
def hbm():
    return np.random.default_rng(0).random(SHAPE, dtype=np.float32)


def _jax(hbm, mode, trips=TRIPS, passes=PASSES):
    return np.asarray(jax_pipeline.overlap_run(
        jnp.asarray(hbm), mode=mode, tripcount=trips, passes=passes,
        interpret=True))


@pytest.mark.parametrize("mode", DEFINED)
def test_checksum_equals_jax_bitwise(hbm, mode):
    got = pipeline.overlap_run(torch.from_numpy(hbm), mode=mode,
                               tripcount=TRIPS, passes=PASSES)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_array_equal(got.numpy(), _jax(hbm, mode))


@pytest.mark.parametrize("mode", ["compute", "compute2"])
def test_seeded_compute_modes_shape_and_determinism(hbm, mode):
    x = torch.from_numpy(hbm)
    a = pipeline.overlap_run(x, mode=mode, tripcount=TRIPS, passes=PASSES)
    b = pipeline.overlap_run(x, mode=mode, tripcount=TRIPS, passes=PASSES)
    assert tuple(a.shape) == _jax(hbm, mode).shape
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    # independent of the data: the chain runs on the seeded slots
    assert torch.equal(a, pipeline.overlap_run(x * 0, mode=mode,
                                               tripcount=TRIPS,
                                               passes=PASSES))


def test_compute2_is_two_chains(hbm):
    # compute2's first chain is compute's, so the difference is the
    # second chain's share and the checksum grows
    x = torch.from_numpy(hbm)
    one = pipeline.overlap_run(x, mode="compute", tripcount=TRIPS)
    two = pipeline.overlap_run(x, mode="compute2", tripcount=TRIPS)
    assert bool((two > one).all())


@pytest.mark.parametrize("a,b", [("overlap", "serial"),
                                 ("overlap_out", "serial_out"),
                                 ("pair_overlap", "pair_serial")])
def test_overlapped_equals_serial(hbm, a, b):
    x = torch.from_numpy(hbm)
    assert torch.equal(
        pipeline.overlap_run(x, mode=a, tripcount=TRIPS, passes=PASSES),
        pipeline.overlap_run(x, mode=b, tripcount=TRIPS, passes=PASSES))


def test_copy_only_modes_and_data_dependence(hbm):
    x = torch.from_numpy(hbm)
    for mode in ("dma", "dma_out"):
        assert not pipeline.overlap_run(x, mode=mode, tripcount=2).any()
    a = pipeline.overlap_run(x, mode="serial", tripcount=3)
    assert not torch.equal(a, pipeline.overlap_run(x + 1, mode="serial",
                                                   tripcount=3))
    assert not torch.equal(a, pipeline.overlap_run(x, mode="serial",
                                                   tripcount=4))


@pytest.mark.parametrize("mode", pipeline.OUT_BUF_MODES)
def test_written_arrays(hbm, mode):
    x = torch.from_numpy(hbm)
    out = torch.full_like(x, -1.0)
    pipeline.overlap_run(x, mode=mode, tripcount=1, out=out)
    _, written = pipeline.overlap_run_reference(x, mode=mode, tripcount=1)
    assert torch.equal(out, written)
    if mode.startswith("pair"):
        assert torch.equal(out, x)
    else:
        for i in range(SHAPE[0]):
            assert bool((out[i] == pipeline.SEEDS[i % 2]).all())


def test_modes_that_write_nothing_return_no_array(hbm):
    for mode in ("overlap", "serial", "dma", "compute", "compute2"):
        _, written = pipeline.overlap_run_reference(
            torch.from_numpy(hbm), mode=mode, tripcount=1)
        assert written is None


def test_bad_mode_shape_and_arguments():
    x = torch.zeros(2, 8, 128)
    with pytest.raises(ValueError, match="mode"):
        pipeline.overlap_run(x, mode="warp")
    for bad in (torch.zeros(2, 8, 64), torch.zeros(2, 12, 128),
                torch.zeros(8, 128)):
        with pytest.raises(ValueError, match="num_chunks"):
            pipeline.overlap_run(bad, mode="serial")
    with pytest.raises(ValueError, match="float32"):
        pipeline.overlap_run(x.double(), mode="serial")
    with pytest.raises(ValueError, match="2 chunks"):
        pipeline.overlap_run(torch.zeros(1, 8, 128), mode="overlap_out")
    with pytest.raises(ValueError, match=">= 0"):
        pipeline.overlap_run(x, mode="serial", tripcount=-1)
    with pytest.raises(ValueError, match="out must match"):
        pipeline.overlap_run(x, mode="pair_serial", out=torch.zeros(2, 8, 64))
    # the JAX package rejects the same calls
    with pytest.raises(ValueError):
        jax_pipeline.overlap_run(jnp.zeros((2, 12, 128)), mode="serial")
    with pytest.raises(ValueError):
        jax_pipeline.overlap_run(jnp.zeros((1, 8, 128)), mode="overlap_out")


@pytest.mark.parametrize("rows,sms,blocks,tiles", [
    (2048, 132, 132, 1), (32768, 132, 132, 2), (64, 132, 8, 1),
    (8, 132, 1, 1), (4096, 16, 16, 2), (200, 10, 10, 1),
    (65536, 132, 132, 3), (1064, 132, 132, 1)])
def test_pipeline_plan(rows, sms, blocks, tiles):
    # one block an SM (fewer below 8 rows a block), each with an equal
    # share of every chunk in 32-float units (shares differ by at most one
    # unit), cut into tiles whose two slots fit shared memory; block 0's
    # first tile holds rows 0-7. Both overlap shapes run one wave on 132
    # SMs: 16 x 2048 in one tile a block, 16 x 32768 in two
    assert pipeline.pipeline_plan(rows, sms) == (blocks, tiles)
    units = rows * 4
    shares = [(b + 1) * units // blocks - b * units // blocks
              for b in range(blocks)]
    assert max(shares) - min(shares) <= 1 and sum(shares) == units
    slot_units = -(-max(shares) // tiles)
    assert 2 * slot_units * pipeline.UNIT_BYTES <= 2 * pipeline.SLOT_BYTES_MAX
    assert shares[0] // tiles * 32 >= 8 * 128


def test_make_hbm_array_is_seeded():
    a = pipeline.make_hbm_array(3, 16, seed=5, device="cpu")
    assert tuple(a.shape) == (3, 16, 128) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, pipeline.make_hbm_array(3, 16, seed=5,
                                                  device="cpu"))
    assert not torch.equal(a, pipeline.make_hbm_array(3, 16, seed=6,
                                                      device="cpu"))


class TestAmortized:
    def test_differencing_recovers_per_iter_cost(self, monkeypatch):
        # a fake clock: each call costs 0.5 s of latency + 1 ms per iter
        clock = {"t": 0.0}
        monkeypatch.setattr(timing.time, "perf_counter",
                            lambda: clock["t"])

        def run(n):
            clock["t"] += 0.5 + 1e-3 * n
            return torch.zeros(1)

        got = timing.amortized_seconds(run, iters=64, base_iters=32,
                                       repetitions=2)
        assert got == pytest.approx(1e-3, rel=1e-9)

    def test_rejects_bad_iters(self):
        with pytest.raises(ValueError):
            timing.amortized_seconds(lambda n: torch.zeros(1), iters=1)
        with pytest.raises(ValueError):
            timing.amortized_seconds(lambda n: torch.zeros(1), iters=4,
                                     base_iters=4)

    def test_negative_difference_clamps_to_zero(self, monkeypatch):
        # the base call is slower than the long one (noise): 0, not < 0
        clock = {"t": 0.0}
        monkeypatch.setattr(timing.time, "perf_counter",
                            lambda: clock["t"])

        def run(n):
            clock["t"] += 1.0 if n == 1 else 0.1
            return torch.zeros(1)

        assert timing.amortized_seconds(run, iters=8, repetitions=1) == 0.0

    def test_measure_forced_reads_the_result_back(self):
        seen = []

        class Probe:
            def cpu(self):
                seen.append(1)

        timing.measure_forced(lambda: Probe(), repetitions=3, warmup=1)
        assert len(seen) == 4


def test_balance_tripcount_clamps_runaway():
    # absurdly fast compute probe: trips must clamp, not explode
    trips, _ = pipeline.balance_tripcount(lambda m, t: 1e-9, 1.0, "compute",
                                          64, max_trips=4096)
    assert trips <= 4096
    want = jax_pipeline.balance_tripcount(lambda m, t: 1e-9, 1.0, "compute",
                                          64, max_trips=4096)
    assert (trips, _) == want


def test_balance_tripcount_converges_on_a_linear_model():
    per_trip = 2.0 ** -20
    trips, t = pipeline.balance_tripcount(lambda m, n: n * per_trip,
                                          100 * per_trip, "compute", 64)
    assert trips == 100 and t == 100 * per_trip


def test_per_pass_seconds_runs_the_protocol_on_cpu(hbm):
    x = torch.from_numpy(hbm)
    t = pipeline.per_pass_seconds(x, "serial", 1, cal_passes=2,
                                  repetitions=1, target_s=1e-3)
    assert t >= 0.0
