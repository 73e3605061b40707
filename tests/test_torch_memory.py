"""The port's tiered-memory package (``hpc_patterns_tpu_torch.memory``)
against the JAX one: JAX's own bodies of ``tests/test_memory.py``'s
policy and accounting classes run on the port's manager
(``tests/_torch_parity.py``); the kind probes give JAX's answers on this
CPU where torch has the same memory (advertised kinds, the refused round
trip) and say no to placing page-locked memory, which the CPU build of
torch does not have; a push and a pull round-trip every dtype's bytes
exactly, with ``mem.prefetch``/``mem.evict`` windows, gauges and the
``host_transfer`` chaos site; ``ResidencyManager.from_fitted`` picks
each policy from a config JAX's autofit wrote, and a tiered port run's
records fit to the same residency section through both packages'
autofit. CPU only.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.harness import autofit as jautofit  # noqa: E402
from hpc_patterns_tpu.memory import kinds as jkinds  # noqa: E402
from hpc_patterns_tpu_torch.harness import autofit as tautofit  # noqa: E402
from hpc_patterns_tpu_torch.harness import chaos as chaoslib  # noqa: E402
from hpc_patterns_tpu_torch.harness import metrics as metricslib  # noqa: E402
from hpc_patterns_tpu_torch.harness import trace as tracelib  # noqa: E402
from hpc_patterns_tpu_torch.memory import (  # noqa: E402
    ColdAfterNPolicy,
    LRUPolicy,
    PriorityAwarePolicy,
    ResidencyManager,
)
from hpc_patterns_tpu_torch.memory import kinds  # noqa: E402

import _torch_parity as parity  # noqa: E402

JAX_BODIES = parity.load("test_memory")
CASES = parity.cases(JAX_BODIES, ["TestPolicies", "TestManagerAccounting"])


@pytest.mark.parametrize("cls,method", CASES,
                         ids=[f"{c}.{m}" for c, m in CASES])
def test_jax_body_on_the_port(cls, method, request):
    parity.call(JAX_BODIES, cls, method, request)


def test_jax_bodies_reach_the_port():
    from hpc_patterns_tpu_torch.memory import residency

    assert JAX_BODIES.ResidencyManager is ResidencyManager
    assert JAX_BODIES.GroupView is residency.GroupView
    assert JAX_BODIES.metricslib is metricslib
    assert len(CASES) == 8


@pytest.mark.parametrize("kind", ["pinned_host", "device", "unpinned_host",
                                  "no-such-kind"])
def test_kinds_advertised_as_jax_says(kind):
    assert kinds.supports_memory_kind(kind) == \
        jkinds.supports_memory_kind(kind)


def test_kind_probes_on_this_cpu():
    jdev = jax.devices()[0]
    # the round trip: refused by both
    assert kinds.memory_kind_transfers_work("cpu") is False
    assert kinds.memory_kind_transfers_work("cpu") == \
        jkinds.memory_kind_transfers_work(jdev)
    # placing: equal for the pageable kinds; page-locked memory needs
    # CUDA in torch, where JAX's CPU places into a host memory
    for kind in ("device", "unpinned_host"):
        assert kinds.memory_kind_placement_works("cpu", kind) is True
        assert jkinds.memory_kind_placement_works(jdev, kind) is True
    assert kinds.memory_kind_placement_works("cpu", "pinned_host") is False
    # memoized, and never raising
    assert kinds.memory_kind_placement_works("cpu", "pinned_host") is False
    assert kinds.memory_kind_placement_works("cpu", "no-such") is False


def test_move_to_kind_is_cached_per_direction():
    assert kinds.move_to_kind("cpu", "device") is \
        kinds.move_to_kind("cpu", "device")
    x = torch.arange(6.0)
    y = kinds.move_to_kind("cpu", "device")(x)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()
    with pytest.raises(RuntimeError, match="CUDA"):
        kinds.move_to_kind("cpu", "pinned_host")(x)


def test_placements_are_single_device_shardings():
    sh = kinds.kind_sharding("cpu", "device")
    assert sh.kind == "device" and sh.device == torch.device("cpu")
    tree = {"a": torch.zeros(4), "b": (torch.zeros(2), torch.zeros(3))}
    got = kinds.memory_kind_shardings(tree, "unpinned_host")
    assert set(got) == {"a", "b"} and len(got["b"]) == 2
    assert all(p.kind == "unpinned_host"
               for p in (got["a"], *got["b"]))
    with pytest.raises(ValueError, match="memory kind"):
        kinds.kind_sharding("cpu", "hbm")


def test_consumers_delegate_to_kinds():
    from hpc_patterns_tpu_torch.apps import common
    from hpc_patterns_tpu_torch.concurrency import commands

    assert commands._kind_sharding is kinds.kind_sharding
    assert commands._memory_kind_transfers_work is \
        kinds.memory_kind_transfers_work
    assert commands._move_to_kind is kinds.move_to_kind
    assert common.supports_memory_kind("pinned_host") == \
        kinds.supports_memory_kind("pinned_host")
    # the copy commands' host side is pinned exactly where the probe says
    m2d = commands.CopyM2DCommand(16, device="cpu")
    assert m2d._host.is_pinned() is False


PAYLOAD_DTYPES = [torch.float32, torch.bfloat16, torch.int8,
                  torch.float8_e4m3fn]


@pytest.mark.parametrize("dtype", PAYLOAD_DTYPES, ids=str)
def test_push_pull_round_trip_bytes_exactly(dtype):
    gen = torch.Generator().manual_seed(3)
    vals = torch.randn(2, 4, 8, 16, generator=gen) * 50
    payload = {"k": tuple(vals[i].to(dtype) for i in range(2)),
               "v": (vals[1].to(dtype), vals[0].to(dtype))}
    m = ResidencyManager(host_blocks=8, device="cpu")
    host = m.push_payload(payload, attrs={"seq_id": 0})
    m.drain()
    back, handle = m.pull_payload(host)
    m.wait_pull(handle)
    m.complete_pull(handle)
    for name in payload:
        for a, h, b in zip(payload[name], host[name], back[name]):
            # copies, not views, and the same bytes both ways
            assert h.data_ptr() != a.data_ptr() != b.data_ptr()
            assert torch.equal(a.view(torch.uint8), h.view(torch.uint8))
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    nbytes = sum(a.numel() * a.element_size()
                 for t in payload.values() for a in t)
    assert m.evict_bytes == m.prefetch_bytes == nbytes
    assert m.swap_outs == m.swap_ins == 1
    assert m.host_tier_is_pinned() is False  # the CPU clone


def test_windows_gauges_and_chaos_site():
    rec = tracelib.configure(enabled=True)
    metricslib.configure(enabled=True)
    chaoslib.configure("slow_host_transfer:delay_ms=30")
    try:
        m = ResidencyManager(host_blocks=8, device="cpu")
        m.register_group("r0", 2, 64)
        dev, handle = m.pull_payload({"k": (torch.arange(8.0),)})
        m.complete_pull(handle, chunk_windows=())
        m.push_payload(dev)
        m.drain()
        wins = [ev for ev in rec.events if ev[0] == "X"
                and ev[1] == "device"]
        names = [ev[2] for ev in wins]
        assert "mem.prefetch" in names and "mem.evict" in names
        pf = next(ev for ev in wins if ev[2] == "mem.prefetch")
        # the injected delay lies inside the window it claims
        assert pf[5] >= 0.03 and pf[6]["bytes"] == 32
        fired = [e for e in chaoslib.injections()
                 if e["site"] == "host_transfer"]
        assert len(fired) == 1 and fired[0]["kind"] == "slow_host_transfer"
        reg = metricslib.get_metrics()
        assert reg.gauge("mem.prefetch_bytes").last == 32
        assert reg.gauge("mem.hbm_pages").last == 2
        assert m.prefetch_overlap_frac == 0.0
    finally:
        chaoslib.reset()
        tracelib.configure(enabled=False)
        metricslib.configure(enabled=False)


def test_overlap_not_inflated_by_late_completion():
    import time

    m = ResidencyManager(host_blocks=8, device="cpu")
    _, handle = m.pull_payload({"k": (torch.zeros(4),)})
    t0 = handle[3]
    time.sleep(0.05)
    m.complete_pull(handle, chunk_windows=((t0, t0 + 0.001),))
    assert m.prefetch_overlap_frac < 0.5


def test_manager_binds_its_consumer_device():
    m = ResidencyManager(host_blocks=4)
    m.bind_device("cpu")
    assert m.device == torch.device("cpu") and m.side_stream is None
    with pytest.raises(ValueError, match="cannot serve"):
        ResidencyManager(host_blocks=4, device="cpu").bind_device("cuda")


def _jax_written(tmp_path, records, **residency):
    """A FittedConfig JAX's autofit fit from ``records`` (its residency
    section overridden by ``residency``), written by JAX's dumps_config."""
    fitted = jautofit.fit(records)
    if residency:
        fitted["residency"] = {**(fitted.get("residency") or {}),
                               **residency}
    path = tmp_path / "fitted.json"
    path.write_text(jautofit.dumps_config(fitted))
    return tautofit.load_fitted(path)


PAGING = [{"kind": "serve_admit", "seq_id": 0, "priority": 0},
          {"kind": "serve_swap_out", "seq_id": 0},
          {"kind": "serve_prefetch", "seq_id": 0}]


@pytest.mark.parametrize("records,over,policy,floor,depth", [
    (PAGING, {}, LRUPolicy, 1, None),
    (PAGING + [{"kind": "serve_admit", "seq_id": 1, "priority": 1}], {},
     PriorityAwarePolicy, 1, None),
    (PAGING + [{"kind": "serve_prefetch", "seq_id": 0}] * 3, {},
     LRUPolicy, 2, None),
    (PAGING, {"policy": "cold_after_n", "cold_after_n": 3,
              "prefetch_depth": 2}, ColdAfterNPolicy, 1, 2),
    ([{"kind": "serve_admit", "seq_id": 0, "priority": 0}], {},
     LRUPolicy, 1, None),
], ids=["lru", "priority", "anti-thrash", "cold_after_n", "never-paged"])
def test_from_fitted_picks_the_policy_jax_wrote(tmp_path, records, over,
                                                policy, floor, depth):
    fitted = _jax_written(tmp_path, records, **over)
    m = ResidencyManager.from_fitted(fitted, host_blocks=16, device="cpu")
    assert type(m.policy) is policy
    assert m.min_resident_rounds == floor and m.prefetch_depth == depth
    assert m.host_blocks == 16
    if policy is ColdAfterNPolicy:
        assert m.policy.n == 3
    bad = dict(fitted, residency={"policy": "fifo"})
    with pytest.raises(ValueError, match="unknown"):
        ResidencyManager.from_fitted(bad, host_blocks=4)


def test_port_paging_records_fit_alike_in_both_packages():
    # a real tiered run of the port's engine emits what fit_residency
    # reads (serve_swap_out, serve_prefetch, serve_admit, mem.* gauges):
    # the port's autofit and JAX's fit the same section from them
    from hpc_patterns_tpu_torch.models.serving import ContinuousBatcher
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                            d_ff=64, max_seq=64, dtype="float32",
                            decode_attn="gather")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    pps = ContinuousBatcher.pages_needed(8, 16, 8)
    records: list = []
    mgr = ResidencyManager(host_blocks=8 * pps, policy=ColdAfterNPolicy(1))
    eng = ContinuousBatcher(params, cfg, slots=4, pool_pages=2 * pps,
                            pages_per_seq=pps, page_size=8, chunk=4,
                            residency=mgr, device="cpu",
                            emit=lambda **kw: records.append(kw))
    rng = np.random.RandomState(0)
    for i in range(4):
        eng.submit(rng.randint(0, 64, size=8).astype(np.int32), 16,
                   priority=i % 2)
    eng.run()
    assert mgr.swap_outs > 0
    records = json.loads(json.dumps(records))
    ours = tautofit.fit_residency(records)
    assert ours is not None and ours == jautofit.fit_residency(records)
    assert ours["policy"] == "priority"
    assert ours["observed"]["swap_outs"] == mgr.swap_outs
