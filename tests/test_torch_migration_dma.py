"""Kernel 13's module in the port (``hpc_patterns_tpu_torch.comm.
migration_dma``): the paired exchange's own contracts, below the
plane-level oracle of tests/test_torch_serving_plane.py.

- the reachability verdicts, over logical endpoints (two ranks of one
  device are a pair; a shared endpoint, a host-shared replica, a
  cross-platform pair and two cards are not);
- the plain exchange byte for byte (uint8 views) at f32, bf16, int8 and
  fp8 slabs and ragged chunkings, into a new tensor recorded as landed on
  the destination endpoint;
- the port's exported payload against the JAX engine's after the same
  prompt on the same params: f32 within 1e-5 (two frameworks' f32
  matmuls in another order), int8/fp8 dequantized within the precision
  battery's 1e-4 (``test_torch_quantization``: logits agree to ~1e-5);
- the byte budget raising ``MigrationDmaError`` before any exchange;
- ``recv_migration`` refusing the wrong transport and the wrong logical
  installer (on one device the device alone proves nothing).

The kernel itself runs only on the card: the ``cuda``-marked test here
skips on the CPU (``tests/test_torch_cuda_kernels.py`` holds it there
without JAX).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.comm import migration_dma as md  # noqa: E402
from hpc_patterns_tpu_torch.comm.migration_dma import (  # noqa: E402
    MigrationDmaError,
    dma_reachable,
    recv_migration,
    send_migration,
)
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.ops.flash_decode import dequant  # noqa: E402
from hpc_patterns_tpu_torch.topology import LogicalDevice  # noqa: E402

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
ENG = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8, chunk=2)
SRC, DST = LogicalDevice("cpu", 0), LogicalDevice("cpu", 1)
POOLS = {"f32": {}, "bf16": {"dtype": "bfloat16"},
         "int8": {"kv_cache_dtype": "int8"}, "fp8": {"kv_cache_dtype": "fp8"}}
PAYLOAD_ATOL = 1e-5
DEQUANT_ATOL = 1e-4


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(jax.random.PRNGKey(0),
                           jtf.TransformerConfig(**BASE))


def _port_bundle(jparams, prompt=np.arange(5, dtype=np.int32), **over):
    cfg = ttf.TransformerConfig(**{**BASE, **over}, decode_attn="flash")
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    eng = tsrv.EngineCore(tp, cfg, **ENG, device="cpu")
    eng.submit(prompt, 4)
    eng.service_round(decode=False)
    return eng.export_migration(eng.exportable_slots()[0])


def _jax_bundle(jparams, prompt=np.arange(5, dtype=np.int32), **over):
    cfg = jtf.TransformerConfig(**{**BASE, **over}, decode_attn="gather")
    eng = jsrv.EngineCore(jparams, cfg, **ENG)
    eng.submit(prompt, 4)
    eng.service_round(decode=False)
    return eng.export_migration(eng.exportable_slots()[0])


class TestReachability:
    def test_verdicts(self):
        assert dma_reachable(SRC, DST) == (True, "")
        ok, reason = dma_reachable(None, DST)
        assert not ok and "no committed device" in reason
        ok, reason = dma_reachable(SRC, LogicalDevice("cpu", 0))
        assert not ok and "share one device" in reason
        # a plain device is rank 0 of itself
        ok, reason = dma_reachable(torch.device("cpu"), SRC)
        assert not ok and "share one device" in reason
        assert dma_reachable(torch.device("cpu"), DST) == (True, "")
        ok, reason = dma_reachable(SRC, torch.device("cuda:0"))
        assert not ok and "cross-platform" in reason
        ok, reason = dma_reachable(torch.device("cuda:0"),
                                   torch.device("cuda:1"))
        assert not ok and "two cards" in reason

    def test_send_refuses_unreachable_pair(self, jparams):
        b = _port_bundle(jparams)
        for src, dst in ((SRC, SRC), (None, DST)):
            with pytest.raises(MigrationDmaError, match="not DMA-reachable"):
                send_migration(b, src, dst)


class TestPlainExchange:
    @pytest.mark.parametrize("page_chunk", [1, 4])
    @pytest.mark.parametrize("n_pages", [1, 4, 5, 9])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int8, torch.float8_e4m3fn],
                             ids=["f32", "bf16", "int8", "fp8"])
    def test_byte_exact_into_a_new_tensor(self, dtype, n_pages, page_chunk):
        rng = np.random.default_rng(n_pages)
        bits = rng.integers(0, 256, size=(n_pages, 96), dtype=np.uint8)
        x = torch.from_numpy(bits).view(dtype)  # every bit pattern
        out = md.migration_exchange(x, page_chunk)
        assert out.dtype == x.dtype and out.shape == x.shape
        assert out.data_ptr() != x.data_ptr()
        np.testing.assert_array_equal(_bytes(out), bits)
        ref = md.migration_exchange_reference(x, page_chunk)
        np.testing.assert_array_equal(_bytes(ref), bits)

    def test_guards(self):
        with pytest.raises(ValueError, match="slab"):
            md.migration_exchange(torch.zeros(4))
        with pytest.raises(ValueError, match="page_chunk"):
            md.migration_exchange(torch.zeros(4, 2), 0)


def test_sender_plan_fills_one_cta_an_sm():
    # one bundle array of the plane (1 MiB) on an H100's 132 SMs: a CTA
    # an SM, each thread with its two vectors in flight; a smaller chunk
    # takes a vector a thread; a tiny one a CTA
    assert md.sender_plan(1 << 20, 132) == 132
    assert md.sender_plan(1 << 19, 132) == 128
    assert md.sender_plan(4096 * 3 + 1, 132) == 4
    assert md.sender_plan(24, 132) == 1
    assert md.sender_plan(1 << 20, 1) == 1


class TestSend:
    @pytest.mark.parametrize("pool", list(POOLS))
    def test_payload_byte_exact_and_landed_on_dst(self, jparams, pool):
        # every payload array (quantized pools ship their scale pools as
        # extra keys) arrives byte-identical, recorded as landed on DST
        b = _port_bundle(jparams, **POOLS[pool])
        out = send_migration(b, SRC, DST)
        assert out.transport == "dma" and b.transport == "local"
        assert set(out.pages_payload) == set(b.pages_payload)
        if pool in ("int8", "fp8"):
            assert {"k_scale", "v_scale"} <= set(out.pages_payload)
        for name, arrs in b.pages_payload.items():
            for a, a2 in zip(arrs, out.pages_payload[name]):
                assert md.landed_on(a2) == DST and md.landed_on(a) is None
                assert a2.dtype == a.dtype and a2.shape == a.shape
                np.testing.assert_array_equal(_bytes(a2), _bytes(a),
                                              err_msg=name)
        assert (out.pos, out.limit, out.token, out.out) == (
            b.pos, b.limit, b.token, b.out)

    def test_ledger_forgets_dead_tensors(self, jparams):
        out = send_migration(_port_bundle(jparams), SRC, DST)
        keys = {id(a) for arrs in out.pages_payload.values() for a in arrs}
        assert keys <= set(md._LANDED)
        del out
        assert not keys & set(md._LANDED)

    def test_budget_gate_raises_before_any_exchange(self, jparams):
        big = torch.empty((1, md.LANDING_LIMIT // 4 + 16), device="meta")
        with pytest.raises(MigrationDmaError, match="budget"):
            md._transfer_array(big, SRC, DST)
        with pytest.raises(MigrationDmaError, match="budget"):
            md.migration_exchange(big)
        # a bundle whose LAST slab is too big moves nothing at all
        b = _port_bundle(jparams)
        k = b.pages_payload["k"]
        b = dataclasses.replace(b, pages_payload={
            **b.pages_payload, "k": k[:-1] + (big,)})
        before = len(md._LANDED)
        with pytest.raises(MigrationDmaError, match="budget"):
            send_migration(b, SRC, DST)
        assert len(md._LANDED) == before

    def test_source_payload_must_live_on_the_source_device(self):
        with pytest.raises(ValueError, match="source"):
            md._transfer_array(torch.zeros(2, 4), torch.device("cuda:0"),
                               torch.device("cuda:1"))


class TestPayloadAgainstJax:
    @pytest.mark.parametrize("pool", ["f32", "int8", "fp8"])
    def test_exported_payload_equals_jax(self, jparams, pool):
        prompt = np.array([3, 9, 27, 17, 60, 2, 44], np.int32)
        tb = _port_bundle(jparams, prompt, **POOLS[pool])
        jb = _jax_bundle(jparams, prompt, **POOLS[pool])
        assert (tb.pos, tb.limit, tb.token, tb.out, tb.n_pages) == (
            jb.pos, jb.limit, jb.token, jb.out, jb.n_pages)
        assert set(tb.pages_payload) == set(jb.pages_payload)
        T = prompt.size  # rows past the prompt are never read
        for name in ("k", "v"):
            for l, (t, j) in enumerate(zip(tb.pages_payload[name],
                                           jb.pages_payload[name])):
                jt = params_from_jax(np.asarray(j), device="cpu")
                if pool == "f32":
                    got, want, tol = t, jt, PAYLOAD_ATOL
                else:
                    got = dequant(t, tb.pages_payload[f"{name}_scale"][l][
                        :, :, 0, :])
                    want = dequant(jt, params_from_jax(np.asarray(
                        jb.pages_payload[f"{name}_scale"][l]),
                        device="cpu")[:, :, 0, :])
                    tol = DEQUANT_ATOL
                # (pages, H, P, D) -> (H, tokens, D), the prompt's rows
                g = got.permute(1, 0, 2, 3).reshape(got.shape[1], -1,
                                                    got.shape[3])[:, :T]
                w = want.permute(1, 0, 2, 3).reshape(want.shape[1], -1,
                                                     want.shape[3])[:, :T]
                torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                           rtol=0, msg=f"{name}[{l}]")


class TestRecv:
    def test_accepts_dma_bundle_on_dst(self, jparams):
        out = send_migration(_port_bundle(jparams), SRC, DST)
        assert recv_migration(out, DST) is out
        # the same endpoint spelled as a plain device + rank
        assert recv_migration(out, LogicalDevice(torch.device("cpu"), 1))

    def test_rejects_wrong_transport_and_wrong_installer(self, jparams):
        b = _port_bundle(jparams)
        with pytest.raises(MigrationDmaError, match="transport"):
            recv_migration(b, DST)  # never crossed the exchange
        out = send_migration(b, SRC, DST)
        # the same device, another rank: the landing record says no
        with pytest.raises(MigrationDmaError, match="not resident"):
            recv_migration(out, LogicalDevice("cpu", 2))
        with pytest.raises(MigrationDmaError, match="not resident"):
            recv_migration(out, SRC)
        with pytest.raises(MigrationDmaError, match="no committed"):
            recv_migration(out, None)
        # a dma-labelled bundle whose payload no exchange landed
        forged = dataclasses.replace(b, transport="dma")
        with pytest.raises(MigrationDmaError, match="not resident"):
            recv_migration(forged, DST)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n_pages in (1, 2, 5, 16):
        x = torch.randint(0, 256, (n_pages, 4096), generator=gen,
                          device="cuda", dtype=torch.uint8).view(
            torch.bfloat16)
        n = md.launches["migration_exchange"]
        got = md.migration_exchange(x)
        md.synchronize()
        assert md.launches["migration_exchange"] == n + 1
        want = md.migration_exchange_reference(x)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
