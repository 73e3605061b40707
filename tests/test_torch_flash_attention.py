"""The port's flash attention (``hpc_patterns_tpu_torch.ops.
flash_attention``) against the JAX Pallas kernels, run in interpret mode
on the CPU. On CPU tensors each wrapper computes its plain version, so
this pins that the plain versions — what the CUDA kernels are held
against on the card — compute the TPU kernels' functions, and that the
backward's routing (fused or split, q-chunking, the slab's masked sum),
which is the same code on both devices, is right.

Tolerances: f32 on both sides. Forward atol = rtol = 1e-5 — only the
summation order differs (online softmax over key blocks vs one dense
softmax). Gradients atol 2e-5, as ``tests/test_ops.py`` holds the JAX
kernels' grads against the dense oracle. Chunked vs unchunked fused
backward 1e-6 (dK/dV accumulate chunk by chunk in f32).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from hpc_patterns_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention_block as jax_flash_attention_block,
)
from hpc_patterns_tpu_torch.ops import flash_attention as fa  # noqa: E402

ATOL = RTOL = 1e-5


def _inputs(seed, B, T, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_matches_jax_causal(T, H, Hkv):
    q, k, v = _inputs(T + H + Hkv, 2, T, H, Hkv, 16)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_matches_jax_non_causal_and_explicit_scale():
    q, k, v = _inputs(3, 1, 128, 4, 2, 16)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        scale=0.3, interpret=True))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False, scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 64, 2, 2, 8))
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v)
    assert fa.launches == before
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v),
                               atol=0, rtol=0)


def test_shape_and_device_checks_raise():
    q = torch.zeros(1, 64, 4, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, torch.zeros(1, 64, 3, 8),
                           torch.zeros(1, 64, 3, 8))
    with pytest.raises(ValueError, match="want"):
        fa.flash_attention(torch.zeros(64, 4, 8), q, q)
    meta = torch.zeros(1, 64, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)


GRAD_ATOL = 2e-5
# JAX's tiles in these tests (its defaults clamp to T; 32 exercises its
# multi-block walk and clamped index maps at T 64)
JAX_BLOCKS = dict(block_q=32, block_k=32, interpret=True)


def _cotangent(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


# (Tq, Tk, q_offset, k_offset, causal): offsets, Tq != Tk both ways, rows
# before every key (dead) inside a visited q tile, a fully-future block
BLOCK_CASES = {
    "offsets": (64, 128, 128, 32, True),
    "tq_gt_tk_dead_rows": (128, 64, 0, 48, True),
    "fully_future": (64, 64, 0, 1000, True),
    "non_causal_tq_lt_tk": (64, 128, 0, 0, False),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_block_forward_and_lse_match_jax(case, H, Hkv):
    Tq, Tk, qo, ko, causal = BLOCK_CASES[case]
    q, _, _ = _inputs(11, 2, Tq, H, Hkv, 16)
    _, k, v = _inputs(12, 2, Tk, H, Hkv, 16)
    want_o, want_l = jax_flash_attention_block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qo, ko,
        causal=causal, **JAX_BLOCKS)
    got_o, got_l = fa.flash_attention_block(*_t(q, k, v), qo, ko,
                                            causal=causal)
    assert got_l.shape == (2, Tq, H) and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL,
                               rtol=RTOL)
    if case == "fully_future":
        assert (got_o == 0).all() and (got_l < -1e29).all()
    if case == "tq_gt_tk_dead_rows":  # rows 0..47 see nothing
        assert (got_o[:, :48] == 0).all() and (got_l[:, :48] < -1e29).all()


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_grads_match_jax(bwd, causal, H, Hkv):
    q, k, v = _inputs(21, 2, 64, H, Hkv, 16)
    g = _cotangent(22, q.shape)

    def jloss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, bwd=bwd,
                                **JAX_BLOCKS)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, causal=causal, bwd=bwd)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert got[1].shape == k.shape  # dk/dv narrow under GQA
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("case", ["offsets", "tq_gt_tk_dead_rows"])
def test_block_grads_through_lse_match_jax(bwd, case):
    Tq, Tk, qo, ko, causal = BLOCK_CASES[case]
    q, _, _ = _inputs(31, 1, Tq, 4, 2, 16)
    _, k, v = _inputs(32, 1, Tk, 4, 2, 16)
    g = _cotangent(33, q.shape)
    gl = _cotangent(34, q.shape[:3])

    def jloss(q, k, v):
        o, lse = jax_flash_attention_block(q, k, v, qo, ko, causal=causal,
                                           bwd=bwd, **JAX_BLOCKS)
        return jnp.sum(o * g) + jnp.sum(jnp.maximum(lse, -30.0) * gl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    o, lse = fa.flash_attention_block(tq, tk, tv, qo, ko, causal=causal,
                                      bwd=bwd)
    loss = (o * torch.from_numpy(g)).sum() + (
        lse.clamp_min(-30.0) * torch.from_numpy(gl)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


def _grads(q, k, v, g, **kw):
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, **kw)
    return torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))


def test_fused_q_chunked_equals_unchunked(monkeypatch):
    q, k, v = _inputs(41, 1, 256, 4, 2, 16)
    g = _cotangent(42, q.shape)
    want = _grads(q, k, v, g, bwd="fused")
    # slab = 2 kv tiles of 128 x 1 x 4 heads x 256 x 16 x 4 B = 128 KiB;
    # half of it forces 2 chunks of 128 queries (still a multiple of the
    # q tile)
    monkeypatch.setattr(fa, "_FUSED_SLAB_LIMIT", 64 << 10)
    plan = fa.plan_backward(1, 256, 256, 4, 16, 4, "fused")
    assert plan["n_chunks"] == 2 and plan["fused"]
    got = _grads(q, k, v, g, bwd="fused")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_auto_route_follows_the_slab_limit(monkeypatch):
    # the chip shape (B 8, T 2048, H 8, D 128, bf16): n_kv = 16 tiles of
    # 128 rows, a 512 MiB slab under the 1.5 GiB default -> fused,
    # unchunked
    plan = fa.plan_backward(8, 2048, 2048, 8, 128, 2)
    assert plan == {"slab_bytes": 1 << 29, "n_chunks": 1, "fused": True,
                    "limit": 3 << 29}
    q, k, v = _inputs(43, 1, 128, 2, 2, 16)
    g = _cotangent(44, q.shape)
    fused = _grads(q, k, v, g)
    monkeypatch.setattr(fa, "_FUSED_SLAB_LIMIT", 0)  # forces the split route
    assert not fa.plan_backward(1, 128, 128, 2, 16, 4)["fused"]
    split = _grads(q, k, v, g)
    for a, b in zip(split, fused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_card_auto_route_is_split_beside_the_cpu_slab_rule():
    # the chip shape (B 8, T 2048, H 8, D 128, bf16): on the CPU the JAX
    # rule (the 512 MiB slab fits 1.5 GiB: fused, unchunked); on a card
    # "auto" is the split route; the named routes plan alike on both
    shape = (8, 2048, 2048, 8, 128, 2)
    assert fa.plan_backward(*shape) == {
        "slab_bytes": 1 << 29, "n_chunks": 1, "fused": True,
        "limit": 3 << 29}
    for bwd in (None, "auto"):
        assert fa.plan_backward(*shape, bwd, on_card=True) == {
            "slab_bytes": 1 << 29, "n_chunks": 1, "fused": False,
            "limit": 3 << 29}
    for bwd in ("fused", "split"):
        assert fa.plan_backward(*shape, bwd, on_card=True) == \
            fa.plan_backward(*shape, bwd)


def test_plain_kernel_contracts_agree():
    # the fused plain version's slab, masked by select and summed, is the
    # dq pass; its dk/dv are the dkv pass; never-written slots are NaN.
    # Tk 192: two kv tiles of 128 keys, the second half
    q, _, _ = _inputs(51, 1, 128, 4, 2, 16)
    _, k, v = _inputs(52, 1, 192, 4, 2, 16)
    q, k, v = _t(q, k, v)
    do = torch.from_numpy(_cotangent(53, q.shape))
    out, lse = fa.flash_attention_reference(q, k, v, q_offset=64,
                                            k_offset=0, with_lse=True)
    delta = (do * out).sum(-1).permute(0, 2, 1).contiguous()
    kw = dict(q_offset=64, k_offset=0, causal=True)
    dk, dv, slab = fa.flash_attention_fused_bwd(q, k, v, do, lse, delta,
                                                **kw)
    assert slab.shape == (2, 4, 128, 16)
    seen = fa._written(128, 192, 64, 0, True, q.device)
    assert torch.isnan(slab[~seen[:, None, :, None].expand_as(slab)]).all()
    assert not torch.isnan(slab[seen[:, None, :, None].expand_as(slab)]).any()
    dq = slab.masked_fill(~seen[:, None, :, None], 0).sum(0)
    want_dq = fa.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    np.testing.assert_allclose(dq.reshape(1, 4, 128, 16).permute(0, 2, 1, 3)
                               .numpy(), want_dq.numpy(), atol=1e-6)
    want_dk, want_dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


# (Tq, Tk, q_offset, k_offset, causal) with Tk % 128 == 64: the fused
# route's last kv tile of 128 keys is half (its missing keys masked, causal
# or not), with offsets that are multiples of neither tile
HALF_TILE_CASES = {
    "square_causal": (192, 192, 0, 0, True),
    "offsets_causal": (128, 320, 224, 96, True),
    "non_causal": (64, 192, 0, 0, False),
}


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("case", list(HALF_TILE_CASES))
def test_grads_at_a_half_last_kv_tile_match_jax(bwd, case):
    Tq, Tk, qo, ko, causal = HALF_TILE_CASES[case]
    q, _, _ = _inputs(71, 1, Tq, 4, 2, 16)
    _, k, v = _inputs(72, 1, Tk, 4, 2, 16)
    g = _cotangent(73, q.shape)
    n_kv = fa.plan_backward(1, Tq, Tk, 4, 16, 4)["slab_bytes"] // (
        4 * Tq * 16 * 4)
    assert n_kv == -(-Tk // 128) and Tk % 128 == 64

    def jloss(q, k, v):
        o, _ = jax_flash_attention_block(q, k, v, qo, ko, causal=causal,
                                         bwd=bwd, **JAX_BLOCKS)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    o, _ = fa.flash_attention_block(tq, tk, tv, qo, ko, causal=causal,
                                    bwd=bwd)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    assert got[1].shape == k.shape  # dk/dv narrow under GQA
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


def test_flash_bench_replays_the_fused_route_and_reads_the_kv_tile():
    # bench_flash times another checkout's fused route by replaying the
    # route's steps around that checkout's kernel: on this tree's kernel
    # (its plain version here) the replay gives _backward's grads, and the
    # tile it masks by is the one the checkout's source names
    from pathlib import Path

    from hpc_patterns_tpu_torch import bench_flash

    q, k, v = _t(*_inputs(81, 1, 192, 4, 4, 16))
    do = torch.from_numpy(_cotangent(82, q.shape))
    out, lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    want = fa._backward(q, k, v, out, lse, 0, 0, do, None, causal=True,
                        scale=None, bwd="fused")
    got = bench_flash._fused_route(fa.flash_attention_fused_bwd, q, k, v,
                                   do, lse, out, fa.BWD_BLOCK_K)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    root = Path(__file__).resolve().parents[1]
    assert bench_flash._kv_tile(root) == fa.BWD_BLOCK_K == 128


def test_bad_bwd_and_shapes_rejected():
    q, k, v = _t(*_inputs(61, 1, 64, 2, 2, 16), grad=True)
    with pytest.raises(ValueError, match="bwd"):
        fa.flash_attention(q, k, v, bwd="fuse")
    with pytest.raises(ValueError, match="bwd"):
        fa.flash_attention_block(q, k, v, 0, 0, bwd="two-pass")
    with pytest.raises(ValueError, match="bwd"):
        fa.plan_backward(1, 64, 64, 2, 16, 4, "fast")
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, k[:, :32], v[:, :32])  # square only
    o, lse = fa.flash_attention_block(q, k[:, :32], v[:, :32], 0, 0)
    assert o.shape == q.shape and lse.shape == (1, 64, 2)
