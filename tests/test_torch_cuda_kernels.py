"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card with the CUDA toolkit (the kernels build on
first use), so they carry the ``cuda`` marker and skip elsewhere. This
file imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

Kernel 1 (the forward) runs its tile edges at both CTA tiles, 64 and
128 query rows, twice each for equal bits. Tolerances (max abs error):
prefill 2e-2 (bf16 in and out, p rounded to
bf16 before p.v as the TPU kernel does), its lse 1e-3 (f32 on both sides
from bf16 scores: only the summation order differs); the three backward
kernels 2e-2 x max|plain| (bf16 outputs, and P and dS rounded to bf16
before their products, where an f32 difference in the last place can
move a rounding); decode 1e-4 (f32 math on both
sides, only the summation order differs; for one-byte caches the linear
and paged kernels fold the scales into scores and probabilities where the
plain versions dequantize first, one more f32 rounding per term, and the
exact-softmax kernel dequantizes first as they do) — the paged, linear
and exact-softmax decode kernels alike, the split ones also a sequence
alone and in a batch to equal bits. Matmuls of the plain versions
run in full f32 (``allow_tf32`` off). The busy-wait and overlap-pipeline
kernels equal their plain versions bit for bit (every step one fmaf
rounding, checksums summed in the same order). The fused ring kernels
equal their plain versions bit for bit (the allreduce over the same chunk
layout, the permute exactly), except allgather_matmul, whose f32 sums run
in another order than the library GEMM: within
``fused.allgather_matmul_tolerance`` (8 sqrt(k) 2^-24 sum|x||w| for
float32, which a TF32 product fails, plus one bf16 ulp of the output for
bfloat16), exact for int32 at small values, and equal bits from two
calls at its tile edges. The alias kernel equals ``x * 2 + 1`` bitwise, in
place. The fused MLP kernels: y, a, dx, g and da within 2e-2 x max|plain|
(bf16 outputs; g and da rounded to bf16 from f32 values whose sums run
in another order, which can move a rounding), dW1 and dW2 within 1e-3 x
max|plain| on the same g and da (f32 sums of the same bf16 products,
in another order); each kernel twice for equal bits. The migration
exchange (kernel 13) equals its plain version byte for byte (compared as
uint8) at every pool dtype, ragged chunkings and rows that are not a
multiple of 16 bytes; a launch one sender short never lands, and
``synchronize()`` raises. The residency manager's host tier on the card
is pinned and round-trips bytes exactly; ``allreduce_app -H``'s
host-resident route equals device memory bit for bit. The parallel layer
over 4 logical ranks: ring attention's flash route (kernel 1 at offsets a
rank and step, merged by lse) and Ulysses' flash route (kernel 1 on the
head slices) against their plain routes on the same bf16 tensors within
2e-2 (prefill's bound), the fused shift (kernel 10) equal bit for bit to
the library roll, the flash ring's gradients against the dense ring's
within 2e-2 x max|dense|; ``moe_dense`` on the card against its CPU
plain version on the same f32 values within 1e-4 (f32 products and sums
in another order; the same slots, so the same tokens drop); the scatter
MoE step at top-3 twice with equal loss and gradient bits. The tp shard
shapes (2 logical tp ranks): kernels 1, 3, 4, 8 and 9 in a tp 2 loss and
its gradients against the same on the CPU's plain versions (bf16 on both
sides: loss rtol 1e-2, each leaf's cosine >= 0.999), and the prefill
(kernel 1) and one linear (5) and paged (6/6q) step on the tp ranks'
kv-head blocks within 2e-2 x max|plain| of the logits, each kernel
launched once a layer over the folded ranks (kernels 8/9 once a rank).
"""

import ctypes
import math

import pytest
import torch

from hpc_patterns_tpu_torch.comm import fused
from hpc_patterns_tpu_torch.comm import migration_dma as md
from hpc_patterns_tpu_torch.concurrency import commands, kernels, pipeline
from hpc_patterns_tpu_torch.interop import device as interop_device
from hpc_patterns_tpu_torch.models.decode import _quantize_rows
from hpc_patterns_tpu_torch.ops import flash_attention as fa
from hpc_patterns_tpu_torch.ops import flash_decode as fd
from hpc_patterns_tpu_torch.ops import fused_mlp as fm
from hpc_patterns_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("T,H,Hkv,D", [(128, 4, 4, 16), (128, 4, 2, 32),
                                       (128, 4, 4, 64), (256, 8, 2, 128),
                                       (512, 8, 8, 128)])
def test_flash_prefill_kernel_matches_plain(gen, T, H, Hkv, D):
    q = torch.randn(2, T, H, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").bfloat16()
    n = fa.launches["fwd"]
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == n + 1
    want = fa.flash_attention_reference(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


# (B, Tq, Tk, H, Hkv, D, q_offset, k_offset, causal): the training shape's
# heads, GQA, offsets with Tq != Tk both ways, rows before every key, a
# fully-future block, non-causal, the small head dims; at D 128, Tk % 128
# == 64 (the backward's last 128-key tile half) causal at an odd k_offset,
# square, and non-causal; Tq % 128 == 64 (the dQ kernel's last 128-query
# block half) causal at an odd q_offset, and non-causal with Tq != Tk
FLASH_CASES = [(2, 256, 256, 8, 8, 128, 0, 0, True),
               (2, 256, 256, 8, 2, 128, 0, 0, True),
               (1, 128, 256, 4, 2, 64, 128, 0, True),
               (1, 256, 128, 4, 4, 32, 0, 96, True),
               (1, 128, 128, 4, 2, 16, 0, 4096, True),
               (1, 128, 192, 4, 1, 64, 0, 0, False),
               (1, 256, 320, 8, 2, 128, 64, 33, True),
               (2, 192, 192, 8, 8, 128, 0, 0, True),
               (1, 128, 192, 4, 2, 128, 0, 0, False),
               (2, 320, 384, 8, 2, 128, 65, 0, True),
               (1, 192, 320, 4, 4, 64, 0, 0, False)]
BWD_TOL = 2e-2


def _flash_inputs(gen, B, Tq, Tk, H, Hkv, D):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    return r(B, Tq, H, D), r(B, Tk, Hkv, D), r(B, Tk, Hkv, D), r(B, Tq, H, D)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_with_lse_and_offsets_matches_plain(gen, case):
    B, Tq, Tk, H, Hkv, D, qo, ko, causal = case
    q, k, v, _ = _flash_inputs(gen, B, Tq, Tk, H, Hkv, D)
    n = fa.launches["fwd_lse"]
    out, lse = fa.flash_attention_block(q, k, v, qo, ko, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches["fwd_lse"] == n + 1
    want, want_lse = fa.flash_attention_reference(
        q, k, v, causal, q_offset=qo, k_offset=ko, with_lse=True)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    torch.testing.assert_close(lse, want_lse.permute(0, 2, 1), atol=1e-3,
                               rtol=1e-5)
    if ko >= qo + Tq:  # fully future: out 0, lse ~ -1e30
        assert (out == 0).all() and (lse < -1e29).all()


# kernel 1's tile edges, at both CTA tiles (64 and 128 query rows, which
# the shape rule picks between) and twice for equal bits: (B, Tq, Tk, H,
# Hkv, D, q_offset, k_offset, causal) — Tq = 64 x odd, where a 128-row
# CTA's upper warpgroup has no rows, with GQA; offsets that are not
# tile-aligned, rows before every key; Tk 192 (a ragged 128-key tile)
# causal and not; a grid smaller than the SM count (B 1, T 128, H 4)
FWD_EDGE_CASES = [(2, 192, 192, 8, 2, 128, 0, 0, True),
                  (1, 320, 320, 4, 1, 64, 0, 0, True),
                  (1, 192, 512, 8, 2, 128, 200, 0, True),
                  (1, 320, 192, 4, 2, 128, 0, 96, True),
                  (1, 256, 384, 4, 2, 64, 96, 32, True),
                  (1, 192, 192, 4, 2, 128, 0, 0, False),
                  (1, 128, 128, 4, 4, 128, 0, 0, True)]


def _forward_edge_case(gen, case, rows):
    B, Tq, Tk, H, Hkv, D, qo, ko, causal = case
    q, k, v, _ = _flash_inputs(gen, B, Tq, Tk, H, Hkv, D)
    out, lse = fa._launch_forward(q, k, v, qo, ko, causal, None, True,
                                  rows=rows)
    again = fa._launch_forward(q, k, v, qo, ko, causal, None, True,
                               rows=rows)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_reference(
        q, k, v, causal, q_offset=qo, k_offset=ko, with_lse=True)
    assert torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    dead = max(0, min(Tq, ko - qo)) if causal else 0
    assert (out[:, :dead] == 0).all() and (lse[..., :dead] < -1e29).all()
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("case", FWD_EDGE_CASES)
def test_flash_forward_tile_edges_with_lse_equal_bits(gen, case, rows):
    _forward_edge_case(gen, case, rows)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_forward_every_head_dim_with_lse_equal_bits(gen, D, rows):
    _forward_edge_case(gen, (2, 192, 320, 4, 2, D, 160, 32, True), rows)


def test_flash_forward_refuses_a_cta_tile_it_has_not(gen):
    q, k, v, _ = _flash_inputs(gen, 1, 128, 128, 4, 2, 64)
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fa._launch_forward(q, k, v, 0, 0, True, None, False, rows=96)


def _backward_case(gen, case):
    B, Tq, Tk, H, Hkv, D, qo, ko, causal = case
    q, k, v, do = _flash_inputs(gen, B, Tq, Tk, H, Hkv, D)
    out, lse = fa.flash_attention_reference(
        q, k, v, causal, q_offset=qo, k_offset=ko, with_lse=True)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    n = dict(fa.launches)
    dk, dv, slab = fa.flash_attention_fused_bwd(*args, **kw)
    dq = fa.flash_attention_dq(*args, **kw)
    dk2, dv2 = fa.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert [fa.launches[x] - n[x] for x in ("fused_bwd", "dq", "dkv")] == [
        1, 1, 1]
    w_dk, w_dv, w_slab = fa.flash_attention_fused_bwd_reference(*args, **kw)
    w_dq = fa.flash_attention_dq_reference(*args, **kw)
    seen = fa._written(Tq, Tk, qo, ko, causal, q.device)[:, None, :, None]
    seen = seen.expand_as(slab)
    for got, want in ((dk, w_dk), (dv, w_dv), (dk2, w_dk), (dv2, w_dv),
                      (dq, w_dq), (slab[seen], w_slab[seen])):
        assert got.shape == want.shape and torch.isfinite(got).all()
        if want.numel() and want.float().abs().max() > 0:
            assert _rel(got, want) <= BWD_TOL
        else:
            assert (got == 0).all()
    again = fa.flash_attention_fused_bwd(*args, **kw)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(again[2][seen], slab[seen])
    assert torch.equal(fa.flash_attention_dq(*args, **kw), dq)
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_attention_dkv(*args, **kw), (dk2, dv2)))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_kernels_match_plain_and_are_deterministic(gen, case):
    _backward_case(gen, case)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_backward_every_head_dim_at_a_half_kv_tile(gen, D):
    # Tk 320: the last 128-key tile half; offsets on neither tile
    _backward_case(gen, (1, 192, 320, 4, 2, D, 160, 33, True))


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_flash_autograd_on_the_card_matches_the_plain_route(gen, bwd):
    q, k, v, g = _flash_inputs(gen, 2, 256, 256, 4, 2, 64)
    got = []
    for t in ((q, k, v), (q.cpu(), k.cpu(), v.cpu())):
        t = [x.detach().float().to(x.device).bfloat16().requires_grad_()
             for x in t]
        out = fa.flash_attention(*t, causal=True, bwd=bwd)
        got.append(torch.autograd.grad(out, t, g.to(out.device)))
    for a, b in zip(*got):
        assert _rel(a.cpu(), b) <= BWD_TOL


def test_flash_backward_wrappers_raise_on_what_the_kernels_take_not(gen):
    q, k, v, do = _flash_inputs(gen, 1, 128, 128, 4, 2, 64)
    lse = torch.zeros(1, 4, 128, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_dq(q, k, v, do, lse.bfloat16(), lse)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_dkv(q.float(), k.float(), v.float(), do.float(),
                               lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_fused_bwd(q, k, v, do, lse[:, :, :64], lse)
    with pytest.raises(ValueError, match="T % 64"):
        short = lse[..., :96].contiguous()
        fa.flash_attention_dq(q[:, :96].contiguous(), k, v,
                              do[:, :96].contiguous(), short, short)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_dkv(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, do, lse, lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hkv,D,P", [(8, 8, 128, 256), (8, 2, 64, 16),
                                       (4, 4, 16, 16), (4, 2, 32, 16)])
def test_paged_decode_kernel_matches_plain(gen, dtype, H, Hkv, D, P):
    B, pages = 4, 3
    n_pool = B * pages + 2
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(n_pool, Hkv, P, D, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn(n_pool, Hkv, P, D, generator=gen,
                     device="cuda").to(dtype)
    table = torch.randperm(n_pool, generator=gen, device="cuda")[:B * pages]
    table = table.to(torch.int32).reshape(B, pages)
    pos = torch.tensor([0, P - 1, P, pages * P - 1], dtype=torch.int32,
                       device="cuda")
    for p in (pos, 2 * P - 3):
        got = fd.flash_decode_paged(q, kp, vp, table, p)
        want = fd.flash_decode_paged_reference(q, kp, vp, table, p)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = torch.zeros(1, 100, 4, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T % 64"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q[:, :64].float(), q[:, :64].float(),
                           q[:, :64].float())
    qd = torch.zeros(2, 4, 64, device="cuda")
    pool = torch.zeros(4, 4, 16, 64, device="cuda")
    table = torch.zeros(2, 2, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        fd.flash_decode_paged(qd, pool, pool, table, 3)


KV_DTYPES = ["bfloat16", "float32", "int8", "fp8"]


def _cache(gen, shape, kv, qdt):
    """Random K or V rows in ``kv`` storage: (values, f32 scales of
    shape[:-1] or None); compute-dtype caches take q's dtype."""
    x = torch.randn(*shape, generator=gen, device="cuda")
    if kv in ("int8", "fp8"):
        return _quantize_rows(x, kv)
    return x.to(qdt), None


def _qdtype(kv, f32_with=()):
    """q's dtype: a compute-dtype cache's own; bf16 for a one-byte cache
    unless it is in ``f32_with`` (each one-byte cache meets both q dtypes
    across the tests below)."""
    return (torch.float32 if kv == "float32" or kv in f32_with
            else torch.bfloat16)


def _pools(gen, kv, B, H, Hkv, D, P, pages, qdt):
    n_pool = B * pages + 2
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(qdt)
    kp, ks = _cache(gen, (n_pool, Hkv, P, D), kv, qdt)
    vp, vs = _cache(gen, (n_pool, Hkv, P, D), kv, qdt)
    if ks is not None:
        ks, vs = ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()
    table = torch.randperm(n_pool, generator=gen, device="cuda")[:B * pages]
    return q, kp, vp, ks, vs, table.to(torch.int32).reshape(B, pages)


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv,D,P", [(8, 8, 128, 256), (8, 2, 128, 256),
                                       (8, 2, 64, 16), (4, 4, 16, 16),
                                       (4, 1, 32, 16), (8, 8, 64, 300)])
def test_paged_decode_kernel_all_pool_dtypes(gen, kv, H, Hkv, D, P):
    # int8/fp8 pools with scale pools through a permuted table, ragged and
    # shared positions, MHA/GQA/MQA; P 300 streams a page in two blocks
    B, pages = 4, 3
    qdt = _qdtype(kv)
    q, kp, vp, ks, vs, table = _pools(gen, kv, B, H, Hkv, D, P, pages, qdt)
    pos = torch.tensor([0, P - 1, P, pages * P - 1], dtype=torch.int32,
                       device="cuda")
    for p in (pos, 2 * P - 3):
        n = fd.launches["paged_decode"]
        got = fd.flash_decode_paged(q, kp, vp, table, p, k_scale_pool=ks,
                                    v_scale_pool=vs)
        torch.cuda.synchronize()
        assert fd.launches["paged_decode"] == n + 1
        want = fd.flash_decode_paged_reference(q, kp, vp, table, p,
                                               k_scale_pool=ks,
                                               v_scale_pool=vs)
        assert (got - want).abs().max().item() <= 1e-4



def _seq_pools(gen, kv, n_pool, Hkv, D, P, qdt):
    kp, ks = _cache(gen, (n_pool, Hkv, P, D), kv, qdt)
    vp, vs = _cache(gen, (n_pool, Hkv, P, D), kv, qdt)
    if ks is not None:
        ks, vs = ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()
    return kp, vp, ks, vs


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv,D,P", [(8, 8, 128, 256), (8, 1, 64, 16),
                                       (8, 2, 32, 300)])
def test_paged_decode_kernel_is_batch_invariant(gen, kv, H, Hkv, D, P):
    # one sequence decoded alone (B 1, a table just wide enough) and as
    # row 5 of a batch of 8 with a wider table gives equal bits: the chunk
    # is fixed by (P, D, dtype), not by the batch, the kv heads or the
    # table width; fills on and next to the chunk and page edges
    qdt = _qdtype(kv)
    pages, wide = 4, 7
    kp, vp, ks, vs = _seq_pools(gen, kv, 8 * wide + 1, Hkv, D, P, qdt)
    q = torch.randn(8, H, D, generator=gen, device="cuda").to(qdt)
    table = torch.randperm(8 * wide + 1, generator=gen,
                           device="cuda")[:8 * wide]
    table = table.to(torch.int32).reshape(8, wide)
    chunk = fd.paged_decode_plan(pages, P)[1]
    assert fd.paged_decode_plan(wide, P)[1] == chunk
    fills = sorted({p for c in (1, 2, 3) for p in (c * chunk - 1, c * chunk)
                    if p < pages * P} | {0, P - 1, pages * P - 1})
    for fill in fills:
        pos = torch.randint(0, wide * P, (8,), generator=gen, device="cuda")
        pos[5] = fill
        pos = pos.to(torch.int32)
        batch = fd.flash_decode_paged(q, kp, vp, table, pos, k_scale_pool=ks,
                                      v_scale_pool=vs)
        alone = fd.flash_decode_paged(
            q[5:6].clone(), kp, vp, table[5:6, :pages].clone(),
            pos[5:6].clone(), k_scale_pool=ks, v_scale_pool=vs)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[5]), fill
        want = fd.flash_decode_paged_reference(
            q[5:6], kp, vp, table[5:6, :pages], pos[5:6], k_scale_pool=ks,
            v_scale_pool=vs)
        assert (alone - want).abs().max().item() <= 1e-4, fill


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("P,pages", [(256, 8), (192, 8), (16, 64)])
def test_paged_decode_kernel_chunks_past_every_fill_equal_bits(gen, kv, H,
                                                               Hkv, P, pages):
    # a table of 8-24 chunks whose every sequence fills far less of it:
    # the chunks past each fill run no work and the merge reads none of
    # them; g from 1 to 8 (G_MAX); the page sizes plan 128-row chunks
    # inside a page, 64-row ones (P 192) and 128-row ones across eight
    # pages (P 16); two calls give equal bits, one launch a call
    B, D = 3, 128
    qdt = _qdtype(kv, f32_with=("fp8",))
    q, kp, vp, ks, vs, table = _pools(gen, kv, B, H, Hkv, D, P, pages, qdt)
    pos = torch.tensor([5, 300, 700], dtype=torch.int32, device="cuda")
    n_chunks, chunk = fd.paged_decode_plan(pages, P)
    assert 700 // chunk + 1 < n_chunks  # chunks past every fill
    n = fd.launches["paged_decode"]
    got = fd.flash_decode_paged(q, kp, vp, table, pos, k_scale_pool=ks,
                                v_scale_pool=vs)
    again = fd.flash_decode_paged(q, kp, vp, table, pos, k_scale_pool=ks,
                                  v_scale_pool=vs)
    torch.cuda.synchronize()
    assert fd.launches["paged_decode"] == n + 2
    assert torch.equal(got, again)
    want = fd.flash_decode_paged_reference(q, kp, vp, table, pos,
                                           k_scale_pool=ks, v_scale_pool=vs)
    assert (got - want).abs().max().item() <= 1e-4

def _linear_decode_positions(gen, kv, B, H, Hkv, D, S, positions):
    """Kernel 5 at each position against its plain version, twice for
    equal bits, one launch a call."""
    qdt = _qdtype(kv, f32_with=("int8",))
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(qdt)
    kc, ks = _cache(gen, (B, Hkv, S, D), kv, qdt)
    vc, vs = _cache(gen, (B, Hkv, S, D), kv, qdt)
    for pos in positions:
        n = fd.launches["flash_decode"]
        got = fd.flash_decode_attention(q, kc, vc, pos, k_scale=ks,
                                        v_scale=vs)
        again = fd.flash_decode_attention(q, kc, vc, pos, k_scale=ks,
                                          v_scale=vs)
        torch.cuda.synchronize()
        assert fd.launches["flash_decode"] == n + 2
        assert torch.equal(got, again), pos
        want = fd.flash_decode_attention_reference(q, kc, vc, pos,
                                                   k_scale=ks, v_scale=vs)
        assert (got - want).abs().max().item() <= 1e-4, pos


def _chunk_edges(pos, rows):
    """Positions on and next to the edges of the split that ``pos``
    gets on this card (the rows before the first edge are one chunk)."""
    n, chunk = fd.decode_chunks(pos, rows, fd._sm_count(torch.device("cuda")))
    edges = {chunk * i + d for i in range(1, n) for d in (-2, -1, 0)}
    return {p for p in edges | {fd.CHUNK_ROWS - 1, fd.CHUNK_ROWS}
            if 0 <= p <= pos}


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv,D", [(8, 8, 128), (8, 2, 128), (4, 1, 64),
                                     (4, 4, 16), (8, 4, 32), (8, 1, 128)])
def test_flash_decode_linear_kernel_matches_plain(gen, kv, H, Hkv, D):
    # S_max 600 at B 3: positions below CHUNK_ROWS run in one chunk, the
    # rest split; the split's chunk edges at the last position (pos =
    # k chunk - 1 ends a chunk, k chunk opens one of a single row);
    # (8, 1, 128) is g = 8; each position twice for equal bits
    B, S = 3, 600
    positions = {0, 255, 256, 511, S - 1} | _chunk_edges(S - 1, B * Hkv)
    _linear_decode_positions(gen, kv, B, H, Hkv, D, S, sorted(positions))


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 2)])
def test_flash_decode_linear_kernel_one_chunk_at_a_full_batch(gen, kv, H,
                                                              Hkv):
    # enough kv rows (B * Hkv) to give every SM its CTAS_PER_SM CTAs
    # unsplit (B 33 at Hkv 8 on 132 SMs): one chunk at every position, so
    # each CTA walks up to 600 rows in several steps, merges its threads'
    # states by lse and normalises in place
    D, S = 128, 600
    sms = fd._sm_count(torch.device("cuda"))
    B = -(-fd.CTAS_PER_SM * sms // Hkv)
    positions = (63, 255, 256, 511, S - 1)
    assert all(fd.decode_chunks(p, B * Hkv, sms)[0] == 1 for p in positions)
    _linear_decode_positions(gen, kv, B, H, Hkv, D, S, positions)


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 2)])
def test_flash_decode_linear_kernel_long_cache(gen, kv, H, Hkv):
    # S_max 4096 full (pos 4095: the split's longest chunks, several steps
    # a chunk) and next to its chunk edges
    B, D, S = 2, 128, 4096
    positions = {S - 1} | set(sorted(_chunk_edges(S - 1, B * Hkv))[-3:])
    _linear_decode_positions(gen, kv, B, H, Hkv, D, S, sorted(positions))


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv,D,P,pages", [(8, 8, 128, 256, 4),
                                             (8, 2, 128, 256, 4),
                                             (8, 8, 64, 16, 7),
                                             (4, 1, 16, 16, 3)])
def test_paged_attention_kernel_matches_plain(gen, kv, H, Hkv, D, P, pages):
    B = 4
    qdt = _qdtype(kv, f32_with=("fp8",))
    q, kp, vp, ks, vs, table = _pools(gen, kv, B, H, Hkv, D, P, pages, qdt)
    pos = torch.tensor([0, P - 1, P + 3, pages * P - 1], dtype=torch.int32,
                       device="cuda")
    for p in (pos, P // 2):
        n = pa.launches
        got = pa.paged_attention_decode(q, kp, vp, table, p, k_scale_pool=ks,
                                        v_scale_pool=vs)
        torch.cuda.synchronize()
        assert pa.launches == n + 1
        want = fd.flash_decode_paged_reference(q, kp, vp, table, p,
                                               k_scale_pool=ks,
                                               v_scale_pool=vs)
        assert (got - want).abs().max().item() <= 1e-4


def test_paged_attention_long_context_launches_and_matches_plain(gen):
    # g 8 x 8192 rows (32 pages of 256): a score row of 256 KB that the
    # one-CTA kernel could not hold in shared memory and refused; split into
    # 128-row chunks it launches (64 chunks, merged by lse) and matches the
    # plain version, at a fill inside the table and at its last row
    q, kp, vp, _, _, table = _pools(gen, "bfloat16", 1, 8, 1, 64, 256, 32,
                                    torch.bfloat16)
    assert fd.paged_decode_plan(32, 256) == (64, 128)
    for p in (5000, 32 * 256 - 1):
        n = pa.launches
        got = pa.paged_attention_decode(q, kp, vp, table, p)
        torch.cuda.synchronize()
        assert pa.launches == n + 1
        want = fd.flash_decode_paged_reference(q, kp, vp, table, p)
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("H,Hkv,D,P", [(8, 8, 128, 256), (8, 1, 64, 16),
                                       (8, 2, 32, 300)])
def test_paged_attention_kernel_is_batch_invariant(gen, kv, H, Hkv, D, P):
    # one sequence decoded alone (B 1, a table just wide enough) and as
    # row 5 of a batch of 8 with a wider table gives equal bits, and two
    # calls give equal bits: the chunk is fixed by the page size, not by
    # the batch, the kv heads or the table width; fills on and next to the
    # chunk edges (127, 128, 255, 256: the table holds three chunks or
    # more) and inside the first chunk (one chunk normalised in place, no
    # merge)
    qdt = _qdtype(kv)
    chunk = fd.paged_decode_chunk(P)
    pages = max(4, -(-3 * chunk // P))
    wide = pages + 3
    kp, vp, ks, vs = _seq_pools(gen, kv, 8 * wide + 1, Hkv, D, P, qdt)
    q = torch.randn(8, H, D, generator=gen, device="cuda").to(qdt)
    table = torch.randperm(8 * wide + 1, generator=gen,
                           device="cuda")[:8 * wide]
    table = table.to(torch.int32).reshape(8, wide)
    assert fd.paged_decode_plan(pages, P)[1] == chunk
    assert fd.paged_decode_plan(wide, P)[1] == chunk
    fills = sorted({p for c in (1, 2) for p in (c * chunk - 1, c * chunk)}
                   | {0, chunk // 2, pages * P - 1})
    assert fills[-1] < pages * P
    for fill in fills:
        pos = torch.randint(0, wide * P, (8,), generator=gen, device="cuda")
        pos[5] = fill
        pos = pos.to(torch.int32)
        batch = pa.paged_attention_decode(q, kp, vp, table, pos,
                                          k_scale_pool=ks, v_scale_pool=vs)
        again = pa.paged_attention_decode(q, kp, vp, table, pos,
                                          k_scale_pool=ks, v_scale_pool=vs)
        alone = pa.paged_attention_decode(
            q[5:6].clone(), kp, vp, table[5:6, :pages].clone(),
            pos[5:6].clone(), k_scale_pool=ks, v_scale_pool=vs)
        torch.cuda.synchronize()
        assert torch.equal(batch, again), fill
        assert torch.equal(alone[0], batch[5]), fill
        want = fd.flash_decode_paged_reference(
            q, kp, vp, table, pos, k_scale_pool=ks, v_scale_pool=vs)
        assert (batch - want).abs().max().item() <= 1e-4, fill


def test_decode_wrappers_reject_pool_dtypes_they_do_not_take(gen):
    q = torch.zeros(2, 4, 64, device="cuda", dtype=torch.bfloat16)
    table = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    sc = torch.ones(4, 4, 1, 16, device="cuda")
    pools = {dt: torch.zeros(4, 4, 16, 64, device="cuda", dtype=dt)
             for dt in (torch.float16, torch.float32, torch.int8,
                        torch.float8_e4m3fn, torch.float8_e5m2)}
    paged = (fd.flash_decode_paged, pa.paged_attention_decode)
    for fn in paged:
        for dt in (torch.float16, torch.float32, torch.float8_e5m2):
            with pytest.raises(ValueError):  # not q's dtype, not one-byte
                fn(q, pools[dt], pools[dt], table, 3)
        with pytest.raises(ValueError, match="needs"):
            fn(q, pools[torch.int8], pools[torch.int8], table, 3)
        with pytest.raises(ValueError, match="float32"):
            fn(q, pools[torch.int8], pools[torch.int8], table, 3,
               k_scale_pool=sc.double(), v_scale_pool=sc.double())
        with pytest.raises(ValueError, match="f32/bf16 q"):
            fn(q.half(), pools[torch.int8], pools[torch.int8], table, 3,
               k_scale_pool=sc, v_scale_pool=sc)
    lin = torch.zeros(2, 4, 32, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(q, lin, lin, 3)
    with pytest.raises(ValueError, match="refuses"):
        fd.flash_decode_attention(q, lin.bfloat16(), lin.bfloat16(), 3,
                                  k_scale=sc[:2, :, 0, :32],
                                  v_scale=sc[:2, :, 0, :32])
    with pytest.raises(ValueError, match="D in"):
        q48 = torch.zeros(2, 4, 48, device="cuda")
        p48 = torch.zeros(4, 4, 16, 48, device="cuda")
        fd.flash_decode_paged(q48, p48, p48, table, 3)


@pytest.mark.parametrize("n,trips", [(1024, 1), (1024, 7), (1024, 300),
                                     (65536, 300), (1000, 3)])
def test_busy_wait_kernel_equals_plain_bitwise(gen, n, trips):
    x = torch.rand(n, generator=gen, device="cuda")
    before = kernels.launches
    got = kernels.busy_wait(x, trips)
    torch.cuda.synchronize()
    assert kernels.launches == before + 1
    assert torch.equal(got, kernels.busy_wait_reference(x, trips))


@pytest.mark.parametrize("mode", pipeline.MODES)
@pytest.mark.parametrize("chunks,rows", [(4, 64), (3, 1064), (2, 14000),
                                         (2, 8), (16, 2048), (16, 32768)],
                         ids=["4x64", "ragged-3x1064", "capped-ragged-2x14000",
                              "2x8", "bench-16x2048", "past-l2-16x32768"])
def test_overlap_pipeline_kernel_equals_plain_bitwise(gen, mode, chunks, rows):
    # on 132 SMs (pipeline_plan): 64 rows on 8 blocks; 1064 rows on 132
    # blocks of 32 or 33 units (1024 or 1056 floats); 14000 rows on 132
    # blocks of 424 or 425 units in one tile; 8 rows on one block; the
    # overlap bench's two shapes: 132 blocks of 62 or 63 units in one
    # tile, and 132 blocks of 992 or 993 units in two tiles (one wave)
    x = torch.rand(chunks, rows, 128, generator=gen, device="cuda")
    out = torch.full_like(x, -1.0)
    before = pipeline.launches
    got = pipeline.overlap_run(x, mode=mode, tripcount=3, passes=2, out=out)
    torch.cuda.synchronize()
    assert pipeline.launches == before + 1
    want, written = pipeline.overlap_run_reference(x, mode=mode, tripcount=3,
                                                   passes=2)
    assert torch.equal(got, want)
    if written is not None:
        assert torch.equal(out, written)
    else:
        assert bool((out == -1.0).all())


@pytest.mark.parametrize("mode", pipeline.MODES)
@pytest.mark.parametrize("chunks,rows", [(3, 32776), (5, 2056)])
def test_overlap_pipeline_partial_shares_and_tiles_equal_plain(gen, mode,
                                                              chunks, rows):
    # row counts that leave partial shares and tiles: 32776 rows are
    # 131104 units over 132 blocks (993 or 994 each, cut into tiles of 496
    # or 497 units), 2056 rows 8224 units (62 or 63); an odd chunk count,
    # three passes, so steps change slot parity across passes and the
    # seeded modes' slots follow the chunk, not the step
    x = torch.rand(chunks, rows, 128, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, tiles = pipeline.pipeline_plan(rows, sms)
    assert rows * 4 % blocks  # the shares are not all equal
    out = torch.full_like(x, -1.0)
    got = pipeline.overlap_run(x, mode=mode, tripcount=2, passes=3, out=out)
    again = pipeline.overlap_run(x, mode=mode, tripcount=2, passes=3)
    torch.cuda.synchronize()
    want, written = pipeline.overlap_run_reference(x, mode=mode, tripcount=2,
                                                   passes=3)
    assert torch.equal(got, want) and torch.equal(again, want)
    if written is not None:
        assert torch.equal(out, written)
    else:
        assert bool((out == -1.0).all())


def test_pipeline_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    x = torch.zeros(2, 16, 128, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        pipeline.overlap_run(x.transpose(0, 1).contiguous().transpose(0, 1),
                             mode="serial")
    with pytest.raises(ValueError, match="out must match"):
        pipeline.overlap_run(x, mode="pair_serial", out=x[:1])


def test_commands_on_the_card_use_streams_and_pinned_memory(gen):
    m2d = commands.CopyM2DCommand(1 << 16, device="cuda")
    d2m = commands.CopyD2MCommand(1 << 16, device="cuda")
    c = commands.ComputeCommand(1024, tripcount=5, device="cuda")
    assert m2d._host.is_pinned() and d2m._host.is_pinned()
    assert len({id(m2d.stream), id(d2m.stream), id(c.stream)}) == 3
    m2d._host.fill_(3.0)
    d2m._dev.fill_(5.0)
    before = kernels.launches
    for cmd in (m2d, d2m, c):
        cmd.submit()
    for cmd in (m2d, d2m, c):
        cmd.block()
    assert kernels.launches == before + 1
    assert bool((m2d._dev == 3.0).all()) and bool((d2m._host == 5.0).all())
    assert torch.equal(c._pending, kernels.busy_wait_reference(c.x, 5))


def _ring_input(gen, ranks, shard, dtype):
    x = torch.randn(ranks, *shard, generator=gen, device="cuda") * 8
    return x.to(torch.int32) if dtype == torch.int32 else x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("size", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("n", [40, 65, 4096])
def test_fused_allreduce_kernel_equals_plain_bitwise(gen, size, dtype, n):
    x = _ring_input(gen, size, (n,), dtype)
    before = fused.launches["fused_allreduce"]
    got = fused.fused_allreduce(x)
    fused.synchronize()
    assert fused.launches["fused_allreduce"] == before + 1
    want = fused.fused_allreduce_reference(x, lane=fused.CARD_LANE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shard", [(3, 40), (2, 5, 24), (1 << 25,)],
                         ids=["3x40", "2x5x24", "bench-2^25"])
def test_fused_allreduce_kernel_shapes(gen, shard):
    x = _ring_input(gen, 4, shard, torch.float32)
    got = fused.fused_allreduce(x)
    fused.synchronize()
    assert torch.equal(got, fused.fused_allreduce_reference(
        x, lane=fused.CARD_LANE))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_allreduce_into_bias_relu_equals_plain_bitwise(gen, dtype):
    x = _ring_input(gen, 8, (65,), dtype)
    bias = _ring_input(gen, 1, (65,), dtype)[0]
    got = fused.allreduce_into(x, bias=bias, epilogue="relu")
    fused.synchronize()
    want = fused.fused_allreduce_reference(x, bias=bias, epilogue="relu",
                                           lane=fused.CARD_LANE)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused.allreduce_into(x, epilogue=torch.tanh)


@pytest.mark.parametrize("size,stride,total", [(4, 1, 8), (2, 4, 8),
                                               (2, 2, 8)])
def test_fused_kernels_over_a_multi_axis_geometry(gen, size, stride, total):
    g = fused.RingGeometry(size=size, stride=stride, total=total)
    x = _ring_input(gen, total, (40,), torch.float32)
    got = fused.fused_allreduce(x, geometry=g)
    fused.synchronize()
    assert torch.equal(got, fused.fused_allreduce_reference(
        x, geometry=g, lane=fused.CARD_LANE))
    assert torch.equal(fused.fused_ring_shift(x, 1, geometry=g),
                       fused.fused_permute_reference(
                           x, fused.ring._ring_perm(size, 1), geometry=g))
    a = _ring_input(gen, total, (4, 16), torch.float32)
    w = _ring_input(gen, total, (16, 8), torch.float32)
    got = fused.allgather_matmul(a, w, geometry=g)
    fused.synchronize()
    want = fused.allgather_matmul_reference(a, w, geometry=g)
    assert bool(((got - want).abs() <= fused.allgather_matmul_tolerance(
        a, w, want, geometry=g)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("size,m,k,n", [(8, 3, 16, 8), (4, 64, 128, 96),
                                        (3, 70, 40, 130),
                                        (4, 256, 1024, 1024)],
                         ids=["battery", "aligned", "ragged", "bench"])
def test_allgather_matmul_kernel_matches_plain(gen, dtype, size, m, k, n):
    if dtype == torch.int32:
        x = torch.randint(-3, 4, (size, m, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        w = torch.randint(-3, 4, (size, k, n), generator=gen, device="cuda",
                          dtype=torch.int32)
    else:
        x = torch.randn(size, m, k, generator=gen, device="cuda").to(dtype)
        w = torch.randn(size, k, n, generator=gen, device="cuda").to(dtype)
    before = fused.launches["allgather_matmul"]
    got = fused.allgather_matmul(x, w)
    fused.synchronize()
    assert fused.launches["allgather_matmul"] == before + 1
    want = fused.allgather_matmul_reference(x, w)
    assert got.shape == (size, size * m, n) and got.dtype == dtype
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        err = (got.float() - want.float()).abs()
        tol = fused.allgather_matmul_tolerance(x, w, want)
        assert bool((err <= tol).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,m,k,n", [(2, 129, 1000, 65),
                                        (8, 200, 17, 1000),
                                        (2, 200, 17, 65),
                                        (8, 129, 1000, 1000)])
def test_allgather_matmul_kernel_at_its_tile_edges_equal_bits(gen, dtype,
                                                              size, m, k, n):
    # rows past a 128-row tile, columns past a 64-column one, k past a
    # 16-deep stage and rows that are not whole 16-byte vectors (the
    # widening route), at ring sizes 2 and 8; two calls give equal bits
    x = torch.randn(size, m, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn(size, k, n, generator=gen, device="cuda").to(dtype)
    got = fused.allgather_matmul(x, w)
    again = fused.allgather_matmul(x, w)
    fused.synchronize()
    want = fused.allgather_matmul_reference(x, w)
    err = (got.float() - want.float()).abs()
    assert bool((err <= fused.allgather_matmul_tolerance(x, w, want)).all())
    assert torch.equal(got, again)


def test_allgather_matmul_plan_matches_the_kernel(gen):
    # the wrapper's tile is the kernel's, and the bench shape is one wave
    # on the card (a CTA per tile of every rank)
    cfg = (ctypes.c_int * 4)()
    fused._lib().allgather_matmul_config(cfg)
    assert (cfg[0], cfg[1]) == fused.AGMM_TILE
    cap = fused._capacity("allgather_matmul", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cap >= sms
    bm, bn, G, waves = fused.agmm_plan(4, 256, 1024, cap)
    assert (G, waves) == ((256 // bm) * (1024 // bn), 1)


def test_allgather_matmul_tolerance_rejects_tf32(gen):
    # the control: the same product with TF32 inputs must fail the bound
    # that the kernel passes, or the bound could not tell f32 FFMA apart
    x = torch.randn(4, 256, 1024, generator=gen, device="cuda")
    w = torch.randn(4, 1024, 1024, generator=gen, device="cuda")
    want = fused.allgather_matmul_reference(x, w)
    tol = fused.allgather_matmul_tolerance(x, w, want)
    got = fused.allgather_matmul(x, w)
    fused.synchronize()
    assert bool(((got - want).abs() <= tol).all())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fused.allgather_matmul_reference(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert not bool(((tf32 - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("shard", [(24,), (2, 4, 3, 8), (1 << 20,), (7,)])
def test_fused_permute_kernel_equals_plain_bitwise(gen, dtype, shard):
    size = 8
    x = (torch.randn(size, *shard, generator=gen, device="cuda") * 50
         ).to(dtype)
    perms = [[(i, i ^ 1) for i in range(size)]] + [
        fused.ring._ring_perm(size, s) for s in (1, -1, 3)]
    for perm in perms:
        before = fused.launches["fused_permute"]
        got = fused.fused_permute(x, perm)
        fused.synchronize()
        assert fused.launches["fused_permute"] == before + 1
        assert torch.equal(got, fused.fused_permute_reference(x, perm))
    with pytest.raises(ValueError, match="partial"):
        fused.fused_permute(x, [(0, 1), (1, 0)])


def test_fused_permute_kernel_at_the_bench_shape(gen):
    x = torch.randn(4, 1 << 25, generator=gen, device="cuda")
    for perm in ([(r, r ^ 1) for r in range(4)],
                 fused.ring._ring_perm(4, 1), fused.ring._ring_perm(4, 3)):
        got = fused.fused_permute(x, perm)
        fused.synchronize()
        assert torch.equal(got, fused.fused_permute_reference(x, perm))



# (size, stride, total, shard, dtype, CTAs a rank): stripes of many tiles
# whose last is ragged (few CTAs a rank; M a multiple of no tile), m > 1
# rows a shard, the rings of multi-axis geometries (stride > 1,
# replicas), and the plan's own CTA count (None)
FIFO_CASES = [(4, 1, 4, (3, 70000), torch.float32, 2),
              (3, 1, 3, (5, 24584), torch.bfloat16, 1),
              (5, 1, 5, (131079,), torch.int32, 3),
              (2, 4, 8, (2, 40000), torch.float32, 2),
              (2, 2, 8, (50000,), torch.bfloat16, 1),
              (4, 2, 8, (3, 9000), torch.int32, None),
              (8, 1, 8, (1 << 20,), torch.float32, None)]


@pytest.mark.parametrize("case", FIFO_CASES)
def test_fused_allreduce_fifo_equals_plain_bitwise(gen, case):
    # stripes of many tiles, walked three at a time through four slots a
    # link (the rings wait on credits: it must not deadlock), with and
    # without the bias/relu epilogue
    size, stride, total, shard, dtype, ctas = case
    g = fused.RingGeometry(size=size, stride=stride, total=total)
    x = _ring_input(gen, total, shard, dtype)
    bias = _ring_input(gen, 1, shard, dtype)[0]
    for kw in ({}, {"bias": bias, "epilogue": "relu"}):
        got = fused._fused_allreduce_launch(
            x, kw.get("bias"), kw.get("epilogue"), g, ranks_launched=total,
            ctas_a_rank=ctas)
        fused.synchronize()
        plan = fused._scratch["allreduce"]["key"][-1]
        assert ctas is None or plan.ctas_a_rank == ctas
        assert torch.equal(got, fused.fused_allreduce_reference(
            x, geometry=g, lane=fused.CARD_LANE, **kw)), kw


def test_fused_allreduce_fifo_sequence_and_epoch_wrap(gen):
    # many back-to-back launches on one scratch whose links' counters (and
    # epoch) stand just short of the u32 wrap: the counters run on from
    # launch to launch, each launch reading where they stand, so they pass
    # 2^32 and many launches' worth of tiles, and each result stays exact
    x = _ring_input(gen, 4, (3, 20000), torch.float32)
    want = fused.fused_allreduce_reference(x, lane=fused.CARD_LANE)
    g = fused.RingGeometry(size=4)

    def call():
        return fused._fused_allreduce_launch(x, None, None, g,
                                             ranks_launched=4, ctas_a_rank=2)

    got = call()
    fused.synchronize()
    assert torch.equal(got, want)
    s = fused._scratch["allreduce"]
    items = 2 * 3 * s["key"][-1].tiles  # tiles a link carries a launch
    # where a launch at that point of the sequence would leave them
    s["flags"].fill_(-5 * items - 3)
    s["epoch"] = (1 << 32) - 20
    for i in range(60):
        got = call()
        if i % 7 == 0:
            fused.synchronize()
            assert torch.equal(got, want), i
    fused.synchronize()
    assert torch.equal(got, want)
    assert int(s["flags"][fused.FIFO_FLAG_WORDS]) == 55 * items - 3
    assert s["epoch"] < 60


def test_fused_allreduce_fifo_missing_rank_times_out(gen):
    # a ring one rank short: the ranks wait on tiles and credits that
    # never come; the spins give up and the next call raises, then runs
    # right again on fresh scratch
    x = _ring_input(gen, 4, (1 << 18,), torch.float32)
    g = fused.RingGeometry(size=4)
    fused._fused_allreduce_launch(x, None, None, g, ranks_launched=3,
                                  ctas_a_rank=2)
    with pytest.raises(RuntimeError, match="timed out"):
        fused.synchronize()
    got = fused.fused_allreduce(x)
    fused.synchronize()
    assert torch.equal(got, fused.fused_allreduce_reference(
        x, lane=fused.CARD_LANE))


def test_fused_allreduce_plan_matches_the_kernel(gen):
    # the wrapper sizes the FIFO and the counters by the kernel's own
    # tile, slots and counter stride
    cfg = (ctypes.c_int * 4)()
    fused._lib().fused_allreduce_config(cfg)
    assert (cfg[0], cfg[1], cfg[3]) == (fused.ALLREDUCE_TILE_VECTORS,
                                        fused.ALLREDUCE_SLOTS,
                                        fused.FIFO_FLAG_WORDS)
    assert cfg[2] * 4 == fused.ALLREDUCE_TILE_VECTORS  # 4 vectors a thread


def test_fused_allreduce_fifo_scratch_stays_in_its_budget(gen):
    # at the bench shape the receive slots no longer scale with the
    # tensor: FIFO and counters within the stated L2 budget (+ counters)
    x = _ring_input(gen, 4, (1 << 25,), torch.float32)
    got = fused.fused_allreduce(x)
    fused.synchronize()
    assert torch.equal(got, fused.fused_allreduce_reference(
        x, lane=fused.CARD_LANE))
    s = fused._scratch["allreduce"]
    plan = s["key"][-1]
    assert s["fifo"].numel() == plan.fifo_bytes \
        <= fused.ALLREDUCE_FIFO_BUDGET
    assert s["flags"].numel() == plan.flag_words
    assert plan.ctas_a_rank * 4 <= fused._capacity("fused_allreduce", 0)

def test_missing_rank_times_out_instead_of_hanging(gen):
    # launch the ring one rank short: rank 0 waits for a neighbour that
    # never runs; the spin must give up, abort the launch and raise
    x = _ring_input(gen, 4, (4096,), torch.float32)
    g = fused.RingGeometry(size=4)
    fused._fused_allreduce_launch(x, None, None, g, ranks_launched=3)
    with pytest.raises(RuntimeError, match="timed out"):
        fused.synchronize()
    # the next launch starts from fresh scratch and is right again
    got = fused.fused_allreduce(x)
    fused.synchronize()
    assert torch.equal(got, fused.fused_allreduce_reference(
        x, lane=fused.CARD_LANE))


@pytest.mark.parametrize("rows,cols", [(8, 128), (3, 5), (1024, 1024)])
def test_alias_kernel_writes_in_place_bitwise(gen, rows, cols):
    x = torch.randn(rows, cols, generator=gen, device="cuda")
    want = x.clone().mul_(2.0).add_(1.0)
    ptr = x.data_ptr()
    before = interop_device.launches
    out = interop_device.alias_inplace(x)
    torch.cuda.synchronize()
    assert interop_device.launches == before + 1
    assert out.data_ptr() == ptr == x.data_ptr()
    assert torch.equal(out, want)
    ok, ev = interop_device.kernel_alias_proof()
    assert ok and ev["pointer_ok"] and not ev["interpret"], ev


MLP_TOL = 2e-2
DW_TOL = 1e-3


def _mlp_inputs(gen, N, D, F):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()
    return (r(N, D), r(D, F, scale=D ** -0.5), r(F, D, scale=F ** -0.5),
            r(N, D))


# (N, D, F): the chip model's layer (B 8 x T 2048, d_model 1024, d_ff
# 4096), off-size token counts and d_ff panels, the narrowest width; one
# token past a 128-token tile; ragged N and F at d_model 384 (clusters of
# 3 CTAs of 128 columns); one token with d_ff 8 (every d_ff column past
# the first 8 of the CTA's 64 is the TMA's zero fill)
MLP_CASES = [(16384, 1024, 4096), (100, 1024, 320), (4096, 512, 2048),
             (37, 128, 136), (129, 1024, 4096), (300, 384, 264),
             (1, 128, 8)]


@pytest.mark.parametrize("N,D,F", MLP_CASES)
def test_fused_mlp_forward_kernels_match_plain(gen, N, D, F):
    x, w1, w2, _ = _mlp_inputs(gen, N, D, F)
    n = dict(fm.launches)
    y = fm.fused_mlp_forward(x, w1, w2)
    ys, a = fm.fused_mlp_forward(x, w1, w2, save_a=True)
    torch.cuda.synchronize()
    assert (fm.launches["fwd"] - n["fwd"],
            fm.launches["fwd_save_a"] - n["fwd_save_a"]) == (1, 1)
    want, want_a = fm.fused_mlp_forward_reference(x, w1, w2, save_a=True)
    assert _rel(y, want) <= MLP_TOL and _rel(a, want_a) <= MLP_TOL
    assert torch.equal(ys, y)  # the same arithmetic with or without a
    assert torch.equal(fm.fused_mlp_forward(x, w1, w2), y)


@pytest.mark.parametrize("N,D,F", MLP_CASES)
def test_fused_mlp_backward_kernels_match_plain_and_are_deterministic(
        gen, N, D, F):
    x, w1, w2, dy = _mlp_inputs(gen, N, D, F)
    n = dict(fm.launches)
    dx, g, da = fm.fused_mlp_bwd_dx(x, w1, w2, dy)
    dw1, dw2 = fm.fused_mlp_bwd_dw(x, g, da, dy)
    torch.cuda.synchronize()
    assert (fm.launches["bwd_dx"] - n["bwd_dx"],
            fm.launches["bwd_dw"] - n["bwd_dw"]) == (1, 1)
    w_dx, w_g, w_da = fm.fused_mlp_bwd_dx_reference(x, w1, w2, dy)
    for got, want in ((dx, w_dx), (g, w_g), (da, w_da)):
        assert torch.isfinite(got).all() and _rel(got, want) <= MLP_TOL
    w_dw1, w_dw2 = fm.fused_mlp_bwd_dw_reference(x, g, da, dy)
    assert dw1.dtype == torch.float32 == dw2.dtype
    assert _rel(dw1, w_dw1) <= DW_TOL and _rel(dw2, w_dw2) <= DW_TOL
    again = fm.fused_mlp_bwd_dx(x, w1, w2, dy)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, g, da)))
    assert all(torch.equal(a, b) for a, b in zip(
        fm.fused_mlp_bwd_dw(x, g, da, dy), (dw1, dw2)))


@pytest.mark.parametrize("mode", fm.BWD_MODES)
def test_fused_mlp_autograd_on_the_card(gen, monkeypatch, mode):
    monkeypatch.setenv("HPCPAT_FUSED_MLP_BWD", mode)
    x, w1, w2, dy = _mlp_inputs(gen, 2 * 100, 256, 1024)
    ins = [t.clone().requires_grad_() for t in (x, w1, w2)]
    n = dict(fm.launches)
    y = fm.fused_mlp(ins[0].reshape(2, 100, 256), ins[1], ins[2])
    grads = torch.autograd.grad(y, ins, dy.reshape(2, 100, 256))
    torch.cuda.synchronize()
    fwd = "fwd_save_a" if mode == "xla_a" else "fwd"
    kernel_bwd = 1 if mode == "kernel" else 0
    assert {k: fm.launches[k] - n[k] for k in fm.launches} == {
        "fwd": int(fwd == "fwd"), "fwd_save_a": int(fwd != "fwd"),
        "bwd_dx": kernel_bwd, "bwd_dw": kernel_bwd}
    want = fm.fused_mlp_backward_reference(x, w1, w2, dy)
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16 and _rel(got, w) <= MLP_TOL


def test_fused_mlp_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x, w1, w2, dy = _mlp_inputs(gen, 64, 256, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        fm.fused_mlp(x.float(), w1.float(), w2.float())
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp(x, w2.t(), w1.t())
    xs, w1s, w2s, _ = _mlp_inputs(gen, 64, 96, 512)
    with pytest.raises(ValueError, match="d_model a multiple of 128"):
        fm.fused_mlp(xs, w1s, w2s)
    xw, w1w, w2w, _ = _mlp_inputs(gen, 64, 2048, 512)
    with pytest.raises(ValueError, match="up|d_model"):
        fm.fused_mlp(xw, w1w, w2w)
    with pytest.raises(ValueError, match="d_ff a multiple of 8"):
        fm.fused_mlp(x, w1[:, :500].contiguous(), w2[:500].contiguous())
    with pytest.raises(ValueError, match="x on"):
        fm.fused_mlp_forward(x, w1.cpu(), w2)


# (n_pages, page shape, dtype): the plane row's bf16 K/V pages (8 kv heads,
# page 256, D 128) at 1, 2, 5 (a ragged last chunk) and 16 pages; int8 and
# fp8 pages with their f32 scale pools; rows of 24 and 13 bytes (the
# byte-wise route)
MIGRATION_CASES = [(1, (8, 256, 128), torch.bfloat16),
                   (2, (8, 256, 128), torch.bfloat16),
                   (5, (8, 256, 128), torch.bfloat16),
                   (16, (8, 256, 128), torch.bfloat16),
                   (2, (8, 256, 128), torch.int8),
                   (2, (8, 1, 256), torch.float32),
                   (5, (8, 256, 128), torch.float8_e4m3fn),
                   (3, (2, 3), torch.float32),
                   (9, (13,), torch.int8)]


@pytest.mark.parametrize("n_pages,page,dtype", MIGRATION_CASES)
@pytest.mark.parametrize("page_chunk", [1, md.PAGE_CHUNK])
def test_migration_exchange_kernel_bytes_equal_plain(gen, n_pages, page,
                                                     dtype, page_chunk):
    nbytes = n_pages * math.prod(page) * torch.tensor([], dtype=dtype
                                                      ).element_size()
    bits = torch.randint(0, 256, (nbytes,), generator=gen, device="cuda",
                         dtype=torch.uint8)
    x = bits.view(dtype).reshape(n_pages, -1)
    n = md.launches["migration_exchange"]
    got = md.migration_exchange(x, page_chunk)
    md.synchronize()
    assert md.launches["migration_exchange"] == n + 1
    assert got.data_ptr() != x.data_ptr() and got.dtype == dtype
    want = md.migration_exchange_reference(x, page_chunk)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8).flatten(), bits)


@pytest.mark.parametrize("page_chunk", [1, md.PAGE_CHUNK])
def test_migration_exchange_missing_sender_times_out(gen, page_chunk):
    # a launch one sender short never lands: synchronize() raises, and the
    # counters it left one short poison neither later launch (both sets)
    x = torch.randn(4, 8 * 256 * 128, generator=gen, device="cuda")
    G = md._senders(x.device, page_chunk * x.shape[1] * 4)
    if G < 2:
        pytest.skip("one sender CTA: nothing to leave out")
    md.migration_exchange(x, page_chunk, senders_launched=G - 1)
    with pytest.raises(RuntimeError, match="never landed"):
        md.synchronize()
    for _ in range(3):  # the next launches are right again
        got = md.migration_exchange(x, page_chunk)
        md.synchronize()
        assert torch.equal(got, x)


def test_migration_exchange_budget_refuses_before_launching(gen):
    big = torch.zeros(1, md.LANDING_LIMIT // 4 + 4, device="cuda")
    n = md.launches["migration_exchange"]
    with pytest.raises(md.MigrationDmaError, match="budget"):
        md.migration_exchange(big)
    assert md.launches["migration_exchange"] == n


# ------------------------------------------------------------ tiered memory

def test_residency_round_trip_on_the_card_is_pinned_and_exact(gen):
    # the host tier on the card is pinned host memory, never pageable; a
    # push (side stream, behind the producer) and a pull (side stream,
    # the consumer waiting on its event) move every byte back exactly
    from hpc_patterns_tpu_torch.memory import ResidencyManager
    from hpc_patterns_tpu_torch.memory import kinds

    assert kinds.memory_kind_transfers_work("cuda")
    m = ResidencyManager(host_blocks=4, device="cuda")
    src = torch.randn(3, 8, 256, 128, generator=gen, device="cuda")
    payload = {"k": (src.to(torch.bfloat16),), "v": (src * 2,)}
    host = m.push_payload(payload)
    assert all(h.is_pinned() for h in (*host["k"], *host["v"]))
    m.drain()
    back, handle = m.pull_payload(host)
    m.wait_pull(handle)
    got = torch.cat([back["k"][0].float().flatten(), back["v"][0].flatten()])
    m.complete_pull(handle)
    want = torch.cat([payload["k"][0].float().flatten(),
                      payload["v"][0].flatten()])
    assert torch.equal(got, want)
    assert m.swap_outs == m.swap_ins == 1


def test_allreduce_host_kind_equals_device_kind_bitwise(gen):
    from hpc_patterns_tpu_torch.apps import allreduce_app, common

    comm = common.make_communicator("cuda", 4, even=True)
    x = comm.rank_filled(1 << 16, "float32")
    for algorithm in ("ring", "fused"):
        step = comm.jit_allreduce(x, algorithm)
        want = step(x).cpu()
        xh = x.cpu().pin_memory()
        got = allreduce_app.host_resident(step, comm.device)(xh)
        comm.synchronize()
        assert got.is_pinned() and torch.equal(got, want)


# ------------------------------------------------------- the parallel layer

RING_SHAPE = dict(P=4, B=2, T=256, H=8, D=128)


def _ring_qkv(gen, Hkv):
    P, B, T, H, D = RING_SHAPE.values()
    q = torch.randn(P, B, T, H, D, generator=gen, device="cuda")
    k = torch.randn(P, B, T, Hkv, D, generator=gen, device="cuda")
    v = torch.randn(P, B, T, Hkv, D, generator=gen, device="cuda")
    return [t.bfloat16() for t in (q, k, v)]


@pytest.mark.parametrize("Hkv", [8, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_and_fused_shift_match_plain_route(gen, Hkv, causal):
    from hpc_patterns_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = _ring_qkv(gen, Hkv)
    P = RING_SHAPE["P"]
    dense = ring_attention(q, k, v, causal=causal)
    fa.launches["fwd_lse"] = 0
    fused.launches["fused_permute"] = 0
    flash = ring_attention(q, k, v, causal=causal, impl="flash",
                              shift_impl="fused")
    torch.cuda.synchronize()
    assert fa.launches["fwd_lse"] == (P * (P + 1) // 2 if causal else P * P)
    assert fused.launches["fused_permute"] == 2 * (P - 1)
    assert (flash.float() - dense.float()).abs().max().item() <= 2e-2
    again = ring_attention(q, k, v, causal=causal, impl="flash")
    assert torch.equal(flash, again)  # the two shifts move the same bytes
    for t in (k, v):
        assert torch.equal(fused.fused_ring_shift(t, 1), torch.roll(t, 1, 0))


def test_ring_flash_grads_match_dense_ring(gen):
    from hpc_patterns_tpu_torch.parallel.ring_attention import ring_attention

    base = _ring_qkv(gen, 2)
    g = torch.randn(base[0].shape, generator=gen, device="cuda").bfloat16()
    grads = []
    for impl in ("flash", "dense"):
        ts = [t.clone().requires_grad_(True) for t in base]
        out = ring_attention(*ts, causal=True, impl=impl)
        grads.append(torch.autograd.grad(out, ts, g))
    for a, b in zip(*grads):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item()


def test_ulysses_flash_matches_plain_route(gen):
    from hpc_patterns_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = _ring_qkv(gen, 4)
    fa.launches["fwd"] = 0
    flash = ulysses_attention(q, k, v, causal=True, impl="flash")
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == 1  # the ranks' head slices in one launch
    dense = ulysses_attention(q, k, v, causal=True)
    assert (flash.float() - dense.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_dense_scatter_on_the_card_matches_cpu(gen, top_k):
    from hpc_patterns_tpu_torch.parallel import moe

    N, D, F, E = 4096, 256, 512, 8
    x = torch.randn(N, D, generator=gen, device="cuda")
    router = torch.randn(D, E, generator=gen, device="cuda") / D ** 0.5
    w1 = torch.randn(E, D, F, generator=gen, device="cuda") / D ** 0.5
    w2 = torch.randn(E, F, D, generator=gen, device="cuda") / F ** 0.5
    cap = moe.default_capacity(N * top_k, E)
    got = moe.moe_dense(x, router, w1, w2, capacity=cap, top_k=top_k,
                        with_stats=True, dispatch="scatter")
    want = moe.moe_dense(*(t.cpu() for t in (x, router, w1, w2)),
                         capacity=cap, top_k=top_k, with_stats=True,
                         dispatch="scatter")
    assert (got[0].cpu() - want[0]).abs().max().item() <= 1e-4
    assert got[2].item() == want[2].item()
    assert abs(got[1].item() - want[1].item()) <= 1e-5


def test_moe_scatter_step_at_top3_gives_equal_bits_twice(gen):
    # three terms a token: the sum order is fixed by the dispatch (by
    # expert id), not by float atomics, so two runs agree bit for bit
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = tf.TransformerConfig(
        vocab=32768, d_model=1024, n_heads=8, n_layers=2, d_ff=4096,
        dtype="bfloat16", max_seq=2048, attention="flash", n_experts=8,
        n_experts_top_k=3, moe_dispatch="scatter")
    params, _ = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           8, 2048, device=dev)
    leaves = tr.tree_leaves(params)
    runs = []
    for _ in range(2):
        loss = tf.loss_fn(params, tokens, cfg)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ------------------------------------------- tp shard shapes (logical ranks)

def _tp_model(**kw):
    from hpc_patterns_tpu_torch.models import sharding as tsh
    from hpc_patterns_tpu_torch.models import transformer as tf

    cfg = tf.TransformerConfig(vocab=512, d_model=256, n_heads=4,
                               n_layers=2, d_ff=1024, max_seq=256,
                               dtype="bfloat16", **kw)
    params = tf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params, tsh


def test_tp_trunk_kernels_at_shard_shapes_match_plain(gen):
    # tp 2: kernel 1 (with lse) and the split backward (3, 4) on the tp
    # ranks' head blocks folded into the batch, one launch a layer; the
    # fused MLP kernels (8, 9) on each rank's (D, F/2) / (F/2, D) shard;
    # loss and every gradient leaf against the same step's plain versions
    # on the CPU (bf16 on both sides): loss rtol 1e-2, each leaf's cosine
    # >= 0.999
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    cfg, params, tsh = _tp_model(attention="flash", mlp_impl="fused")
    mesh = {"tp": 2}
    tokens = torch.randint(0, cfg.vocab, (4, 256),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tsh.shard_params({k: (v.to(dev) if torch.is_tensor(v) else
                                  tr.tree_map(lambda t: t.to(dev), v))
                              for k, v in params.items()}, mesh, cfg)
        leaves = tr.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        n_fa, n_fm = dict(fa.launches), dict(fm.launches)
        loss = tf.loss_fn(p, tokens.to(dev), cfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (loss.item(), [g.float().cpu() for g in grads])
        if dev == "cuda":
            torch.cuda.synchronize()
            L = cfg.n_layers
            assert {k: fa.launches[k] - n_fa[k] for k in
                    ("fwd_lse", "dq", "dkv")} == {"fwd_lse": L, "dq": L,
                                                  "dkv": L}
            assert {k: fm.launches[k] - n_fm[k] for k in
                    ("fwd", "bwd_dx", "bwd_dw")} == {
                "fwd": 2 * L, "bwd_dx": 2 * L, "bwd_dw": 2 * L}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-2 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        cos = (a.flatten() @ b.flatten()) / (a.norm() * b.norm())
        assert cos.item() >= 0.999


@pytest.mark.parametrize("kv,n_kv,tp", [("compute", 4, 2), ("int8", 4, 2),
                                         ("compute", 2, 4)],
                         ids=["compute", "int8", "tp4-over-kv2"])
def test_tp_decode_kernels_at_shard_shapes_match_plain(gen, kv, n_kv, tp):
    # tp 2 over kv_heads 4: the prefill (kernel 1, T 128) and one linear
    # (kernel 5) and one paged (kernel 6/6q) step on the tp ranks' kv-head
    # blocks, one launch a layer, against the same calls' plain versions
    # on the CPU: logits within 2e-2 x max|plain| (bf16 model). tp 4 over
    # kv_heads 2: the same kernels, one launch a layer, on the unsharded
    # cache (q gathered)
    from hpc_patterns_tpu_torch.models import decode as dec

    cfg, params, tsh = _tp_model(n_kv_heads=n_kv, kv_cache_dtype=kv)
    mesh = {"tp": tp}
    prompt = torch.randint(0, cfg.vocab, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    tok = torch.tensor([3, 5])
    got = {}
    for dev in ("cpu", "cuda"):
        p = tsh.shard_params({k: (v.to(dev) if torch.is_tensor(v) else
                                  {n: t.to(dev) for n, t in v.items()})
                              for k, v in params.items()}, mesh, cfg)
        n_fa, n_fd = dict(fa.launches), dict(fd.launches)
        with torch.no_grad():
            lg, cache = dec.prefill(p, prompt.to(dev), cfg, 136, mesh=mesh)
            step = dec.decode_step(p, cache, 128, tok.to(dev), cfg,
                                   mesh=mesh)
            pc = dec.init_paged_cache(cfg, 2, 3, 64, device=dev, mesh=mesh)
            dec.paged_prefill(p, prompt.to(dev), cfg, pc, 64, mesh=mesh)
            paged = dec.paged_decode_step(p, pc, 128, tok.to(dev), cfg,
                                          mesh=mesh)
        got[dev] = [t.float().cpu() for t in (lg, step, paged)]
        if dev == "cuda":
            torch.cuda.synchronize()
            L = cfg.n_layers
            assert fa.launches["fwd"] - n_fa["fwd"] == 2 * L
            assert fd.launches["flash_decode"] - n_fd["flash_decode"] == L
            assert fd.launches["paged_decode"] - n_fd["paged_decode"] == L
    for a, b in zip(got["cuda"], got["cpu"]):
        assert (a - b).abs().max().item() <= 2e-2 * b.abs().max().item()


# ------------------------------------- pp and the tp engine (logical ranks)

def test_pp_step_on_the_card_matches_the_no_mesh_step(gen):
    # pp 2 x 4 microbatches, fused MLP: the loss and every gradient leaf
    # against the no-mesh loss_fn's on the card (bf16 both: loss rtol
    # 1e-2, each leaf's cosine >= 0.999); kernels 1, 3/4 and 8/9 launched
    # as the schedule runs them: a forward and a recompute forward (with
    # lse) per microbatch and layer, one backward per microbatch and layer
    from hpc_patterns_tpu_torch.models import pp as pplib
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = tf.TransformerConfig(vocab=512, d_model=256, n_heads=4,
                               n_layers=4, d_ff=1024, max_seq=256,
                               dtype="bfloat16", attention="flash",
                               mlp_impl="fused")
    params, _ = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           8, 256, device=dev)
    leaves = tr.tree_leaves(params)
    loss0 = tf.loss_fn(params, tokens, cfg)
    g0 = torch.autograd.grad(loss0, leaves)
    M, L = 4, cfg.n_layers
    n_fa, n_fm = dict(fa.launches), dict(fm.launches)
    stats = {}
    loss1, grads = pplib.pp_loss_and_grads(params, tokens, cfg, {"pp": 2},
                                           microbatches=M, stats=stats)
    torch.cuda.synchronize()
    assert {k: fa.launches[k] - n_fa[k] for k in
            ("fwd", "fwd_lse", "dq", "dkv")} == {
        "fwd": M * L, "fwd_lse": M * L, "dq": M * L, "dkv": M * L}
    assert {k: fm.launches[k] - n_fm[k] for k in
            ("fwd", "bwd_dx", "bwd_dw")} == {
        "fwd": 2 * M * L, "bwd_dx": M * L, "bwd_dw": M * L}
    assert stats["peak_stash"] == [2, 1]
    assert abs(loss1.item() - loss0.item()) <= 1e-2 * abs(loss0.item())
    for a, b in zip(tr.tree_leaves(grads), g0):
        a, b = a.float().flatten(), b.float().flatten()
        assert ((a @ b) / (a.norm() * b.norm())).item() >= 0.999


def test_tp_engine_on_the_card_matches_its_standalone(gen):
    # tp 2 over kv_heads 4 on bf16 pools: every request's tokens against
    # the tp standalone paged_generate, tie-aware at bench_serving's bf16
    # tolerance (batch 2 and batch 1 round the logits differently);
    # kernel 1 once a layer an admission, kernel 6 once a layer a step
    from hpc_patterns_tpu_torch.bench_serving import TIE_TOL
    from hpc_patterns_tpu_torch.models import decode as dec
    from hpc_patterns_tpu_torch.models import serving as srv

    cfg, params, _ = _tp_model(n_kv_heads=4)
    params = {k: (v.cuda() if torch.is_tensor(v) else
                  {n: t.cuda() for n, t in v.items()})
              for k, v in params.items()}
    mesh = {"tp": 2}
    eng = srv.ContinuousBatcher(params, cfg, slots=2, pool_pages=8,
                                pages_per_seq=4, page_size=64, chunk=4,
                                device="cuda", mesh=mesh)
    assert eng.cache["k"][0].shape[:3] == (2, 9, 2)
    prompts = [torch.randint(0, cfg.vocab, (128,),
                             generator=torch.Generator().manual_seed(s))
               .to(torch.int32).numpy() for s in range(3)]
    n_fa, n_fd = dict(fa.launches), dict(fd.launches)
    ids = [eng.submit(p, 32) for p in prompts]
    got = eng.run()
    L = cfg.n_layers
    assert fa.launches["fwd"] - n_fa["fwd"] == L * eng.admissions
    assert fd.launches["paged_decode"] - n_fd["paged_decode"] == \
        L * eng.decode_steps
    for sid, p in zip(ids, prompts):
        with torch.no_grad():
            want, margins = dec.paged_generate(
                params, torch.from_numpy(p)[None].cuda(), cfg, 32,
                page_size=64, with_margins=True, mesh=mesh)
        assert srv.tie_aware_compare(
            got[sid], want[0].cpu().numpy(), margins[0].cpu().numpy(),
            TIE_TOL[cfg.dtype]) != "mismatch"


def test_real_adapter_wire_handoff_on_the_card(gen):
    # the launched plane's replica adapters at the serving widths (vocab
    # 32768, d_model 1024, 8 heads of 128, 8 layers, d_ff 4096, bf16, flash
    # decode): a prefill-role RealAdapter exports every row over the wire
    # (JSON both ways, as the socket carries it) into a decode-role one.
    # Every sequence tie-aware against its standalone; kernel 1 once a
    # layer an admission (256-token prompts), kernel 6 once a layer a
    # decode step of the receiver
    import json

    from hpc_patterns_tpu_torch.bench_serving import TIE_TOL
    from hpc_patterns_tpu_torch.models import decode as dec
    from hpc_patterns_tpu_torch.models import serving as srv
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from hpc_patterns_tpu_torch.serving_plane import service

    cfg = TransformerConfig(vocab=32768, d_model=1024, n_heads=8,
                            n_layers=8, d_ff=4096, max_seq=320,
                            dtype="bfloat16", decode_attn="flash")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda", dtype=torch.bfloat16)
    kw = dict(slots=2, pool_pages=4, pages_per_seq=2, page_size=256,
              chunk=4, prompt_buckets=(128, 256), device="cuda")
    pre = service.RealAdapter(srv.EngineCore(params, cfg, **kw),
                              role="prefill")
    dst = service.RealAdapter(srv.EngineCore(params, cfg, **kw),
                              role="decode")
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (256,), generator=rng)
               .to(torch.int32).tolist() for _ in range(3)]
    n_fa, n_fd = dict(fa.launches), dict(fd.launches)
    for rid, p in enumerate(prompts):
        pre.submit({"rid": rid, "prompt": p, "max_new": 32})
    finished, exports = {}, 0
    for _ in range(64):
        r = pre.round(None)
        for wire in r["exports"]:
            exports += 1
            service.recv_migration(json.loads(json.dumps(wire)), dst, None)
        r = dst.round(None)
        finished.update({int(k): v for k, v in r["finished"].items()})
        if len(finished) == len(prompts):
            break
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert exports == len(prompts) and len(finished) == len(prompts)
    assert fa.launches["fwd"] - n_fa["fwd"] == L * pre.engine.admissions
    assert fd.launches["paged_decode"] - n_fd["paged_decode"] == \
        L * dst.engine.decode_steps > 0
    for rid, p in enumerate(prompts):
        with torch.no_grad():
            want, margins = dec.paged_generate(
                params, torch.tensor(p)[None].cuda(), cfg, 32,
                page_size=256, with_margins=True)
        assert srv.tie_aware_compare(
            finished[rid], want[0].cpu().numpy(), margins[0].cpu().numpy(),
            TIE_TOL[cfg.dtype]) != "mismatch"


def test_smem_rows_equal_the_compiled_kernels(gen):
    """Every library's exported rows (cudaFuncGetAttributes' static bytes
    and the launcher's dynamic request) against analysis/smem.py's rows
    from the same sources; the requests set per call (kernels 8, 8a and
    14) at their launchers' plans; every block within the opt-in limit."""
    from hpc_patterns_tpu_torch.analysis import runtime, smem

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert optin == smem.SMEM_LIMIT
    plans = runtime.launch_plans([(2048, 1024, 4096), (512, 512, 2048)],
                                 [64, 2048])
    assert {k.split("<")[0] for k in plans} == {"mlp_kernel",
                                                "pipeline_kernel"}
    rows, bad, got_optin = runtime.smem_card_rows(plans)
    assert not bad and got_optin == optin
    held = {smem.canonical(r["kernel"]) for r in rows
            if r.get("plan") not in (None, "every call")
            and r.get("total") is not None}
    assert held == set(plans)
    assert all(r["total"] <= optin for r in rows if "total" in r)


def test_ledger_build_balances_kernels_11_and_14(gen):
    """The -DHPCPAT_LEDGER build of fused_ring.cu and overlap_pipeline.cu:
    one launch each, its result equal to the plain version's, its barrier
    and flag ledger balanced; the timed libraries untouched."""
    from hpc_patterns_tpu_torch.analysis import runtime
    from hpc_patterns_tpu_torch.ops import _build

    timed = _build.load("fused_ring")
    with runtime.strict_barriers() as sb:
        assert _build.load("fused_ring") is sb.libs["fused_ring"]
        x = torch.randn(4, 1 << 18, generator=gen, device="cuda")
        sb.reset("fused_ring")
        got = fused.fused_allreduce(x)
        fused.synchronize()
        led = sb.check("fused_ring", flags=True)
        assert torch.equal(got, fused.fused_allreduce_reference(
            x, lane=fused.CARD_LANE))
        assert led["flags"]["release"] > 0
        xp = torch.rand(4, 64, 128, generator=gen, device="cuda")
        sb.reset("overlap_pipeline")
        got = pipeline.overlap_run(xp, mode="overlap", tripcount=3, passes=2)
        torch.cuda.synchronize()
        led = sb.check("overlap_pipeline")
        want, _ = pipeline.overlap_run_reference(xp, mode="overlap",
                                                 tripcount=3, passes=2)
        assert torch.equal(got, want)
        assert led["bars"] and sb.checked == 2
    assert _build.load("fused_ring") is timed
