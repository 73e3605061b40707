"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card with the CUDA toolkit (the kernels build on
first use), so they carry the ``cuda`` marker and skip elsewhere. This
file imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances (max abs error): prefill 2e-2 (bf16 in and out, p rounded to
bf16 before p.v as the TPU kernel does); decode 1e-4 (f32 math on both
sides, only the summation order differs). Matmuls of the plain versions
run in full f32 (``allow_tf32`` off).
"""

import pytest
import torch

from hpc_patterns_tpu_torch.ops import flash_attention as fa
from hpc_patterns_tpu_torch.ops import flash_decode as fd

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
    n = fa.launches
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    want = fa.flash_attention_reference(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


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
