"""The port's interop suite on the CPU: the native library's bindings
(a copy of the JAX package's), the zero-copy bridges between native
memory, numpy, PyTorch and DLPack, the in-place proofs (the alias
kernel's plain version here; the kernel itself runs in
``test_torch_cuda_kernels.py``), and the interop app.
"""

import numpy as np
import pytest
import torch

from hpc_patterns_tpu.interop import native as jnative
from hpc_patterns_tpu_torch.apps import interop_app
from hpc_patterns_tpu_torch.interop import device, native, zero_copy


@pytest.fixture
def lib():
    if not (native.available() or native.build()):
        pytest.skip("native library unavailable (make -C native failed)")
    return native


def test_bindings_match_the_reference(lib):
    xs = [3.0, 1.0, 2.0, 5.0]
    assert lib.stats(xs) == jnative.stats(xs)
    assert lib.stats_roundtrip(xs) == xs
    for size in (2, 5, 8):
        for shift in (1, -1, 3):
            assert lib.ring_plan(size, shift) == jnative.ring_plan(size, shift)
    assert lib.ring_phase_senders(8, 0) == jnative.ring_phase_senders(8, 0)


@pytest.mark.parametrize("alignment", [128, 4096])
def test_native_to_torch_is_zero_copy(lib, alignment):
    buf = lib.AlignedBuffer(256, alignment=alignment)
    buf.iota(1.0, 1.0)
    t, zc = zero_copy.native_to_torch(buf)
    assert zc and t.data_ptr() == buf.address
    assert buf.address % alignment == 0
    assert torch.equal(t, torch.arange(1, 257, dtype=torch.float32))
    t[3] = -1.0  # the write lands in the native allocation
    assert buf.validate(1.0, tol=1e9) == -1 and buf.as_numpy()[3] == -1.0


def test_numpy_torch_bridges_and_dlpack(lib):
    x = np.arange(64, dtype=np.float32)
    t, zc = zero_copy.numpy_to_torch(x)
    back, zc2 = zero_copy.torch_to_numpy(t)
    assert zc and zc2 and back.ctypes.data == x.ctypes.data
    d, zc3 = zero_copy.torch_dlpack_roundtrip(t)
    assert zc3 and d.data_ptr() == t.data_ptr() and torch.equal(d, t)


def test_in_place_proofs_on_cpu():
    ok, ev = device.kernel_alias_proof(device="cpu")
    assert ok and ev["pointer_ok"] and ev["values_ok"] and ev["interpret"]
    ok, ev = device.donation_alias_proof(4096, device="cpu")
    assert ok and ev["pointer_ok"] and ev["values_ok"]
    x = torch.arange(6, dtype=torch.float32)
    ptr = x.data_ptr()
    out = device.alias_inplace(x)
    assert out.data_ptr() == ptr
    assert torch.equal(out, torch.arange(6, dtype=torch.float32) * 2 + 1)
    with pytest.raises(ValueError, match="float32"):
        device.alias_inplace(torch.ones(3, dtype=torch.int32))


def test_interop_app_passes_on_cpu(lib, capsys):
    code = interop_app.main(["--device", "cpu", "-n", "4096"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert "SUCCESS" in out and out.count("Passed") == 7
    assert "FAILED" not in out
