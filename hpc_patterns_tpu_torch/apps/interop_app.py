"""Interop proof app — the counterpart of
``hpc_patterns_tpu/apps/interop_app.py`` (the reference's
``interop_omp_ze_sycl``, which proves zero-copy both ways between two
runtimes sharing one device context, interop_omp_ze_sycl.cpp:70-104).

The port's runtimes are its own (it has no JAX): the native C++
allocator, numpy, PyTorch, DLPack and a separately compiled CUDA library.
Legs:

1. native → numpy → torch, zero-copy (pointer identity) + values
   (≙ OMP fill, SYCL read);
2. torch (on the app's device) → DLPack → torch, zero-copy, the result
   checked by the C oracle (``hp_validate``) after one staged copy home;
3. native host buffer → device → host, values validated (a copy by
   physics when the device is the card);
4. in place on the device: PyTorch's in-place ops, and the CUDA library's
   kernel writing ``x * 2 + 1`` into a PyTorch-allocated buffer
   (``interop/device.py``; the plain version on the CPU).

The C++ native driver of the JAX app (``--native-driver``) embeds JAX and
is not ported (ROADMAP.md). Prints "Passed <i>" lines and SUCCESS/FAILURE.

    python -m hpc_patterns_tpu_torch.apps.interop_app
    python -m hpc_patterns_tpu_torch.apps.interop_app --device cpu -n 4096
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hpc_patterns_tpu_torch.apps import common
from hpc_patterns_tpu_torch.harness import metrics as metricslib
from hpc_patterns_tpu_torch.harness.cli import base_parser
from hpc_patterns_tpu_torch.harness.runlog import RunLog
from hpc_patterns_tpu_torch.harness.verdict import Verdict
from hpc_patterns_tpu_torch.interop import device as device_proofs
from hpc_patterns_tpu_torch.interop import native, zero_copy
from hpc_patterns_tpu_torch.topology import resolve_device


def build_parser():
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("-n", "--elements", type=int, default=1 << 16)
    p.add_argument("--alignment", type=int, default=128,
                   help="native allocation alignment (reference ALIGNMENT=128)")
    return p


def run(args) -> int:
    log = RunLog(args.log, truncate=not args.log_append)
    dev = resolve_device(args.device)
    if not native.available() and not native.build():
        log.print("SKIP: native library unavailable (make -C native failed)")
        log.print("FAILURE")
        return 1
    n = args.elements
    checks: list[tuple[str, bool]] = []

    # 1. native C++ -> numpy -> torch, zero-copy
    buf = native.AlignedBuffer(n, alignment=args.alignment)
    buf.iota(0.0, 1.0)
    t, zc = zero_copy.native_to_torch(buf)
    checks.append(("native->torch zero-copy", zc))
    checks.append(("native->torch values", bool(
        torch.equal(t, torch.arange(n, dtype=torch.float32)))))

    # 2. torch -> DLPack -> torch on the device, then the C oracle
    doubled = torch.ones(n, dtype=torch.float32, device=dev) * 2.0
    back, zc_dl = zero_copy.torch_dlpack_roundtrip(doubled)
    out = native.AlignedBuffer(n, alignment=args.alignment)
    out.as_numpy()[:] = back.cpu().numpy()
    checks.append((f"torch({dev.type})->dlpack->torch zero-copy", zc_dl))
    checks.append(("C-oracle validation", out.validate(2.0) == -1))

    # 3. native memory -> device and back
    staged = torch.from_numpy(buf.as_numpy()).to(dev)
    tripled = (staged * 3.0).cpu().numpy()
    expect_last = np.float32(3.0) * np.float32(n - 1)
    checks.append((f"native->{dev.type} roundtrip",
                   bool(np.isclose(tripled[-1], expect_last, rtol=1e-6))))

    # 4. in place on the device
    ok_don, _ = device_proofs.donation_alias_proof(n, device=dev)
    checks.append(("in-place ops (data_ptr)", ok_don))
    ok_k, ev = device_proofs.kernel_alias_proof(device=dev)
    checks.append((f"alias kernel in place (data_ptr"
                   f"{', plain version' if ev['interpret'] else ''})", ok_k))

    all_ok = all(ok for _, ok in checks)
    m = metricslib.get_metrics()
    m.gauge("interop.checks_total").set(len(checks))
    m.gauge("interop.checks_ok").set(sum(ok for _, ok in checks))
    for i, (name, ok) in enumerate(checks):
        log.print(f"{'Passed' if ok else 'FAILED'} {i} ({name})")
    log.emit(kind="result", name="interop", success=all_ok,
             checks={name: ok for name, ok in checks}, elements=n,
             device=dev.type)
    verdict = Verdict(success=all_ok,
                      messages=("SUCCESS" if all_ok else "FAILURE",))
    log.print(verdict.summary_line())
    return verdict.exit_code


def main(argv=None) -> int:
    return common.run_instrumented(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
