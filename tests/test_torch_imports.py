"""Import hygiene and device resolution of the PyTorch port.

The port runs on machines with no JAX: no module of
``hpc_patterns_tpu_torch`` (and not ``chip_smoke.py``) may import
``jax``, ``jaxlib`` or anything of ``hpc_patterns_tpu`` — checked on the
source with ``ast``, so nothing is imported to check it. Its entry points
run on ``cuda`` unless told ``device="cpu"``, and without a GPU they
raise instead of running on the host.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hpc_patterns_tpu_torch import topology
from hpc_patterns_tpu_torch.models import decode, serving, transformer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "hpc_patterns_tpu")
SOURCES = sorted((ROOT / "hpc_patterns_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_package_import(path):
    bad = [(ln, mod) for ln, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom hpc_patterns_tpu.models import x\n"
                 "def g():\n    import jax.numpy\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == [
        "hpc_patterns_tpu", "jax"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topology.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topology.resolve_device("cuda:0")


def test_resolve_device_cpu_and_bad_types():
    assert topology.resolve_device("cpu") == torch.device("cpu")
    assert topology.resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported"):
        topology.resolve_device("meta")


def test_entry_points_raise_without_gpu_and_run_on_cpu(no_gpu):
    cfg = transformer.TransformerConfig(vocab=32, d_model=16, n_heads=2,
                                        n_layers=1, d_ff=32, max_seq=32,
                                        dtype="float32")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg, generator=gen)
    params = transformer.init_params(cfg, generator=gen, device="cpu")
    prompt = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.paged_generate(params, prompt, cfg, 2, page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.ContinuousBatcher(params, cfg, slots=1, pool_pages=2,
                                  pages_per_seq=2, page_size=8)
    out = decode.paged_generate(params, prompt, cfg, 2, page_size=8,
                                device="cpu")
    assert out.shape == (1, 2)
    # the linear cache and the quantized path: the same rule
    qcfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.generate(params, prompt, qcfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.init_cache(qcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.init_paged_cache(qcfg, 1, 2, 8)
    out = decode.generate(params, prompt, qcfg, 2, device="cpu")
    assert out.shape == (1, 2)


def test_comm_and_interop_entry_points_raise_without_gpu(no_gpu, capsys):
    from hpc_patterns_tpu_torch.apps import (
        allreduce_app,
        common,
        interop_app,
        pingpong_app,
    )
    from hpc_patterns_tpu_torch.comm.communicator import Communicator
    from hpc_patterns_tpu_torch.interop import device

    for call in (lambda: Communicator({"x": 4}, "x"),
                 lambda: common.make_communicator(None),
                 lambda: allreduce_app.main(["-p", "4"]),
                 lambda: pingpong_app.main(["-p", "4"]),
                 lambda: interop_app.main(["-n", "64"]),
                 device.kernel_alias_proof,
                 device.donation_alias_proof):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    c = Communicator({"x": 4}, "x", device="cpu")
    assert c.device.type == "cpu"
    assert allreduce_app.main(["-p", "4", "--device", "cpu",
                               "--repetitions", "1"]) == 0
    capsys.readouterr()


def test_training_entry_points_raise_without_gpu(no_gpu, capsys):
    from hpc_patterns_tpu_torch.apps import eval_app, train_app
    from hpc_patterns_tpu_torch.models import train
    from hpc_patterns_tpu_torch.utils import data

    cfg = transformer.TransformerConfig(vocab=32, d_model=16, n_heads=2,
                                        n_layers=1, d_ff=32, max_seq=64,
                                        dtype="float32")
    small = ["--steps", "1", "--batch", "1", "--seq", "64", "--d-model",
             "16", "--n-layers", "1", "--n-heads", "2", "--vocab", "32"]
    for call in (lambda: train.init_train_state(torch.Generator(), cfg),
                 lambda: train.make_batch(torch.Generator(), cfg, 1, 8),
                 data.device_placer,
                 lambda: train_app.main(small),
                 lambda: eval_app.main(small[2:] + ["--batches", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert train_app.main(small + ["--device", "cpu"]) == 0
    capsys.readouterr()


def test_flash_bench_needs_a_card(no_gpu, capsys):
    from hpc_patterns_tpu_torch import bench_flash

    assert bench_flash.main([]) == 1
    assert bench_flash.main(["--other", ".", "--train"]) == 1
    assert "needs an NVIDIA card" in capsys.readouterr().err


def test_mlp_bench_imports_without_jax_and_needs_a_card(no_gpu, capsys):
    # a fresh interpreter in which importing jax (or the reference
    # package) fails: the bench module must not need either
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                  'hpc_patterns_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import hpc_patterns_tpu_torch.bench_mlp as b\n"
            "assert callable(b.main) and callable(b.plan)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    from hpc_patterns_tpu_torch import bench_mlp

    assert bench_mlp.main([]) == 1
    assert bench_mlp.main(["--other", ".", "--train"]) == 1
    assert "needs an NVIDIA card" in capsys.readouterr().err


def test_comm_bench_imports_without_jax_and_needs_a_card(no_gpu, capsys):
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                  'hpc_patterns_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import hpc_patterns_tpu_torch.bench_comm as b\n"
            "assert callable(b.main) and callable(b.agmm_row)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    from hpc_patterns_tpu_torch import bench_comm

    assert bench_comm.main([]) == 1
    assert bench_comm.main(["--other", "."]) == 1
    assert "needs an NVIDIA card" in capsys.readouterr().err
