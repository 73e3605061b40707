"""The port's precision law and int8 weights (``hpc_patterns_tpu_torch.
models.quantization``) against the JAX package's, and the carrying of
quantized state across (``models.convert``).

- ``precision_law`` of the port and of JAX on the same carried-across
  params and prompts (the JAX battery's config and prompts, f32 on the
  CPU): greedy agreement equal, TV distances within 1e-4 (logits agree
  to ~1e-5 in f32, and a TV is a sum of |dp| over the vocabulary);
- the law's bounds held in-port for int8 KV, fp8 KV, int8 weights and the
  composed form, and a broken dequant (scales doubled) failing them;
- ``quantize_weights_int8``: the structure and bytes of JAX's, and the
  accessor the identity on plain trees;
- ``params_from_jax``: a JAX int8-weight tree and an fp8 paged cache
  carried across byte for byte, scales kept f32 under ``dtype``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import quantization as jq  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.models import quantization as tq  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32", decode_attn="gather")
PROMPTS = np.arange(3 * 12, dtype=np.int32).reshape(3, 12) % 60
TV_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**BASE)
    tcfg = ttf.TransformerConfig(**{**BASE, "decode_attn": "flash"})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _bytes(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("kv,weights", [("int8", False), ("fp8", False),
                                        ("compute", True), ("int8", True)],
                         ids=["int8-kv", "fp8-kv", "int8-weights",
                              "composed"])
def test_law_matches_jax_and_holds_its_bounds(model, kv, weights):
    jcfg, tcfg, jp, tp = model
    jqcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    tqcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    jqp = jq.quantize_weights_int8(jp) if weights else jp
    tqp = ttf.quantize_weights_int8(tp) if weights else tp
    want = jq.precision_law(jp, jcfg, jqp, jqcfg, PROMPTS, steps=4)
    got = tq.precision_law(tp, tcfg, tqp, tqcfg, PROMPTS, steps=4)
    assert got.steps == want.steps == 4
    assert got.greedy_agreement == want.greedy_agreement
    assert got.tv_mean == pytest.approx(want.tv_mean, abs=TV_ATOL)
    assert got.tv_max == pytest.approx(want.tv_max, abs=TV_ATOL)
    got.check()


def test_oracle_has_teeth(model):
    _, tcfg, _, tp = model
    broken = ttf.quantize_weights_int8(tp)
    layers = dict(broken["layers"])
    layers["wqkv_qscale"] = layers["wqkv_qscale"] * 2.0
    broken["layers"] = layers
    law = tq.precision_law(tp, tcfg, broken, tcfg, PROMPTS, steps=4)
    with pytest.raises(AssertionError, match="precision law"):
        law.check()


def test_guards_and_bounds_equal_jax(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="max_seq"):
        tq.precision_law(tp, tcfg, tp, tcfg, np.zeros((1, 60), np.int32),
                         steps=8)
    assert tq.DEFAULT_BOUNDS == jq.DEFAULT_BOUNDS
    assert ttf.QUANTIZED_LAYER_WEIGHTS == jtf.QUANTIZED_LAYER_WEIGHTS
    assert ttf.QUANT_SCALE_SUFFIX == jtf.QUANT_SCALE_SUFFIX


def test_quantize_weights_int8_structure_and_bytes_equal_jax(model):
    _, _, jp, tp = model
    want = params_from_jax(jax.tree.map(np.asarray,
                                        jq.quantize_weights_int8(jp)),
                           device="cpu")
    got = ttf.quantize_weights_int8(tp)
    assert sorted(got) == sorted(want)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name in ttf.QUANTIZED_LAYER_WEIGHTS:
        w, s = got["layers"][name], got["layers"][name + "_qscale"]
        assert w.dtype == torch.int8 and s.dtype == torch.float32
        assert s.shape == w.shape[:-2] + w.shape[-1:]
        assert torch.equal(w, want["layers"][name])
        assert torch.equal(s, want["layers"][name + "_qscale"])
        # dequant error within half a step per output channel
        deq = ttf.matmul_weight(got["layers"], name, torch.float32)
        assert bool(((deq - tp["layers"][name]).abs()
                     <= s[..., None, :] * 0.5 + 1e-7).all())
    assert torch.equal(got["lm_head"], want["lm_head"])
    assert got["embed"] is tp["embed"]  # embeddings and norms untouched
    assert "ln1_scale_qscale" not in got["layers"]


def test_accessor_is_identity_on_plain_trees(model):
    _, _, _, tp = model
    for dt in (torch.float32, torch.bfloat16):
        got = ttf.matmul_weight(tp["layers"], "w1", dt)
        assert torch.equal(got, tp["layers"]["w1"].to(dt))


def test_convert_carries_quantized_trees_and_caches():
    cfg = jtf.TransformerConfig(**{**BASE, "kv_cache_dtype": "fp8"})
    jp = jq.quantize_weights_int8(jtf.init_params(jax.random.PRNGKey(1),
                                                  cfg))
    npt = jax.tree.map(np.asarray, jp)
    got = params_from_jax(npt, device="cpu", dtype=torch.bfloat16)
    assert got["layers"]["wqkv"].dtype == torch.int8
    assert got["layers"]["wqkv_qscale"].dtype == torch.float32
    assert got["lm_head_qscale"].dtype == torch.float32
    assert got["embed"].dtype == torch.bfloat16
    assert np.array_equal(got["layers"]["w1"].numpy(),
                          npt["layers"]["w1"])
    assert np.array_equal(got["layers"]["w1_qscale"].numpy(),
                          npt["layers"]["w1_qscale"])
    cache = jdec.init_paged_cache(cfg, 2, 2, 8)
    _, cache = jdec.paged_prefill(jp, jnp.asarray(PROMPTS[:2, :10]), cfg,
                                  cache, 8)
    npc = jax.tree.map(np.asarray, cache)
    tc = params_from_jax(npc, device="cpu", dtype=torch.bfloat16)
    assert isinstance(tc["k"], tuple) and len(tc["k"]) == cfg.n_layers
    for l in range(cfg.n_layers):
        assert tc["k"][l].dtype == torch.float8_e4m3fn
        assert np.array_equal(_bytes(tc["k"][l]).numpy(),
                              npc["k"][l].view(np.uint8))
        assert tc["v_scale"][l].dtype == torch.float32
        assert np.array_equal(tc["v_scale"][l].numpy(), npc["v_scale"][l])
    assert tc["table"].dtype == torch.int32
    bf = params_from_jax({"x": np.asarray(jnp.arange(5, dtype=jnp.bfloat16))},
                         device="cpu")["x"]
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [0, 1, 2, 3, 4]


def test_kv_dtype_resolver_equals_jax_and_degrades_fp8(monkeypatch):
    from hpc_patterns_tpu.harness import cli as jcli
    from hpc_patterns_tpu_torch import dtypes
    from hpc_patterns_tpu_torch.harness import cli as tcli

    assert tcli.KV_DTYPE_CHOICES == jcli.KV_DTYPE_CHOICES
    for spec in ("f32", "bf16", "int8", " INT8 "):
        assert tcli.resolve_kv_cache_dtype(spec) == \
            jcli.resolve_kv_cache_dtype(spec)
    assert dtypes.supports_fp8("cpu") is True  # torch's CPU runs fp8
    assert tcli.resolve_kv_cache_dtype("fp8", device="cpu") == (None, "fp8")
    notes = []
    monkeypatch.setattr(dtypes, "supports_fp8", lambda device=None: False)
    assert tcli.resolve_kv_cache_dtype("fp8", note=notes.append) == (
        None, "int8")
    assert len(notes) == 1 and "degrading" in notes[0]
    with pytest.raises(Exception, match="kv-dtype"):
        tcli.resolve_kv_cache_dtype("fp16")
