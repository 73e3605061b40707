"""The port's transformer (``hpc_patterns_tpu_torch.models.transformer``)
against the JAX model: the same config fields and validation, the same
parameter shapes and scales, and — from the same numbers
(``params_from_jax``) — the same logits.

Tolerance: logits atol = rtol = 1e-4 in f32 (matmul summation order
differs between XLA:CPU and torch across two layers).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)

ATOL = RTOL = 1e-4
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=256,
             max_seq=128, dtype="float32")


def _pair(**kw):
    fields = {**SMALL, **kw}
    return jtf.TransformerConfig(**fields), ttf.TransformerConfig(**fields)


def _params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("kw", [
    {}, {"pos_embed": "rope"}, {"n_kv_heads": 2},
    {"n_kv_heads": 1, "pos_embed": "rope"}, {"attention": "flash"},
], ids=["learned", "rope", "gqa", "mqa-rope", "flash"])
def test_forward_logits_match_jax(kw):
    jcfg, tcfg = _pair(**kw)
    jp, tp = _params(jcfg)
    T = 128 if kw.get("attention") == "flash" else 24
    tokens = np.random.default_rng(1).integers(0, 256, (2, T), np.int32)
    want = np.asarray(jtf.forward(jp, jnp.asarray(tokens),
                                  dataclasses.replace(jcfg,
                                                      attention="full")))
    got = ttf.forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, T, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kw", [{}, {"pos_embed": "rope",
                                     "n_kv_heads": 2}])
def test_init_params_shapes_and_scales_match_jax(kw):
    jcfg, tcfg = _pair(**kw, d_model=128, d_ff=512, vocab=512)
    jp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    tp = ttf.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert set(map(str, jflat)) == set(map(str, tflat))
    tby = {str(k): v for k, v in tflat.items()}
    for k, jv in jflat.items():
        tv = tby[str(k)]
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, k
        # same distribution: the standard deviations agree within 5%
        if jv.std() > 0:
            assert abs(tv.std() / jv.std() - 1) < 0.05, k
        else:
            np.testing.assert_array_equal(tv, jv)


def test_init_params_storage_dtype_and_device():
    _, tcfg = _pair()
    tp = ttf.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.bfloat16)
    assert tp["layers"]["wqkv"].dtype == torch.bfloat16
    assert tp["embed"].device.type == "cpu"


@pytest.mark.parametrize("bad", [
    {"pos_embed": "alibi"}, {"attention": "sparse"}, {"n_kv_heads": 3},
    {"kv_cache_dtype": "int4"}, {"decode_attn": "ring"},
    {"mlp_impl": "moe"}, {"remat_policy": "all"}, {"loss_chunk": 7},
])
def test_config_validation_matches_jax(bad):
    fields = {**SMALL, **bad}
    with pytest.raises(ValueError):
        jtf.TransformerConfig(**fields)
    with pytest.raises(ValueError):
        ttf.TransformerConfig(**fields)


def test_rmsnorm_rope_and_qkv_split_match_jax():
    jcfg, tcfg = _pair(n_kv_heads=2, pos_embed="rope")
    jp, tp = _params(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 8, 64),
                                                 dtype=np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = ttf.layer_params(tp, 0)
    jh = jtf._rmsnorm(jnp.asarray(x), jl["ln1_scale"])
    th = ttf._rmsnorm(torch.from_numpy(x), tl["ln1_scale"])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    pos = np.arange(8, dtype=np.int32)
    for jt, tt in zip(jtf.project_qkv(jh, jl, jcfg),
                      ttf.project_qkv(th, tl, tcfg)):
        assert tuple(tt.shape) == jt.shape
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
        jr = jtf.apply_rope(jt, jnp.asarray(pos), jcfg)
        tr = ttf.apply_rope(tt, torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)


def test_quantized_weight_tree_raises():
    # int8 weights are ported: a quantized tree dequantizes at use
    # (values times per-output-channel scales); what still raises is
    # quantizing an MoE tree, as in JAX
    tree = {"w": torch.tensor([[1, -2], [3, 4]], dtype=torch.int8),
            "w_qscale": torch.tensor([0.5, 2.0])}
    got = ttf.matmul_weight(tree, "w", torch.float32)
    assert torch.equal(got, torch.tensor([[0.5, -4.0], [1.5, 8.0]]))
    with pytest.raises(ValueError, match="MoE"):
        ttf.quantize_weights_int8({"layers": {"router": torch.zeros(1)}})
