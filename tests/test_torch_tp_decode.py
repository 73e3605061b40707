"""tp-sharded decode (``models/decode.py`` with ``mesh=``) against JAX's
UNSHARDED decode on the CPU, token for token (JAX
``tests/test_decode.py:130-220``'s cases on the port).

The port's tp route: params as their tp shards, column/row-parallel
projections summed over the tp ranks, the cache and the page pools
kv-head-sharded in contiguous head blocks, stacked (tp, ...), every rank
in one call of the decode function over the folded ranks (on the CPU the
kernels' plain versions). JAX's side runs its ``gather`` route (the
plain einsums; its own tests hold its flash route and its tp mesh equal
to it). Inputs come from seeds through numpy. Tolerances: tokens exact;
the ragged step's logits atol 1e-5 (f32 on both sides, the tp partial
products summed in another order). Where tp does not divide kv_heads the
cache stays whole and the flash route keeps its kernel wrappers on it.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import sharding as tsh  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import params_from_jax  # noqa: E402

SMALL = dict(vocab=256, d_model=64, n_heads=8, n_layers=2, d_ff=256,
             max_seq=144, dtype="float32")
MESH = {"dp": 2, "sp": 2, "tp": 2}
NEW = 8
LOGITS_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (small models; see
    test_torch_sharding's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(T=32, **kw):
    jcfg = jtf.TransformerConfig(**{**SMALL, "n_kv_heads": 4,
                                    "decode_attn": "gather", **kw})
    tcfg = ttf.TransformerConfig(**{**SMALL, "n_kv_heads": 4, **kw})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(1).integers(0, SMALL["vocab"], (2, T),
                                               np.int32)
    return jcfg, tcfg, jp, tp, prompt


@pytest.mark.parametrize("kw,T", [
    ({}, 32), ({"kv_cache_dtype": "int8"}, 32), ({}, 128),
    ({"decode_attn": "gather"}, 32)],
    ids=["flash", "flash-int8", "flash-prefill-128", "gather"])
def test_tp_greedy_token_exact(kw, T):
    jcfg, tcfg, jp, tp, prompt = _setup(T, **kw)
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                           NEW))
    sharded = tsh.shard_params(tp, MESH, tcfg)
    with torch.no_grad():
        got = tdec.greedy_generate(sharded, torch.from_numpy(prompt), tcfg,
                                   NEW, device="cpu", mesh=MESH)
        # the captured cache: kv-head blocks stacked over tp
        _, cache = tdec.prefill(sharded, torch.from_numpy(prompt), tcfg,
                                T + NEW, mesh=MESH)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cache["k"][0].shape == (2, 2, 2, T + NEW, tcfg.head_dim)
    if tcfg.kv_cache_dtype == "int8":
        assert cache["k_scale"][0].shape == (2, 2, 2, T + NEW)


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8"}],
                         ids=["paged", "paged-int8"])
def test_tp_paged_generate_token_exact(kw):
    jcfg, tcfg, jp, tp, prompt = _setup(**kw)
    want = np.asarray(jdec.paged_generate(jp, jnp.asarray(prompt), jcfg,
                                          NEW, page_size=8))
    with torch.no_grad():
        got = tdec.paged_generate(tp, torch.from_numpy(prompt), tcfg, NEW,
                                  page_size=8, device="cpu", mesh=MESH)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tp_paged_ragged_step_matches_unsharded():
    jcfg, tcfg, jp, tp, prompt = _setup(T=8)
    jcache = jdec.init_paged_cache(jcfg, 2, pages_per_seq=3, page_size=8)
    _, jcache = jdec.paged_prefill(jp, jnp.asarray(prompt), jcfg, jcache, 8)
    pos = np.array([8, 9], np.int32)
    tok = np.array([1, 2], np.int32)
    # JAX's row 1 first takes position 8, then the ragged step
    want, _ = jdec.paged_decode_step(jp, jcache, jnp.asarray(pos),
                                     jnp.asarray(tok), jcfg)
    cache = tdec.init_paged_cache(tcfg, 2, 3, 8, device="cpu", mesh=MESH)
    assert cache["k"][0].shape == (2, 6, 2, 8, tcfg.head_dim)
    with torch.no_grad():
        tdec.paged_prefill(tp, torch.from_numpy(prompt), tcfg, cache, 8,
                           mesh=MESH)
        got = tdec.paged_decode_step(tp, cache, torch.from_numpy(pos),
                                     torch.from_numpy(tok), tcfg, mesh=MESH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


def _counting(monkeypatch, name):
    """Wrap decode's kernel wrapper ``name`` to count its calls (on the
    CPU it runs its plain version; the route is what is checked)."""
    fn, calls = getattr(tdec, name), []

    def wrapped(*a, **kw):
        calls.append(a[1].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(tdec, name, wrapped)
    return calls


def test_tp_not_dividing_kv_heads_warns_and_gathers(monkeypatch):
    # tp 4 over kv_heads 2: JAX's warning (only the head sharding is
    # lost), the cache unsharded, q gathered and the flash route's kernel
    # wrapper on it as without a mesh, the projections still tp-sharded
    jcfg, tcfg, jp, tp, prompt = _setup(n_kv_heads=2)
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                           NEW))
    calls = _counting(monkeypatch, "flash_decode_attention")
    with warnings.catch_warnings(record=True) as seen, torch.no_grad():
        warnings.simplefilter("always")
        got = tdec.greedy_generate(tp, torch.from_numpy(prompt), tcfg, NEW,
                                   device="cpu", mesh={"tp": 4})
    assert any("does not divide kv_heads" in str(w.message) for w in seen)
    np.testing.assert_array_equal(got.numpy(), want)
    # one call a layer a step, each on the whole (B, kv_heads, ...) cache
    assert len(calls) == tcfg.n_layers * (NEW - 1)
    assert {c[:2] for c in calls} == {(2, 2)}


def test_tp_not_dividing_kv_heads_paged_keeps_kernel_route(monkeypatch):
    # the paged route of the same mesh: the whole pools, kernel 6's
    # wrapper, token for token against JAX's unsharded paged decode
    jcfg, tcfg, jp, tp, prompt = _setup(n_kv_heads=2)
    want = np.asarray(jdec.paged_generate(jp, jnp.asarray(prompt), jcfg,
                                          NEW, page_size=8))
    calls = _counting(monkeypatch, "flash_decode_paged")
    with warnings.catch_warnings(record=True) as seen, torch.no_grad():
        warnings.simplefilter("always")
        got = tdec.paged_generate(tp, torch.from_numpy(prompt), tcfg, NEW,
                                  page_size=8, device="cpu",
                                  mesh={"tp": 4})
    assert any("does not divide kv_heads" in str(w.message) for w in seen)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == tcfg.n_layers * (NEW - 1)
    assert {c[1] for c in calls} == {2}
