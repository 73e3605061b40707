"""The tp-sharded serving engine and speculative rounds
(``ContinuousBatcher(mesh=)``, ``speculative_generate[_batched](mesh=)``)
on logical ranks of one device, on the CPU.

Against JAX's UNSHARDED oracles, token for token (f32, greedy: no
tolerance): the tp engine against JAX's standalone ``paged_generate``
(the oracle of ``test_serving.py``), with and without a draft (JAX's
``test_draft_assisted_tp_matches_standalone``), on f32 and int8
pools; ``speculative_generate`` and the ragged batched form under tp
against JAX's ``greedy_generate`` (JAX ``test_decode.py:594``, ``:936``).
JAX's side runs its plain ``gather`` route.

Inside the port, byte for byte: the prefix cache, preemption and resume
and the residency manager's paging under tp each equal the tp standalone
``paged_generate(..., mesh=)``; a bundle crosses from a tp engine to an
unsharded one and back (the bundle keeps JAX's global layout); the
sampled tp engine equals the sampled unsharded engine (the sampler reads
the gathered logits). Weights come from JAX's init through
``models/convert.py``; prompts from seeds through numpy.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdec  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.memory import (  # noqa: E402
    ColdAfterNPolicy,
    ResidencyManager,
)
from hpc_patterns_tpu_torch.models import decode as tdec  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import speculative as tspec  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import params_from_jax  # noqa: E402

# JAX test_serving.py's BASE
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
DRAFT = dict(BASE, d_model=16, d_ff=32, n_layers=1, n_heads=2)
P = 8
MESH = {"tp": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (small models; see
    test_torch_sharding's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(base=BASE, seed=0, **over):
    """(JAX cfg on the gather route, the port's cfg, JAX params, the
    port's params)."""
    jcfg = jtf.TransformerConfig(**{**base, **over, "decode_attn": "gather"})
    tcfg = ttf.TransformerConfig(**{**base, **over})
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


def _requests(n, seed=1, vocab=64):
    """JAX test_serving's request mix: prompts of 5, 8 or 11, budgets of
    3, 6 or 9."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=int(rng.choice([5, 8, 11])))
             .astype(np.int32), int(rng.choice([3, 6, 9])))
            for _ in range(n)]


def _engine(tp, tcfg, mesh=MESH, **over):
    kw = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=P, chunk=2,
              device="cpu", mesh=mesh)
    kw.update(over)
    return tsrv.ContinuousBatcher(tp, tcfg, **kw)


def _standalone(tp, tcfg, prompt, max_new, mesh=MESH, **kw):
    return tdec.paged_generate(tp, torch.from_numpy(prompt)[None], tcfg,
                               max_new, page_size=P, device="cpu",
                               mesh=mesh, **kw)[0].numpy()


def _jax_standalone(jp, jcfg, prompt, max_new):
    return np.asarray(jdec.paged_generate(
        jp, jnp.asarray(prompt)[None], jcfg, max_new, page_size=P))[0]


# ---------------------------------------------------- against JAX's oracle


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_tp_engine_token_exact_vs_jax_unsharded(kv):
    jcfg, tcfg, jp, tp = _model(n_kv_heads=2, kv_cache_dtype=kv)
    eng = _engine(tp, tcfg)
    # the pools kv-head-sharded over tp, stacked (tp, pages + trash, ...)
    assert eng.cache["k"][0].shape == (2, 9, 1, P, tcfg.head_dim)
    reqs = _requests(5, seed=17)
    ids = [eng.submit(p, m) for p, m in reqs]
    got = eng.run()
    for sid, (prompt, max_new) in zip(ids, reqs):
        np.testing.assert_array_equal(
            got[sid], _jax_standalone(jp, jcfg, prompt, max_new))
    assert eng.free_page_count == eng.pool_pages


def test_tp_draft_engine_token_exact_vs_jax_unsharded(model):
    jcfg, tcfg, jp, tp = model
    _, dcfg, _, dp = _model(DRAFT, seed=42)
    eng = _engine(tp, tcfg, draft_params=dp, draft_cfg=dcfg, gamma=2)
    assert eng.dcache["k"][0].shape[0] == 2
    reqs = _requests(3, seed=17)
    ids = [eng.submit(p, m) for p, m in reqs]
    got = eng.run()
    for sid, (prompt, max_new) in zip(ids, reqs):
        np.testing.assert_array_equal(
            got[sid], _jax_standalone(jp, jcfg, prompt, max_new))
    assert eng.spec_rounds > 0


@pytest.mark.parametrize("impl", ["linear", "ragged"])
def test_tp_speculative_token_exact_vs_jax_greedy(impl):
    base = dict(BASE, max_seq=32)
    jcfg, tcfg, jp, tp = _model(base, n_heads=4, n_kv_heads=2)
    dover = dict(d_model=16, d_ff=32, n_layers=1, n_heads=2)
    if impl == "linear":
        dover["n_kv_heads"] = 2
    _, dcfg, _, dp = _model({**base, **dover}, seed=42)
    batch = 1 if impl == "linear" else 2
    prompt = np.random.default_rng(1).integers(0, 64, (batch, 8), np.int32)
    want = np.asarray(jdec.greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                           8))
    with torch.no_grad():
        if impl == "linear":
            got = tspec.speculative_generate(
                tp, tcfg, dp, dcfg, torch.from_numpy(prompt), 8, gamma=3,
                mesh=MESH, device="cpu")
        else:
            got = tspec.speculative_generate_batched(
                tp, tcfg, dp, dcfg, torch.from_numpy(prompt), 8, gamma=2,
                mesh=MESH, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_tp_extend_steps_match_unsharded(model):
    # the verify extends on the tp shards: the linear and the paged
    # (int8) forms against the unsharded ones on the same prefix
    _, tcfg, _, tp = model
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (2, 8), np.int32))
    chunk = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    with torch.no_grad():
        outs = []
        for mesh in (None, MESH):
            _, cache = tdec.prefill(tp, prompt, tcfg, 16, mesh=mesh)
            outs.append(tdec.extend_step(tp, cache, 8, chunk, tcfg,
                                         mesh=mesh))
        assert cache["k"][0].dim() == 5
        np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                                   atol=1e-5)
        q = ttf.TransformerConfig(**BASE, kv_cache_dtype="int8")
        outs = []
        pos = torch.tensor([8, 8], dtype=torch.int32)
        for mesh in (None, MESH):
            cache = tdec.init_paged_cache(q, 2, 3, P, device="cpu",
                                          mesh=mesh)
            tdec.paged_prefill(tp, prompt, q, cache, P, mesh=mesh)
            outs.append(tdec.paged_extend_step(tp, cache, pos, chunk, q,
                                               mesh=mesh))
        np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                                   atol=1e-5)


# ------------------------------------------- inside the port, byte for byte


def _template_requests(n, seed=2):
    rng = np.random.RandomState(seed)
    template = rng.randint(0, 64, size=16).astype(np.int32)
    return [(np.concatenate([template, rng.randint(0, 64, size=int(
        rng.choice((3, 5, 8))))]).astype(np.int32), int(rng.choice([3, 5])))
        for _ in range(n)]


@pytest.mark.parametrize("leg", ["prefix_cache", "preempt", "residency"])
def test_tp_engine_paths_equal_tp_standalone(leg):
    _, tcfg, _, tp = _model(decode_attn="gather")
    events = []
    if leg == "prefix_cache":
        reqs = _template_requests(5)
        eng = _engine(tp, tcfg, pool_pages=12, prompt_buckets=(16, 24, 32),
                      prefix_cache=True)
        ids = [eng.submit(p, m) for p, m in reqs]
    elif leg == "preempt":
        reqs = _requests(2, seed=5)
        reqs = [(reqs[0][0], 18), (reqs[1][0], 4)]
        eng = _engine(tp, tcfg, pool_pages=4, preempt=True,
                      emit=lambda **r: events.append(r))
        ids = [eng.submit(reqs[0][0], 18, priority=1)]
        eng.run(max_rounds=3)
        ids.append(eng.submit(reqs[1][0], 4, priority=0))
    else:
        reqs = [(np.random.RandomState(3).randint(0, 64, size=8)
                 .astype(np.int32), 20) for _ in range(4)]
        mgr = ResidencyManager(host_blocks=16, policy=ColdAfterNPolicy(1))
        eng = _engine(tp, tcfg, slots=4, pool_pages=8, residency=mgr)
        ids = [eng.submit(p, m) for p, m in reqs]
    got = eng.run()
    for sid, (prompt, max_new) in zip(ids, reqs):
        np.testing.assert_array_equal(got[sid],
                                      _standalone(tp, tcfg, prompt, max_new))
    if leg == "prefix_cache":
        assert eng.prefill_skip_frac > 0
    elif leg == "preempt":
        assert [e["seq_id"] for e in events
                if e["kind"] == "serve_preempt"] == [ids[0]]
    else:
        assert mgr.swap_outs > 0 and mgr.swap_ins > 0


@pytest.mark.parametrize("direction", ["tp_to_plain", "plain_to_tp"])
def test_bundle_crosses_tp_and_unsharded_engines(model, direction):
    _, tcfg, _, tp = model
    meshes = (MESH, None) if direction == "tp_to_plain" else (None, MESH)
    src, dst = (_engine(tp, tcfg, mesh=m) for m in meshes)
    prompt = np.arange(5, 16, dtype=np.int32)
    sid = src.submit(prompt, 9)
    src.service_round()
    [slot] = src.exportable_slots()
    b = src.export_migration(slot)
    # JAX's global layout: every kv head in the bundle
    assert b.pages_payload["k"][0].shape == (b.n_pages, tcfg.kv_heads, P,
                                             tcfg.head_dim)
    dst.install_migration(b)
    got = dst.run()
    np.testing.assert_array_equal(got[sid],
                                  _standalone(tp, tcfg, prompt, 9, mesh=None))
    np.testing.assert_array_equal(got[sid], _standalone(tp, tcfg, prompt, 9))


def test_sampled_tp_engine_equals_sampled_unsharded_engine(model):
    _, tcfg, _, tp = model
    reqs = _requests(4, seed=9)
    outs = []
    for mesh in (None, MESH):
        eng = _engine(tp, tcfg, mesh=mesh, temperature=0.8, top_k=8,
                      seed=3)
        ids = [eng.submit(p, m) for p, m in reqs]
        got = eng.run()
        outs.append([got[s] for s in ids])
        if mesh:
            for sid, (prompt, max_new) in zip(ids, reqs):
                np.testing.assert_array_equal(got[sid], _standalone(
                    tp, tcfg, prompt, max_new, temperature=0.8, top_k=8,
                    key=eng.request_key(sid)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_tp_not_dividing_kv_heads_keeps_whole_pools():
    # tp 4 over kv_heads 2: JAX's warning, the pools whole, the tokens
    # still the unsharded standalone's
    jcfg, tcfg, jp, tp = _model(n_kv_heads=2)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        eng = _engine(tp, tcfg, mesh={"tp": 4})
        reqs = _requests(3, seed=4)
        ids = [eng.submit(p, m) for p, m in reqs]
        got = eng.run()
    assert any("does not divide" in str(w.message) for w in seen)
    assert eng.cache["k"][0].dim() == 4
    for sid, (prompt, max_new) in zip(ids, reqs):
        np.testing.assert_array_equal(
            got[sid], _jax_standalone(jp, jcfg, prompt, max_new))
