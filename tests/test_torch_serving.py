"""The port's continuous-batching engine (``hpc_patterns_tpu_torch.
models.serving``): mixed-length requests through fewer slots than
requests, with a bucket ladder, each sequence equal to the port's own
standalone ``paged_generate``; every page back on the free list at the
end; the sizing helpers equal to the JAX engine's; the greedy engine's
tokens equal to the JAX engine's on the same params; quantized pools
(int8, fp8) on the "flash" and "paged_flash" routes, each sequence equal
to the standalone under the same quantized config. All on the CPU in
f32, where greedy tokens must be equal (no tolerance).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.models import serving as jsrv  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu_torch.apps import serve_app  # noqa: E402
from hpc_patterns_tpu_torch.models import serving as tsrv  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.models.decode import (  # noqa: E402
    paged_generate,
)

P = 16
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=256,
             max_seq=96, dtype="float32")


def _requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, int(rng.integers(3, 40)), np.int32),
             int(rng.integers(1, 20))) for _ in range(n)]


def _engine(tp, tcfg, *, slots=3, eos_id=None, chunk=4):
    buckets = tsrv.bucket_ladder(48)
    pps = tsrv.EngineCore.pages_needed(40, 20, P, padded_len=48)
    return tsrv.ContinuousBatcher(
        tp, tcfg, slots=slots, pool_pages=slots * pps, pages_per_seq=pps,
        page_size=P, chunk=chunk, eos_id=eos_id, prompt_buckets=buckets,
        device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**SMALL, n_kv_heads=2, decode_attn="gather")
    tcfg = ttf.TransformerConfig(**SMALL, n_kv_heads=2, decode_attn="flash")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


@pytest.mark.parametrize("slots", [2, 3])
def test_engine_equals_standalone_and_frees_every_page(model, slots):
    _, tcfg, _, tp = model
    reqs = _requests()
    eng = _engine(tp, tcfg, slots=slots)
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    for sid, (p, b) in zip(ids, reqs):
        want = paged_generate(tp, torch.from_numpy(p)[None], tcfg, b,
                              page_size=P, device="cpu")[0].numpy()
        np.testing.assert_array_equal(got[sid], want)
    assert eng.free_page_count == eng.pool_pages
    assert not eng.has_work() and eng.admissions == len(reqs)
    assert (eng._table == eng.trash).all()


@pytest.mark.parametrize("route", ["flash", "paged_flash"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_engine_equals_standalone(model, kv, route):
    _, tcfg, _, tp = model
    qcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv, decode_attn=route)
    reqs = _requests(seed=3)
    eng = _engine(tp, qcfg)
    # the shared pool stores one byte per value, with scale pools (the
    # trash page's included)
    assert eng.cache["k"][0].dtype == (torch.int8 if kv == "int8"
                                       else torch.float8_e4m3fn)
    assert eng.cache["k_scale"][0].shape[0] == eng.pool_pages + 1
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    for sid, (p, b) in zip(ids, reqs):
        want = paged_generate(tp, torch.from_numpy(p)[None], qcfg, b,
                              page_size=P, device="cpu")[0].numpy()
        np.testing.assert_array_equal(got[sid], want)
    assert eng.free_page_count == eng.pool_pages


def test_engine_matches_jax_engine(model):
    jcfg, tcfg, jp, tp = model
    reqs = _requests(seed=5)
    buckets = jsrv.bucket_ladder(48)
    pps = jsrv.ContinuousBatcher.pages_needed(40, 20, P, padded_len=48)
    jeng = jsrv.ContinuousBatcher(jp, jcfg, slots=3, pool_pages=3 * pps,
                                  pages_per_seq=pps, page_size=P, chunk=4,
                                  prompt_buckets=buckets)
    jids = [jeng.submit(p, b) for p, b in reqs]
    jgot = jeng.run()
    teng = _engine(tp, tcfg)
    tids = [teng.submit(p, b) for p, b in reqs]
    tgot = teng.run()
    for j, t in zip(jids, tids):
        np.testing.assert_array_equal(tgot[t], np.asarray(jgot[j]))


def test_eos_truncates_like_standalone(model):
    _, tcfg, _, tp = model
    reqs = _requests(seed=2)
    # an eos that the first request emits mid-stream
    p0, b0 = reqs[0]
    first = paged_generate(tp, torch.from_numpy(p0)[None], tcfg, 20,
                           page_size=P, device="cpu")[0].numpy()
    eos = int(first[min(3, len(first) - 1)])
    eng = _engine(tp, tcfg, eos_id=eos)
    ids = [eng.submit(p, 20) for p, _ in reqs]
    got = eng.run()
    for sid, (p, _) in zip(ids, reqs):
        want = paged_generate(tp, torch.from_numpy(p)[None], tcfg, 20,
                              page_size=P, device="cpu")[0].numpy()
        if (want == eos).any():
            want = want[:int(np.argmax(want == eos)) + 1]
        np.testing.assert_array_equal(got[sid], want)
    assert eng.free_page_count == eng.pool_pages


@pytest.mark.parametrize("max_len", [1, 16, 17, 48, 512, 1000])
def test_sizing_helpers_equal_jax(max_len):
    assert tsrv.bucket_ladder(max_len) == jsrv.bucket_ladder(max_len)
    ladder = jsrv.bucket_ladder(max_len)
    for n in sorted({1, max_len // 2 or 1, max_len}):
        assert tsrv.pad_to_bucket(ladder, n) == jsrv.pad_to_bucket(ladder, n)
        for budget in (1, 7, 64):
            pad = jsrv.pad_to_bucket(ladder, n)
            assert (tsrv.EngineCore.pages_needed(n, budget, P, padded_len=pad)
                    == jsrv.ContinuousBatcher.pages_needed(
                        n, budget, P, padded_len=pad))


@pytest.mark.parametrize("kw", [
    {"mesh": {"tp": 3}},
])
def test_later_slice_options_raise(model, kw):
    # the tp engine serves (tests/test_torch_tp_serving.py); what a mesh
    # still refuses is a tp that does not divide the model's widths
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="divide"):
        tsrv.ContinuousBatcher(tp, tcfg, slots=1, pool_pages=4,
                               pages_per_seq=4, page_size=P,
                               device="cpu", **kw)


@pytest.mark.parametrize("kw,match", [
    ({}, "draft_cfg"),
    ({"draft_cfg": "vocab32"}, "vocab mismatch"),
    ({"draft_cfg": "same", "gamma": 0}, "gamma"),
])
def test_draft_engine_guards(model, kw, match):
    # JAX's engine guards (hpc_patterns_tpu/models/serving.py:721-727)
    _, tcfg, _, tp = model
    kw = dict(kw)
    if kw.get("draft_cfg") == "vocab32":
        kw["draft_cfg"] = dataclasses.replace(tcfg, vocab=32)
    elif kw.get("draft_cfg") == "same":
        kw["draft_cfg"] = tcfg
    with pytest.raises(ValueError, match=match):
        tsrv.ContinuousBatcher(tp, tcfg, slots=1, pool_pages=4,
                               pages_per_seq=4, page_size=P, device="cpu",
                               draft_params=tp, **kw)


@pytest.mark.parametrize("kw", [
    {"temperature": 0.7}, {"preempt": True}, {"admit_highwater": 0.9},
])
def test_former_later_slice_options_serve(model, kw):
    # sampling, preemption and the high-water mark: each constructs and
    # serves every request, equal to the standalone under the same
    # options (the sampled one with each request's key)
    _, tcfg, _, tp = model
    reqs = _requests(seed=7)
    buckets = tsrv.bucket_ladder(48)
    pps = tsrv.EngineCore.pages_needed(40, 20, P, padded_len=48)
    eng = tsrv.ContinuousBatcher(tp, tcfg, slots=3, pool_pages=3 * pps,
                                 pages_per_seq=pps, page_size=P, chunk=4,
                                 prompt_buckets=buckets, device="cpu", **kw)
    ids = [eng.submit(p, b, priority=i % 2) for i, (p, b) in
           enumerate(reqs)]
    got = eng.run()
    sampled = {"key": None, "temperature": kw.get("temperature", 0.0)}
    for sid, (p, b) in zip(ids, reqs):
        if sampled["temperature"]:
            sampled["key"] = eng.request_key(sid)
        want = paged_generate(tp, torch.from_numpy(p)[None], tcfg, b,
                              page_size=P, device="cpu",
                              **sampled)[0].numpy()
        np.testing.assert_array_equal(got[sid], want)
    assert eng.free_page_count == eng.pool_pages
    with pytest.raises(ValueError, match="admit_highwater"):
        tsrv.ContinuousBatcher(tp, tcfg, slots=1, pool_pages=4,
                               pages_per_seq=4, page_size=P, device="cpu",
                               admit_highwater=0.0)


def test_submit_rejects_oversize_and_duplicates(model):
    _, tcfg, _, tp = model
    eng = _engine(tp, tcfg)
    with pytest.raises(ValueError, match="above the bucket-ladder top"):
        eng.submit(np.zeros(60, np.int32), 4)
    sid = eng.submit(np.zeros(5, np.int32), 4)
    with pytest.raises(ValueError, match="already"):
        eng.submit(np.zeros(5, np.int32), 4, seq_id=sid)


def test_tie_aware_compare():
    want = np.array([1, 2, 3, 4])
    gaps = np.array([1.0, 0.01, 1.0, 1.0])
    assert tsrv.tie_aware_compare(want, want, gaps, 0.05) == "exact"
    assert tsrv.tie_aware_compare([1, 9, 9, 9], want, gaps,
                                  0.05) == "near_tie"
    assert tsrv.tie_aware_compare([1, 2, 9, 4], want, gaps,
                                  0.05) == "mismatch"
    assert tsrv.tie_aware_compare([1, 2], want, gaps, 0.05) == "mismatch"


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_serve_app_kv_dtype_cpu_succeeds(capsys, kv):
    rc = serve_app.main(["--device", "cpu", "--dtype", "float32",
                         "--prompt-mix", "--requests", "4", "--slots", "2",
                         "--n-kv-heads", "2", "--kv-dtype", kv])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("SUCCESS"), out
    assert f"kv {kv}" in out and "mismatch 0" in out


def test_serve_app_cpu_succeeds(capsys):
    rc = serve_app.main(["--device", "cpu", "--dtype", "float32",
                         "--prompt-mix", "--requests", "5", "--slots", "2",
                         "--n-kv-heads", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("SUCCESS"), out
    assert "mismatch 0" in out and "pages leaked 0" in out


def test_serve_app_serves_a_train_app_checkpoint(tmp_path, capsys):
    from hpc_patterns_tpu_torch.apps import train_app

    ck = str(tmp_path / "ck")
    dims = ["--d-model", "32", "--n-layers", "2", "--n-heads", "4",
            "--vocab", "128"]
    assert train_app.main(["--device", "cpu", "--batch", "2", "--seq", "32",
                           "--steps", "1", "--checkpoint-dir", ck,
                           *dims]) == 0
    capsys.readouterr()
    rc = serve_app.main(["--device", "cpu", "--dtype", "float32",
                         "--checkpoint-dir", ck, "--requests", "3",
                         "--prompt-mix", "--no-overlap", "--eos-id", "7",
                         "--prompt-buckets", "none", "--pool-pages", "9",
                         *dims])
    out = capsys.readouterr().out
    assert rc == 0 and "restored step 1" in out, out
    assert out.strip().endswith("SUCCESS") and "mismatch 0" in out
    assert serve_app.main(["--device", "cpu", "--checkpoint-dir",
                           str(tmp_path / "nothing")]) == 1


@pytest.mark.parametrize("flag,names", [
    (["--autofit", "fit.json"], "item 2"),
    (["--explain"], "item 2"),
])
def test_serve_app_later_flags_name_their_slice(capsys, flag, names):
    # the flags of ROADMAP item 2 are ported: neither refuses any more.
    # --autofit with a config that does not exist fails naming the file;
    # --explain serves and prints the tail-attribution table
    rc = serve_app.main(["--device", "cpu", *flag])
    out = capsys.readouterr().out
    assert "not ported yet" not in out and names not in out
    if flag[0] == "--autofit":
        assert rc == 1 and "fit.json" in out
        assert out.strip().endswith("FAILURE")
    else:
        assert rc == 0 and "request forensics  n=8" in out
        assert out.strip().endswith("SUCCESS")


@pytest.mark.parametrize("flag,says", [
    (["--checkpoint-dir", "ck"], "--checkpoint-dir would be silently"),
    (["--kv-dtype", "int8"], "--kv-dtype int8 would be silently"),
    ([], "cannot load the pair"),
])
def test_serve_app_draft_pair_guards(capsys, tmp_path, flag, says):
    # JAX's app guards (hpc_patterns_tpu/apps/serve_app.py:132-146) and a
    # pair directory that holds no pair
    assert serve_app.main(["--device", "cpu", "--draft-pair",
                           str(tmp_path / "no_pair"), *flag]) == 1
    out = capsys.readouterr().out
    assert says in out and out.strip().endswith("FAILURE"), out
