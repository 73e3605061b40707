"""The port's launched serving plane (``hpc_patterns_tpu_torch.serving_plane.
service``) against the JAX package's ``serving_plane/service.py`` on the
CPU:

- the stub tier's pure functions (``stub_token``, ``stub_key0``,
  ``stub_next_key``, ``stub_token_keyed``, ``stub_sampled_stream``)
  byte-equal to JAX's over numpy-seeded prompts;
- the port's and JAX's ``StubAdapter`` giving equal replies to one message
  sequence (prefill, decode and both roles, greedy and sampled);
- the port's and JAX's ``PlaneRouter`` over stub replicas served on
  localhost threads (``serve_replica``) giving equal finished streams,
  outcomes and migration counts;
- ``RealAdapter`` in process on JAX's ``init_params(PRNGKey(0))`` carried
  over with ``models/convert.py``: a prefill-role export crosses the wire
  (JSON both ways) into a decode-role adapter, and the tokens equal JAX's
  ``paged_generate`` byte for byte in f32; sampled, the resume checkpoint's
  keys are the engine's request keys;
- the module imports no torch: a fresh interpreter that imports it leaves
  ``torch`` out of ``sys.modules``.
"""

import json
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from hpc_patterns_tpu.models import decode as jdecode  # noqa: E402
from hpc_patterns_tpu.models import transformer as jtf  # noqa: E402
from hpc_patterns_tpu.serving_plane import service as jsvc  # noqa: E402
from hpc_patterns_tpu_torch.models import transformer as ttf  # noqa: E402
from hpc_patterns_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)
from hpc_patterns_tpu_torch.models.serving import EngineCore  # noqa: E402
from hpc_patterns_tpu_torch.serving_plane import service as tsvc  # noqa: E402

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64, dtype="float32")
ENG = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8, chunk=2)
STUB = dict(slots=2, pool_pages=8, pages_per_seq=4, page_size=8, chunk=3)


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, size=int(rng.choice(
        [3, 7, 12])))] for _ in range(n)]


# ---------------------------------------------------------------------------
# the stub tier


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stub_functions_byte_equal_jax(seed):
    for prompt in _prompts(6, seed):
        assert [tsvc.stub_token(prompt, k) for k in range(20)] \
            == [jsvc.stub_token(prompt, k) for k in range(20)]
        key, jkey = tsvc.stub_key0(prompt), jsvc.stub_key0(prompt)
        assert key == jkey and isinstance(key, bytes)
        for _ in range(5):
            assert tsvc.stub_token_keyed(key) == jsvc.stub_token_keyed(key)
            key, jkey = tsvc.stub_next_key(key), jsvc.stub_next_key(jkey)
            assert key == jkey
        assert tsvc.stub_sampled_stream(prompt, 17) \
            == jsvc.stub_sampled_stream(prompt, 17)


def _drive_stubs(svc, roles, sampled):
    """One message sequence through a prefill (or both) adapter and a
    decode adapter of ``svc``'s StubAdapter: every reply, in order."""
    a, b = (svc.StubAdapter(**STUB, role=r, sampled=sampled) for r in roles)
    replies = [a.describe(), b.describe()]
    for rid, prompt in enumerate(_prompts(5, seed=3)):
        a.submit({"rid": rid, "prompt": prompt, "max_new": 4 + rid})
    # a resume with a prefix and, sampled, a carried key
    a.submit({"rid": 9, "prompt": [1, 2, 3, 40, 41], "max_new": 5,
              "resume_prefix": [40, 41], "priority": 1,
              "key": svc.stub_key0([1, 2, 3]).hex() if sampled else None})
    for _ in range(12):
        reply = a.round(None)
        replies.append(reply)
        for wire in reply["exports"]:
            svc.recv_migration(json.loads(json.dumps(wire)), b, None)
        replies.append(b.round(None))
    return replies


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("roles", [("prefill", "decode"), ("both", "both")])
def test_stub_adapter_replies_equal_jax(roles, sampled):
    ours = _drive_stubs(tsvc, roles, sampled)
    theirs = _drive_stubs(jsvc, roles, sampled)
    assert ours == theirs
    assert any(r.get("exports") for r in ours[2:]) == (roles[0] == "prefill")
    assert any(r.get("finished") for r in ours[2:])


# ---------------------------------------------------------------------------
# the router over stub replicas on localhost threads


def _serve_plane(svc, tmp_path, roles, policy, sampled):
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    threads = []
    for rank, role in enumerate(roles, start=1):
        adapter = svc.StubAdapter(**STUB, role=role, sampled=sampled)
        t = threading.Thread(target=svc.serve_replica, args=(adapter,),
                             kwargs=dict(rank=rank, rdv_dir=rdv,
                                         timeout_s=30.0), daemon=True)
        t.start()
        threads.append(t)
    handles = svc.connect_replicas(rdv, range(1, len(roles) + 1),
                                   wait_s=30.0, timeout_s=30.0)
    router = svc.PlaneRouter(handles, policy=policy)
    arrivals = [(0.0, dict(prompt=p, max_new=4 + i % 5, priority=i % 2))
                for i, p in enumerate(_prompts(9, seed=5))]
    report = router.run(arrivals, timeout_s=30.0)
    for t in threads:
        t.join(timeout=30.0)
    outcomes = {rid: rec["outcome"] for rid, rec in router.stats.items()}
    return (dict(router.finished), outcomes, report["migrations"],
            report["served"], {k: len(h.assigned) for k, h in
                               enumerate(router.handles)})


@pytest.mark.parametrize("roles,policy,sampled", [
    (("prefill", "decode"), "least_loaded", False),
    (("prefill", "decode", "decode"), "round_robin", True),
    (("both", "both"), "least_loaded", True),
])
def test_plane_router_over_stub_replicas_equals_jax(tmp_path, roles, policy,
                                                    sampled):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = _serve_plane(tsvc, tmp_path / "port", roles, policy, sampled)
    theirs = _serve_plane(jsvc, tmp_path / "jax", roles, policy, sampled)
    assert ours == theirs
    finished, outcomes, migrations, served, _ = ours
    assert served == 9 and set(outcomes.values()) == {"ok"}
    assert migrations == (9 if roles[0] == "prefill" else 0)


# ---------------------------------------------------------------------------
# the real adapter in process


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**BASE)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield ttf.TransformerConfig(**BASE, decode_attn="gather"), tp, jcfg, jp
    torch.set_num_threads(threads)


def _real_pair(model, **skw):
    cfg, tp, _, _ = model
    return (tsvc.RealAdapter(EngineCore(tp, cfg, **ENG, **skw, device="cpu"),
                             role=role) for role in ("prefill", "decode"))


def _serve_over_the_wire(pre, dec, reqs, rounds=40):
    """Submit ``reqs`` to the prefill adapter, carry every export through
    JSON into the decode adapter, run until all finish; returns the
    finished tokens, the exports seen and the last key checkpoint."""
    for rid, (prompt, budget) in enumerate(reqs):
        pre.submit({"rid": rid, "prompt": [int(t) for t in prompt],
                    "max_new": budget})
    finished, exports, keys = {}, [], {}
    for _ in range(rounds):
        r = pre.round(None)
        keys.update(r.get("keys", {}))
        assert r["export_s"] >= 0.0
        for wire in r["exports"]:
            exports.append(wire)
            tsvc.recv_migration(json.loads(json.dumps(wire)), dec, None)
        r = dec.round(None)
        keys.update(r.get("keys", {}))
        finished.update({int(k): v for k, v in r["finished"].items()})
        if len(finished) == len(reqs):
            break
    return finished, exports, keys


def test_real_adapter_handoff_over_the_wire_equals_jax(model):
    cfg, tp, jcfg, jp = model
    rng = np.random.RandomState(7)
    reqs = [(rng.randint(0, 64, size=int(n)).astype(np.int32), int(b))
            for n, b in ((5, 6), (9, 9), (12, 4))]
    pre, dec = _real_pair(model)
    finished, exports, _ = _serve_over_the_wire(pre, dec, reqs)
    assert len(exports) == len(reqs)
    assert {w["transport"] for w in exports} == {"wire"}
    assert {w["payload_dtype"] for w in exports} == {"float32"}
    assert [w["seq"] for w in exports] == list(range(len(reqs)))
    for rid, (prompt, budget) in enumerate(reqs):
        want = np.asarray(jdecode.paged_generate(
            jp, jax.numpy.asarray(prompt)[None], jcfg, budget,
            page_size=8))[0]
        np.testing.assert_array_equal(finished[rid], want,
                                      err_msg=f"rid {rid}")
    assert pre.engine.free_page_count == dec.engine.free_page_count == 8


def test_real_adapter_sampled_checkpoint_carries_the_request_keys(model):
    pre, dec = _real_pair(model, temperature=0.8, top_k=8, seed=0)
    reqs = [(np.arange(1, 6, dtype=np.int32), 6),
            (np.arange(7, 15, dtype=np.int32), 8)]
    finished, exports, keys = _serve_over_the_wire(pre, dec, reqs)
    assert set(finished) == {0, 1}
    # the port's key is the row's whole sampler state: the checkpoint
    # reports each row's request key, exported and decoded alike
    for rid in (0, 1):
        want = [int(v) for v in pre.engine.request_key(rid)]
        assert keys[str(rid)] == want


def test_real_adapter_resume_submit_takes_the_checkpointed_key(model):
    # a resumed sampled row (prompt = original + emitted, the checkpointed
    # key handed back) continues the uninterrupted stream exactly
    cfg, tp, _, _ = model
    skw = dict(temperature=0.8, top_k=8, seed=0)
    prompt = [3, 1, 4, 1, 5, 9]
    whole = tsvc.RealAdapter(EngineCore(tp, cfg, **ENG, **skw,
                                        device="cpu"))
    whole.submit({"rid": 4, "prompt": prompt, "max_new": 8})
    full = None
    for _ in range(20):
        r = whole.round(None)
        if "4" in r["finished"]:
            full = r["finished"]["4"]
            break
    key = [int(v) for v in whole.engine.request_key(4)]
    resumed = tsvc.RealAdapter(EngineCore(tp, cfg, **ENG, **dict(skw, seed=9),
                                          device="cpu"))
    resumed.submit({"rid": 4, "prompt": prompt + full[:3], "max_new": 5,
                    "resume_prefix": full[:3], "key": key})
    for _ in range(20):
        r = resumed.round(None)
        if "4" in r["finished"]:
            assert r["finished"]["4"] == full
            break
    else:
        raise AssertionError("the resumed row never finished")


def test_service_imports_no_torch():
    code = ("import sys; import hpc_patterns_tpu_torch.serving_plane.service;"
            " import hpc_patterns_tpu_torch.apps.plane_app;"
            " print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "False"
