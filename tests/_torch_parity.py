"""Helpers of the port's parity tests: the JAX package's own test bodies
run against the port's modules, and inputs both packages write.

:func:`load` executes ``tests/<name>.py`` as a fresh module and points
every name it imported from ``hpc_patterns_tpu`` (modules, classes and
functions) at the port's counterpart in ``hpc_patterns_tpu_torch``.
:func:`cases` lists ``(class, method)`` pairs for parametrization, and
:func:`call` runs one with the pytest fixtures it asks for, with
``sys.modules`` redirected so that imports inside a test body resolve to
the port too. A name with no port counterpart keeps the JAX object, so
only bodies whose every import has a port counterpart are run this way.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import sys
import types
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
JAX, PORT = "hpc_patterns_tpu", "hpc_patterns_tpu_torch"


def port_name(name: str) -> str:
    return PORT + name[len(JAX):]


def load(name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"_jax_bodies_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, val in list(vars(mod).items()):
        if isinstance(val, types.ModuleType):
            src = val.__name__
        elif inspect.isclass(val) or inspect.isfunction(val):
            src = getattr(val, "__module__", "") or ""
        else:
            continue
        if not src.startswith(JAX + "."):
            continue
        try:
            target = importlib.import_module(port_name(src))
        except ModuleNotFoundError:
            continue  # not ported: only bodies that never reach it run
        if isinstance(val, types.ModuleType):
            setattr(mod, attr, target)
        elif hasattr(target, val.__name__):
            setattr(mod, attr, getattr(target, val.__name__))
    return mod


def cases(mod: types.ModuleType, classes, skip=()) -> list:
    """``(class name, method name)`` of every test method of ``classes``
    in definition order, but those named in ``skip``."""
    out = []
    for cls_name in classes:
        cls = getattr(mod, cls_name)
        for name, fn in vars(cls).items():
            if name.startswith("test") and callable(fn) \
                    and name not in skip:
                out.append((cls_name, name))
    return out


def call(mod: types.ModuleType, cls_name: str, method: str, request,
         redirect=(), **fixtures) -> None:
    """Run ``cls_name().method`` with the fixtures it names (``fixtures``
    first, then pytest's), each module of ``redirect`` (JAX names) mapped
    to the port's in ``sys.modules`` for the call."""
    fn = getattr(getattr(mod, cls_name)(), method)
    kwargs = {}
    for arg in inspect.signature(fn).parameters:
        if arg in fixtures:
            val = fixtures[arg]
            kwargs[arg] = val() if callable(val) else val
        else:
            kwargs[arg] = request.getfixturevalue(arg)
    mp = request.getfixturevalue("monkeypatch")
    for name in redirect:
        mp.setitem(sys.modules, name, importlib.import_module(
            port_name(name)))
    fn(**kwargs)


# ---------------------------------------------------------------------------
# inputs both packages' recorders write the same way


#: the lifecycle kinds a seeded history walks through (every one the
#: port's engine stamps, and the decode-phase stall kinds explain and
#: budget weigh)
SEEDED_KINDS = ("admit_wait", "prefill", "decode", "preempted",
                "swapped_out", "prefetch_wait", "migrating", "decode")


def seeded_reqtrace(reqtrace_mod, seed: int, n: int = 24) -> dict:
    """A ``kind=reqtrace`` payload from one package's recorder: ``n``
    requests in two priority classes, each a numpy-seeded walk of
    transitions at fixed instants (some gaps left unstamped, some
    requests shed before their first token), with token stamps across
    the decode phase."""
    rng = np.random.default_rng(seed)
    rtr = reqtrace_mod.ReqTrace()
    stats = {}
    for sid in range(n):
        t = float(rng.uniform(0.0, 2.0))
        t_submit = t
        rtr.begin_request(sid, t)
        shed = rng.uniform() < 0.1
        kinds = ["admit_wait", "prefill"] + [
            SEEDED_KINDS[int(k)] for k in rng.integers(2, 8, 3)]
        t_first = None
        for i, kind in enumerate(kinds[:1] if shed else kinds):
            t += float(rng.exponential(0.05))
            if rng.uniform() < 0.2:
                t += float(rng.exponential(0.01))  # an unstamped gap
            rtr.stamp_transition(sid, kind, t)
            if kind == "prefill":
                t_first = t + float(rng.exponential(0.02))
        t += float(rng.exponential(0.1))
        rtr.finish_request(sid, t, final="shed" if shed else None)
        tokens = 0 if shed else int(rng.integers(1, 9))
        token_ts = (sorted(float(x) for x in rng.uniform(t_first, t,
                                                         tokens - 1))
                    if tokens else [])
        stats[sid] = {
            "priority": int(rng.integers(0, 2)), "t_submit": t_submit,
            "t_first": None if shed else t_first, "t_finish": t,
            "tokens": tokens, "outcome": "shed" if shed else "ok",
            "preemptions": int(rng.integers(0, 2)),
            "token_ts": ([t_first] + token_ts) if tokens else [],
        }
    return rtr.snapshot(stats)


SMOKE_SERVE = ["--prompt-mix", "--requests", "8"]


def serve_log(which: str, path: Path, *extra) -> Path:
    """A real ``serve_app --explain --log`` run of the smoke model in
    ``which`` package ("port" or "jax"), on the CPU, in f32."""
    argv = [*SMOKE_SERVE, "--explain", "--log", str(path), *map(str, extra)]
    if which == "port":
        from hpc_patterns_tpu_torch.apps import serve_app

        argv += ["--device", "cpu", "--dtype", "float32"]
    else:
        from hpc_patterns_tpu.apps import serve_app

        argv += ["--backend", "cpu", "--kv-dtype", "f32"]
    assert serve_app.main(argv) == 0
    return path
