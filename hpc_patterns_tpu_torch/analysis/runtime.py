"""Runtime complements to the static rules (the counterpart of
``hpc_patterns_tpu/analysis/runtime.py``).

Five helpers, each the runtime check behind a static family:

**Consumed-input poisoning** (:func:`poison_consumed`, behind
``inplace-alias``). The serving step consumes ``pos``, ``limit`` and
``tokens`` and returns new ones (``models/serving.py::_chunk_step``), as
JAX donates them. A host view of a consumed tensor (``.numpy()`` of a
CPU tensor) keeps reading plausible values as long as nothing reuses the
storage — the bug passes every test. ``poison_consumed`` removes the
luck: after each call it fills every tensor of a consumed argument that
no output shares storage with (``untyped_storage().data_ptr()``) with a
sentinel byte, so a stale view reads garbage at once.
:func:`install_serving_poison` wraps the engine's consuming steps.

**Strict dispatch** (:func:`strict_dispatch`, behind
``host-sync-in-dispatch``). On the card every dispatch-critical function
the static pass judges clean (no finding, none suppressed) runs under
``torch.cuda.set_sync_debug_mode("error")``, callees included: a
synchronizing op anywhere in it raises — the runtime sees what the
static rule, which reads one body, cannot (a pageable host-to-device
copy in a helper). The mode is lifted inside a function whose syncs are
deliberate (a suppressed finding) and inside the loop's sync points
(:data:`SYNC_POINTS`), so a clean caller does not fail on a sanctioned
sync. Guarded calls are counted.

**Strict barriers** (:func:`strict_barriers`, behind ``mbar-balance``/
``flag-balance``). A ledger build of kernels 11 (``fused_ring.cu``) and 14
(``overlap_pipeline.cu``), made with ``-DHPCPAT_LEDGER`` into
``build/ledger/`` (the timed libraries never change): ``csrc/ledger.cuh``
counts every mbarrier init, arrival, expected and brought transaction
byte and completed wait, and every flag release, credit and satisfied
spin, in a ``__device__`` table read after the launch. Inside the
context the wrappers launch the ledger build; :meth:`StrictBarriers.check`
holds the balance.

**Shared memory on the card** (:func:`smem_card_rows`, behind
``smem-budget``). Every library exports its kernels'
``cudaFuncGetAttributes`` and the dynamic bytes its launcher requests;
each row is held against ``smem.py``'s, and a request set per call at the
shapes of the launchers' own plans (:func:`launch_plans`), every block
within the card's opt-in limit.

**Collective schedule verification** (:class:`CollectiveSchedule`,
behind ``collective-divergence``/``collective-order``) lives in
``harness/trace.py`` and is re-exported here.
"""

from __future__ import annotations

import ctypes
import functools
import importlib
from pathlib import Path

from hpc_patterns_tpu_torch.harness.trace import (  # noqa: F401
    CollectiveSchedule,
    collective_schedule,
    record_collective,
    reset_collective_schedule,
)

#: sentinel byte: 0xAB patterns read as huge-magnitude garbage in every
#: dtype the engine keeps (int32 -1414812757), never a plausible cursor
SENTINEL_BYTE = 0xAB

_PACKAGE = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# consumed-input poisoning
# ---------------------------------------------------------------------------


def _tensors(obj):
    import torch

    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _storage_ptr(t) -> int:
    return t.untyped_storage().data_ptr()


def poison_consumed(fn, argnums, *, sentinel: int = SENTINEL_BYTE):
    """Wrap ``fn`` so its consumed arguments die loudly after each call.

    After ``fn(*args)`` returns, every tensor of each ``args[i]`` for ``i``
    in ``argnums`` is filled with ``sentinel`` bytes — unless an output
    shares its storage (the step handed the input back: poisoning it
    would corrupt the result). The fill is stream-ordered after the call's
    kernels; nothing waits. ``wrapper.poison_count`` counts poisoned
    tensors — tests assert on it so the hook provably engaged."""
    import torch

    argnums = tuple(argnums)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        keep = {_storage_ptr(t) for t in _tensors(out)}
        seen: set[int] = set()
        for i in argnums:
            if i >= len(args):
                continue
            for t in _tensors(args[i]):
                ptr = _storage_ptr(t)
                if ptr in keep or ptr in seen or t.numel() == 0:
                    continue
                seen.add(ptr)
                st = t.untyped_storage()
                raw = torch.empty(0, dtype=torch.uint8, device=t.device)
                raw.set_(st, 0, (st.nbytes(),))
                raw.fill_(sentinel)
                wrapper.poison_count += 1
        return out

    wrapper.poison_count = 0
    wrapper.__wrapped__ = fn
    return wrapper


#: the serving engine's consuming steps and the positions they consume —
#: the arguments each returns anew (models/serving.py): pos, limit and
#: tokens (cur for the draft-assisted chunk)
SERVING_POISON_TARGETS: dict[str, tuple[int, ...]] = {
    "_chunk_step": (2, 3, 4),
    "_chunk_step_rows": (2, 3, 4),
    "_spec_chunk": (4, 5, 6),
}


def install_serving_poison():
    """Swap the serving module's consuming steps for poisoned wrappers;
    returns an ``uninstall()`` restoring the originals. The wrappers are
    reachable as ``serving.<name>`` while installed (their
    ``poison_count`` says whether they engaged)."""
    from hpc_patterns_tpu_torch.models import serving

    originals = {}
    for name, argnums in SERVING_POISON_TARGETS.items():
        originals[name] = getattr(serving, name)
        setattr(serving, name, poison_consumed(originals[name], argnums))

    def uninstall():
        for name, fn in originals.items():
            setattr(serving, name, fn)

    return uninstall


# ---------------------------------------------------------------------------
# strict dispatch
# ---------------------------------------------------------------------------


def judged_functions(paths=None) -> dict[str, dict[str, bool]]:
    """``{module: {qualname: clean}}`` for every dispatch-critical function
    (a top-level function or a method) in the package's Python: clean
    when the static ``host-sync-in-dispatch`` pass finds nothing in its
    body, live or suppressed."""
    import ast

    from hpc_patterns_tpu_torch.analysis.core import (
        AnalysisConfig,
        ModuleInfo,
        analyze_file,
        iter_python_files,
    )
    from hpc_patterns_tpu_torch.analysis.rules import HostSyncRule

    rule = HostSyncRule()
    cfg = AnalysisConfig(select=frozenset({rule.name}))
    out: dict[str, dict[str, bool]] = {}
    for f in iter_python_files(paths or [_PACKAGE]):
        f = Path(f).resolve()
        try:
            rel = f.relative_to(_PACKAGE.parent)
        except ValueError:
            continue
        mod = ModuleInfo.parse(f)
        live, suppressed = analyze_file(f, cfg)
        lines = {x.line for x in live + suppressed}
        fns = {}
        for node in mod.tree.body:
            cands = [(node, node.name)] if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)) else []
            if isinstance(node, ast.ClassDef):
                cands = [(m, f"{node.name}.{m.name}") for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))]
            for fn, qual in cands:
                if not rule._is_critical(mod, fn, cfg):
                    continue
                span = range(fn.lineno, (fn.end_lineno or fn.lineno) + 1)
                fns[qual] = not any(ln in span for ln in lines)
        if fns:
            name = ".".join(rel.with_suffix("").parts)
            out[name] = fns
    return out


#: the serving loop's designated sync points (the host-sync rule's hint
#: names them): the first-token and chunk readbacks. A guarded round
#: calls them; inside them the sync debug mode is lifted
SYNC_POINTS = {
    "hpc_patterns_tpu_torch.models.serving": (
        "EngineCore._resolve_pending", "EngineCore._collect_chunk",
        "EngineCore._collect_spec"),
}


class StrictDispatch:
    """The context of :func:`strict_dispatch`: ``guarded_calls`` counts
    calls of the clean functions, ``lifted_calls`` of the deliberate
    ones, ``raised`` the synchronizing ops caught (each re-raised)."""

    def __init__(self, modules=None):
        self.modules = modules
        self.guarded_calls = 0
        self.lifted_calls = 0
        self.raised: list[str] = []
        self.functions: dict[str, bool] = {}
        self._undo: list[tuple[object, str, object]] = []

    def _wrap(self, fn, clean: bool, qual: str):
        import torch

        on_card = torch.cuda.is_available()
        ctx = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if clean:
                ctx.guarded_calls += 1
            else:
                ctx.lifted_calls += 1
            if not on_card:
                return fn(*args, **kwargs)
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error" if clean else "default")
            try:
                return fn(*args, **kwargs)
            except RuntimeError as e:
                if clean and "synchroniz" in str(e).lower():
                    ctx.raised.append(f"{qual}: {e}")
                raise
            finally:
                torch.cuda.set_sync_debug_mode(before)

        return wrapper

    def __enter__(self):
        judged = judged_functions()
        for modname, quals in SYNC_POINTS.items():
            judged.setdefault(modname, {}).update(
                {q: False for q in quals})
        for modname, fns in judged.items():
            if self.modules is not None and modname not in self.modules:
                continue
            mod = importlib.import_module(modname)
            for qual, clean in fns.items():
                owner, attr = mod, qual
                if "." in qual:
                    cls, attr = qual.split(".", 1)
                    owner = getattr(mod, cls, None)
                    if owner is None or attr not in vars(owner):
                        continue
                    fn = vars(owner)[attr]
                    if isinstance(fn, (staticmethod, classmethod)):
                        continue
                else:
                    fn = getattr(mod, attr, None)
                if fn is None or not callable(fn):
                    continue
                self._undo.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(fn, clean,
                                                f"{modname}.{qual}"))
                self.functions[f"{modname}.{qual}"] = clean
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []
        return False


def strict_dispatch(modules=None) -> StrictDispatch:
    """Run the statically clean dispatch-critical functions under
    ``torch.cuda.set_sync_debug_mode("error")``::

        with strict_dispatch() as guard:
            engine.run()
        assert guard.guarded_calls > 0 and not guard.raised

    ``modules``: restrict to these dotted module names (default: every
    module of the package that has such a function). On the CPU the
    wrappers only count (there is no device to sync)."""
    return StrictDispatch(modules)


# ---------------------------------------------------------------------------
# shared memory: the static rows against the compiled kernels
# ---------------------------------------------------------------------------


def launch_plans(mlp_shapes=(), pipeline_rows=()) -> dict[str, list]:
    """``{kernel: [(shape, dynamic bytes), ...]}`` for the kernels whose
    dynamic shared memory is set per call, from their launchers' own plan
    functions: kernels 8 and 8a (``fused_mlp_plan``; the instance its DS
    picks) at each ``(N, D, F)`` of ``mlp_shapes``, and kernel 14
    (``overlap_pipeline_smem``; every mode alike) at each chunk of
    ``pipeline_rows`` rows on this card's grid. Needs the card."""
    import torch

    from hpc_patterns_tpu_torch.concurrency.pipeline import (
        MODES,
        pipeline_plan,
    )
    from hpc_patterns_tpu_torch.ops import _build

    plans: dict[str, list] = {}
    fn = _build.load("fused_mlp").fused_mlp_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for N, D, F in mlp_shapes:
        for k, save_a in ((0, "false"), (1, "true")):
            out = (ctypes.c_int * 8)()
            _build.check(fn(k, N, D, F, ctypes.addressof(out)),
                         f"fused_mlp_plan {k}")
            # out[2]: the plan's DS, out[6]: its dynamic bytes
            plans.setdefault(f"mlp_kernel<{out[2]},{save_a}>", []).append(
                (f"N{N} D{D} F{F}", out[6]))
    lib = _build.load("overlap_pipeline")
    lib.overlap_pipeline_smem.argtypes = [ctypes.c_int] * 3
    lib.overlap_pipeline_smem.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in pipeline_rows:
        blocks, tiles = pipeline_plan(rows, sms)
        dyn = lib.overlap_pipeline_smem(rows, blocks, tiles)
        for m in range(len(MODES)):
            plans.setdefault(f"pipeline_kernel<{m}>", []).append(
                (f"chunk_rows {rows}", dyn))
    return plans


def smem_card_rows(plans=None) -> tuple[list[dict], list[str], int]:
    """Every library's ``hpcpat_smem_rows`` (``cudaFuncGetAttributes``'
    static bytes and registers, the dynamic bytes its launcher requests)
    against ``analysis/smem.py``'s row of the same instantiation. A row
    whose request is set per call (-1) is held at each shape of ``plans``
    (:func:`launch_plans`). Returns ``(rows, problems, opt-in limit)``:
    a problem is a static size or a bound request that differs from
    smem.py's, a block over ``shared_memory_per_block_optin``, a row one
    side lacks, or a plan the launcher refuses. Needs the card."""
    import torch

    from hpc_patterns_tpu_torch.analysis import smem
    from hpc_patterns_tpu_torch.ops import _build

    plans = plans or {}
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    ip = ctypes.POINTER(ctypes.c_int)
    rows: list[dict] = []
    bad: list[str] = []
    for name in _build.SOURCES:
        fn = _build.load(name).hpcpat_smem_rows
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ip, ip,
                       ip]
        fn.restype = ctypes.c_int
        est = {r.key: r for r in smem.estimate_unit(
            _PACKAGE / "csrc" / f"{name}.cu")}
        n = fn(-1, None, None, None, None)
        seen = set()
        for i in range(n):
            nm, st, regs, dyn = (ctypes.c_char_p(), ctypes.c_int(),
                                 ctypes.c_int(), ctypes.c_int())
            rc = fn(i, ctypes.byref(nm), ctypes.byref(st), ctypes.byref(regs),
                    ctypes.byref(dyn))
            if rc != n:
                bad.append(f"{name}: hpcpat_smem_rows({i}) returned {rc}")
                continue
            kname = nm.value.decode()
            key = smem.canonical(kname)
            seen.add(key)
            r = est.get(key)
            base = {"library": name, "kernel": kname,
                    "card_static": st.value, "regs": regs.value,
                    "smem_static": r and r.static_bytes,
                    "smem_dynamic": r and r.dynamic_bytes}
            if r is None:
                bad.append(f"{name}: {kname} has no smem.py row")
                rows.append(dict(base, launcher_dynamic=dyn.value))
                continue
            if r.static_bytes != st.value:
                bad.append(f"{name}: {kname}: static {st.value} B on the "
                           f"card, {r.static_bytes} B in smem.py")
            if dyn.value >= 0:
                shapes = [("every call", dyn.value)]
                if r.dynamic_bytes != dyn.value:
                    bad.append(f"{name}: {kname}: the launcher requests "
                               f"{dyn.value} B, smem.py {r.dynamic_bytes}")
            else:
                shapes = plans.get(key, [])
                if r.dynamic_bytes is not None:
                    bad.append(f"{name}: {kname}: set per call, but smem.py "
                               f"binds {r.dynamic_bytes} B")
                if not shapes:
                    rows.append(dict(base, launcher_dynamic=None,
                                     plan="per call: not launched here"))
            for label, d in shapes:
                total = st.value + d
                if d < 0 or total > optin:
                    bad.append(f"{name}: {kname} at {label}: {st.value} + "
                               f"{d} B against the opt-in {optin} B")
                rows.append(dict(base, launcher_dynamic=d, plan=label,
                                 total=total))
        missing = sorted(set(est) - seen)
        if missing:
            bad.append(f"{name}: smem.py rows the library does not export: "
                       f"{missing[:4]}")
    return rows, bad, optin


# ---------------------------------------------------------------------------
# strict barriers: the ledger build of kernels 11 and 14
# ---------------------------------------------------------------------------

#: the sources built with the ledger, and the field order of
#: csrc/ledger.cuh
LEDGER_SOURCES = ("fused_ring", "overlap_pipeline")
BAR_FIELDS = ("inits", "count", "arrive", "tx_expect", "tx_copy", "wait")
FLAG_FIELDS = ("release", "credit", "spin_ok")


class BarrierBalanceError(AssertionError):
    """A kernel's barrier or flag ledger did not balance after its
    launch: a phase left part-arrived, transaction bytes expected but not
    brought, or a released item never credited back."""


class StrictBarriers:
    """The context of :func:`strict_barriers`. Inside it the wrappers of
    kernels 10-12 and 14 launch the ledger build; :meth:`reset` before a
    launch, :meth:`read` and :meth:`check` after it (synchronized)."""

    def __init__(self):
        self.libs: dict[str, ctypes.CDLL] = {}
        self.checked = 0

    def __enter__(self):
        from hpc_patterns_tpu_torch.ops import _build

        self.libs = _build.build_variant(LEDGER_SOURCES, ("HPCPAT_LEDGER",),
                                         "ledger")
        for lib in self.libs.values():
            lib.hpcpat_ledger_read.argtypes = [ctypes.c_void_p] * 2
            lib.hpcpat_ledger_read.restype = ctypes.c_int
            lib.hpcpat_ledger_reset.restype = ctypes.c_int
            lib.hpcpat_ledger_shape.argtypes = [ctypes.POINTER(ctypes.c_int)]
        _build._override.update(self.libs)
        return self

    def __exit__(self, *exc):
        from hpc_patterns_tpu_torch.ops import _build

        for name in self.libs:
            _build._override.pop(name, None)
        return False

    def reset(self, name: str) -> None:
        from hpc_patterns_tpu_torch.ops import _build

        _build.check(self.libs[name].hpcpat_ledger_reset(), "ledger reset")

    def read(self, name: str) -> dict:
        """``{"bars": {offset: {field: n}}, "flags": {field: n}}`` of the
        launches since :meth:`reset` (call after a synchronize)."""
        from hpc_patterns_tpu_torch.ops import _build

        lib = self.libs[name]
        shape = (ctypes.c_int * 3)()
        lib.hpcpat_ledger_shape(shape)
        n_bars, n_f, n_flags = shape
        bars = (ctypes.c_ulonglong * (n_bars * n_f))()
        flags = (ctypes.c_ulonglong * n_flags)()
        _build.check(lib.hpcpat_ledger_read(ctypes.addressof(bars),
                                            ctypes.addressof(flags)),
                     "ledger read")
        rows = {}
        for r in range(n_bars):
            vals = bars[r * n_f:(r + 1) * n_f]
            if any(vals):
                rows[r * 8] = dict(zip(BAR_FIELDS, vals))
        return {"bars": rows, "flags": dict(zip(FLAG_FIELDS, flags))}

    def check(self, name: str, *, flags: bool = False) -> dict:
        """Hold the ledger since :meth:`reset` to balance. Every barrier
        row: initialized, every phase whole (arrivals a multiple of the
        per-block init count), every expected transaction byte brought,
        a wait completed; with ``flags``: every released item credited
        back (releases == credits > 0). Raises
        :class:`BarrierBalanceError`; returns the ledger."""
        led = self.read(name)
        problems = []
        for off, row in sorted(led["bars"].items()):
            if not row["inits"]:
                problems.append(f"barrier at shared offset {off}: "
                                f"{row['arrive']} arrival(s) on a barrier "
                                f"never initialized")
                continue
            per = row["count"] / row["inits"]
            if per != int(per) or row["arrive"] % int(per):
                problems.append(
                    f"barrier at shared offset {off}: {row['arrive']} "
                    f"arrival(s) is not a whole number of phases of "
                    f"{per:g} (a phase left part-arrived)")
            if row["tx_expect"] != row["tx_copy"]:
                problems.append(
                    f"barrier at shared offset {off}: {row['tx_expect']} "
                    f"transaction byte(s) expected, {row['tx_copy']} "
                    f"brought")
            if row["arrive"] and not row["wait"]:
                problems.append(f"barrier at shared offset {off}: "
                                f"arrivals but no wait completed")
        if flags:
            f = led["flags"]
            if not f["release"] or f["release"] != f["credit"]:
                problems.append(
                    f"{f['release']} release(s) vs {f['credit']} credit(s) "
                    f"handed back: an item sent was never consumed")
        if problems:
            raise BarrierBalanceError(
                f"{name}: the ledger did not balance — "
                + "; ".join(problems))
        self.checked += 1
        return led


def strict_barriers() -> StrictBarriers:
    """The ledger build of kernels 11 and 14 as a context manager::

        with strict_barriers() as sb:
            sb.reset("overlap_pipeline")
            pipeline.overlap_run(x, mode="overlap")
            torch.cuda.synchronize()
            sb.check("overlap_pipeline")

    Builds ``fused_ring.cu`` and ``overlap_pipeline.cu`` with
    ``-DHPCPAT_LEDGER`` into ``build/ledger/`` on first use (the card's
    toolkit; nothing builds on the CPU)."""
    return StrictBarriers()
