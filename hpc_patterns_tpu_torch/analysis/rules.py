"""The torchlint and shardlint rule sets over the port's Python.

Each rule is a pure-``ast`` visitor over one module, the torch form of a
rule of ``hpc_patterns_tpu/analysis/rules.py``. Canonical-name matching
goes through :meth:`ModuleInfo.resolve`, so ``dist``/
``torch.distributed`` and ``np``/``numpy`` spellings are equivalent.

torchlint:

- ``inplace-alias``        — a host view of a tensor (``.numpy()``,
                             ``np.asarray``, ``torch.from_numpy``) read
                             after a call that writes that tensor in
                             place (JAX's ``donation-alias``)
- ``host-sync-in-dispatch``— a device readback or sync inside a
                             dispatch-critical function
- ``rebuild-hazard``       — a kernel build or load per call or per loop
                             iteration (JAX's ``recompile-hazard``)
- ``generator-reuse``      — a generator re-seeded per call or per
                             iteration, or one sampler key drawn twice
                             at the same position (JAX's
                             ``prng-key-reuse``)
- ``autograd-leak``        — a differentiated tensor kept on ``self`` or
                             a global (its graph stays alive), or a
                             tensor kept on an ``autograd.Function``
                             ctx as an attribute (JAX's ``tracer-leak``)

shardlint (the SPMD collective-divergence class, over
``torch.distributed``, the ``Communicator`` and ``comm/processes.py``'s
gloo wire):

- ``collective-divergence``, ``collective-order``,
  ``unchecked-permutation``, ``spec-mismatch`` — JAX's rules with the
  port's collectives, rank sources and spec tuples.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable

from hpc_patterns_tpu_torch.analysis.core import (
    AnalysisConfig,
    Finding,
    ModuleInfo,
    Rule,
    register,
)
from hpc_patterns_tpu_torch.analysis.core import walk as _walk


def _func_name(mod: ModuleInfo, call: ast.Call) -> str | None:
    return mod.resolve(call.func)


_FUNCS: dict[int, tuple[ast.AST, list]] = {}


def _functions(tree: ast.AST) -> list[ast.FunctionDef]:
    """Every def in ``tree`` (memoized: every rule walks them)."""
    hit = _FUNCS.get(id(tree))
    if hit is not None and hit[0] is tree:
        return hit[1]
    out = [node for node in _walk(tree)
           if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
    _FUNCS[id(tree)] = (tree, out)
    if len(_FUNCS) > 1024:
        _FUNCS.pop(next(iter(_FUNCS)))
    return out


def _enclosing(mod: ModuleInfo, node: ast.AST, kinds) -> ast.AST | None:
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = mod.parents.get(cur)
    return None


def _loop_ancestors(mod: ModuleInfo, node: ast.AST) -> set[int]:
    """ids of the For/While nodes enclosing ``node``."""
    out: set[int] = set()
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.For, ast.While)):
            out.add(id(cur))
        cur = mod.parents.get(cur)
    return out


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


# ---------------------------------------------------------------------------
# inplace-alias
# ---------------------------------------------------------------------------

# methods that leave a host view of their receiver's storage: a CPU
# tensor's .numpy(), through the no-op hops before it
_VIEW_HOPS = frozenset({"cpu", "detach"})
_VIEW_CALLS = frozenset({"numpy.asarray", "memoryview",
                         "torch.from_numpy", "torch.as_tensor"})
#: "the cache is updated in place" / "the caches are written in place"
_INPLACE_DOC = re.compile(
    r"\b(?:[Tt]he|[Ii]ts)\s+(\w+?)(s?)\s+(?:is|are)\s+(?:updated|written)"
    r"\s+in\s+place")


def _view_source(mod: ModuleInfo, call: ast.Call) -> ast.AST | None:
    """The tensor/array a host-view expression aliases, or None."""
    cname = _func_name(mod, call)
    if cname in _VIEW_CALLS or (cname == "numpy.array" and any(
            kw.arg == "copy" and isinstance(kw.value, ast.Constant)
            and kw.value.value is False for kw in call.keywords)):
        if call.args and isinstance(
                call.args[0], (ast.Name, ast.Attribute, ast.Subscript)):
            return call.args[0]
        return None
    if isinstance(call.func, ast.Attribute) and call.func.attr in (
            "numpy", "__array__"):
        src = call.func.value
        while (isinstance(src, ast.Call)
               and isinstance(src.func, ast.Attribute)
               and src.func.attr in _VIEW_HOPS and not src.args):
            src = src.func.value
        if isinstance(src, (ast.Name, ast.Attribute, ast.Subscript)):
            return src
    return None


def _inplace_table(mod: ModuleInfo) -> dict[str, tuple[int, ...]]:
    """name -> positions of the arguments written in place, for every
    def in this module whose docstring says an argument is updated in
    place (``_chunk_step``: "the cache is updated in place")."""
    table: dict[str, tuple[int, ...]] = {}
    for fn in _functions(mod.tree):
        doc = ast.get_docstring(fn) or ""
        doc = " ".join(doc.split())
        written: list[int] = []
        names = [p.arg for p in fn.args.posonlyargs + fn.args.args]
        for m in _INPLACE_DOC.finditer(doc):
            word, plural = m.group(1), m.group(2)
            for i, p in enumerate(names):
                if p == word or (plural and p.endswith(word)):
                    written.append(i)
        if written:
            table[fn.name] = tuple(sorted(set(written)))
    return table


def _writes(mod: ModuleInfo, node: ast.AST,
            table: dict[str, tuple[int, ...]]) -> list[str]:
    """``ast.dump``\\ s of the expressions ``node`` writes in place."""
    out: list[str] = []
    if isinstance(node, ast.Call):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr.endswith("_")
                and not f.attr.startswith("_")):
            out.append(ast.dump(f.value))  # x.add_(...), x.copy_(...)
        for kw in node.keywords:
            if kw.arg == "out":
                out.append(ast.dump(kw.value))
        cname = _func_name(mod, node)
        for i in table.get((cname or "").rsplit(".", 1)[-1], ()):
            if i < len(node.args):
                out.append(ast.dump(node.args[i]))
    elif isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if isinstance(t, ast.Subscript):
                out.append(ast.dump(t.value))  # x[i] = ...
    return out


@register
class InplaceAliasRule(Rule):
    """The "poisoned cache" class in torch's form: ``v = t.numpy()``
    (or ``np.asarray(t)``, ``t.cpu().numpy()`` of a CPU tensor) is a
    zero-copy HOST VIEW of ``t``'s storage. If a later call writes ``t``
    in place — an ``*_`` method, ``out=t``, a subscript store, or an
    entry point whose docstring says it updates that argument in place
    — the "snapshot" changes under the host's feet. On the card the
    same code reads a copy, so the bug shows only on the CPU, and only
    when the write lands between the view and its last read."""

    name = "inplace-alias"
    summary = "host view of a tensor that a later call writes in place"
    hint = ("snapshot with .clone()/.copy() (or .tolist()) before the "
            "in-place write, or defer the host read past it")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        table = _inplace_table(mod)
        for fn in _functions(mod.tree):
            views: dict[str, tuple[str, int, ast.AST]] = {}
            writes: list[tuple[int, str, ast.AST]] = []
            loads: dict[str, list[int]] = {}
            for node in _walk(fn):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)):
                    src = _view_source(mod, node.value)
                    if src is not None:
                        views[node.targets[0].id] = (
                            ast.dump(src), node.lineno, node)
                for dump in _writes(mod, node, table):
                    writes.append((node.lineno, dump, node))
                if isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Load):
                    loads.setdefault(node.id, []).append(node.lineno)
            for var, (src_dump, vline, vnode) in views.items():
                for wline, dump, wnode in writes:
                    if dump != src_dump:
                        continue
                    if wline > vline:
                        used_after = any(
                            ln > wline for ln in loads.get(var, ()))
                    elif _loop_ancestors(mod, vnode) & _loop_ancestors(
                            mod, wnode):
                        # shared loop: iteration N's view is still live
                        # when iteration N+1's write lands
                        used_after = any(
                            ln > vline for ln in loads.get(var, ()))
                    else:
                        continue
                    if used_after:
                        yield self.finding(
                            mod, vnode,
                            f"{var!r} is a zero-copy host view of a "
                            f"tensor written in place at line {wline}; "
                            f"the view changes under the host's feet",
                        )
                        break


# ---------------------------------------------------------------------------
# host-sync-in-dispatch
# ---------------------------------------------------------------------------


def _class_of(mod: ModuleInfo, fn: ast.AST) -> str | None:
    parent = mod.parents.get(fn)
    return parent.name if isinstance(parent, ast.ClassDef) else None


_DEVICE_ATTRS: dict[int, tuple[ast.AST, frozenset[str]]] = {}


@register
class HostSyncRule(Rule):
    """Dispatch-critical functions (the overlapped serving path, the
    plane's round, the command queue's enqueue — the names in
    ``AnalysisConfig.dispatch_critical``, or any function decorated
    ``@dispatch_critical``) exist to keep the card's queue fed. A device
    readback (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``.to("cpu")``, ``.nonzero()``) or a sync (``torch.cuda.synchronize``,
    ``Event/Stream.synchronize``) stalls exactly the pipeline they
    implement. ``np.asarray``/``np.array`` and ``int``/``float``/``bool``
    read a device value only when handed one: they are judged on a
    tensor attribute of ``self`` (one the module assigns from a
    ``torch.*`` constructor), a cast also on a call's result (JAX's
    form); a readback inside the argument is its own finding. So a host
    list packed into an array is not a finding."""

    name = "host-sync-in-dispatch"
    summary = "host readback/sync inside a dispatch-critical function"
    hint = ("defer the readback to the loop's sync point (the serving "
            "pattern: _resolve_pending / _collect_chunk), keep a host "
            "mirror, or keep the decision on the device")

    _SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
    _SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy", "nonzero",
                               "synchronize"})
    _HOST_COPIES = frozenset({"numpy.asarray", "numpy.array"})
    _SYNC_CASTS = frozenset({"float", "int", "bool"})
    #: torch.* calls that do not make a tensor
    _NOT_TENSORS = ("torch.cuda.", "torch.device", "torch.Generator",
                    "torch.dtype")

    def _device_attrs(self, mod: ModuleInfo) -> frozenset[str]:
        """Names ``n`` the module assigns as ``self.n = torch.<ctor>(...)``
        (memoized by tree)."""
        hit = _DEVICE_ATTRS.get(id(mod.tree))
        if hit is not None and hit[0] is mod.tree:
            return hit[1]
        out = set()
        for node in _walk(mod.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            name = _func_name(mod, node.value) or ""
            if not name.startswith("torch.") or name.startswith(
                    self._NOT_TENSORS):
                continue
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out.add(t.attr)
        _DEVICE_ATTRS[id(mod.tree)] = (mod.tree, frozenset(out))
        return frozenset(out)

    def _tensor_valued(self, mod: ModuleInfo, expr: ast.AST) -> bool:
        """``expr`` holds a tensor attribute of ``self`` and no readback
        of its own (a ``.tolist()`` inside is the finding, once)."""
        attrs = self._device_attrs(mod)
        held = False
        for sub in _walk(expr):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in self._SYNC_METHODS):
                return False
            held |= (isinstance(sub, ast.Attribute) and sub.attr in attrs
                     and isinstance(sub.value, ast.Name)
                     and sub.value.id == "self")
        return held

    def _is_critical(self, mod: ModuleInfo, fn: ast.FunctionDef,
                     config: AnalysisConfig) -> bool:
        cls = _class_of(mod, fn)
        if (fn.name in config.dispatch_critical
                or (cls and f"{cls}.{fn.name}" in config.dispatch_critical)):
            return True
        for dec in fn.decorator_list:
            node = dec.func if isinstance(dec, ast.Call) else dec
            name = node.attr if isinstance(node, ast.Attribute) else (
                node.id if isinstance(node, ast.Name) else "")
            if name == "dispatch_critical":
                return True
        return False

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "to"):
            return False
        vals = list(call.args) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
        for v in vals:
            for sub in _walk(v):
                if isinstance(sub, ast.Constant) and sub.value == "cpu":
                    return True
        return False

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for fn in _functions(mod.tree):
            if not self._is_critical(mod, fn, config):
                continue
            for node in _walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                cname = _func_name(mod, node)
                arg = node.args[0] if node.args else None
                if cname in self._SYNC_CALLS:
                    yield self.finding(
                        mod, node,
                        f"{cname}() forces a host sync inside "
                        f"dispatch-critical {fn.name!r}",
                    )
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in self._SYNC_METHODS):
                    yield self.finding(
                        mod, node,
                        f".{node.func.attr}() forces a host sync "
                        f"inside dispatch-critical {fn.name!r}",
                    )
                elif self._to_cpu(node):
                    yield self.finding(
                        mod, node,
                        f'.to("cpu") reads back a device tensor inside '
                        f"dispatch-critical {fn.name!r}",
                    )
                elif (cname in self._HOST_COPIES and arg is not None
                        and self._tensor_valued(mod, arg)):
                    yield self.finding(
                        mod, node,
                        f"{cname}() of a tensor reads it back inside "
                        f"dispatch-critical {fn.name!r}",
                    )
                elif (cname in self._SYNC_CASTS and arg is not None
                        and (isinstance(arg, ast.Call)
                             or self._tensor_valued(mod, arg))):
                    # float(f(...)) or float(self.t[i]): materializes the
                    # device value — host-side int(x.size) bookkeeping
                    # stays legal
                    yield self.finding(
                        mod, node,
                        f"{cname}() of a device value reads it back inside "
                        f"dispatch-critical {fn.name!r}",
                    )


# ---------------------------------------------------------------------------
# rebuild-hazard
# ---------------------------------------------------------------------------

#: constructors that build or load a kernel (or compile a function):
#: each call does the work again, where the package builds once at first
#: use (ops/_build.load memoizes, and is not among them)
_BUILDERS = frozenset({
    "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
    "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
    "torch.compile", "triton.jit",
})


def _is_builder(mod: ModuleInfo, node: ast.AST) -> bool:
    name = mod.resolve(node.func if isinstance(node, ast.Call) else node)
    return name in _BUILDERS


@register
class RebuildRule(Rule):
    """A kernel library loaded, an extension built or a function
    compiled inside a loop, or constructed and called at once inside a
    function body (``torch.compile(f)(x)``, a ``@triton.jit`` def
    nested in a function): every iteration or call pays the build again
    — the silent 1000x slowdown of JAX's per-call ``jax.jit``."""

    name = "rebuild-hazard"
    summary = ("kernel build/load or compile constructed per call or "
               "per loop iteration")
    hint = ("build once at first use and keep the handle "
            "(ops/_build.load), or hoist the compiled wrapper to module "
            "level")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for node in _walk(mod.tree):
            if isinstance(node, ast.Call) and _is_builder(mod, node):
                loop = _enclosing(mod, node, (ast.For, ast.While))
                fn = _enclosing(mod, node,
                                (ast.FunctionDef, ast.AsyncFunctionDef))
                parent = mod.parents.get(node)
                called_now = (isinstance(parent, ast.Call)
                              and parent.func is node)
                what = _func_name(mod, node)
                if loop is not None:
                    yield self.finding(
                        mod, node,
                        f"{what}(...) inside a loop: every iteration "
                        f"builds or loads again",
                    )
                elif fn is not None and called_now:
                    yield self.finding(
                        mod, node,
                        f"{what}(...)(...) inside {fn.name!r}: the "
                        f"wrapper is rebuilt on every call of "
                        f"{fn.name!r}",
                    )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                outer = _enclosing(mod, node,
                                   (ast.FunctionDef, ast.AsyncFunctionDef))
                if outer is None:
                    continue
                for dec in node.decorator_list:
                    if _is_builder(mod, dec) or (
                            isinstance(dec, ast.Call)
                            and _is_builder(mod, dec)):
                        yield self.finding(
                            mod, dec,
                            f"@{mod.resolve(getattr(dec, 'func', dec))} "
                            f"on {node.name!r} nested in {outer.name!r}: "
                            f"a fresh compiled function every call",
                        )


# ---------------------------------------------------------------------------
# generator-reuse
# ---------------------------------------------------------------------------

#: sampler draws keyed by (key, position): name -> (key arg, pos arg,
#: the noise argument that, when given, means the call draws nothing)
_DRAWS = {"uniform_noise": (0, 1, None), "gumbel_noise": (0, 1, None),
          "sample_scores": (1, 2, 5), "_pick": (3, 4, 5)}


def _local_names(fn: ast.FunctionDef) -> set[str]:
    out: set[str] = set()
    for node in _walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


@register
class GeneratorReuseRule(Rule):
    """A ``torch.Generator`` is a stream: re-seeding one that outlives
    the call (an attribute, a parameter, a module global) restarts the
    stream every call, and re-seeding in a loop with a seed the loop
    does not vary draws the same bits every iteration. The sampler's
    counter-based draws (``uniform_noise``/``gumbel_noise``/
    ``sample_scores``/``_pick``) are keyed by (key, position): two
    draws with one key at one position are bit-identical."""

    name = "generator-reuse"
    summary = ("generator re-seeded per call/iteration, or one key "
               "drawn twice at one position")
    hint = ("seed a generator once where it is made (or vary the seed "
            "with the loop), and draw each (key, position) once — fold "
            "a stream tag (decode.fold_keys) for a second stream")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for fn in _functions(mod.tree):
            local = _local_names(fn) - set(_params(fn))
            draws: dict[tuple[str, str], int] = {}
            for node in _walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if _enclosing(mod, node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) is not fn:
                    continue  # a nested def is scanned on its own
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "manual_seed":
                    yield from self._reseed(mod, fn, node, local)
                base = (_func_name(mod, node) or "").rsplit(".", 1)[-1]
                if base in _DRAWS:
                    ki, pi, ni = _DRAWS[base]
                    key = self._arg(node, ki, "keys")
                    pos = self._arg(node, pi, "pos")
                    if ni is not None and self._arg(node, ni, "noise"):
                        continue  # the noise handed in: no draw here
                    if key is None or pos is None:
                        continue
                    sig = (ast.dump(key), ast.dump(pos))
                    if sig in draws and draws[sig] != node.lineno:
                        yield self.finding(
                            mod, node,
                            f"{base} draws key {ast.unparse(key)!r} at "
                            f"position {ast.unparse(pos)!r} again (first "
                            f"at line {draws[sig]}): both draws are "
                            f"bit-identical",
                        )
                    else:
                        draws.setdefault(sig, node.lineno)

    @staticmethod
    def _arg(call: ast.Call, i: int, kw: str) -> ast.AST | None:
        for k in call.keywords:
            if k.arg == kw:
                return k.value
        return call.args[i] if i < len(call.args) else None

    def _reseed(self, mod, fn, node, local) -> Iterable[Finding]:
        recv = node.func.value
        loop = _enclosing(mod, node, (ast.For, ast.While))
        if loop is not None and _enclosing(
                mod, loop, (ast.FunctionDef, ast.AsyncFunctionDef)) is fn:
            varied = set()
            if isinstance(loop, ast.For):
                varied = {n.id for n in _walk(loop.target)
                          if isinstance(n, ast.Name)}
            varied |= {n.id for s in loop.body for n in _walk(s)
                       if isinstance(n, ast.Name)
                       and isinstance(n.ctx, ast.Store)}
            used = {n.id for a in node.args for n in _walk(a)
                    if isinstance(n, ast.Name)}
            if not used & varied:
                yield self.finding(
                    mod, node,
                    "generator re-seeded inside a loop with a seed the "
                    "loop does not vary: every iteration draws the same "
                    "stream",
                )
            return  # a seed per iteration is a stream per iteration
        # torch.Generator(...).manual_seed(s) on a fresh generator, or a
        # generator made in this call, is seeded once where it is made
        if isinstance(recv, ast.Call):
            return
        root = recv
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(recv, ast.Name) and recv.id in local:
            return
        if mod.resolve(recv) == "torch":
            return  # the global generator: a program's own seeding
        if isinstance(root, ast.Name):
            yield self.finding(
                mod, node,
                f"{ast.unparse(recv)}.manual_seed(...) re-seeds a "
                f"generator that outlives {fn.name!r}: every call "
                f"restarts its stream",
            )


# ---------------------------------------------------------------------------
# autograd-leak
# ---------------------------------------------------------------------------


def _no_grad_context(mod: ModuleInfo, node: ast.AST) -> bool:
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                e = item.context_expr
                name = mod.resolve(e.func if isinstance(e, ast.Call) else e)
                if (name or "").rsplit(".", 1)[-1] in (
                        "no_grad", "inference_mode"):
                    return True
        cur = mod.parents.get(cur)
    return False


@register
class AutogradLeakRule(Rule):
    """Two ways to keep a graph alive past its step. (a) A tensor the
    function backpropagates through (``.backward()`` on it, or passed to
    ``torch.autograd.grad``) stored on ``self`` or a module global
    outside ``no_grad``/``inference_mode``: the whole graph of the step
    lives as long as the attribute. (b) A tensor argument of an
    ``autograd.Function``'s ``forward`` kept on ``ctx`` as an attribute
    instead of ``ctx.save_for_backward``: autograd cannot check it for
    in-place modification, and the reference cycle keeps it alive."""

    name = "autograd-leak"
    summary = ("differentiated tensor stored on self/globals, or a "
               "tensor kept on an autograd.Function ctx attribute")
    hint = ("store .detach() (or .item() at a sync point), and keep "
            "forward's tensors with ctx.save_for_backward")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for fn in _functions(mod.tree):
            yield from self._graph_kept(mod, fn)
        for cls in _walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if not any((mod.resolve(b) or "").endswith("autograd.Function")
                       for b in cls.bases):
                continue
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef) and fn.name == "forward":
                    yield from self._ctx_tensors(mod, fn)

    def _graph_kept(self, mod, fn) -> Iterable[Finding]:
        diffed: set[str] = set()
        for node in _walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "backward"
                    and isinstance(f.value, ast.Name)):
                diffed.add(f.value.id)
            elif ((_func_name(mod, node) or "").endswith("autograd.grad")
                    and node.args and isinstance(node.args[0], ast.Name)):
                diffed.add(node.args[0].id)
        if not diffed:
            return
        globs = {n for node in _walk(fn) if isinstance(node, ast.Global)
                 for n in node.names}
        for node in _walk(fn):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in diffed):
                continue
            if _no_grad_context(mod, node):
                continue
            for tgt in node.targets:
                if ((isinstance(tgt, ast.Attribute)
                     and isinstance(tgt.value, ast.Name)
                     and tgt.value.id == "self")
                        or (isinstance(tgt, ast.Name) and tgt.id in globs)):
                    yield self.finding(
                        mod, node,
                        f"{node.value.id!r} is differentiated in "
                        f"{fn.name!r} and stored on "
                        f"{ast.unparse(tgt)}: its whole graph stays "
                        f"alive with it",
                    )

    def _ctx_tensors(self, mod, fn) -> Iterable[Finding]:
        params = _params(fn)
        if not params:
            return
        ctx, tensors = params[0], set(params[1:])
        for node in _walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                elts = (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt])
                vals = (node.value.elts if isinstance(node.value, ast.Tuple)
                        and isinstance(tgt, ast.Tuple) else [node.value])
                for t, v in zip(elts, vals):
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == ctx
                            and isinstance(v, ast.Name)
                            and v.id in tensors):
                        yield self.finding(
                            mod, node,
                            f"forward's tensor {v.id!r} kept as "
                            f"{ctx}.{t.attr}: use "
                            f"{ctx}.save_for_backward",
                        )


# ---------------------------------------------------------------------------
# shardlint: SPMD collective-divergence rule family
# ---------------------------------------------------------------------------

# comm-layer collective entry points matched by final name (JAX's set:
# Communicator methods, the ring and fused routes, the migration pair),
# plus comm/processes.py's gloo wire between launched processes
_COLLECTIVE_NAMES = frozenset({
    "allreduce", "all_gather", "reduce_scatter", "all_to_all",
    "pingpong", "sendrecv_ring", "broadcast", "barrier_value",
    "ring_shift", "pairwise_exchange", "ring_allreduce",
    "ring_allreduce_chunked", "ring_reduce_scatter", "ring_all_gather",
    "ring_schedule", "halo_exchange", "jacobi_step",
    "process_allgather", "sync_global_devices", "broadcast_one_to_all",
    "fused_allreduce", "allreduce_into", "allgather_matmul",
    "fused_permute", "fused_ring_shift",
    "migrate_pages", "send_migration", "recv_migration",
    "exchange_rows", "gather_rows", "allreduce_mean", "host_values",
    # jax.lax spellings stay collectives (a twin of a JAX module reads
    # the same)
    "psum", "pmean", "pmax", "pmin", "ppermute", "pshuffle",
    "psum_scatter", "pbroadcast",
})
#: torch.distributed's collectives, matched through the resolved name
#: (their bare names — send, gather, reduce — are too common alone)
_DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "barrier", "monitored_barrier", "send",
    "recv", "isend", "irecv", "gather", "gather_object", "scatter",
    "scatter_object_list", "reduce", "batch_isend_irecv",
})

#: final names whose call result identifies the calling rank
_RANK_SOURCES = frozenset({"get_rank", "get_node_local_rank",
                           "axis_index", "process_index"})

#: pair-list consumers audited by ``unchecked-permutation``
_PERMUTE_CONSUMERS = frozenset({"fused_permute", "ring_permute",
                                "ppermute"})


def _collective_id(mod: ModuleInfo, call: ast.Call
                   ) -> tuple[str, str, str] | None:
    """(receiver, op, axis) identity of a collective call, or None."""
    name = _func_name(mod, call) or ""
    recv, _, op = name.rpartition(".")
    if not (op in _COLLECTIVE_NAMES or (
            recv == "torch.distributed" and op in _DIST_COLLECTIVES)):
        return None
    axis = ""
    candidates = list(call.args) + [
        kw.value for kw in call.keywords
        if kw.arg in ("axis", "axis_name", "group")]
    for a in candidates:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            axis = a.value
            break
    return (recv, op, axis)


class _Unjudgeable(Exception):
    """A nested branch whose arms issue DIFFERENT collective sequences:
    comparisons through it abstain."""


def _collective_seq(mod: ModuleInfo, stmts
                    ) -> list[tuple[str, str, str]] | None:
    """Collective identities issued by a statement list, in evaluation
    order; None when a nested branch makes it unjudgeable."""
    try:
        return _seq_block(mod, stmts)
    except _Unjudgeable:
        return None


def _seq_block(mod: ModuleInfo, stmts) -> list[tuple[str, str, str]]:
    out: list[tuple[str, str, str]] = []
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, ast.If):
            _seq_expr(mod, stmt.test, out)
            a = _seq_block(mod, stmt.body)
            b = _seq_block(mod, stmt.orelse)
            if a != b:
                raise _Unjudgeable
            out.extend(a)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            _seq_expr(mod, stmt.iter, out)
            out.extend(_seq_block(mod, stmt.body))
            out.extend(_seq_block(mod, stmt.orelse))
        elif isinstance(stmt, ast.While):
            _seq_expr(mod, stmt.test, out)
            out.extend(_seq_block(mod, stmt.body))
            out.extend(_seq_block(mod, stmt.orelse))
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                _seq_expr(mod, item.context_expr, out)
            out.extend(_seq_block(mod, stmt.body))
        elif isinstance(stmt, ast.Try):
            out.extend(_seq_block(mod, stmt.body))
            for h in stmt.handlers:
                out.extend(_seq_block(mod, h.body))
            out.extend(_seq_block(mod, stmt.orelse))
            out.extend(_seq_block(mod, stmt.finalbody))
        else:
            _seq_expr(mod, stmt, out)
    return out


def _seq_expr(mod: ModuleInfo, node: ast.AST,
              out: list[tuple[str, str, str]]) -> None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef, ast.Lambda)):
        return
    if isinstance(node, ast.IfExp):
        _seq_expr(mod, node.test, out)
        a: list[tuple[str, str, str]] = []
        b: list[tuple[str, str, str]] = []
        _seq_expr(mod, node.body, a)
        _seq_expr(mod, node.orelse, b)
        if a != b:
            raise _Unjudgeable
        out.extend(a)
        return
    for child in ast.iter_child_nodes(node):
        _seq_expr(mod, child, out)
    if isinstance(node, ast.Call):
        cid = _collective_id(mod, node)
        if cid is not None:
            out.append(cid)


def _is_rank_source(mod: ModuleInfo, node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        name = _func_name(mod, node) or ""
        if name.rsplit(".", 1)[-1] in _RANK_SOURCES:
            return True
        # os.environ.get("HPCPAT_PROCESS_ID") — the launcher protocol
        if (name in ("os.environ.get", "os.getenv") and node.args
                and isinstance(node.args[0], ast.Constant)
                and "PROCESS_ID" in str(node.args[0].value)):
            return True
    if isinstance(node, ast.Subscript):
        if (mod.resolve(node.value) == "os.environ"
                and isinstance(node.slice, ast.Constant)
                and "PROCESS_ID" in str(node.slice.value)):
            return True
    # a communicator's (or a rank block's) rank
    if (isinstance(node, ast.Attribute) and node.attr == "rank"
            and isinstance(node.ctx, ast.Load)):
        return True
    return False


def _expr_rank_dependent(mod: ModuleInfo, expr: ast.AST,
                         tainted: set[str]) -> bool:
    for node in _walk(expr):
        if _is_rank_source(mod, node):
            return True
        if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                and node.id in tainted):
            return True
    return False


def _rank_tainted(mod: ModuleInfo, fn: ast.FunctionDef) -> set[str]:
    """Names assigned (transitively) from a rank source anywhere in
    ``fn`` — a flow-insensitive fixpoint."""
    tainted: set[str] = set()
    assigns = [n for n in _walk(fn)
               if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
    changed = True
    while changed:
        changed = False
        for a in assigns:
            if a.value is None:
                continue
            if not _expr_rank_dependent(mod, a.value, tainted):
                continue
            targets = a.targets if isinstance(a, ast.Assign) else [a.target]
            for tgt in targets:
                for sub in _walk(tgt):
                    if (isinstance(sub, ast.Name)
                            and sub.id not in tainted):
                        tainted.add(sub.id)
                        changed = True
    return tainted


def _ops(seq: list[tuple[str, str, str]]) -> str:
    return ", ".join(op for _, op, _ in seq) if seq else "(none)"


@register
class CollectiveDivergenceRule(Rule):
    """SPMD ranks must issue the identical collective sequence: a
    collective under rank-dependent control flow (``dist.get_rank()``,
    ``HPCPAT_PROCESS_ID``, a communicator's ``rank``) whose paths
    disagree — branch arms with different sequences, a rank-guarded
    early return skipping later collectives, a loop with a rank-sized
    trip count — hangs the job silently: every other rank waits inside
    a gloo collective this rank never enters."""

    name = "collective-divergence"
    family = "shardlint"
    summary = ("collective under rank-dependent control flow whose "
               "paths disagree on the schedule")
    hint = ("issue the same collective sequence on every rank: branch "
            "on rank for DATA (torch.where) or host I/O, never for "
            "which collective comes next")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for fn in _functions(mod.tree):
            tainted = _rank_tainted(mod, fn)
            yield from self._scan(mod, fn.body, tainted)

    def _scan(self, mod, stmts, tainted) -> Iterable[Finding]:
        for idx, stmt in enumerate(stmts):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                if _expr_rank_dependent(mod, stmt.test, tainted):
                    a = _collective_seq(mod, stmt.body)
                    b = _collective_seq(mod, stmt.orelse)
                    if a is None or b is None:
                        pass  # abstain; an inner branch scans itself
                    elif a != b:
                        yield self.finding(
                            mod, stmt,
                            f"rank-dependent branch issues different "
                            f"collective sequences: if-arm [{_ops(a)}] "
                            f"vs else-arm [{_ops(b)}] — ranks disagree "
                            f"on which collective comes next (deadlock "
                            f"shape)",
                        )
                    elif (self._returns(stmt.body)
                            != self._returns(stmt.orelse)):
                        trailing = _collective_seq(mod, stmts[idx + 1:])
                        if trailing:
                            yield self.finding(
                                mod, stmt,
                                f"rank-dependent early return skips "
                                f"{len(trailing)} later collective(s) "
                                f"([{_ops(trailing)}]) on the "
                                f"returning ranks",
                            )
                yield from self._scan(mod, stmt.body, tainted)
                yield from self._scan(mod, stmt.orelse, tainted)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                bound = (stmt.test if isinstance(stmt, ast.While)
                         else stmt.iter)
                if _expr_rank_dependent(mod, bound, tainted):
                    body = _collective_seq(mod, stmt.body)
                    if body:
                        yield self.finding(
                            mod, stmt,
                            f"collective(s) [{_ops(body)}] inside a "
                            f"loop with a rank-dependent trip count — "
                            f"ranks issue different collective counts",
                        )
                yield from self._scan(mod, stmt.body, tainted)
                yield from self._scan(mod, stmt.orelse, tainted)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._scan(mod, stmt.body, tainted)
            elif isinstance(stmt, ast.Try):
                for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                    yield from self._scan(mod, blk, tainted)
                for h in stmt.handlers:
                    yield from self._scan(mod, h.body, tainted)

    @staticmethod
    def _returns(stmts) -> bool:
        """Whether the block unconditionally RETURNS (``raise`` is
        exempt: an error path kills the job loudly)."""
        return bool(stmts) and isinstance(stmts[-1], ast.Return)


@register
class CollectiveOrderRule(Rule):
    """Two code paths reaching the same communicator with the same ops
    in different orders: should the predicate EVER disagree across
    ranks, rank A's first collective pairs with rank B's second."""

    name = "collective-order"
    family = "shardlint"
    summary = ("sibling code paths issue the same collectives in "
               "different orders")
    hint = ("normalize the order so every path reaching the "
            "communicator issues the identical sequence")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for node in _walk(mod.tree):
            if not isinstance(node, ast.If):
                continue
            a = _collective_seq(mod, node.body)
            b = _collective_seq(mod, node.orelse)
            if a and b and a != b and sorted(a) == sorted(b):
                yield self.finding(
                    mod, node,
                    f"if/else arms issue the same collectives in "
                    f"different orders: [{_ops(a)}] vs [{_ops(b)}] — "
                    f"should the predicate ever disagree across "
                    f"ranks, the orderings cross",
                )


@register
class UncheckedPermutationRule(Rule):
    """A malformed pair list does not deadlock the library routes — a
    destination with no incoming pair keeps garbage — and strands the
    device-initiated ``fused_permute`` on a flag that never arrives
    (until the spin timeout). ``comm.ring.check_permutation`` closes the
    gap; this rule makes routing every pair list through it a checked
    invariant. ``comm.fused.fused_permute`` and
    ``fused_permute_reference`` check their own pair list (``_dst_table``)
    and are sinks, not consumers; what is judged is a pair list reaching
    the raw C entry (``lib.fused_permute(x, out, dst, ...)``, the third
    positional) or another consumer (the ``perm``/``pairs`` keyword, else
    the second positional of ``(x, perm)``). A C entry's table is a device
    pointer the AST cannot follow back to its list: it passes when its
    function ran ``check_permutation`` or ``_dst_table``."""

    name = "unchecked-permutation"
    family = "shardlint"
    summary = ("fused_permute/ring_permute pair list built without "
               "ring.check_permutation")
    hint = ("bind the pair list to a name and run "
            "comm.ring.check_permutation(pairs, size) before the "
            "permute — a malformed permutation drops data or hangs")

    _CHECKERS = frozenset({"check_permutation", "_dst_table"})
    #: the Python entries that run ``_dst_table`` on their pair list
    _SINKS = frozenset({f"hpc_patterns_tpu_torch.comm.fused.{n}" for n in
                        ("fused_permute", "fused_permute_reference")})

    def _is_sink(self, mod: ModuleInfo, call: ast.Call) -> bool:
        name = _func_name(mod, call) or ""
        if name in self._SINKS:
            return True
        # fused.py's own calls of its checking entries
        return (isinstance(call.func, ast.Name)
                and Path(mod.path).as_posix().endswith("comm/fused.py")
                and f"hpc_patterns_tpu_torch.comm.fused.{name}"
                in self._SINKS)

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        checked: dict[ast.AST | None, set[str]] = {}
        permutes: list[tuple[ast.Call, str]] = []
        for node in _walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            base = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else _func_name(mod, node) or "").rsplit(".", 1)[-1]
            if base in self._CHECKERS:
                names = checked.setdefault(self._scope(mod, node), set())
                names.add("")  # the scope ran a check
                if node.args and isinstance(node.args[0], ast.Name):
                    names.add(node.args[0].id)
            elif base in _PERMUTE_CONSUMERS and not self._is_sink(mod, node):
                permutes.append((node, base))
        for call, base in permutes:
            perm = None
            for kw in call.keywords:
                if kw.arg in ("perm", "pairs"):
                    perm = kw.value
            if perm is None:
                n = len(call.args)
                i = 1 if n == 2 else 2
                perm = call.args[i] if i < n else None
            if perm is None:
                continue
            seen = checked.get(self._scope(mod, call), set())
            if isinstance(perm, ast.Name):
                if perm.id in seen:
                    continue
                msg = (f"pair list {perm.id!r} reaches {base} "
                       f"without a check_permutation in this scope")
            elif isinstance(perm, (ast.List, ast.Tuple, ast.ListComp,
                                   ast.GeneratorExp)):
                msg = (f"pair list built inline in the {base} call — "
                       "it can never have been check_permutation'd")
            elif "" in seen:
                continue
            else:
                msg = (f"{base}'s table comes from no check_permutation "
                       f"or _dst_table in this scope")
            yield self.finding(mod, call, msg)

    @staticmethod
    def _scope(mod: ModuleInfo, node: ast.AST) -> ast.AST | None:
        return _enclosing(mod, node, (ast.FunctionDef, ast.AsyncFunctionDef))


#: calls whose spec argument is a port spec tuple (models/sharding_util)
_SPEC_TAKERS = {"resolve_spec": 0, "to_ranks": 1, "from_ranks": 1,
                "rank_axes": 0, "shard_at": 1, "is_stacked": 1}
#: mesh declarations: a {axis: size} literal handed to one of these
_MESH_MAKERS = frozenset({"make_mesh", "logical_mesh", "make_hybrid_mesh"})


@register
class SpecMismatchRule(Rule):
    """Spec tuples inconsistent with the module they live in. A port
    spec is a tuple per tensor dim of None, an axis name, or a tuple of
    names (``models/sharding_util``): the tables ``*_specs``/``*_spec``
    functions return, and the spec argument of ``resolve_spec``,
    ``to_ranks``, ``from_ranks``, ``rank_axes``, ``shard_at``. Three
    checks: an axis named twice in one spec (a literal, or one variable
    twice); an axis absent from the mesh the SAME module declares
    (``make_mesh({...})``/``logical_mesh({...})`` literals; a module
    with none, or a non-literal one, is never judged); and a callable
    declared with ``in_specs``/``out_specs`` whose in-place argument's
    spec matches no output spec (the buffer cannot be written in its
    own layout; JAX's donated-sharding check)."""

    name = "spec-mismatch"
    family = "shardlint"
    summary = ("spec tuple inconsistent with the module's mesh axes or "
               "an in-place argument's output specs")
    hint = ("axis names in a spec must exist on the mesh and appear at "
            "most once; an argument written in place must share a spec "
            "with some output")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        declared = self._declared_axes(mod)
        for node, elts in self._specs(mod):
            axes = [self._axis(e) for e in elts]
            names = [a for a in axes if a is not None]
            seen: set[str] = set()
            for ax in names:
                if ax in seen:
                    yield self.finding(
                        mod, node,
                        f"axis {ax.lstrip('$')!r} appears twice in one "
                        f"spec — a dim sharded twice over one axis",
                    )
                    break
                seen.add(ax)
            literal = {a for a in names if not a.startswith("$")}
            if declared:
                unknown = sorted(literal - declared)
                if unknown:
                    yield self.finding(
                        mod, node,
                        f"spec axis(es) "
                        f"{', '.join(map(repr, unknown))} not among "
                        f"the mesh axes declared in this module "
                        f"({', '.join(map(repr, sorted(declared)))})",
                    )
        yield from self._inplace_specs(mod)

    @staticmethod
    def _axis(e: ast.AST) -> str | None:
        """An element's axis names, flattened to one key ("$v" for a
        variable); None for None."""
        if isinstance(e, ast.Constant):
            return e.value if isinstance(e.value, str) else None
        if isinstance(e, ast.Name):
            return f"${e.id}"
        return None

    def _specs(self, mod: ModuleInfo):
        """(anchor, flattened elements) of every spec tuple."""
        out = []

        def add(node, tup):
            elts = []
            for e in tup.elts:
                if isinstance(e, (ast.Tuple, ast.List)):
                    elts.extend(e.elts)
                else:
                    elts.append(e)
            if all(isinstance(e, (ast.Constant, ast.Name)) for e in elts):
                out.append((node, elts))

        for node in _walk(mod.tree):
            if isinstance(node, ast.Call):
                base = (_func_name(mod, node) or "").rsplit(".", 1)[-1]
                i = _SPEC_TAKERS.get(base)
                if i is not None and i < len(node.args) and isinstance(
                        node.args[i], ast.Tuple):
                    add(node, node.args[i])
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name.endswith(("_specs", "_spec")):
                for sub in _walk(node):
                    if isinstance(sub, ast.Dict):
                        for v in sub.values:
                            if isinstance(v, ast.Tuple):
                                add(v, v)
                    elif isinstance(sub, ast.Return) and isinstance(
                            sub.value, ast.Tuple):
                        add(sub.value, sub.value)
        return out

    def _declared_axes(self, mod: ModuleInfo) -> frozenset[str] | None:
        axes: set[str] = set()
        found = False
        for node in _walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            base = (_func_name(mod, node) or "").rsplit(".", 1)[-1]
            if base not in _MESH_MAKERS:
                continue
            if not node.args:
                return None
            shape = node.args[0]
            if not (isinstance(shape, ast.Dict) and all(
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                    for k in shape.keys)):
                return None
            axes.update(k.value for k in shape.keys)
            found = True
        return frozenset(axes) if found else None

    def _inplace_specs(self, mod: ModuleInfo) -> Iterable[Finding]:
        for fn in _functions(mod.tree):
            for dec in fn.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                kws = {kw.arg: kw.value for kw in dec.keywords}
                nums = kws.get("inplace_argnums")
                ins, outs = kws.get("in_specs"), kws.get("out_specs")
                if nums is None or ins is None or outs is None:
                    continue
                nums = [e.value for e in (
                    nums.elts if isinstance(nums, (ast.Tuple, ast.List))
                    else [nums]) if isinstance(e, ast.Constant)]
                in_specs = self._spec_list(ins)
                out_specs = self._spec_list(outs)
                if in_specs is None or out_specs is None:
                    continue
                out_sigs = {sig for _, sig in out_specs}
                for i in nums:
                    if i >= len(in_specs):
                        continue
                    node, sig = in_specs[i]
                    if sig not in out_sigs:
                        yield self.finding(
                            mod, node,
                            f"in-place arg {i}'s spec matches no "
                            f"out_spec of {fn.name!r} — the tensor "
                            f"cannot be written in its own layout",
                        )

    @staticmethod
    def _spec_list(node: ast.AST) -> list[tuple[ast.AST, tuple]] | None:
        if not isinstance(node, (ast.Tuple, ast.List)):
            return None
        out = []
        for e in node.elts:
            if not isinstance(e, ast.Tuple):
                return None
            sig = []
            for a in e.elts:
                if isinstance(a, ast.Constant) and (
                        a.value is None or isinstance(a.value, str)):
                    sig.append(a.value)
                else:
                    return None
            out.append((e, tuple(sig)))
        return out
