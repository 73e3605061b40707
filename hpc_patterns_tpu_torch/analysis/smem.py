"""Shared-memory budget of every kernel in ``csrc/`` (the counterpart of
``hpc_patterns_tpu/analysis/vmem.py``).

A Hopper CTA may hold at most 232448 bytes of shared memory when its
kernel opts in (``cudaFuncAttributeMaxDynamicSharedMemorySize``;
``cudaDevAttrMaxSharedMemoryPerBlockOptin`` on the H100;
``fused_mlp.cu``'s ``SMEM_MAX``). Past it a launch is refused on the card
and nowhere else. This module gives each kernel instantiation a number
before the code reaches the card:

- every instantiation the launchers make is found statically (the host
  functions are walked from the untemplated ones down, binding template
  parameters — ``D``, ``NWG``, ``MODE``, ``TK`` — from the explicit
  template arguments of each call, through the ``switch``/macro
  dispatch, as ``vmem.py`` binds model dims);
- its **static** bytes are the ``__shared__`` declarations of the kernel
  and of the device functions it calls (each variable once, laid out in
  declaration order at its alignment), with ``constexpr`` arithmetic
  evaluated (``Cfg<D, NWG>::bytes``, ``AG_SMEM``, ``H_SMEM``, ...);
- its **dynamic** bytes are what its launch asks for: the third
  ``<<<...>>>`` argument, a ``cudaLaunchKernelEx`` config's
  ``dynamicSmemBytes`` (through the ``Launch`` helper), or
  ``cudaLaunchCooperativeKernel``'s argument;
- a symbol it cannot bind (a runtime plan's ``P.smem``, a launch's
  ``n_chunks``) is NAMED in the row, never guessed: such a row's dynamic
  part is "runtime".

``--smem-report`` prints the table; the ``smem-budget`` rule
(``cuda_rules.py``) fires on a row whose bytes, all bound, exceed the
limit. On the card, ``chip_smoke.py`` phase ``analysis`` holds every row
against ``cudaFuncGetAttributes`` and the launchers' own requests, which
each library exports (``hpcpat_smem_rows``, ``csrc/smem_rows.cuh``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

from hpc_patterns_tpu_torch.analysis import csource as cs
from hpc_patterns_tpu_torch.analysis.csource import (
    Env,
    Function,
    Tok,
    Unbound,
    Unit,
)

#: the H100's per-block opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_LIMIT = 232448


@dataclass
class SharedVar:
    name: str
    func: str
    type: str
    bytes: int | None
    align: int
    line: int
    unbound: set[str] = field(default_factory=set)
    #: an ``extern __shared__`` array: no static bytes, but the static
    #: section ends on its alignment (the dynamic part starts there)
    extern: bool = False


@dataclass
class KernelRow:
    """One kernel instantiation's shared-memory budget."""

    kernel: str              # "flash_fwd_kernel<128, 2>"
    path: str
    line: int
    threads: int | None
    static_vars: list[SharedVar] = field(default_factory=list)
    #: the dynamic bytes of each launch site (int), or the names that
    #: stayed unbound there
    dynamic: list[int | set[str]] = field(default_factory=list)
    #: this instance's template bindings
    binds: dict = field(default_factory=dict)
    function: Function | None = None

    @property
    def static_bytes(self) -> int | None:
        """The variables laid out in order at their alignments; a
        non-empty static section is padded to 16 bytes, or to an extern
        array's larger alignment (where the dynamic part begins), as the
        compiler reports it."""
        off = 0
        end = 16
        for v in self.static_vars:
            if v.extern:
                end = max(end, v.align)
                continue
            if v.bytes is None:
                return None
            off = (off + v.align - 1) // v.align * v.align + v.bytes
        return (off + end - 1) // end * end if off else 0

    @property
    def static_unbound(self) -> set[str]:
        out: set[str] = set()
        for v in self.static_vars:
            out |= v.unbound
        return out

    @property
    def dynamic_bytes(self) -> int | None:
        """The launch's request when every site binds to one number."""
        vals = {d for d in self.dynamic if isinstance(d, int)}
        if len(vals) == 1 and all(isinstance(d, int) for d in self.dynamic):
            return vals.pop()
        return None

    @property
    def dynamic_unbound(self) -> set[str]:
        out: set[str] = set()
        if not self.dynamic:
            return {"<no launch found>"}
        for d in self.dynamic:
            if isinstance(d, set):
                out |= d
        vals = {d for d in self.dynamic if isinstance(d, int)}
        if len(vals) > 1:
            out.add("<launches differ: " + ", ".join(map(str, sorted(vals)))
                    + ">")
        return out

    @property
    def total_bytes(self) -> int | None:
        s, d = self.static_bytes, self.dynamic_bytes
        return None if s is None or d is None else s + d

    @property
    def key(self) -> str:
        return canonical(self.kernel)


def canonical(name: str) -> str:
    """A kernel name with every space and namespace qualifier removed (the
    libraries stringize their rows as written:
    ``dkv::dkv_kernel<128, true>``)."""
    return re.sub(r"[A-Za-z_]\w*::", "", "".join(name.split()))


# ---------------------------------------------------------------------------
# kernel references and the host walk
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelRef:
    fn_id: int
    label: str
    binds: tuple


class _Walker:
    def __init__(self, unit: Unit):
        self.unit = unit
        self.kernels = {id(f): f for f in unit.functions if f.is_kernel}
        self.rows: dict[str, KernelRow] = {}
        self.visited: set = set()

    # -- kernel references in a token list --------------------------------

    def kernel_at(self, toks: list[Tok], i: int, env: Env):
        """(KernelRef, next index) if a kernel name starts at ``i``."""
        name = toks[i].text
        j = i + 1
        while j + 1 < len(toks) and toks[j].text == "::":
            name += "::" + toks[j + 1].text
            j += 2
        base = name.rsplit("::", 1)[-1]
        cands = [f for f in self.kernels.values() if f.name == base]
        if not cands:
            return None, i + 1
        fn = cands[0]
        binds: dict = {}
        if fn.template is not None:
            if j >= len(toks) or toks[j].text != "<":
                return None, i + 1
            c = cs.match_angle(toks, j)
            args = cs.split_top(toks[j + 1:c])
            try:
                vals = [cs.eval_arg(a, env) for a in args]
            except Unbound:
                return None, c + 1
            binds = dict(zip(fn.template.names, vals))
            j = c + 1
        return self.ref(fn, binds), j

    def ref(self, fn: Function, binds: dict) -> KernelRef:
        if fn.template is not None:
            label = (f"{fn.name}<"
                     + ", ".join(cs.fmt_arg(binds[n])
                                 for n in fn.template.names) + ">")
        else:
            label = fn.name
        ref = KernelRef(id(fn), label, tuple(sorted(
            (k, str(v)) for k, v in binds.items())))
        if ref.label not in self.rows:
            threads = None
            if fn.launch_bounds:
                try:
                    threads = int(cs.evaluate(
                        fn.launch_bounds, Env(self.unit, fn.ns, binds)))
                except Unbound:
                    threads = None
            row = KernelRow(kernel=label, path=fn.file, line=fn.line,
                            threads=threads, binds=binds, function=fn)
            row.static_vars = static_shared(self.unit, fn, binds)
            self.rows[label] = row
        return ref

    def refs_in(self, toks: list[Tok], env: Env, kvars: dict) -> set:
        out = set()
        i = 0
        while i < len(toks):
            t = toks[i]
            if t.kind == "id":
                if t.text in kvars and not (i > 0 and toks[i - 1].text in (
                        ".", "->")):
                    out |= kvars[t.text]
                    i += 1
                    continue
                ref, j = self.kernel_at(toks, i, env)
                if ref is not None:
                    out.add(ref)
                    i = j
                    continue
                # a call to a host function returning kernel pointers
                f = self.host_fn(t.text)
                if f is not None and i + 1 < len(toks) and \
                        toks[i + 1].text == "(":
                    out |= self.refs_in(f.body, Env(self.unit, f.ns), {})
            i += 1
        return out

    def host_fn(self, name: str) -> Function | None:
        for f in self.unit.funcs_named(name):
            if not (f.quals & {"__device__", "__global__", "lambda"}):
                return f
        return None

    # -- the walk ----------------------------------------------------------

    def walk(self, fn: Function, env: Env, kvars: dict):
        key = (id(fn), tuple(sorted((k, str(v)) for k, v in
                                    env.vars.items())),
               tuple(sorted((k, tuple(sorted(r.label for r in v)))
                            for k, v in kvars.items())))
        if key in self.visited:
            return
        self.visited.add(key)
        toks = fn.body
        local = env.child()
        kv = dict(kvars)
        # the Launch-helper config objects: name -> the ctor arg env
        cfgs: dict[str, tuple[list[Tok], Env]] = {}
        i = 0
        while i < len(toks):
            t = toks[i]
            s = t.text
            # local declarations: `using C = ...;`, `T name = expr;`
            if s == "using" and i + 3 < len(toks) and toks[i + 2].text == "=":
                e = i
                while toks[e].text != ";":
                    e += 1
                al = toks[i + 3:e]
                local.vars[toks[i + 1].text] = cs._Lazy(
                    (lambda al=al, env=local: cs.eval_type(al, env)))
                i = e + 1
                continue
            if t.kind == "id" and i + 2 < len(toks) and \
                    toks[i + 1].kind == "id" and toks[i + 2].text == "(" and \
                    s in self.unit.structs:
                # `Launch l(grid, cluster, smem, stream);`
                c = cs.match_close(toks, i + 2)
                cfgs[toks[i + 1].text] = (toks[i + 3:c], local)
                i = c + 1
                continue
            if t.kind == "id" and i + 2 < len(toks) and \
                    toks[i + 1].text == "=" and toks[i + 2].text != "=":
                # name = expr;  (a kernel pointer or a local constant)
                e = i + 2
                while e < len(toks) and toks[e].text != ";":
                    if toks[e].text in ("(", "[", "{"):
                        e = cs.match_close(toks, e)
                    e += 1
                rhs = toks[i + 2:e]
                refs = self.refs_in(rhs, local, kv)
                if refs:
                    kv[s] = kv.get(s, set()) | refs if (
                        i > 0 and toks[i - 1].kind != "id") else refs
                else:
                    local.vars[s] = cs._Lazy(
                        (lambda rhs=rhs, env=local: cs.evaluate(rhs, env)))
                i += 2
                continue
            if s == "<<<":
                # kernel<...><<<grid, block, smem, stream>>>
                k = i - 1
                while k > 0 and toks[k].text not in (";", "{", "}", ")"):
                    k -= 1
                start = k + 1 if toks[k].text in (";", "{", "}", ")") else k
                refs = self.refs_in(toks[start:i], local, kv)
                e = i + 1
                depth = 0
                while toks[e].text != ">>>" or depth:
                    if toks[e].text in ("(", "["):
                        depth += 1
                    elif toks[e].text in (")", "]"):
                        depth -= 1
                    e += 1
                cfg = cs.split_top(toks[i + 1:e])
                smem = cfg[2] if len(cfg) > 2 else None
                self.record(refs, smem, local)
                i = e + 1
                continue
            if s in ("cudaLaunchKernelEx", "cudaLaunchCooperativeKernel") \
                    and i + 1 < len(toks) and toks[i + 1].text == "(":
                c = cs.match_close(toks, i + 1)
                args = cs.split_top(toks[i + 2:c])
                if s == "cudaLaunchKernelEx" and len(args) >= 2:
                    refs = self.refs_in(args[1], local, kv)
                    smem, senv = self.config_smem(args[0], toks[:i], cfgs,
                                                  local)
                    self.record(refs, smem, senv)
                elif len(args) >= 5:
                    refs = self.refs_in(args[0], local, kv)
                    self.record(refs, args[4], local)
                i = c + 1
                continue
            if t.kind == "id" and i + 1 < len(toks):
                # a call into another host function (with template args)
                j = i + 1
                while j + 1 < len(toks) and toks[j].text == "::":
                    s += "::" + toks[j + 1].text
                    j += 2
                f = self.host_fn(s)
                targs = None
                if f is not None and toks[j].text == "<" and \
                        f.template is not None:
                    c = cs.match_angle(toks, j)
                    targs = cs.split_top(toks[j + 1:c])
                    j = c + 1
                if f is not None and j < len(toks) and toks[j].text == "(":
                    c = cs.match_close(toks, j)
                    self.call(f, targs, cs.split_top(toks[j + 1:c]), local,
                              kv)
                    i = j + 1
                    continue
            i += 1

    def call(self, f: Function, targs, args, env: Env, kv: dict):
        binds: dict = {}
        if f.template is not None and targs is not None:
            for nm, kind, a in zip(f.template.names, f.template.kinds,
                                   targs):
                try:
                    binds[nm] = cs.eval_arg(a, env)
                except Unbound:
                    pass
        callee = Env(self.unit, f.ns, binds)
        ckv: dict = {}
        for (pname, _), a in zip(f.params, args):
            refs = self.refs_in(a, env, kv)
            if refs:
                ckv[pname] = refs
            else:
                callee.vars[pname] = cs._Lazy(
                    (lambda a=a, env=env: cs.evaluate(a, env)))
        self.walk(f, callee, ckv)

    def config_smem(self, cfg_expr, before, cfgs, env):
        """The dynamic bytes of a ``cudaLaunchKernelEx`` config: a
        ``Launch`` helper's ctor argument, or ``cfg.dynamicSmemBytes =
        expr`` earlier in the body."""
        names = [t.text for t in cfg_expr if t.kind == "id"]
        for nm in names:
            if nm in cfgs:
                ctor_args, cenv = cfgs[nm]
                obj = cs.split_top(ctor_args)
                for sts in self.unit.structs.values():
                    for st in sts:
                        if st.ctor is None:
                            continue
                        body = st.ctor.body
                        for k in range(len(body) - 3):
                            if body[k + 1].text == "dynamicSmemBytes" and \
                                    body[k + 2].text == "=":
                                src = body[k + 3].text
                                idx = [p for p, _ in st.ctor.params]
                                if src in idx and idx.index(src) < len(obj):
                                    return obj[idx.index(src)], cenv
        # cfg.dynamicSmemBytes = expr;
        for k in range(len(before) - 1, 2, -1):
            if before[k].text == "=" and before[k - 1].text == \
                    "dynamicSmemBytes":
                e = k + 1
                while before[e].text != ";":
                    e += 1
                return before[k + 1:e], env
        return None, env

    def record(self, refs, smem, env):
        for r in refs:
            row = self.rows[r.label]
            if smem is None:
                row.dynamic.append(0)
                continue
            try:
                v = cs.evaluate(smem, env)
                row.dynamic.append(int(v))
            except Unbound as e:
                row.dynamic.append({cs.text_of(smem)} if not e.names else
                                   {f"{cs.text_of(smem)} ({', '.join(sorted(e.names))})"})


# ---------------------------------------------------------------------------
# static __shared__ declarations
# ---------------------------------------------------------------------------


def _callees(unit: Unit, fn: Function, env: Env, seen: set, depth=0):
    """(function, env) of every device function ``fn`` calls, once."""
    if depth > 12:
        return
    toks = fn.body
    for i, t in enumerate(toks):
        if t.kind != "id" or i + 1 >= len(toks):
            continue
        name = t.text
        j = i + 1
        qual = ""
        k = i
        while k >= 2 and toks[k - 1].text == "::":
            qual = toks[k - 2].text + "::" + qual
            k -= 2
        targs = None
        if toks[j].text == "<":
            c = cs.match_angle(toks, j)
            if c < 0:
                continue
            targs = cs.split_top(toks[j + 1:c])
            j = c + 1
        if j >= len(toks) or toks[j].text != "(":
            continue
        for f in unit.funcs_named(qual + name if qual else name):
            if not (f.quals & {"__device__"}) or f is fn:
                continue
            binds = {}
            if f.template is not None and targs is not None:
                for nm, a in zip(f.template.names, targs):
                    try:
                        binds[nm] = cs.eval_arg(a, env)
                    except Unbound:
                        pass
            key = (id(f), tuple(sorted((k2, str(v)) for k2, v in
                                       binds.items())))
            if key in seen:
                continue
            seen.add(key)
            fenv = Env(unit, f.ns, binds)
            yield f, fenv
            yield from _callees(unit, f, fenv, seen, depth + 1)


def _shared_decls(unit: Unit, fn: Function, env: Env) -> list[SharedVar]:
    out = []
    toks = fn.body
    local = env.child()
    for i, t in enumerate(toks):
        if t.text == "using" and i + 3 < len(toks) and \
                toks[i + 2].text == "=":
            e = i
            while toks[e].text != ";":
                e += 1
            al = toks[i + 3:e]
            local.vars[toks[i + 1].text] = cs._Lazy(
                (lambda al=al, env=local: cs.eval_type(al, env)))
        if t.text == "constexpr" and i + 3 < len(toks):
            # constexpr int N = L::N, CG = ...;
            e = i
            while toks[e].text != ";":
                e += 1
            for part in cs.split_top(toks[i + 1:e]):
                eq = next((m for m, x in enumerate(part) if x.text == "="),
                          None)
                if eq is not None and part[eq - 1].kind == "id":
                    expr = part[eq + 1:]
                    local.vars[part[eq - 1].text] = cs._Lazy(
                        (lambda ex=expr, env=local: cs.evaluate(ex, env)))
        if t.text != "__shared__":
            continue
        extern = i > 0 and toks[i - 1].text == "extern"
        e = i + 1
        while toks[e].text != ";":
            e += 1
        decl = toks[i + 1:e]
        align = None
        if decl and decl[0].text == "__align__":
            c = cs.match_close(decl, 1)
            try:
                align = int(cs.evaluate(decl[2:c], local))
            except Unbound:
                align = None
            decl = decl[c + 1:]
        # the type: identifiers up to the first declarator
        k = 0
        while k + 1 < len(decl) and decl[k].kind == "id" and \
                decl[k + 1].kind == "id":
            k += 1
        type_name = " ".join(x.text for x in decl[:k])
        for part in cs.split_top(decl[k:]):
            if not part:
                continue
            name = part[0].text
            if extern:
                out.append(SharedVar(name=name, func=fn.name,
                                     type=type_name, bytes=0,
                                     align=align or min(cs.SCALAR_ALIGN.get(
                                         type_name, cs.SCALAR_SIZES.get(
                                             type_name, 4)), 16),
                                     line=t.line, extern=True))
                continue
            dims = []
            m = 1
            while m < len(part) and part[m].text == "[":
                c = cs.match_close(part, m)
                dims.append(part[m + 1:c])
                m = c + 1
            unbound: set[str] = set()
            try:
                size = cs.sizeof(cs.eval_type(
                    [x for x in decl[:k]], local)) if k else None
            except Unbound:
                size = cs.SCALAR_SIZES.get(type_name)
            if size is None:
                unbound.add(f"sizeof({type_name})")
            total = size
            for d in dims:
                try:
                    n = int(cs.evaluate(d, local))
                    total = None if total is None else total * n
                except Unbound as ex:
                    unbound |= ex.names
                    total = None
            nat = min(cs.SCALAR_ALIGN.get(type_name, size or 4), 16)
            out.append(SharedVar(name=name, func=fn.name, type=type_name,
                                 bytes=total if not unbound else None,
                                 align=align or nat, line=t.line,
                                 unbound=unbound))
    return out


def static_shared(unit: Unit, fn: Function, binds: dict) -> list[SharedVar]:
    env = Env(unit, fn.ns, binds)
    out = _shared_decls(unit, fn, env)
    for f, fenv in _callees(unit, fn, env, set()):
        out.extend(_shared_decls(unit, f, fenv))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


_CACHE: dict[tuple[str, int], list[KernelRow]] = {}


def estimate_unit(path: str | Path) -> list[KernelRow]:
    """Every kernel instantiation of one ``.cu`` (with its headers)."""
    path = Path(path)
    key = (str(path), hash(tuple(
        p.read_text() for p in [path, *sorted(path.parent.glob("*.cuh"))])))
    if key in _CACHE:
        return _CACHE[key]
    unit = cs.parse_unit(path)
    w = _Walker(unit)
    for f in unit.functions:
        if f.template is None and not (
                f.quals & {"__device__", "__global__", "lambda"}):
            w.walk(f, Env(unit, f.ns), {})
    # a kernel no launcher instantiates still gets its row (untemplated)
    for f in unit.functions:
        if f.is_kernel and f.template is None:
            w.ref(f, {})
    rows = sorted(w.rows.values(), key=lambda r: (r.line, r.kernel))
    _CACHE[key] = rows
    return rows


def estimate_paths(paths) -> list[KernelRow]:
    """Rows for every ``.cu`` under ``paths`` (the package's ``csrc/``
    when a path is the package itself)."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".cu":
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.cu")))
    rows: list[KernelRow] = []
    for f in files:
        rows.extend(estimate_unit(f))
    return rows


def format_smem_table(rows: list[KernelRow],
                      root: str | Path | None = None) -> str:
    """The ``--smem-report`` table: per instantiation, static + dynamic
    bytes against the opt-in limit, every unbound symbol named."""
    lines = [f"{'kernel':<52} {'site':<30} {'static':>7} {'dynamic':>8} "
             f"{'total':>7} {'frac':>5}  notes"]
    for r in rows:
        path = r.path
        if root is not None:
            try:
                path = str(Path(r.path).relative_to(root))
            except ValueError:
                pass
        site = f"{path}:{r.line}"
        st = r.static_bytes
        dy = r.dynamic_bytes
        tot = r.total_bytes
        notes = []
        if r.static_unbound:
            notes.append("static unbound: "
                         + ", ".join(sorted(r.static_unbound)))
        if dy is None:
            notes.append("dynamic runtime: "
                         + ", ".join(sorted(r.dynamic_unbound)))
        frac = f"{tot / SMEM_LIMIT:5.2f}" if tot is not None else "    -"
        flag = " OVER" if tot is not None and tot > SMEM_LIMIT else ""
        lines.append(
            f"{r.kernel[:52]:<52} {site[-30:]:<30} "
            f"{st if st is not None else '?':>7} "
            f"{dy if dy is not None else 'runtime':>8} "
            f"{tot if tot is not None else '-':>7} {frac}{flag}  "
            + "; ".join(notes))
    if not rows:
        lines.append("(no kernels found)")
    return "\n".join(lines)


def smem_summary(rows: list[KernelRow]) -> dict:
    """JSON-able rollup for the ``kind=analysis`` RunLog record."""
    out = []
    n_over = 0
    for r in rows:
        tot = r.total_bytes
        over = tot is not None and tot > SMEM_LIMIT
        n_over += over
        out.append({"kernel": r.kernel, "line": r.line,
                    "static": r.static_bytes, "dynamic": r.dynamic_bytes,
                    "bytes": tot, "limit": SMEM_LIMIT, "over": over,
                    "unbound": sorted(r.static_unbound
                                      | (r.dynamic_unbound
                                         if r.dynamic_bytes is None
                                         else set()))})
    return {"kernels": len(rows), "over_limit": n_over, "rows": out}
