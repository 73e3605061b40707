"""cudalint: the in-kernel barrier, flag and shared-memory rules over
``csrc/`` (the counterpart of ``hpc_patterns_tpu/analysis/pallas_rules.py``).

The chip-only bug class moves with the port: a Pallas semaphore ledger
becomes the Hopper mbarriers of ``hopper.cuh`` (``mbar_init``/
``expect_tx``/``arrive``/``wait``, the TMA and bulk copies that complete
on them, ``mbar_arrive_cluster``), the release/acquire flags of
``fused_ring.cu`` (``st_release``/``add_release``/``ld_acquire`` and the
``cta_*`` spins) and ``migration_dma.cu``'s last-arrival acquire, and the
cp.async ring of the all-gather matmul. None of it runs on the CPU: the
plain versions carry no barrier at all, so a miscounted arrival or a ring
slot refilled early is invisible to every test here.

This is a static ledger, not a compiler: the kernels are read through
``csource.py``'s tokenizer, every lambda and device function a kernel
calls is walked in place (with its arguments bound), and each
instantiation's template arguments prune its ``if constexpr`` and
template-constant branches. Each protocol call becomes an event with its
barrier or flag family (``ring_bar(bars, K_FULL, s)`` -> ``ring_bar:K_FULL``,
``&full[k & 1]`` -> ``full``, a flag pointer's root such as ``a.flags``),
the guards around it and the loops it sits in. The rules:

- ``mbar-balance``: for each arrival site, the threads that reach it
  (every thread of the block enumerated, its const thread-derived locals
  evaluated; grouped by the barrier's thread-dependent index, as the
  warpgroups' own ``pfull_bar(bars, w)``) against the barrier's init
  count, under each value of a bounded runtime count such as ``n_live``;
  ``expect_tx`` bytes against the bytes of the bulk copies that complete
  on that barrier in the same region, where both are constant or the
  same expression (a TMA box is set on the host: not compared); a
  barrier used before a CTA barrier follows its init; a barrier waited on
  that nothing arrives on or fills. A condition on a non-const local is
  read as uniform across the block (a path), so the ledger checks the
  arrivals of one path: warpgroups that take different paths (the causal
  catch-up loops) must each give their barrier the same arrivals;
- ``ring-slot-reuse``: a copy into a ring slot (its completion barrier
  varies with the loop) with no wait on another barrier (the slot's
  empty barrier) before it in that loop's body; a FIFO store
  (``st_fifo``) with no credit acquire before it; a cp.async stage
  issue or fill with no ``__syncthreads()`` before it;
- ``flag-balance``: a release (``st_release``, ``add_release``,
  ``red_release``, ``atom_acq_rel``) with no fence or block barrier
  before it on its path, and a flag family written by a release that no
  acquire (``ld_acquire``, ``atom_acq_rel``, the ``cta_*`` spins) reads;
- ``smem-budget``: a kernel instantiation whose shared memory, every
  symbol bound, exceeds the H100's 232448-byte opt-in limit
  (``smem.py``).

A construct the walk cannot order — a barrier expression it cannot name,
a thread-dependent guard it cannot evaluate, an init count with an
unbounded runtime symbol — makes the kernel ABSTAIN (no findings from
it, never a guess); :func:`kernel_report` counts each kernel as analyzed
or abstained. JAX's ``kernel-dtype-cast`` has no counterpart: nvcc
type-checks every store, so a widened accumulator stored into a narrower
pointer is a conversion the compiler defines, not a hazard interpret
mode forgives (the README's port section says so); and
``collective-id-collision`` has none either (no kernel here takes a
collective id: each launch's flags and counters are its own arguments).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable

from hpc_patterns_tpu_torch.analysis import csource as cs
from hpc_patterns_tpu_torch.analysis import smem as smem_mod
from hpc_patterns_tpu_torch.analysis.core import (
    AnalysisConfig,
    Finding,
    ModuleInfo,
    Rule,
    register,
)
from hpc_patterns_tpu_torch.analysis.csource import Env, Function, Tok, Unbound

# -- the protocol vocabulary -------------------------------------------------

_INIT = "mbar_init"
_ARRIVE = "mbar_arrive"
_EXPECT = "mbar_expect_tx"
_RARRIVE = "mbar_arrive_cluster"
_WAITS = {"mbar_wait", "mbar_wait_cluster"}
#: copies that complete on a barrier: name -> index of the bytes argument
#: (None: a TMA box, set on the host)
_COPIES = {"tma_load": None, "tma_load_2d": None, "bulk_load": 2,
           "bulk_copy_to_peer": 2}
_BLOCK_SYNCS = {"__syncthreads", "cluster_sync", "cluster_sync_diverged"}
_FENCES = {"__threadfence", "__threadfence_system"}
_RELEASES = {"st_release", "add_release", "red_release", "atom_acq_rel"}
_CREDITS = {"st_relaxed"}
_FIFO = {"st_fifo"}
#: helpers the walk does not enter (their protocol is the call itself)
_OPAQUE = (set(_COPIES) | {_INIT, _ARRIVE, _EXPECT, _RARRIVE} | _WAITS
           | _RELEASES | {"ld_acquire"} | _FIFO | {"cp_async16", "mapa",
                                                   "smem_addr"})

_DEPTH_CAP = 10


class Abstain(Exception):
    """The walk met a construct it cannot order soundly."""


@dataclass
class Loop:
    id: int
    variant: set[str]
    line: int


@dataclass
class Event:
    kind: str              # init arrive expect rarrive wait copy sync ...
    name: str              # the call's name
    line: int
    args: list[list[Tok]]
    env: Env
    guards: list[tuple[list[Tok], bool, Env]]
    loops: list[Loop]
    seq: int
    family: str | None = None
    index: list[list[Tok]] = field(default_factory=list)
    index_env: Env | None = None
    names: set[str] = field(default_factory=set)
    remote: bool = False


@dataclass
class KernelLedger:
    kernel: str
    path: str
    line: int
    threads: int | None
    events: list[Event] = field(default_factory=list)
    status: str = "analyzed"      # or "abstained"
    reason: str = ""
    findings: list[tuple[str, int, str]] = field(default_factory=list)

    @property
    def protocol(self) -> bool:
        return any(e.kind not in ("sync", "fence") for e in self.events)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _builtins() -> dict:
    return {
        "__shfl_sync": lambda ev, a: ev(a[1]),
        "min": lambda ev, a: min(ev(a[0]), ev(a[1])),
        "max": lambda ev, a: max(ev(a[0]), ev(a[1])),
    }


class _Walk:
    def __init__(self, unit: cs.Unit, kernel: Function, binds: dict,
                 threads: int | None):
        self.unit = unit
        self.events: list[Event] = []
        self.seq = 0
        self.threads = threads
        env = Env(unit, kernel.ns, dict(binds))
        env.cache = False
        env.calls = _builtins()
        env.stamp = lambda: _TID[0]
        env.vars["threadIdx"] = cs._Lazy(lambda: {"x": _TID[0]})
        env.vars["blockDim"] = {"x": threads}
        self.root = env
        #: name -> (tokens, env) of every local declaration (pointer roots)
        self.decls: dict[str, tuple[list[Tok], Env]] = {}
        self.kernel = kernel

    # -- helpers ------------------------------------------------------------

    def event(self, kind, name, line, args, env, guards, loops, **kw):
        self.seq += 1
        ev = Event(kind=kind, name=name, line=line, args=args, env=env,
                   guards=list(guards), loops=list(loops), seq=self.seq,
                   **kw)
        self.events.append(ev)
        return ev

    def lookup_fn(self, name: str, method: bool) -> Function | None:
        base = name.rsplit("::", 1)[-1]
        for f in self.unit.functions:
            if f.name != base:
                continue
            if method and "method" in f.quals:
                return f
            if not method and (f.quals & {"__device__"}) and \
                    "method" not in f.quals and not f.is_kernel:
                return f
        return None

    # -- statements ---------------------------------------------------------

    def walk_fn(self, fn: Function, env: Env, guards, loops, depth):
        if depth > _DEPTH_CAP:
            raise Abstain(f"call depth past {_DEPTH_CAP} at {fn.name}")
        self.block(cs.parse_block(fn.body), env, guards, loops, depth)

    def block(self, stmts, env, guards, loops, depth):
        for st in stmts:
            self.stmt(st, env, guards, loops, depth)

    def stmt(self, st: cs.Stmt, env: Env, guards, loops, depth):
        k = st.kind
        if k in ("simple", "return"):
            self.simple(st.toks, env, guards, loops, depth)
        elif k == "block":
            self.block(st.body, env.child(), guards, loops, depth)
        elif k == "if":
            self.expr_calls(st.toks, env, guards, loops, depth)
            val = _const(st.toks, env)
            if val is True:
                self.block(st.body, env.child(), guards, loops, depth)
            elif val is False:
                self.block(st.orelse, env.child(), guards, loops, depth)
            else:
                self.block(st.body, env.child(),
                           guards + [(st.toks, True, env)], loops, depth)
                self.block(st.orelse, env.child(),
                           guards + [(st.toks, False, env)], loops, depth)
        elif k in ("for", "while", "do"):
            inner = env.child()
            if k == "for":
                self.simple(st.init, inner, guards, loops, depth)
            loop = Loop(id=id(st), variant=_assigned(st), line=st.line)
            lp = loops + [loop]
            self.expr_calls(st.toks, inner, guards, lp, depth)
            self.block(st.body, inner.child(), guards, lp, depth)
            if k == "for":
                self.expr_calls(st.step, inner, guards, lp, depth)
        elif k == "switch":
            self.expr_calls(st.toks, env, guards, loops, depth)
            self.block(st.body, env.child(), guards, loops, depth)

    def simple(self, toks, env: Env, guards, loops, depth):
        if not toks:
            return
        # lambdas defined here: kept on the env, walked where called
        for lam in cs.lambdas_in(toks, self.kernel):
            env.vars.setdefault("__lambdas__", {})
            env.vars["__lambdas__"] = dict(env.vars["__lambdas__"])
            env.vars["__lambdas__"][lam.name] = (lam, env)
        if toks[0].text == "auto" and len(toks) > 3 and toks[3].text == "[":
            return
        self.declare(toks, env)
        self.expr_calls(toks, env, guards, loops, depth)

    def declare(self, toks, env: Env):
        """``[const] T a = e1, b = e2;`` and ``T x(args);``: bind the
        names (numeric only when const, as the roots of pointers
        always)."""
        texts = [t.text for t in toks]
        if "=" not in texts:
            return
        eq0 = texts.index("=")
        if eq0 < 1 or toks[eq0 - 1].kind != "id":
            return
        is_decl = eq0 >= 2 and (toks[eq0 - 2].kind == "id"
                                or toks[eq0 - 2].text in ("*", "&", ">"))
        if not is_decl:
            return  # a plain assignment: the walk binds declarations only
        const = "const" in texts[:eq0] or "constexpr" in texts[:eq0]
        for part in cs.split_top(toks):
            pt = [t.text for t in part]
            if "=" not in pt:
                continue
            e = pt.index("=")
            if e < 1 or part[e - 1].kind != "id":
                continue
            name = part[e - 1].text
            expr = part[e + 1:]
            self.decls[name] = (expr, env)
            if const:
                env.vars[name] = cs._Lazy(
                    (lambda ex=expr, en=env: cs.evaluate(ex, en)))
            else:
                env.vars[name] = cs._Lazy(_raise_runtime(name))

    def expr_calls(self, toks, env: Env, guards, loops, depth):
        """Every call in ``toks``, inner calls (arguments) first."""
        i = 0
        n = len(toks)
        while i < n:
            t = toks[i]
            if t.kind == "str" and i > 0 and toks[i - 1].text in (
                    "(", "volatile"):
                self.asm(t.text, toks, i, env, guards, loops)
                i += 1
                continue
            if t.kind != "id":
                i += 1
                continue
            name = t.text
            j = i + 1
            while j + 1 < n and toks[j].text == "::":
                name += "::" + toks[j + 1].text
                j += 2
            targs = None
            if j < n and toks[j].text == "<" and name not in (
                    "static_cast", "reinterpret_cast", "const_cast"):
                c = cs.match_angle(toks, j)
                if c > 0 and c + 1 < n and toks[c + 1].text == "(":
                    targs = cs.split_top(toks[j + 1:c])
                    j = c + 1
            if j >= n or toks[j].text != "(":
                i += 1
                continue
            c = cs.match_close(toks, j)
            args = cs.split_top(toks[j + 1:c])
            method = i > 0 and toks[i - 1].text in (".", "->")
            # arguments first (their calls run before this one)
            for a in args:
                self.expr_calls(a, env, guards, loops, depth)
            self.call(name, targs, args, method, t.line, env, guards, loops,
                      depth)
            i = c + 1

    def asm(self, text, toks, i, env, guards, loops):
        if "fence.mbarrier_init" in text:
            self.event("sync", "fence.mbarrier_init", toks[i].line, [], env,
                       guards, loops)
        elif "st.relaxed" in text:
            # an inline credit: st.relaxed ... [flag]
            args = cs.split_top(_asm_operands(toks, i))
            self.event("credit", "st.relaxed", toks[i].line, args, env,
                       guards, loops,
                       family=self.root_of(args[0] if args else [], env))

    def call(self, name, targs, args, method, line, env, guards, loops,
             depth):
        base = name.rsplit("::", 1)[-1]
        lam = env.lookup("__lambdas__").get(base) if _has(
            env, "__lambdas__") else None
        if base == _INIT:
            fam, idx = self.family(args[0], env)
            self.event("init", base, line, args, env, guards, loops,
                       family=fam, index=idx, index_env=env)
        elif base in (_ARRIVE, _EXPECT):
            fam, idx = self.family(args[0], env)
            self.event("arrive" if base == _ARRIVE else "expect", base, line,
                       args, env, guards, loops, family=fam, index=idx,
                       index_env=env)
        elif base == _RARRIVE:
            fam, idx = self.family(args[0], env)
            self.event("rarrive", base, line, args, env, guards, loops,
                       family=fam, index=idx, index_env=env)
        elif base in _WAITS:
            fam, idx = self.family(args[0], env)
            self.event("wait", base, line, args, env, guards, loops,
                       family=fam, index=idx, index_env=env)
        elif base in _COPIES:
            fam, idx = self.family(args[-1], env)
            ev = self.event("copy", base, line, args, env, guards, loops,
                            family=fam, index=idx, index_env=env)
            ev.names = self.expr_names(args[-1], env)
            ev.remote = any(t.text == "mapa" for t in args[-1])
        elif base in _BLOCK_SYNCS:
            self.event("sync", base, line, args, env, guards, loops)
        elif base in _FENCES:
            self.event("fence", base, line, args, env, guards, loops)
        elif base in _RELEASES and not method:
            fam = self.root_of(args[0], env) if args else None
            self.event("release", base, line, args, env, guards, loops,
                       family=fam)
            if base == "atom_acq_rel":
                self.event("acquire", base, line, args, env, guards, loops,
                           family=fam)
        elif base in _FIFO:
            self.event("fifo", base, line, args, env, guards, loops)
        elif base == "cp_async16":
            self.event("stage", base, line, args, env, guards, loops)
        if base in ("ld_acquire",):
            fam = self.root_of(args[0], env) if args else None
            self.event("acquire", base, line, args, env, guards, loops,
                       family=fam)
        if base in ("cta_wait", "cta_spin", "cta_wait_ge"):
            fam = self.root_of(args[0], env) if args else None
            self.event("acquire", base, line, args, env, guards, loops,
                       family=fam)
        if base in _CREDITS:
            fam = self.root_of(args[0], env) if args else None
            self.event("credit", base, line, args, env, guards, loops,
                       family=fam)
        if base == "fill" and method:
            self.event("stage", base, line, args, env, guards, loops)
        if base in _OPAQUE:
            return
        # walk into a lambda or a device function
        if lam is not None:
            fn, lenv = lam
            callee = lenv.child()
        else:
            fn = self.lookup_fn(name, method)
            if fn is None:
                return
            binds = {}
            if fn.template is not None and targs is not None:
                for nm, a in zip(fn.template.names, targs):
                    try:
                        binds[nm] = cs.eval_arg(a, env)
                    except Unbound:
                        pass
            callee = Env(self.unit, fn.ns, binds)
            callee.cache = False
            callee.calls = env.calls
            callee.stamp = env.stamp
            callee.vars["threadIdx"] = self.root.vars["threadIdx"]
            callee.vars["blockDim"] = self.root.vars["blockDim"]
        for (pname, _), a in zip(fn.params, args):
            callee.vars[pname] = cs._Lazy(
                (lambda a=a, en=env: cs.evaluate(a, en)))
            self.decls[f"{id(callee)}:{pname}"] = (a, env)
        callee.vars["__params__"] = {p: (a, env) for (p, _), a in
                                     zip(fn.params, args)}
        self.walk_fn(fn, callee, guards, loops, depth + 1)

    # -- families -------------------------------------------------------------

    def family(self, toks: list[Tok], env: Env, depth=0):
        """(family, index expressions) of a barrier expression."""
        toks = _strip(toks)
        if not toks or depth > 8:
            raise Abstain("empty barrier expression")
        head = toks[0]
        # mapa(bar, rank): the barrier in a peer CTA
        if head.text == "mapa" and len(toks) > 1 and toks[1].text == "(":
            args = cs.split_top(toks[2:cs.match_close(toks, 1)])
            return self.family(args[0], env, depth + 1)
        if head.text == "&" and len(toks) > 1:
            return self.family(toks[1:], env, depth + 1)
        if head.kind == "id" and len(toks) > 1 and toks[1].text == "(":
            c = cs.match_close(toks, 1)
            args = cs.split_top(toks[2:c])
            # the base address is the first argument; enum constants name
            # the ring, the rest index it
            fam = head.text
            idx = []
            for a in args[1:]:
                if len(a) == 1 and a[0].kind == "id" and a[0].text.isupper():
                    fam += ":" + a[0].text
                else:
                    idx.append(a)
            return fam, idx
        if head.kind == "id" and len(toks) > 1 and toks[1].text == "[":
            c = cs.match_close(toks, 1)
            return head.text, [toks[2:c]]
        if head.kind == "id" and len(toks) == 1:
            # a local alias (`full = full_bar(bars, pos.s)`), a parameter
            # bound at the call, or the base barrier itself
            params = env.lookup("__params__") if _has(env, "__params__") \
                else {}
            if head.text in params:
                a, aenv = params[head.text]
                return self.family(a, aenv, depth + 1)
            d = self.decls.get(head.text)
            if d is not None and d[0]:
                try:
                    return self.family(d[0], d[1], depth + 1)
                except Abstain:
                    pass
            return head.text, []
        raise Abstain(f"barrier expression '{cs.text_of(toks)}'")

    def root_of(self, toks: list[Tok], env: Env, depth=0) -> str | None:
        """The flag memory a pointer expression points into: its first
        operand's root, through local pointers and bound parameters."""
        toks = _strip(toks)
        if not toks or depth > 8:
            return None
        # the first operand of a + / - chain
        first: list[Tok] = []
        d = 0
        for t in toks:
            if t.text in ("(", "["):
                d += 1
            elif t.text in (")", "]"):
                d -= 1
            elif t.text in ("+", "-") and d == 0 and first:
                break
            first.append(t)
        first = _strip(first)
        if not first:
            return None
        if first[0].kind == "id" and len(first) == 1:
            nm = first[0].text
            params = env.lookup("__params__") if _has(env, "__params__") \
                else {}
            if nm in params:
                a, aenv = params[nm]
                return self.root_of(a, aenv, depth + 1)
            dd = self.decls.get(nm)
            if dd is not None:
                return self.root_of(dd[0], dd[1], depth + 1)
            return nm
        if len(first) == 3 and first[1].text in (".", "->"):
            return f"{first[0].text}.{first[2].text}"
        return cs.text_of(first)

    def expr_names(self, toks, env, depth=0) -> set[str]:
        """Names an expression reads, through bound parameters (the
        loop variables a lambda's argument carries)."""
        out = set()
        params = env.lookup("__params__") if _has(env, "__params__") else {}
        for nm in cs.names_in(toks):
            if nm in params and depth < 8:
                a, aenv = params[nm]
                out |= self.expr_names(a, aenv, depth + 1)
            else:
                out.add(nm.split(".")[0])
        # a member access `pos.s` reads `pos`
        for i, t in enumerate(toks):
            if t.kind == "id" and i + 1 < len(toks) and toks[i + 1].text == ".":
                out.add(t.text)
        return out


_TID = [0]


def _raise_runtime(name):
    def f():
        raise Unbound([f"runtime:{name}"])
    return f


def _has(env: Env, name: str) -> bool:
    try:
        env.lookup(name)
        return True
    except Unbound:
        return False


def _strip(toks: list[Tok]) -> list[Tok]:
    """Drop casts and one level of enclosing parentheses."""
    toks = list(toks)
    changed = True
    while changed and toks:
        changed = False
        if toks[0].text == "(":
            c = cs.match_close(toks, 0)
            inner = toks[1:c]
            if c == len(toks) - 1:
                toks = inner
                changed = True
            elif inner and all(t.kind == "id" or t.text in ("*", "&")
                               for t in inner):
                toks = toks[c + 1:]  # a C cast
                changed = True
        elif toks[0].text in ("static_cast", "reinterpret_cast",
                              "const_cast"):
            c = cs.match_angle(toks, 1)
            pc = cs.match_close(toks, c + 1)
            toks = toks[c + 2:pc]
            changed = True
    return toks


def _asm_operands(toks, i) -> list[Tok]:
    """The input operands of an ``asm(...)`` whose string starts at
    ``i``: the expressions in ``"l"(expr)`` after the first ``:``."""
    out: list[Tok] = []
    j = i
    while j < len(toks) and toks[j].text not in (":", ")"):
        j += 1
    while j < len(toks):
        if toks[j].kind == "str" and j + 1 < len(toks) and \
                toks[j + 1].text == "(":
            c = cs.match_close(toks, j + 1)
            if out:
                out.append(Tok("op", ",", toks[j].line, toks[j].file))
            out.extend(toks[j + 2:c])
            j = c + 1
            continue
        if toks[j].text == ")" and j + 1 >= len(toks):
            break
        j += 1
    return out


def _assigned(st: cs.Stmt) -> set[str]:
    """Names a loop changes: its init's and step's targets, names assigned
    or incremented in its body, receivers of a method call in its step."""
    out: set[str] = set()

    def scan(toks):
        for i, t in enumerate(toks):
            if t.kind != "id":
                continue
            nxt = toks[i + 1].text if i + 1 < len(toks) else ""
            prv = toks[i - 1].text if i > 0 else ""
            if nxt in ("=", "+=", "-=", "*=", "++", "--", "^=", "|=",
                       "&=") or prv in ("++", "--"):
                out.add(t.text)
            if nxt == "." and i + 3 < len(toks) and toks[i + 3].text == "(":
                out.add(t.text)

    scan(st.init)
    scan(st.step)

    def walk(stmts):
        for s in stmts:
            scan(s.toks)
            scan(s.init)
            scan(s.step)
            walk(s.body)
            walk(s.orelse)

    walk(st.body)
    return out


def _const(toks, env):
    """A branch condition's value when it binds without a thread or a
    runtime value (template constants prune dead branches); a conjunction
    with one constant-false conjunct is false."""
    parts = _conj(toks)
    if len(parts) > 1:
        if any(_const(p, env) is False for p in parts):
            return False
        return None
    _TID[0] = -1
    try:
        v = cs.evaluate(toks, env)
    except (Unbound, TypeError, ZeroDivisionError, RecursionError):
        return None
    if _thread_dependent(toks, env):
        return None
    return bool(v)


def _thread_dependent(toks, env, depth=0) -> bool:
    """Whether the expression's value differs between threads: it reads
    threadIdx, or a const local or bound parameter that does."""
    if depth > 12:
        return False
    for nm in cs.names_in(toks):
        if nm.startswith("threadIdx"):
            return True
        e = env
        params = env.lookup("__params__") if _has(env, "__params__") else {}
        if nm in params:
            a, aenv = params[nm]
            if _thread_dependent(a, aenv, depth + 1):
                return True
            continue
        # a const local: look at its definition
        while e is not None:
            if nm in e.vars and isinstance(e.vars[nm], cs._Lazy):
                fn = e.vars[nm].fn
                ex = getattr(fn, "__defaults__", None)
                if ex and isinstance(ex[0], list):
                    if _thread_dependent(ex[0], ex[1], depth + 1):
                        return True
                break
            if nm in e.vars:
                break
            e = e.parent
    return False


# ---------------------------------------------------------------------------
# counting threads
# ---------------------------------------------------------------------------


def _conj(toks: list[Tok]) -> list[list[Tok]]:
    """Top-level && conjuncts of a condition."""
    return [p for p in cs.split_top(toks, "&&") if p]


def _site_counts(ev: Event, threads: int, extra: dict
                 ) -> dict[tuple, int]:
    """{thread-dependent barrier index: threads reaching the site} under
    the runtime bindings ``extra``. Abstains on a thread-dependent guard
    it cannot evaluate."""
    conds = []
    for toks, pol, genv in ev.guards:
        parts = _conj(toks) if pol else [toks]
        for p in parts:
            if _thread_dependent(p, genv):
                conds.append((p, pol, genv))
    idx_dep = [(ix, ev.index_env) for ix in ev.index
               if _thread_dependent(ix, ev.index_env)]
    counts: dict[tuple, int] = {}
    ekey = tuple(sorted(extra.items()))
    masks = [_mask(p, pol, genv, threads, extra, ekey, ev)
             for p, pol, genv in conds]
    for tid in range(threads):
        if not all(m[tid] for m in masks):
            continue
        _TID[0] = tid
        key = []
        for ix, ienv in idx_dep:
            try:
                key.append(cs.evaluate(ix, ienv.child(dict(extra))))
            except (Unbound, TypeError) as e:
                raise Abstain(f"barrier index '{cs.text_of(ix)}': {e}")
        counts[tuple(key)] = counts.get(tuple(key), 0) + 1
    return counts


_MASKS: dict = {}


def _definition_key(toks, env, depth=0) -> tuple:
    """What a condition's value depends on besides the thread: its text,
    and each name it reads with its definition's text (through const
    locals and bound parameters) or its bound value. Equal keys give
    equal thread masks, so instantiations share them."""
    out = [cs.text_of(toks)]
    if depth > 10:
        return tuple(out)
    params = env.lookup("__params__") if _has(env, "__params__") else {}
    for nm in sorted(cs.names_in(toks)):
        if nm in params:
            a, aenv = params[nm]
            out.append((nm, _definition_key(a, aenv, depth + 1)))
            continue
        e = env
        while e is not None:
            if nm in e.vars:
                v = e.vars[nm]
                d = getattr(getattr(v, "fn", None), "__defaults__", None)
                if isinstance(v, cs._Lazy) and d and isinstance(d[0], list):
                    out.append((nm, _definition_key(d[0], d[1], depth + 1)))
                elif not isinstance(v, cs._Lazy):
                    out.append((nm, repr(v)))
                else:
                    out.append((nm, id(v)))
                break
            e = e.parent
        else:
            out.append((nm, None))
    return tuple(out)


def _mask(p, pol, genv, threads, extra, ekey, ev) -> list[bool]:
    """Which threads satisfy one guard conjunct (memoized on what it
    depends on: sites and instantiations share their guards)."""
    key = (_definition_key(p, genv), pol, threads, ekey)
    hit = _MASKS.get(key)
    if hit is not None:
        return hit
    out = []
    for tid in range(threads):
        _TID[0] = tid
        try:
            v = bool(cs.evaluate(p, genv.child(dict(extra))))
        except (Unbound, TypeError, ZeroDivisionError) as e:
            raise Abstain(f"guard '{cs.text_of(p)}' at line "
                          f"{p[0].line if p else ev.line}: {e}")
        out.append(v == pol)
    _MASKS[key] = out
    return out


def _local_names(toks, env, depth=0) -> set[str]:
    """The locals an expression reads, through const locals' definitions
    and bound parameters."""
    out = set()
    if depth > 10:
        return out
    params = env.lookup("__params__") if _has(env, "__params__") else {}
    for nm in cs.names_in(toks):
        if nm in params:
            a, aenv = params[nm]
            out |= _local_names(a, aenv, depth + 1)
            continue
        e = env
        while e is not None:
            if nm in e.vars:
                out.add(nm)
                v = e.vars[nm]
                if isinstance(v, cs._Lazy):
                    d = getattr(v.fn, "__defaults__", None)
                    if d and isinstance(d[0], list):
                        out |= _local_names(d[0], d[1], depth + 1)
                break
            e = e.parent
    return out


def _domain(walk: _Walk, name: str) -> list[int] | None:
    """Values a bounded runtime count may take: ``min(C, ...)``."""
    d = walk.decls.get(name)
    if d is None:
        return None
    toks = d[0]
    if toks and toks[0].text == "min" and len(toks) > 1:
        c = cs.match_close(toks, 1)
        for a in cs.split_top(toks[2:c]):
            try:
                v = int(cs.evaluate(a, d[1]))
                return list(range(0, v + 1))
            except (Unbound, TypeError):
                continue
    return None


# ---------------------------------------------------------------------------
# the ledger checks
# ---------------------------------------------------------------------------


def _check(walk: _Walk, led: KernelLedger) -> None:
    evs = walk.events
    fam_events: dict[str, list[Event]] = {}
    for e in evs:
        if e.family is not None and e.kind in ("init", "arrive", "expect",
                                               "rarrive", "wait", "copy"):
            fam_events.setdefault(e.family, []).append(e)
    inits = {f: [e for e in es if e.kind == "init"]
             for f, es in fam_events.items()}
    # -- init fenced before first use ---------------------------------------
    init_seqs = [e.seq for e in evs if e.kind == "init"]
    if init_seqs:
        last_init = max(init_seqs)
        first_use = min((e.seq for e in evs if e.kind in (
            "arrive", "expect", "rarrive", "wait", "copy")
            and e.seq > last_init), default=None)
        if first_use is not None and not any(
                e.kind == "sync" and e.name in _BLOCK_SYNCS
                and last_init < e.seq < first_use for e in evs):
            use = next(e for e in evs if e.seq == first_use)
            led.findings.append(("mbar-balance", use.line, (
                f"barrier '{use.family}' used at line {use.line} with no "
                f"block barrier after the inits (line "
                f"{next(e for e in evs if e.seq == last_init).line}): "
                f"another thread may arrive on or wait for an "
                f"uninitialized barrier")))
    # -- every family initialized, every waited family fed -------------------
    for fam, es in fam_events.items():
        if not inits.get(fam):
            e = es[0]
            led.findings.append(("mbar-balance", e.line, (
                f"barrier '{fam}' is used ({e.name}) but never "
                f"initialized in this kernel")))
            continue
        waits = [e for e in es if e.kind == "wait"]
        feeds = [e for e in es if e.kind in ("arrive", "expect", "rarrive",
                                             "copy")]
        if waits and not feeds:
            led.findings.append(("mbar-balance", waits[0].line, (
                f"barrier '{fam}' is waited on but nothing arrives on or "
                f"copies into it: the wait never completes")))
    # -- arrivals per phase against the init count ---------------------------
    if walk.threads is None:
        if any(e.kind in ("arrive", "expect") for e in evs):
            raise Abstain("the block's thread count is not bound")
    for fam, es in fam_events.items():
        ins = inits.get(fam) or []
        sites = [e for e in es if e.kind in ("arrive", "expect")]
        if not ins or not sites:
            continue
        for init in ins:
            count_toks = init.args[1] if len(init.args) > 1 else []
            runtime = _local_names(count_toks, init.env)
            for site in sites:
                for g, _, genv in site.guards:
                    runtime |= _local_names(g, genv)
                doms = {}
                for nm in runtime:
                    dom = _domain(walk, nm)
                    if dom is None:
                        continue
                    doms[nm] = dom
                assigns = [{}]
                for nm, dom in doms.items():
                    assigns = [dict(a, **{nm: v}) for a in assigns
                               for v in dom]
                for extra in assigns:
                    try:
                        _TID[0] = 0
                        want = int(cs.evaluate(count_toks,
                                               init.env.child(dict(extra))))
                    except (Unbound, TypeError) as e:
                        raise Abstain(f"init count of '{fam}' "
                                      f"'{cs.text_of(count_toks)}': {e}")
                    counts = _site_counts(site, walk.threads, extra)
                    for key, got in counts.items():
                        if got != want:
                            where = (f" (index {list(key)})" if key else "")
                            bind = (" with " + ", ".join(
                                f"{k}={v}" for k, v in extra.items())
                                if extra else "")
                            led.findings.append(("mbar-balance", site.line, (
                                f"{got} thread(s) reach {site.name} on "
                                f"'{fam}'{where} per phase but its init "
                                f"count is {want}{bind}: the phase "
                                f"{'never completes' if got < want else 'overruns'}")))
                            break
    # -- expect_tx against the bulk copies of the same region ----------------
    for e in evs:
        if e.kind != "expect":
            continue
        copies = [c for c in evs if c.kind == "copy" and c.family == e.family
                  and c.seq > e.seq and c.guards[:len(e.guards)] == e.guards
                  and _same_region(e, c, evs)]
        if not copies or any(_COPIES[c.name] is None or c.remote
                             for c in copies):
            # a TMA box is set on the host; a copy into a peer's barrier
            # completes there (this barrier's bytes come from the peers)
            continue
        want = cs.text_of(e.args[1]) if len(e.args) > 1 else ""
        got = [cs.text_of(c.args[_COPIES[c.name]]) for c in copies]
        try:
            _TID[0] = 0
            wv = int(cs.evaluate(e.args[1], e.env))
            gv = sum(int(cs.evaluate(c.args[_COPIES[c.name]], c.env))
                     for c in copies)
            if wv != gv:
                led.findings.append(("mbar-balance", e.line, (
                    f"expect_tx of {wv} byte(s) on '{e.family}' but the "
                    f"copies completing on it bring {gv}")))
            continue
        except (Unbound, TypeError, ZeroDivisionError):
            pass
        if len(got) == 1 and _norm(got[0]) != _norm(want):
            led.findings.append(("mbar-balance", e.line, (
                f"expect_tx of '{want}' bytes on '{e.family}' but its copy "
                f"brings '{got[0]}'")))
    # -- ring slots ------------------------------------------------------------
    def prefix_has(c, loops, pred):
        """``pred`` holds for an event earlier in the same iteration of
        one of ``loops`` (a slot's release may sit in an outer loop)."""
        return any(pred(e) for loop in loops for e in evs
                   if loop in e.loops and e.seq < c.seq)

    for c in evs:
        if c.kind == "copy":
            variant = [k for k, loop in enumerate(c.loops)
                       if c.names & loop.variant]
            if not variant:
                continue  # one phase's fill: no slot is reused
            loops = c.loops[:variant[-1] + 1]
            readers = any(e.kind in ("arrive", "rarrive")
                          and e.family != c.family for e in evs)
            if not readers:
                # a copy-only ring (nothing reads the slots and releases
                # them): the previous copy into the slot must have landed,
                # a wait on its own barrier anywhere in the iteration
                if any(e.kind == "wait" and e.family == c.family
                       for loop in loops for e in evs if loop in e.loops):
                    continue
            if not prefix_has(c, loops, lambda e: e.kind == "wait"
                              and e.family != c.family):
                led.findings.append(("ring-slot-reuse", c.line, (
                    f"{c.name} refills a slot of '{c.family}' in the "
                    f"loop at line {c.loops[variant[-1]].line} with no wait "
                    f"on its empty barrier before it in the loop: it may "
                    f"overwrite a slot still being read")))
        elif c.kind in ("fifo", "stage") and c.loops:
            if c.kind == "fifo":
                ok = prefix_has(c, c.loops, lambda e: e.kind == "acquire")
                need = "credit acquire"
            else:
                ok = prefix_has(c, c.loops, lambda e: e.kind == "sync"
                                and e.name == "__syncthreads")
                need = "__syncthreads()"
            if not ok:
                led.findings.append(("ring-slot-reuse", c.line, (
                    f"{c.name} writes a ring slot in the loop at line "
                    f"{c.loops[-1].line} with no {need} before it in the "
                    f"loop")))
    # -- flags -----------------------------------------------------------------
    acquired = {e.family for e in evs if e.kind == "acquire"}
    for e in evs:
        if e.kind != "release":
            continue
        if e.name != "atom_acq_rel" and not _fenced_before(e, evs):
            led.findings.append(("flag-balance", e.line, (
                f"{e.name} on '{e.family}' with no fence or block barrier "
                f"before it: other threads' writes may land after the "
                f"flag")))
        if e.family not in acquired:
            led.findings.append(("flag-balance", e.line, (
                f"'{e.family}' is released here but no acquire (ld_acquire, "
                f"a cta_* spin, atom_acq_rel) ever reads it: the flag "
                f"orders nothing")))


def _same_region(a: Event, b: Event, evs) -> bool:
    """No other expect on the family between them."""
    return not any(e.kind == "expect" and e.family == a.family
                   and a.seq < e.seq < b.seq for e in evs)


def _norm(s: str) -> str:
    return "".join(s.split())


def _fenced_before(e: Event, evs) -> bool:
    """A fence or block barrier earlier on the release's path: in the
    same loop iteration when the release sits in a loop."""
    prior = [x for x in evs if x.seq < e.seq]
    if e.loops:
        prior = [x for x in prior if e.loops[-1] in x.loops]
    return any(x.kind == "fence" or (x.kind == "sync"
                                     and x.name == "__syncthreads")
               for x in prior)


# ---------------------------------------------------------------------------
# per unit
# ---------------------------------------------------------------------------

_CACHE: dict[tuple[str, int], list[KernelLedger]] = {}


def ledgers(path: str | Path) -> list[KernelLedger]:
    """The static ledger of every kernel instantiation in one ``.cu``
    that uses the protocol vocabulary."""
    path = Path(path)
    key = (str(path), hash(tuple(
        p.read_text() for p in [path, *sorted(path.parent.glob("*.cuh"))])))
    if key in _CACHE:
        return _CACHE[key]
    rows = smem_mod.estimate_unit(path)
    unit = cs.parse_unit(path)
    out: list[KernelLedger] = []
    for r in rows:
        fn = next((f for f in unit.functions if f.is_kernel
                   and f.name == r.function.name and f.line == r.line), None)
        if fn is None:
            continue
        led = KernelLedger(kernel=r.kernel, path=fn.file, line=fn.line,
                           threads=r.threads)
        walk = _Walk(unit, fn, r.binds, r.threads)
        try:
            walk.walk_fn(fn, walk.root, [], [], 0)
            led.events = walk.events
            if led.protocol:
                _check(walk, led)
        except Abstain as e:
            led.status, led.reason = "abstained", str(e)
            led.findings = []
        except RecursionError:
            led.status, led.reason = "abstained", "recursion"
            led.findings = []
        if led.protocol or led.status == "abstained":
            out.append(led)
    _CACHE[key] = out
    return out


def kernel_report(paths) -> list[KernelLedger]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".cu":
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.cu")))
    out: list[KernelLedger] = []
    for f in files:
        out.extend(ledgers(f))
    return out


def _module_findings(mod: ModuleInfo, rule: str) -> Iterable[tuple[int, str]]:
    if not mod.path.endswith(".cu"):
        return
    seen = set()
    for led in ledgers(mod.path):
        for r, line, msg in led.findings:
            if r != rule:
                continue
            # one finding per (line, message shape): instantiations repeat
            k = (line, msg.split(" with ")[0])
            if k in seen:
                continue
            seen.add(k)
            yield line, f"{led.kernel}: {msg}"


def _anchor(line: int):
    return SimpleNamespace(lineno=line, col_offset=0)


class _LedgerRule(Rule):
    family = "cudalint"
    lang = "cuda"

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        for line, msg in _module_findings(mod, self.name):
            yield self.finding(mod, _anchor(line), msg)


@register
class MbarBalanceRule(_LedgerRule):
    """Hopper mbarriers complete a phase when the init count of arrivals
    and every expected transaction byte have come: a site reached by more
    or fewer threads than the count, an ``expect_tx`` the copies do not
    fill, or a barrier used before its init is visible hangs the kernel
    (or lets a consumer read a slot that has not landed) — on the card
    only."""

    name = "mbar-balance"
    summary = ("mbarrier arrivals vs init count, expect_tx vs copy bytes, "
               "init not fenced, waited barrier never fed")
    hint = ("make every phase's arrivals equal the init count (one per "
            "thread that reaches the site), expect exactly the bytes the "
            "copies bring, and put a __syncthreads() between the inits "
            "and the first use")


@register
class RingSlotReuseRule(_LedgerRule):
    """The full/empty discipline of the TMA and bulk rings (kernels 1-4,
    8-9, 14), the credits of kernel 11's FIFO and the block barrier of
    kernel 12's cp.async stages: a slot may be refilled only once its
    readers released it."""

    name = "ring-slot-reuse"
    summary = ("ring slot refilled with no empty-barrier wait, credit or "
               "block barrier before it")
    hint = ("wait the slot's empty barrier (or acquire its credit, or "
            "__syncthreads) in the loop before the copy that refills it")


@register
class FlagBalanceRule(_LedgerRule):
    """Release/acquire flags across CTAs (kernels 10-13): a release must
    follow the block barrier or fence that orders the CTA's writes, and a
    flag that is released must be acquired somewhere, or the data it
    publishes is read unordered."""

    name = "flag-balance"
    summary = ("flag release with no fence before it, or a released flag "
               "no acquire reads")
    hint = ("__syncthreads() (and __threadfence()) before the release; "
            "spin with ld_acquire on the flag the release writes")


@register
class SmemBudgetRule(Rule):
    """A kernel whose shared memory exceeds the per-block opt-in limit
    is refused at launch on the card (``smem.py``); this fires only on
    rows whose every symbol is bound — a runtime plan's bytes are the
    report's, named, never judged."""

    name = "smem-budget"
    family = "cudalint"
    lang = "cuda"
    summary = ("kernel shared memory (static + requested dynamic, all "
               "bound) over the 232448-byte opt-in limit")
    hint = ("shrink the tiles or the ring's stages; the H100 gives one "
            "block at most 232448 bytes")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        if not mod.path.endswith(".cu"):
            return
        for r in smem_mod.estimate_unit(mod.path):
            tot = r.total_bytes
            if tot is not None and tot > smem_mod.SMEM_LIMIT:
                yield self.finding(
                    mod, _anchor(r.line),
                    f"kernel {r.kernel!r} takes {tot:,} bytes of shared "
                    f"memory ({r.static_bytes:,} static + "
                    f"{r.dynamic_bytes:,} dynamic) against the "
                    f"{smem_mod.SMEM_LIMIT:,}-byte opt-in limit")
