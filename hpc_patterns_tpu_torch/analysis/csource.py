"""A small C++ front end over the port's CUDA sources, for the kernel
family (``smem.py``, ``cuda_rules.py``). Stdlib only, never a compiler.

It reads the subset ``csrc/`` is written in, and says so when it meets
something else (:class:`Unbound` names what it could not resolve):

- a comment-stripping tokenizer with ``#include "…"`` inlined once,
  object- and function-like ``#define``\\ s expanded, and ``#if``/
  ``#ifdef`` blocks taken against a given set of defined macros (the
  timed build defines none);
- declarations: namespaces (anonymous, named, ``extern "C"``),
  templates, ``struct``\\ s with ``static constexpr`` members, bases and
  specializations, ``enum``\\ s, namespace-scope ``constexpr``/``const``
  integers, ``using`` aliases and declarations, and function
  definitions (``__global__`` kernels with ``__launch_bounds__``,
  ``__device__`` helpers, host launchers);
- statements: blocks, ``if``/``else``, ``for``, ``while``, ``do``,
  ``switch`` and simple statements, with lambdas (``auto f = [&](…) {…};``)
  kept as local functions;
- integer constant expressions: the C operators, ``?:``, casts,
  ``sizeof`` of the scalar types, ``min``/``max``, qualified names and
  ``Struct<args>::member`` under template bindings.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tok:
    kind: str   # "id", "num", "str", "chr", "op"
    text: str
    line: int
    file: str


_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r\f\v]+)
  | (?P<nl>\n)
  | (?P<lc>//[^\n]*)
  | (?P<bc>/\*.*?\*/)
  | (?P<str>"(?:\\.|[^"\\\n])*")
  | (?P<chr>'(?:\\.|[^'\\\n])*')
  | (?P<num>(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)[uUlLfF]*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op><<<|>>>|<<=|>>=|->\*|\.\.\.|::|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%&|^!~<>=]=|\#\#|[-+*/%&|^!~<>=?:;,.(){}\[\]\#])
""", re.S | re.X)


def _lex(text: str, path: str) -> list[Tok]:
    out: list[Tok] = []
    line = 1
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            pos += 1  # a stray byte (a backslash at a line end is handled
            continue  # by the preprocessor before lexing)
        kind = m.lastgroup
        s = m.group()
        if kind in ("str", "chr", "num", "id", "op"):
            out.append(Tok(kind, s, line, path))
        line += s.count("\n")
        pos = m.end()
    return out


@dataclass
class Macro:
    params: list[str] | None  # None: object-like
    body: list[Tok]


class Preprocessor:
    """Line-level preprocessing: includes, defines, conditionals."""

    def __init__(self, defined: frozenset[str] = frozenset()):
        self.macros: dict[str, Macro] = {}
        self.defined = set(defined)
        self.included: set[str] = set()

    def run(self, path: Path) -> list[Tok]:
        path = Path(path)
        key = str(path.resolve())
        if key in self.included:
            return []
        self.included.add(key)
        text = path.read_text()
        # join continuation lines, keeping the line count
        lines = text.split("\n")
        out: list[Tok] = []
        stack: list[tuple[bool, bool]] = []  # (active, any branch taken)
        i = 0
        pending: list[tuple[int, str]] = []
        while i < len(lines):
            start = i
            raw = lines[i]
            while raw.endswith("\\") and i + 1 < len(lines):
                i += 1
                raw = raw[:-1] + " " + lines[i]
            i += 1
            active = all(a for a, _ in stack)
            stripped = raw.strip()
            if stripped.startswith("#"):
                self._directive(stripped[1:].strip(), stack, active, path,
                                out, start + 1, pending)
                continue
            if active:
                pending.append((start + 1, raw))
        self._flush(pending, path, out)
        return out

    def _flush(self, pending, path, out):
        if not pending:
            return
        # lex the pending code lines together (a block comment may span)
        text_lines = []
        first = pending[0][0]
        cur = first
        for ln, raw in pending:
            while cur < ln:
                text_lines.append("")
                cur += 1
            text_lines.append(raw)
            cur += 1
        toks = _lex("\n".join(text_lines), str(path))
        toks = [Tok(t.kind, t.text, t.line + first - 1, t.file) for t in toks]
        out.extend(self.expand(toks))
        pending.clear()

    def _directive(self, d, stack, active, path, out, lineno, pending):
        m = re.match(r"(\w+)\s*(.*)", d)
        if not m:
            return
        word, rest = m.group(1), m.group(2)
        # strip a trailing // comment
        rest = re.sub(r"//.*$", "", rest).strip()
        if word in ("ifdef", "ifndef"):
            name = rest.split()[0] if rest else ""
            cond = (name in self.defined or name in self.macros)
            if word == "ifndef":
                cond = not cond
            stack.append((cond, cond))
        elif word == "if":
            cond = self._if_value(rest)
            stack.append((cond, cond))
        elif word == "elif":
            act, taken = stack.pop()
            cond = (not taken) and self._if_value(rest)
            stack.append((cond, taken or cond))
        elif word == "else":
            act, taken = stack.pop()
            stack.append((not taken, True))
        elif word == "endif":
            if stack:
                stack.pop()
        elif not active:
            return
        elif word == "include":
            m2 = re.match(r'"([^"]+)"', rest)
            if m2:
                self._flush(pending, path, out)
                inc = path.parent / m2.group(1)
                if inc.is_file():
                    out.extend(self.run(inc))
        elif word == "define":
            self._flush(pending, path, out)
            m2 = re.match(r"(\w+)(\(([^)]*)\))?\s*(.*)", rest, re.S)
            if m2:
                name = m2.group(1)
                params = None
                if m2.group(2) is not None:
                    params = [p.strip() for p in m2.group(3).split(",")
                              if p.strip()]
                body = _lex(m2.group(4), str(path))
                body = [Tok(t.kind, t.text, lineno, t.file) for t in body]
                self.macros[name] = Macro(params, body)
        elif word == "undef":
            self._flush(pending, path, out)
            self.macros.pop(rest.split()[0] if rest else "", None)

    def _if_value(self, expr: str) -> bool:
        expr = re.sub(r"defined\s*\(?\s*(\w+)\s*\)?",
                      lambda m: "1" if (m.group(1) in self.defined
                                        or m.group(1) in self.macros)
                      else "0", expr)
        # unknown macros (CUDART_VERSION) read as a modern toolkit's
        expr = re.sub(r"\bCUDART_VERSION\b", "12080", expr)
        expr = re.sub(r"[A-Za-z_]\w*", "0", expr)
        expr = expr.replace("&&", " and ").replace("||", " or ")
        expr = re.sub(r"!(?!=)", " not ", expr)
        try:
            return bool(eval(expr, {"__builtins__": {}}))  # noqa: S307
        except Exception:  # noqa: BLE001 - an unreadable #if is false
            return False

    def expand(self, toks: list[Tok], hide: frozenset[str] = frozenset()
               ) -> list[Tok]:
        out: list[Tok] = []
        i = 0
        while i < len(toks):
            t = toks[i]
            mac = self.macros.get(t.text) if t.kind == "id" else None
            if mac is None or t.text in hide:
                out.append(t)
                i += 1
                continue
            if mac.params is None:
                body = [Tok(b.kind, b.text, t.line, t.file) for b in mac.body]
                out.extend(self.expand(body, hide | {t.text}))
                i += 1
                continue
            if i + 1 >= len(toks) or toks[i + 1].text != "(":
                out.append(t)
                i += 1
                continue
            args, j = _split_args(toks, i + 1)
            sub: dict[str, list[Tok]] = {}
            for k, p in enumerate(mac.params):
                if p == "...":
                    rest = []
                    for a in args[k:]:
                        if rest:
                            rest.append(Tok("op", ",", t.line, t.file))
                        rest.extend(a)
                    sub["__VA_ARGS__"] = rest
                else:
                    sub[p] = args[k] if k < len(args) else []
            body: list[Tok] = []
            mb = mac.body
            k = 0
            while k < len(mb):
                b = mb[k]
                if b.text == "#" and k + 1 < len(mb) and mb[k + 1].text in sub:
                    s = " ".join(x.text for x in sub[mb[k + 1].text])
                    body.append(Tok("str", f'"{s}"', t.line, t.file))
                    k += 2
                    continue
                if b.kind == "id" and b.text in sub:
                    body.extend(Tok(x.kind, x.text, t.line, t.file)
                                for x in self.expand(sub[b.text], hide))
                else:
                    body.append(Tok(b.kind, b.text, t.line, t.file))
                k += 1
            out.extend(self.expand(body, hide | {t.text}))
            i = j
        return out


def _split_args(toks: list[Tok], i: int) -> tuple[list[list[Tok]], int]:
    """Macro/call arguments from the ``(`` at ``i``: (args, index after
    the closing paren). Commas split only at paren depth 1."""
    assert toks[i].text == "("
    depth = 0
    args: list[list[Tok]] = [[]]
    j = i
    while j < len(toks):
        s = toks[j].text
        if s in ("(", "[", "{"):
            depth += 1
            if depth > 1:
                args[-1].append(toks[j])
        elif s in (")", "]", "}"):
            depth -= 1
            if depth == 0:
                return ([a for a in args] if any(args) else []), j + 1
            args[-1].append(toks[j])
        elif s == "," and depth == 1:
            args.append([])
        else:
            args[-1].append(toks[j])
        j += 1
    return args, j


def match_close(toks: list[Tok], i: int) -> int:
    """Index of the bracket closing the one at ``i`` (() [] {})."""
    pairs = {"(": ")", "[": "]", "{": "}"}
    open_, close = toks[i].text, pairs[toks[i].text]
    depth = 0
    for j in range(i, len(toks)):
        s = toks[j].text
        if s == open_:
            depth += 1
        elif s == close:
            depth -= 1
            if depth == 0:
                return j
    return len(toks) - 1


def match_angle(toks: list[Tok], i: int) -> int:
    """Index of the ``>`` closing the template ``<`` at ``i`` (a ``>>``
    closes two)."""
    depth = 0
    j = i
    while j < len(toks):
        s = toks[j].text
        if s in ("(", "["):
            j = match_close(toks, j) + 1
            continue
        if s == "<":
            depth += 1
        elif s == ">":
            depth -= 1
        elif s == ">>":
            depth -= 2
        elif s == ">>>":
            depth -= 3
        elif s in (";", "{", "}"):
            return -1
        if depth <= 0:
            return j
        j += 1
    return -1


def split_top(toks: list[Tok], sep: str = ",") -> list[list[Tok]]:
    """Split on ``sep`` outside (), [], {} and template <>."""
    out: list[list[Tok]] = [[]]
    depth = 0
    angle = 0
    for t in toks:
        s = t.text
        if s in ("(", "[", "{"):
            depth += 1
        elif s in (")", "]", "}"):
            depth -= 1
        elif s == "<" and depth == 0 and out[-1] and out[-1][-1].kind == "id" \
                and _looks_template(out[-1][-1].text):
            angle += 1
        elif s == ">" and depth == 0 and angle:
            angle -= 1
        elif s == ">>" and depth == 0 and angle:
            angle = max(0, angle - 2)
        if s == sep and depth == 0 and angle == 0:
            out.append([])
        else:
            out[-1].append(t)
    return out if any(out) else []


_TEMPLATE_NAMES: set[str] = set()


def _looks_template(name: str) -> bool:
    return name in _TEMPLATE_NAMES or name in (
        "static_cast", "reinterpret_cast", "const_cast", "Cfg", "Atoms",
        "Lanes", "Vec", "min", "max")


def text_of(toks: list[Tok]) -> str:
    out = []
    for t in toks:
        if out and (t.kind in ("id", "num") and out[-1][-1:].isalnum()):
            out.append(" ")
        out.append(t.text)
    return "".join(out)


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------


@dataclass
class Template:
    names: list[str]
    kinds: list[str]  # "int", "bool", "type", "class"
    defaults: list[list[Tok] | None]


@dataclass
class Struct:
    name: str
    ns: str
    template: Template | None
    spec_args: list[list[Tok]] | None  # a specialization's <args>
    bases: list[list[Tok]]
    members: dict[str, list[Tok]]      # static constexpr name -> expr
    aliases: dict[str, list[Tok]]      # using X = ...; -> type tokens
    fields: list[tuple[str, list[Tok]]]  # non-static members (name, init)
    ctor: "Function | None" = None


@dataclass
class Function:
    name: str
    ns: str
    template: Template | None
    params: list[tuple[str, list[Tok]]]  # (name, type tokens)
    body: list[Tok]
    quals: set[str]
    launch_bounds: list[Tok] | None
    line: int
    file: str
    #: for a lambda: the function that holds it
    parent: "Function | None" = None

    @property
    def is_kernel(self) -> bool:
        return "__global__" in self.quals

    @property
    def qualname(self) -> str:
        return f"{self.ns}::{self.name}" if self.ns else self.name


@dataclass
class Unit:
    """One translation unit: a ``.cu`` and the headers it includes."""

    path: str
    toks: list[Tok]
    functions: list[Function] = field(default_factory=list)
    structs: dict[str, list[Struct]] = field(default_factory=dict)
    consts: dict[str, tuple[str, list[Tok]]] = field(default_factory=dict)
    #: ns-qualified using-declarations and aliases: "ns::X" -> tokens
    aliases: dict[str, list[Tok]] = field(default_factory=dict)

    def funcs_named(self, name: str) -> list[Function]:
        base = name.rsplit("::", 1)[-1]
        return [f for f in self.functions if f.name == base
                and (("::" not in name) or f.qualname.endswith(name))]


_SKIP_QUALS = {"static", "inline", "__forceinline__", "__device__",
               "__global__", "__host__", "constexpr", "extern", "const",
               "__noinline__", "volatile", "unsigned", "signed", "typename"}


_UNITS: dict[tuple, "Unit"] = {}


def parse_unit(path: str | Path, defined: frozenset[str] = frozenset()
               ) -> Unit:
    """One ``.cu`` and its headers, parsed (memoized on their texts)."""
    path = Path(path)
    key = (str(path), frozenset(defined), hash(tuple(
        f.read_text() for f in [path, *sorted(path.parent.glob("*.cuh"))])))
    if key not in _UNITS:
        _UNITS[key] = _parse_unit(path, defined)
        if len(_UNITS) > 64:
            _UNITS.pop(next(iter(_UNITS)))
    return _UNITS[key]


def _parse_unit(path: Path, defined: frozenset[str]) -> Unit:
    pp = Preprocessor(defined)
    toks = pp.run(Path(path))
    unit = Unit(path=str(path), toks=toks)
    _parse_decls(unit, toks, 0, len(toks), "")
    for name in unit.structs:
        _TEMPLATE_NAMES.add(name)
    for f in unit.functions:
        if f.template is not None:
            _TEMPLATE_NAMES.add(f.name)
    return unit


def _parse_template(toks, i) -> tuple[Template, int]:
    """``template <...>`` at ``i`` (pointing at ``template``)."""
    j = match_angle(toks, i + 1)
    inner = toks[i + 2:j]
    names, kinds, defaults = [], [], []
    for part in split_top(inner):
        if not part:
            continue
        default = None
        eq = next((k for k, t in enumerate(part) if t.text == "="), None)
        if eq is not None:
            default = part[eq + 1:]
            part = part[:eq]
        ids = [t for t in part if t.kind == "id"]
        if not ids:
            continue
        if part[-1].text == "...":
            names.append(ids[-1].text)
            kinds.append("pack")
        else:
            names.append(part[-1].text)
            kinds.append("type" if ids[0].text in ("typename", "class")
                         else ids[0].text)
        defaults.append(default)
    return Template(names, kinds, defaults), j + 1


def _parse_decls(unit: Unit, toks: list[Tok], i: int, end: int, ns: str):
    template: Template | None = None
    while i < end:
        t = toks[i]
        s = t.text
        if s == ";":
            i += 1
            continue
        if s == "namespace":
            j = i + 1
            name = ""
            while toks[j].text != "{":
                if toks[j].kind == "id":
                    name += ("::" if name else "") + toks[j].text
                j += 1
            close = match_close(toks, j)
            inner_ns = ns if not name else (f"{ns}::{name}" if ns else name)
            _parse_decls(unit, toks, j + 1, close, inner_ns)
            i = close + 1
            continue
        if s == "extern" and i + 1 < end and toks[i + 1].kind == "str":
            if toks[i + 2].text == "{":
                close = match_close(toks, i + 2)
                _parse_decls(unit, toks, i + 3, close, ns)
                i = close + 1
                continue
            i += 2
            continue
        if s == "template":
            template, i = _parse_template(toks, i)
            continue
        if s in ("struct", "class", "union") and toks[i + 1].kind == "id":
            i = _parse_struct(unit, toks, i, ns, template)
            template = None
            continue
        if s == "enum":
            i = _parse_enum(unit, toks, i, ns)
            continue
        if s == "using":
            j = i
            while toks[j].text != ";":
                j += 1
            stmt = toks[i + 1:j]
            if stmt and stmt[0].text == "namespace":
                pass
            elif len(stmt) > 2 and stmt[1].text == "=":
                unit.aliases[_q(ns, stmt[0].text)] = stmt[2:]
            elif stmt:
                # using a::b::NAME;
                unit.aliases[_q(ns, stmt[-1].text)] = stmt
            i = j + 1
            template = None
            continue
        if s == "static_assert":
            j = match_close(toks, i + 1)
            i = j + 1
            continue
        # a declaration: a function definition, or a variable
        j = i
        depth = 0
        while j < end:
            x = toks[j].text
            if x in ("(", "["):
                j = match_close(toks, j) + 1
                continue
            if x in ("{", ";", "="):
                break
            j += 1
        if j >= end:
            break
        if toks[j].text == "{" and _is_function_head(toks, i, j):
            close = match_close(toks, j)
            fn = _make_function(toks, i, j, close, ns, template, unit.path)
            if fn is not None:
                unit.functions.append(fn)
            i = close + 1
            template = None
            continue
        if toks[j].text == "=":
            # NAME = expr;  (namespace-scope constant or variable)
            k = j
            while toks[k].text != ";":
                if toks[k].text in ("(", "[", "{"):
                    k = match_close(toks, k)
                k += 1
            head = toks[i:j]
            if head and head[-1].kind == "id":
                quals = {x.text for x in head}
                if "constexpr" in quals or "const" in quals:
                    for part in split_top(toks[i:k]):
                        if not part:
                            continue
                        eq = next((m for m, x in enumerate(part)
                                   if x.text == "="), None)
                        if eq is None:
                            continue
                        nm = part[eq - 1].text
                        unit.consts[_q(ns, nm)] = (ns, part[eq + 1:])
            i = k + 1
            template = None
            continue
        if toks[j].text == "{":
            close = match_close(toks, j)
            i = close + 1
            template = None
            continue
        i = j + 1
        template = None


def _q(ns: str, name: str) -> str:
    return f"{ns}::{name}" if ns else name


def _is_function_head(toks, i, j) -> bool:
    k = j - 1
    while k > i and toks[k].kind == "id" and toks[k].text in (
            "const", "override", "noexcept"):
        k -= 1
    return toks[k].text == ")"


def _make_function(toks, i, j, close, ns, template, path):
    head = toks[i:j]
    # the parameter list: the last top-level (...) of the head
    k = len(head) - 1
    while k >= 0 and head[k].text != ")":
        k -= 1
    depth = 0
    p = k
    while p >= 0:
        if head[p].text == ")":
            depth += 1
        elif head[p].text == "(":
            depth -= 1
            if depth == 0:
                break
        p -= 1
    if p <= 0:
        return None
    name_tok = head[p - 1]
    if name_tok.kind != "id":
        return None
    quals = {t.text for t in head[:p - 1] if t.kind == "id"}
    lb = None
    for q in range(p - 1):
        if head[q].text == "__launch_bounds__":
            c = match_close(head, q + 1)
            lb = split_top(head[q + 2:c])[0]
    params = []
    for part in split_top(head[p + 1:k]):
        part = [t for t in part]
        eq = next((m for m, x in enumerate(part) if x.text == "="), None)
        if eq is not None:
            part = part[:eq]
        ids = [t for t in part if t.kind == "id"]
        if not ids or (len(part) == 1 and part[0].text == "void"):
            continue
        # the name: the last identifier not inside an array suffix
        name = None
        for t in reversed(part):
            if t.text == "]":
                break
        brk = next((m for m, x in enumerate(part) if x.text == "["), None)
        body_part = part[:brk] if brk is not None else part
        # `void (*kernel)(Exp...)`: a function pointer's name
        star = next((m for m, x in enumerate(part) if x.text == "*"
                     and m > 0 and part[m - 1].text == "("
                     and m + 2 < len(part) and part[m + 1].kind == "id"
                     and part[m + 2].text == ")"), None)
        if star is not None:
            params.append((part[star + 1].text, part))
            continue
        # `float (&sc)[N]`: the name sits in the parens
        amp = next((m for m, x in enumerate(part) if x.text == "&"
                    and m + 1 < len(part) and part[m + 1].kind == "id"
                    and m > 0 and part[m - 1].text == "("), None)
        if amp is not None:
            name = part[amp + 1].text
        else:
            cand = [t for t in body_part if t.kind == "id"]
            name = cand[-1].text if cand else None
        if name:
            params.append((name, part))
    return Function(name=name_tok.text, ns=ns, template=template,
                    params=params, body=toks[j + 1:close], quals=quals,
                    launch_bounds=lb, line=name_tok.line, file=name_tok.file)


def _parse_struct(unit, toks, i, ns, template) -> int:
    name = toks[i + 1].text
    j = i + 2
    spec_args = None
    if toks[j].text == "<":
        c = match_angle(toks, j)
        spec_args = split_top(toks[j + 1:c])
        j = c + 1
    bases: list[list[Tok]] = []
    if toks[j].text == ":":
        k = j + 1
        while toks[k].text != "{" and toks[k].text != ";":
            k += 1
        for part in split_top(toks[j + 1:k]):
            part = [t for t in part if t.text not in ("public", "private",
                                                      "protected")]
            if part:
                bases.append(part)
        j = k
    if toks[j].text == ";":
        return j + 1  # a forward declaration
    close = match_close(toks, j)
    st = Struct(name=name, ns=ns, template=template, spec_args=spec_args,
                bases=bases, members={}, aliases={}, fields=[])
    body = toks[j + 1:close]
    k = 0
    while k < len(body):
        t = body[k]
        if t.text in ("public", "private", "protected") and k + 1 < len(
                body) and body[k + 1].text == ":":
            k += 2
            continue
        if t.text == "using":
            e = k
            while body[e].text != ";":
                e += 1
            stmt = body[k + 1:e]
            if len(stmt) > 2 and stmt[1].text == "=":
                st.aliases[stmt[0].text] = stmt[2:]
            k = e + 1
            continue
        if t.text == "template":
            _, k = _parse_template(body, k)
            continue
        if t.text == "enum":
            k = _parse_enum(unit, body, k, _q(ns, name), st)
            continue
        if t.text == "static_assert":
            k = match_close(body, k + 1) + 1
            continue
        # find the statement's end
        e = k
        while e < len(body) and body[e].text not in (";", "{"):
            if body[e].text in ("(", "["):
                e = match_close(body, e)
            e += 1
        if e < len(body) and body[e].text == "{":
            head = body[k:e]
            c = match_close(body, e)
            if head and head[0].text == name and (len(head) > 1 and
                                                  head[1].text == "("):
                st.ctor = Function(name=name, ns=ns, template=None,
                                   params=[], body=body[e + 1:c],
                                   quals=set(), launch_bounds=None,
                                   line=head[0].line, file=head[0].file)
                pc = match_close(head, 1)
                for part in split_top(head[2:pc]):
                    ids = [x for x in part if x.kind == "id"]
                    if ids:
                        st.ctor.params.append((ids[-1].text, part))
            elif head and "(" in [x.text for x in head] and \
                    "=" not in [x.text for x in head]:
                # a member function: kept for the kernel family's walks
                pi = [x.text for x in head].index("(")
                if pi > 0 and head[pi - 1].kind == "id":
                    m = _make_function(body, k, e, c, _q(ns, name), None,
                                       unit.path)
                    if m is not None:
                        m.quals.add("method")
                        unit.functions.append(m)
            # a member function or an initializer brace: skip it
            if head and "=" in [x.text for x in head]:
                # `T x = {};` — a field with a brace initializer
                e2 = c + 1
                while e2 < len(body) and body[e2].text != ";":
                    e2 += 1
                nm = head[[x.text for x in head].index("=") - 1].text
                st.fields.append((nm, body[e:c + 1]))
                k = e2 + 1
                continue
            k = c + 1
            continue
        stmt = body[k:e]
        texts = [x.text for x in stmt]
        if "static" in texts and "constexpr" in texts and "=" in texts:
            for part in split_top(stmt):
                eq = next((m for m, x in enumerate(part) if x.text == "="),
                          None)
                if eq is not None:
                    st.members[part[eq - 1].text] = part[eq + 1:]
        elif stmt and "(" not in texts:
            for part in split_top(stmt):
                eq = next((m for m, x in enumerate(part) if x.text == "="),
                          None)
                nm_part = part[:eq] if eq is not None else part
                brk = next((m for m, x in enumerate(nm_part)
                            if x.text == "["), None)
                if brk is not None:
                    nm_part = nm_part[:brk]
                ids = [x for x in nm_part if x.kind == "id"]
                if ids:
                    st.fields.append((ids[-1].text, part[eq + 1:]
                                      if eq is not None else []))
        k = e + 1
    unit.structs.setdefault(name, []).append(st)
    e = close + 1
    while e < len(toks) and toks[e].text != ";":
        e += 1
    return e + 1


def _parse_enum(unit, toks, i, ns, struct: Struct | None = None) -> int:
    j = i + 1
    while toks[j].text not in ("{", ";"):
        j += 1
    if toks[j].text == ";":
        return j + 1
    close = match_close(toks, j)
    value: list[Tok] = [Tok("num", "-1", toks[j].line, toks[j].file)]
    n = 0
    for part in split_top(toks[j + 1:close]):
        if not part:
            continue
        nm = part[0].text
        if len(part) > 2 and part[1].text == "=":
            expr = part[2:]
            n = 0
        else:
            expr = None
            n += 1
        if expr is None:
            expr = value + [Tok("op", "+", part[0].line, part[0].file),
                            Tok("num", "1", part[0].line, part[0].file)]
        value = [Tok("op", "(", part[0].line, part[0].file)] + expr + [
            Tok("op", ")", part[0].line, part[0].file)]
        if struct is not None:
            struct.members[nm] = value
        else:
            unit.consts[_q(ns, nm)] = (ns, value)
    e = close + 1
    while e < len(toks) and toks[e].text != ";":
        e += 1
    return e + 1


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------


@dataclass
class Stmt:
    kind: str                 # block if for while do switch simple return
    toks: list[Tok] = field(default_factory=list)  # simple/return/cond
    body: list["Stmt"] = field(default_factory=list)
    orelse: list["Stmt"] = field(default_factory=list)
    init: list[Tok] = field(default_factory=list)
    step: list[Tok] = field(default_factory=list)
    line: int = 0
    constexpr: bool = False


def parse_block(toks: list[Tok]) -> list[Stmt]:
    out: list[Stmt] = []
    i = 0
    while i < len(toks):
        st, i = _parse_stmt(toks, i)
        if st is not None:
            out.append(st)
    return out


def _parse_stmt(toks, i) -> tuple[Stmt | None, int]:
    t = toks[i]
    s = t.text
    if s == ";":
        return None, i + 1
    if s == "{":
        c = match_close(toks, i)
        return Stmt("block", body=parse_block(toks[i + 1:c]), line=t.line), \
            c + 1
    if s == "#":
        return None, i + 1
    if s == "if":
        j = i + 1
        cexpr = False
        if toks[j].text == "constexpr":
            cexpr = True
            j += 1
        c = match_close(toks, j)
        cond = toks[j + 1:c]
        body, k = _parse_stmt(toks, c + 1)
        orelse = None
        if k < len(toks) and toks[k].text == "else":
            orelse, k = _parse_stmt(toks, k + 1)
        return Stmt("if", toks=cond, body=_as_list(body),
                    orelse=_as_list(orelse), line=t.line,
                    constexpr=cexpr), k
    if s == "for":
        c = match_close(toks, i + 1)
        parts = _split_semis(toks[i + 2:c])
        body, k = _parse_stmt(toks, c + 1)
        init, cond, step = (parts + [[], [], []])[:3]
        return Stmt("for", toks=cond, init=init, step=step,
                    body=_as_list(body), line=t.line), k
    if s == "while":
        c = match_close(toks, i + 1)
        body, k = _parse_stmt(toks, c + 1)
        return Stmt("while", toks=toks[i + 2:c], body=_as_list(body),
                    line=t.line), k
    if s == "do":
        body, k = _parse_stmt(toks, i + 1)
        # while ( cond ) ;
        c = match_close(toks, k + 1)
        return Stmt("do", toks=toks[k + 2:c], body=_as_list(body),
                    line=t.line), c + 2
    if s == "switch":
        c = match_close(toks, i + 1)
        body, k = _parse_stmt(toks, c + 1)
        return Stmt("switch", toks=toks[i + 2:c], body=_as_list(body),
                    line=t.line), k
    if s in ("case", "default"):
        j = i
        while toks[j].text != ":" or (j + 1 < len(toks)
                                      and toks[j + 1].text == ":"):
            if toks[j].text == "::":
                j += 1
            j += 1
        return Stmt("label", toks=toks[i + 1:j], line=t.line), j + 1
    # a simple statement: up to the ; at depth 0
    j = i
    while j < len(toks) and toks[j].text != ";":
        if toks[j].text in ("(", "[", "{"):
            j = match_close(toks, j)
        j += 1
    kind = "return" if s == "return" else "simple"
    return Stmt(kind, toks=toks[i + (1 if kind == "return" else 0):j],
                line=t.line), j + 1


def _as_list(st: Stmt | None) -> list[Stmt]:
    if st is None:
        return []
    return st.body if st.kind == "block" else [st]


def _split_semis(toks):
    out = [[]]
    depth = 0
    for t in toks:
        if t.text in ("(", "[", "{"):
            depth += 1
        elif t.text in (")", "]", "}"):
            depth -= 1
        if t.text == ";" and depth == 0:
            out.append([])
        else:
            out[-1].append(t)
    return out


def lambdas_in(toks: list[Tok], parent: Function) -> list[Function]:
    """``auto name = [&](params) { body };`` definitions in ``toks``."""
    out = []
    for i in range(len(toks) - 4):
        if toks[i].text == "auto" and toks[i + 1].kind == "id" and \
                toks[i + 2].text == "=" and toks[i + 3].text == "[":
            c = match_close(toks, i + 3)
            if toks[c + 1].text != "(":
                continue
            pc = match_close(toks, c + 1)
            if pc + 1 >= len(toks) or toks[pc + 1].text != "{":
                continue
            bc = match_close(toks, pc + 1)
            params = []
            for part in split_top(toks[c + 2:pc]):
                amp = next((m for m, x in enumerate(part) if x.text == "&"
                            and m > 0 and part[m - 1].text == "("), None)
                if amp is not None:
                    params.append((part[amp + 1].text, part))
                    continue
                brk = next((m for m, x in enumerate(part) if x.text == "["),
                           None)
                ids = [x for x in (part[:brk] if brk else part)
                       if x.kind == "id"]
                if ids:
                    params.append((ids[-1].text, part))
            out.append(Function(
                name=toks[i + 1].text, ns=parent.ns, template=None,
                params=params, body=toks[pc + 2:bc], quals={"lambda"},
                launch_bounds=None, line=toks[i].line, file=toks[i].file,
                parent=parent))
    return out


# ---------------------------------------------------------------------------
# integer constant expressions
# ---------------------------------------------------------------------------


class Unbound(Exception):
    """An expression names something this front end cannot bind."""

    def __init__(self, names):
        super().__init__(", ".join(sorted(set(names))))
        self.names = set(names)


@dataclass(frozen=True)
class TypeVal:
    """A type: a scalar's name, or a struct instance."""

    name: str
    args: tuple = ()
    ns: str = ""

    def __str__(self):
        if not self.args:
            return self.name
        return f"{self.name}<{', '.join(map(fmt_arg, self.args))}>"


def fmt_arg(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, TypeVal):
        return str(v)
    return str(v)


SCALAR_SIZES = {
    "float": 4, "int": 4, "unsigned": 4, "uint32_t": 4, "int32_t": 4,
    "uint64_t": 8, "int64_t": 8, "long": 8, "double": 8, "char": 1,
    "uint8_t": 1, "int8_t": 1, "short": 2, "uint16_t": 2, "int16_t": 2,
    "__nv_bfloat16": 2, "bf16": 2, "half": 2, "__half": 2,
    "__nv_fp8_e4m3": 1, "__nv_fp8_e5m2": 1, "bool": 1,
    "float2": 8, "float4": 16, "int2": 8, "int4": 16, "uint2": 8,
    "uint4": 16, "size_t": 8, "unsigned char": 1, "unsigned int": 4,
    "long long": 8, "unsigned long long": 8, "unsigned long": 8,
    "unsigned short": 2,
}
_CAST_WORDS = set(SCALAR_SIZES) | {"unsigned", "long", "signed", "const"}
SCALAR_ALIGN = {"float2": 8, "float4": 16, "int2": 8, "int4": 16,
                "uint2": 8, "uint4": 16}


class Env:
    """Name bindings for evaluation: locals (template args, constants,
    aliases) over the unit's namespace scopes."""

    def __init__(self, unit: Unit, ns: str = "",
                 vars: dict | None = None, parent: "Env | None" = None,
                 struct: tuple[Struct, dict] | None = None):
        self.unit = unit
        self.ns = ns
        self.vars = dict(vars or {})
        self.parent = parent
        self.struct = struct  # (struct, its bindings) for member lookup
        self._busy: set[str] = set()
        #: keep a forced lazy binding (off where a binding depends on the
        #: thread being evaluated)
        self.cache = parent.cache if parent is not None else True
        #: builtin calls: name -> fn(evaluate, args)
        self.calls = parent.calls if parent is not None else {}
        #: with cache off: a lazy's value is kept per stamp() (the thread
        #: being evaluated)
        self.stamp = parent.stamp if parent is not None else (lambda: None)
        self.stamped: dict = {}

    def child(self, vars=None, ns=None, struct=None) -> "Env":
        return Env(self.unit, self.ns if ns is None else ns, vars, self,
                   struct)

    # -- lookup ----------------------------------------------------------

    def lookup(self, name: str):
        """The value of a (possibly qualified) name; Unbound if none."""
        if "::" not in name:
            e: Env | None = self
            while e is not None:
                if name in e.vars:
                    v = e.vars[name]
                    if isinstance(v, _Lazy):
                        if self.cache:
                            v = v.force()
                            e.vars[name] = v
                        else:
                            key = (name, self.stamp())
                            if key in e.stamped:
                                return e.stamped[key]
                            v = v.force()
                            e.stamped[key] = v
                    return v
                if e.struct is not None:
                    v = struct_member(self.unit, e.struct[0], e.struct[1],
                                      name, missing=True)
                    if v is not _MISSING:
                        return v
                e = e.parent
        return self.lookup_ns(name)

    def lookup_ns(self, name: str):
        unit = self.unit
        scopes = []
        ns = self.ns
        while True:
            scopes.append(ns)
            if not ns:
                break
            ns = ns.rsplit("::", 1)[0] if "::" in ns else ""
        head, _, rest = name.partition("::")
        for sc in scopes:
            key = _q(sc, name)
            if key in unit.consts:
                if key in self._busy:
                    raise Unbound([name])
                self._busy.add(key)
                try:
                    cns, expr = unit.consts[key]
                    return evaluate(expr, Env(unit, cns))
                finally:
                    self._busy.discard(key)
            if key in unit.aliases:
                al = unit.aliases[key]
                if len(al) > 1 and any(t.text == "::" for t in al) and \
                        al[-1].text == name.rsplit("::", 1)[-1] and \
                        al[0].text != "typename":
                    return Env(unit, "").lookup("".join(t.text for t in al))
                return eval_type(al, Env(unit, sc))
        # Struct::member with a non-template struct
        if rest:
            for sc in scopes:
                sts = [x for x in unit.structs.get(head, ())
                       if _in_scope(x.ns, self.ns, "")]
                if sts:
                    st = next((s for s in sts if s.template is None), None)
                    if st is not None:
                        return struct_member(unit, st, {}, rest)
        base = name.rsplit("::", 1)[-1]
        if base in SCALAR_SIZES or base in ("void",):
            return TypeVal(base)
        raise Unbound([name])


class _Lazy:
    def __init__(self, fn):
        self.fn = fn

    def force(self):
        return self.fn()


_MISSING = object()


def _in_scope(cand_ns: str, ns: str, qual: str) -> bool:
    if qual:
        return cand_ns == qual or cand_ns.endswith("::" + qual)
    return cand_ns == "" or ns == cand_ns or ns.startswith(cand_ns + "::")


def find_struct(unit: Unit, name: str, args: tuple, ns: str = ""
                ) -> tuple[Struct, dict]:
    base = name.rsplit("::", 1)[-1]
    qual = name.rsplit("::", 1)[0] if "::" in name else ""
    cands = [st for st in unit.structs.get(base, ())
             if _in_scope(st.ns, ns, qual)]
    if not cands:
        cands = list(unit.structs.get(base, ()))
    if not cands:
        raise Unbound([name])
    cands.sort(key=lambda st: -len(st.ns))
    # a specialization whose args match first
    for st in cands:
        if st.spec_args is not None:
            env = Env(unit, st.ns)
            try:
                spec = tuple(eval_arg(a, env) for a in st.spec_args)
            except Unbound:
                continue
            if spec == args:
                return st, {}
    for st in cands:
        if st.spec_args is None:
            binds = {}
            if st.template is not None:
                for k, nm in enumerate(st.template.names):
                    if k < len(args):
                        binds[nm] = args[k]
                    elif st.template.defaults[k] is not None:
                        binds[nm] = eval_arg(st.template.defaults[k],
                                             Env(unit, st.ns, binds))
            return st, binds
    raise Unbound([f"{name}<{', '.join(map(fmt_arg, args))}>"])


def struct_member(unit: Unit, st: Struct, binds: dict, name: str,
                  missing: bool = False):
    env = Env(unit, st.ns, binds)
    env.struct = None
    if name in st.members:
        inner = Env(unit, st.ns, binds, struct=(st, binds))
        return evaluate(st.members[name], inner)
    if name in st.aliases:
        inner = Env(unit, st.ns, binds, struct=(st, binds))
        return eval_type(st.aliases[name], inner)
    for b in st.bases:
        try:
            bt = eval_type(b, Env(unit, st.ns, binds))
        except Unbound:
            continue
        if isinstance(bt, TypeVal) and bt.name in unit.structs:
            bst, bb = find_struct(unit, bt.name, bt.args, bt.ns or st.ns)
            v = struct_member(unit, bst, bb, name, missing=True)
            if v is not _MISSING:
                return v
    if missing:
        return _MISSING
    raise Unbound([f"{st.name}::{name}"])


def eval_arg(toks: list[Tok], env: Env):
    """A template argument: a type or a constant."""
    if len(toks) >= 1 and toks[0].kind == "id" and (
            toks[0].text in SCALAR_SIZES or toks[0].text in ("unsigned",
                                                             "signed")):
        if len(toks) == 1 or all(t.kind == "id" for t in toks):
            return TypeVal(" ".join(t.text for t in toks))
    try:
        return evaluate(toks, env)
    except Unbound:
        if toks and toks[0].kind == "id" and toks[0].text in env.unit.structs:
            return eval_type(toks, env)
        raise


def eval_type(toks: list[Tok], env: Env):
    """A type expression: ``Cfg<D, NWG>``, ``float``, an alias."""
    toks = [t for t in toks if t.text not in ("typename", "const",
                                              "volatile")]
    if not toks:
        raise Unbound(["<empty type>"])
    # Name<args> [:: member]
    name = toks[0].text
    i = 1
    while i + 1 < len(toks) and toks[i].text == "::":
        name += "::" + toks[i + 1].text
        i += 2
    args: tuple = ()
    if i < len(toks) and toks[i].text == "<":
        c = match_angle(toks, i)
        args = tuple(eval_arg(a, env) for a in split_top(toks[i + 1:c]))
        i = c + 1
    if i < len(toks) and toks[i].text == "::":
        st, binds = find_struct(env.unit, name, args, env.ns)
        return struct_member(env.unit, st, binds,
                             "".join(t.text for t in toks[i + 1:]))
    base = name.rsplit("::", 1)[-1]
    if base in env.unit.structs:
        st, _ = find_struct(env.unit, name, args, env.ns)
        return TypeVal(base, args, st.ns)
    if len(toks) > 1 and all(t.kind == "id" for t in toks):
        return TypeVal(" ".join(t.text for t in toks))
    try:
        v = env.lookup(name)
    except Unbound:
        if base in SCALAR_SIZES:
            return TypeVal(base)
        raise
    return v


def sizeof(v) -> int:
    if isinstance(v, TypeVal):
        if v.name in SCALAR_SIZES:
            return SCALAR_SIZES[v.name]
    raise Unbound([f"sizeof({v})"])


# -- the evaluator: a precedence climber over tokens ------------------------

_BIN = {
    "||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7, "<<": 8, ">>": 8,
    "+": 9, "-": 9, "*": 10, "/": 10, "%": 10,
}


def evaluate(toks: list[Tok], env: Env):
    """The value of an integer constant expression; Unbound names
    whatever it could not resolve."""
    p = _Parser(toks, env)
    try:
        v = p.expr()
    except IndexError:
        raise Unbound([f"truncated '{text_of(toks)}'"]) from None
    if p.i < len(toks):
        raise Unbound([f"unparsed '{text_of(toks[p.i:])}'"])
    return v


def _num(text: str):
    t = text.rstrip("uUlL")
    if t.lower().startswith("0x"):
        return int(t, 16)
    if any(c in t for c in ".eE") or text[-1:] in "fF":
        return float(t.rstrip("fF"))
    return int(t)


def _cdiv(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a / b
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cmod(a, b):
    return a - _cdiv(a, b) * b


class _Parser:
    def __init__(self, toks, env):
        self.t = toks
        self.i = 0
        self.env = env

    def peek(self, k=0):
        j = self.i + k
        return self.t[j].text if j < len(self.t) else None

    def take(self, s=None):
        tok = self.t[self.i]
        if s is not None and tok.text != s:
            raise Unbound([f"expected {s!r} at '{text_of(self.t[self.i:])}'"])
        self.i += 1
        return tok

    def expr(self):
        v = self.binary(1)
        if self.peek() == "?":
            self.take("?")
            # evaluate both arms lazily: only the taken arm must bind
            start = self.i
            a_err = b_err = None
            try:
                a = self.expr()
            except Unbound as e:
                a_err = e
                self._skip_to_colon(start)
            self.take(":")
            try:
                b = self.expr()
            except Unbound as e:
                b_err = e
                b = None
            if v:
                if a_err:
                    raise a_err
                return a
            if b_err:
                raise b_err
            return b
        return v

    def _skip_to_colon(self, start):
        depth = 0
        self.i = start
        while self.i < len(self.t):
            s = self.t[self.i].text
            if s in ("(", "[", "{"):
                depth += 1
            elif s in (")", "]", "}"):
                depth -= 1
            elif s == "?":
                depth += 1
            elif s == ":" and depth == 0:
                return
            elif s == ":" and depth > 0:
                depth -= 1
            self.i += 1

    def binary(self, prec):
        lhs = self.unary()
        while True:
            op = self.peek()
            p = _BIN.get(op)
            if p is None or p < prec:
                return lhs
            self.take()
            if op == "&&" and not lhs:
                self.binary(p + 1) if False else self._skip_operand(p + 1)
                lhs = False
                continue
            if op == "||" and lhs:
                self._skip_operand(p + 1)
                lhs = True
                continue
            rhs = self.binary(p + 1)
            lhs = _apply(op, lhs, rhs)

    def _skip_operand(self, prec):
        try:
            self.binary(prec)
        except Unbound:
            # skip tokens up to the next operator of lower precedence
            depth = 0
            while self.i < len(self.t):
                s = self.t[self.i].text
                if s in ("(", "["):
                    depth += 1
                elif s in (")", "]"):
                    if depth == 0:
                        return
                    depth -= 1
                elif depth == 0 and (s in ("?", ":", ",") or (
                        s in _BIN and _BIN[s] < prec)):
                    return
                self.i += 1

    def unary(self):
        s = self.peek()
        if s == "-":
            self.take()
            return -self.unary()
        if s == "+":
            self.take()
            return self.unary()
        if s == "!":
            self.take()
            return not self.unary()
        if s == "~":
            self.take()
            return ~self.unary()
        if s == "(":
            # a cast `(int)x` or a parenthesized expression
            j = self.i + 1
            k = j
            while k < len(self.t) and self.t[k].kind == "id" and \
                    self.t[k].text in _CAST_WORDS:
                k += 1
            if k > j and k < len(self.t) and self.t[k].text == ")":
                ty = " ".join(x.text for x in self.t[j:k])
                self.i = k + 1
                return _cast(ty, self.unary())
            self.take("(")
            v = self.expr()
            while self.peek() == ",":
                self.take()
                v = self.expr()
            self.take(")")
            return self.postfix(v)
        return self.postfix(self.primary())

    def postfix(self, v):
        return v

    def primary(self):
        tok = self.take()
        if tok.kind == "num":
            return _num(tok.text)
        if tok.kind == "chr":
            return ord(tok.text[1:-1][-1])
        if tok.kind != "id":
            raise Unbound([f"'{tok.text}'"])
        s = tok.text
        if s in ("true", "false"):
            return s == "true"
        if s == "nullptr":
            return 0
        if s == "sizeof":
            self.take("(")
            c = match_close(self.t, self.i - 1)
            inner = self.t[self.i:c]
            self.i = c + 1
            try:
                return sizeof(eval_type(inner, self.env))
            except Unbound:
                return sizeof(TypeVal(" ".join(x.text for x in inner)))
        if s in ("static_cast", "reinterpret_cast", "const_cast"):
            c = match_angle(self.t, self.i)
            ty = " ".join(x.text for x in self.t[self.i + 1:c])
            self.i = c + 1
            self.take("(")
            v = self.expr()
            self.take(")")
            return _cast(ty, v)
        if s in ("min", "max", "std::min", "std::max") and self.peek() == "(":
            self.take("(")
            a = self.expr()
            self.take(",")
            b = self.expr()
            self.take(")")
            return min(a, b) if s.endswith("min") else max(a, b)
        # a (qualified) name, maybe with template args and ::member
        name = s
        while self.peek() == "::" and self.i + 1 < len(self.t):
            self.take("::")
            name += "::" + self.take().text
        if self.peek() == "<" and (name.rsplit("::", 1)[-1]
                                   in self.env.unit.structs):
            c = match_angle(self.t, self.i)
            args = tuple(eval_arg(a, self.env)
                         for a in split_top(self.t[self.i + 1:c]))
            self.i = c + 1
            st, binds = find_struct(self.env.unit, name, args, self.env.ns)
            if self.peek() == "::":
                self.take("::")
                mem = self.take().text
                return struct_member(self.env.unit, st, binds, mem)
            return TypeVal(st.name, args, st.ns)
        if self.peek() == "(":
            fn = self.env.calls.get(name)
            if fn is None:
                raise Unbound([f"{name}(...)"])
            c = match_close(self.t, self.i)
            args = split_top(self.t[self.i + 1:c])
            self.i = c + 1
            return fn(lambda a: evaluate(a, self.env), args)
        if "::" in name:
            head, _, mem = name.rpartition("::")
            try:
                v = self.env.lookup(head)
            except Unbound:
                v = None
            if isinstance(v, TypeVal) and v.name in self.env.unit.structs:
                st, binds = find_struct(self.env.unit, v.name, v.args,
                                        v.ns or self.env.ns)
                return struct_member(self.env.unit, st, binds, mem)
        v = self.env.lookup(name)
        if self.peek() == "." and isinstance(v, dict):
            self.take(".")
            mem = self.take().text
            if mem in v:
                return v[mem]
            raise Unbound([f"{name}.{mem}"])
        return v


def _cast(ty: str, v):
    if "float" in ty or "double" in ty:
        return float(v)
    if "bool" in ty:
        return bool(v)
    v = int(v)
    if "unsigned" in ty or "uint32" in ty:
        return v & 0xFFFFFFFF if "long" not in ty else v & (2 ** 64 - 1)
    return v


def _apply(op, a, b):
    if isinstance(a, TypeVal) or isinstance(b, TypeVal):
        if op in ("==", "!="):
            return (a == b) == (op == "==")
        raise Unbound([f"{a} {op} {b}"])
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if b == 0:
            raise Unbound(["division by zero"])
        return _cdiv(a, b)
    if op == "%":
        if b == 0:
            raise Unbound(["division by zero"])
        return _cmod(a, b)
    if op == "<<":
        return int(a) << int(b)
    if op == ">>":
        return int(a) >> int(b)
    if op == "&":
        return int(a) & int(b)
    if op == "|":
        return int(a) | int(b)
    if op == "^":
        return int(a) ^ int(b)
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "&&":
        return bool(a) and bool(b)
    if op == "||":
        return bool(a) or bool(b)
    raise Unbound([op])


def names_in(toks: list[Tok]) -> set[str]:
    """Identifiers an expression reads (qualified names joined)."""
    out = set()
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "id":
            name = t.text
            while i + 2 < len(toks) and toks[i + 1].text == "::":
                name += "::" + toks[i + 2].text
                i += 2
            if not (i > 0 and toks[i - 1].text in (".", "->")):
                out.add(name)
        i += 1
    return out
