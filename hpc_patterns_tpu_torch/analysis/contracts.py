"""contractlint extraction: whole-tree producer/consumer tables (the
counterpart of ``hpc_patterns_tpu/analysis/contracts.py``).

The repo's cross-module seams are stringly typed by design — metric
names (``harness/metrics.py``), RunLog record kinds
(``harness/runlog.py``), bench gate keys (``harness/regress.py``
``SPECS`` vs. the ``detail`` dicts the benches emit), the migration
wire codec's field names (``serving_plane/migration.py``), Perfetto
device-subtrack bands (``harness/trace.py`` ``TRACK_BANDS``), and
chaos site/kind names (``harness/chaos.py``). Every one of them is a
producer/consumer contract that Python cannot check, and the review
pass of PRs 5/9/16/17/18 caught drift in each BY HAND.

This module is the first pass of the contractlint family
(``contract_rules.py``): pure stdlib ``ast`` extraction of the
producer and consumer tables, per module, merged over a TREE. The
rules (second pass) judge a module's own sites against the merged
tables, so a deleted emitter becomes a finding at the surviving
consumer's line — review-time, not a runtime coverage-loss warning.

Tree resolution (``tables_for``): a module under the live repo (an
ancestor directory holding both ``chip_smoke.py`` and the
``hpc_patterns_tpu_torch`` package) is judged against tables merged
over the port's whole tree — the package, ``chip_smoke.py`` and
``tests/test_torch_*.py`` (fixture corpora excluded); the gate keys'
producer side is the port's benches (``hpc_patterns_tpu_torch/bench*.py``).
A module under a ``fixtures`` directory — or outside any repo root — is
judged SELF-CONTAINED: its own file is the whole tree, which is what
makes the bad/clean fixture twins reproducible without dragging the
live tables in.

Like the rest of the analyzer, nothing here imports the code under
analysis; the live-tree tables are cached per root for the process
lifetime (the tree does not change under a single analyzer run).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from hpc_patterns_tpu_torch.analysis.core import (ModuleInfo, iter_python_files,
                                                  walk)

#: chaos spec literals look like "kind:key=val,...;kind:..." — the
#: kind prefix is the contract half checked against chaos.KINDS
_CHAOS_SPEC_RE = re.compile(r"^[a-z_]+:[a-z_]+=")

#: calls whose first string argument claims a chaos SITE name
_CHAOS_SITE_FUNCS = frozenset(
    {"maybe_inject", "matching", "suppress", "record_injection"})

#: call keywords / function names that carry a chaos SPEC string
_CHAOS_SPEC_KWARGS = frozenset({"chaos_spec", "chaos", "spec"})
_CHAOS_SPEC_FUNCS = frozenset({"configure", "parse"})


@dataclass(frozen=True)
class Site:
    """One producer or consumer occurrence: where, and which name."""

    path: str
    line: int
    col: int
    name: str
    #: role-specific payload (e.g. the band range, the spec path)
    detail: str = ""


@dataclass(frozen=True)
class Band:
    """One device-subtrack band: ``[base, base + count)``."""

    name: str
    base: int
    count: int
    site: Site

    @property
    def hi(self) -> int:
        return self.base + self.count - 1

    def overlaps(self, other: "Band") -> bool:
        return (self.base <= other.hi and other.base <= self.hi)

    def covers(self, track: int) -> bool:
        return self.base <= track <= self.hi


@dataclass
class ContractTables:
    """The merged producer/consumer tables for one tree."""

    root: str = ""  # "" = self-contained single module
    files: tuple[str, ...] = ()
    # -- telemetry (metric names + device-window span names) --------
    gauges_produced: dict[str, list[Site]] = field(default_factory=dict)
    #: f-string producers ("plane.{name}.queue_depth") reduced to
    #: their literal prefix — consumers match by startswith
    gauge_prefixes: list[Site] = field(default_factory=list)
    gauges_consumed: list[Site] = field(default_factory=list)
    spans_produced: dict[str, list[Site]] = field(default_factory=dict)
    spans_consumed: list[Site] = field(default_factory=list)
    # -- bench gate keys --------------------------------------------
    #: every string key a bench-tree dict literal/store emits
    detail_keys: dict[str, list[Site]] = field(default_factory=dict)
    #: MetricSpec(...) paths consumed by the regression gate
    gate_specs: list[Site] = field(default_factory=list)
    # -- RunLog record kinds ----------------------------------------
    kinds_produced: dict[str, list[Site]] = field(default_factory=dict)
    kinds_consumed: dict[str, list[Site]] = field(default_factory=dict)
    #: FORENSIC_KINDS declarations: written for the record stream /
    #: replay tooling, deliberately never string-dispatched
    forensic_kinds: dict[str, Site] = field(default_factory=dict)
    # -- Perfetto device-subtrack bands -----------------------------
    #: TRACK_BANDS registry literal(s): name -> Band
    declared_bands: dict[str, Band] = field(default_factory=dict)
    #: track_band("<name>") references at module scope / call sites
    band_refs: list[Site] = field(default_factory=list)
    #: hand-written ``*_TRACK_BASE = <int>`` literals
    band_literals: list[Site] = field(default_factory=list)
    #: ``track=<int>`` literal call-site arguments
    track_literals: list[Site] = field(default_factory=list)
    # -- chaos ------------------------------------------------------
    chaos_kinds: dict[str, Site] = field(default_factory=dict)
    chaos_sites: dict[str, Site] = field(default_factory=dict)
    chaos_site_claims: list[Site] = field(default_factory=list)
    chaos_kind_claims: list[Site] = field(default_factory=list)

    def merge(self, other: "ContractTables") -> None:
        for name, sites in other.gauges_produced.items():
            self.gauges_produced.setdefault(name, []).extend(sites)
        self.gauge_prefixes.extend(other.gauge_prefixes)
        self.gauges_consumed.extend(other.gauges_consumed)
        for name, sites in other.spans_produced.items():
            self.spans_produced.setdefault(name, []).extend(sites)
        self.spans_consumed.extend(other.spans_consumed)
        for name, sites in other.detail_keys.items():
            self.detail_keys.setdefault(name, []).extend(sites)
        self.gate_specs.extend(other.gate_specs)
        for name, sites in other.kinds_produced.items():
            self.kinds_produced.setdefault(name, []).extend(sites)
        for name, sites in other.kinds_consumed.items():
            self.kinds_consumed.setdefault(name, []).extend(sites)
        self.forensic_kinds.update(other.forensic_kinds)
        self.declared_bands.update(other.declared_bands)
        self.band_refs.extend(other.band_refs)
        self.band_literals.extend(other.band_literals)
        self.track_literals.extend(other.track_literals)
        self.chaos_kinds.update(other.chaos_kinds)
        self.chaos_sites.update(other.chaos_sites)
        self.chaos_site_claims.extend(other.chaos_site_claims)
        self.chaos_kind_claims.extend(other.chaos_kind_claims)

    # -- lookups the rules share ------------------------------------

    def gauge_has_producer(self, name: str) -> bool:
        if name in self.gauges_produced:
            return True
        return any(name.startswith(p.name) for p in self.gauge_prefixes)

    def band_covering(self, track: int) -> Band | None:
        for band in self.declared_bands.values():
            if band.covers(track):
                return band
        return None


# ---------------------------------------------------------------------------
# per-module extraction
# ---------------------------------------------------------------------------


def _is_chaos_call(mod: ModuleInfo, fn: ast.AST) -> bool:
    resolved = (mod.resolve(fn) or "").lower()
    return ("chaos" in resolved
            or "chaos" in Path(mod.path).stem.lower())


def _site(path: str, node: ast.AST, name: str, detail: str = "") -> Site:
    return Site(path=path, line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0), name=name,
                detail=detail)


def _last_segment(mod: ModuleInfo, node: ast.AST) -> str:
    return (mod.resolve(node) or "").rsplit(".", 1)[-1]


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _int_const(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _module_str_constants(mod: ModuleInfo) -> dict[str, str]:
    """Top-level ``NAME = "literal"`` assignments — both sides of a
    kind contract may spell the kind through one (``FITTED_KIND``,
    ``ROLLUP_KIND``), and the extraction must see through it."""
    out: dict[str, str] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = _str_const(node.value)
            if value is not None:
                out[node.targets[0].id] = value
    return out


def _reads_kind_field(node: ast.AST) -> bool:
    """``rec["kind"]`` or ``rec.get("kind", ...)``."""
    if isinstance(node, ast.Subscript):
        return _str_const(node.slice) == "kind"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return (node.func.attr == "get" and node.args
                and _str_const(node.args[0]) == "kind")
    return False


def _kind_vars(tree: ast.Module) -> set[str]:
    """Names bound from a record's kind field (``kind =
    rec.get("kind", "?")``) — ONLY such names count as kind reads
    when compared bare, so the many other ``kind`` locals in the tree
    (chaos fault kinds, CLI command kinds, lifecycle-segment kinds)
    never register as record-kind consumers."""
    out: set[str] = set()
    for node in walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _reads_kind_field(node.value):
            out.add(node.targets[0].id)
    return out


def _kind_expr(node: ast.AST, kind_vars: set[str]) -> bool:
    """Does this expression read a record's ``kind``? Covers the
    repo's three consumer spellings: ``rec["kind"]``,
    ``rec.get("kind", ...)``, and a variable bound from either."""
    if _reads_kind_field(node):
        return True
    return isinstance(node, ast.Name) and node.id in kind_vars


def _str_tuple_elems(node: ast.AST) -> list[ast.Constant] | None:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)) and all(
            _str_const(e) is not None for e in node.elts):
        return list(node.elts)  # type: ignore[return-value]
    return None


def extract_module(mod: ModuleInfo,
                   bench_producer: bool = True) -> ContractTables:
    """One module's contract sites. ``bench_producer`` gates the
    detail-key harvest: in a live tree only the port's benches'
    (``bench*.py``) dict keys count as gate-key emitters (a test
    fabricating a round must not satisfy the gate table); a
    self-contained fixture is its own bench."""
    t = ContractTables()
    path = mod.path
    consts = _module_str_constants(mod)
    kind_vars = _kind_vars(mod.tree)

    def const_or_name(node: ast.AST) -> str | None:
        s = _str_const(node)
        if s is not None:
            return s
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        return None

    # ---- module-level declarations (plain or annotated assigns) ----
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target = node.target
        else:
            continue
        # TRACK_BANDS = {"name": (base, count), ...}
        if isinstance(target, ast.Name) and target.id == "TRACK_BANDS" \
                and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                name = _str_const(k) if k is not None else None
                if name is None or not isinstance(v, ast.Tuple) \
                        or len(v.elts) != 2:
                    continue
                base, count = (_int_const(v.elts[0]),
                               _int_const(v.elts[1]))
                if base is None or count is None:
                    continue
                t.declared_bands[name] = Band(
                    name=name, base=base, count=count,
                    site=_site(path, v, name, f"{base}..+{count}"))
        # FORENSIC_KINDS = ("...",)
        elif isinstance(target, ast.Name) \
                and target.id == "FORENSIC_KINDS":
            for e in _str_tuple_elems(node.value) or ():
                t.forensic_kinds[e.value] = _site(path, e, e.value)
        # chaos KINDS / SITES declarations (harness/chaos.py shape)
        elif isinstance(target, ast.Name) and target.id == "KINDS":
            for e in _str_tuple_elems(node.value) or ():
                t.chaos_kinds[e.value] = _site(path, e, e.value)
        elif isinstance(target, ast.Name) and target.id == "SITES":
            for e in _str_tuple_elems(node.value) or ():
                t.chaos_sites[e.value] = _site(path, e, e.value)
        # _DEFAULT_SITE = {"kind": "site"} — claims BOTH halves
        elif isinstance(target, ast.Name) \
                and target.id == "_DEFAULT_SITE" \
                and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if k is not None and _str_const(k) is not None:
                    t.chaos_kind_claims.append(
                        _site(path, k, _str_const(k), "default-site key"))
                if _str_const(v) is not None:
                    t.chaos_site_claims.append(
                        _site(path, v, _str_const(v),
                              "default-site value"))
        # hand-written band base: FOO_TRACK_BASE = <int>
        elif isinstance(target, ast.Name) \
                and target.id.endswith("_TRACK_BASE"):
            base = _int_const(node.value)
            if base is not None:
                t.band_literals.append(
                    _site(path, node.value, target.id, str(base)))

    # ---- whole-tree walk ------------------------------------------
    for node in walk(mod.tree):
        # dict literals: bench detail keys + "kind": producers
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                key = _str_const(k) if k is not None else None
                if key is None:
                    continue
                if bench_producer:
                    t.detail_keys.setdefault(key, []).append(
                        _site(path, k, key))
                if key == "kind":
                    kind = const_or_name(v)
                    if kind is not None:
                        t.kinds_produced.setdefault(kind, []).append(
                            _site(path, v, kind))
            continue
        # subscript stores: x["k"] = ... (bench keys + kind)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Subscript):
            key = _str_const(node.targets[0].slice)
            if key is not None:
                if bench_producer:
                    t.detail_keys.setdefault(key, []).append(
                        _site(path, node.targets[0], key))
                if key == "kind":
                    kind = const_or_name(node.value)
                    if kind is not None:
                        t.kinds_produced.setdefault(kind, []).append(
                            _site(path, node.value, kind))
            continue
        # comparisons: kind dispatch (==/!=/in/not in)
        if isinstance(node, ast.Compare) and len(node.comparators) == 1:
            left, op, right = (node.left, node.ops[0],
                               node.comparators[0])
            if isinstance(op, (ast.Eq, ast.NotEq)):
                for a, b in ((left, right), (right, left)):
                    if not _kind_expr(a, kind_vars):
                        continue
                    kind = const_or_name(b)
                    if kind is not None:
                        t.kinds_consumed.setdefault(kind, []).append(
                            _site(path, b, kind))
            elif isinstance(op, (ast.In, ast.NotIn)) \
                    and _kind_expr(left, kind_vars):
                for e in _str_tuple_elems(right) or ():
                    t.kinds_consumed.setdefault(e.value, []).append(
                        _site(path, e, e.value))
            continue
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")

        # kind= producer keyword on any call (RunLog.emit, _emit, ...)
        for kw in node.keywords:
            if kw.arg == "kind":
                kind = const_or_name(kw.value)
                if kind is not None:
                    t.kinds_produced.setdefault(kind, []).append(
                        _site(path, kw.value, kind))
            # track=<int literal> call-site argument
            elif kw.arg == "track":
                track = _int_const(kw.value)
                if track is not None:
                    t.track_literals.append(
                        _site(path, kw.value, fname, str(track)))

        # metric producers: <registry>.gauge/counter/histogram("name")
        if isinstance(fn, ast.Attribute) and fn.attr in (
                "gauge", "counter", "histogram") and node.args:
            name = _str_const(node.args[0])
            if name is not None:
                t.gauges_produced.setdefault(name, []).append(
                    _site(path, node.args[0], name, fn.attr))
            elif isinstance(node.args[0], ast.JoinedStr):
                parts = node.args[0].values
                prefix = parts[0].value if parts and isinstance(
                    parts[0], ast.Constant) else ""
                if isinstance(prefix, str) and prefix:
                    t.gauge_prefixes.append(
                        _site(path, node.args[0], prefix, fn.attr))
        # metric consumers: gauges.get("mem.hbm_pages") — the base
        # name says which table is being read; dotted names only so
        # field lookups like g.get("n") never register
        elif isinstance(fn, ast.Attribute) and fn.attr == "get" \
                and node.args:
            base = _last_segment(mod, fn.value).lower()
            name = _str_const(node.args[0])
            if name is not None and "." in name and any(
                    b in base for b in ("gauge", "counter", "histogram",
                                        "hist")):
                t.gauges_consumed.append(
                    _site(path, node.args[0], name, base))
        # device-window producers: rec.mark_dispatch("serve.chunk",...)
        if fname in ("mark_dispatch", "mark_complete") and node.args:
            name = _str_const(node.args[0])
            if name is not None:
                t.spans_produced.setdefault(name, []).append(
                    _site(path, node.args[0], name, fname))
        # device-window consumers: _windows(records, "mem.prefetch")
        elif fname == "_windows" and len(node.args) >= 2:
            name = _str_const(node.args[1])
            if name is not None:
                t.spans_consumed.append(
                    _site(path, node.args[1], name))
        # gate-key consumers: MetricSpec("detail.x", ...)
        elif fname == "MetricSpec":
            spec_path = None
            if node.args:
                spec_path = _str_const(node.args[0])
            for kw in node.keywords:
                if kw.arg == "path":
                    spec_path = _str_const(kw.value)
            if spec_path is not None:
                anchor = node.args[0] if node.args else node
                gated = True
                for kw in node.keywords:
                    if kw.arg == "gated" and isinstance(
                            kw.value, ast.Constant):
                        gated = bool(kw.value.value)
                t.gate_specs.append(_site(
                    path, anchor, spec_path,
                    "gated" if gated else "informational"))
        # band references: track_band("migration")
        elif fname == "track_band" and node.args:
            name = _str_const(node.args[0])
            if name is not None:
                t.band_refs.append(_site(path, node.args[0], name))
        # chaos site claims: chaos.maybe_inject("collective", i), ...
        # recognized only when the call plausibly targets the chaos
        # module ("chaos" in the resolved name or the file name) —
        # `matching`/`suppress` are too generic to claim bare
        elif fname in _CHAOS_SITE_FUNCS and _is_chaos_call(mod, fn):
            if node.args and _str_const(node.args[0]) is not None:
                t.chaos_site_claims.append(
                    _site(path, node.args[0],
                          _str_const(node.args[0]), fname))
            if fname == "record_injection":
                kind = (_str_const(node.args[2])
                        if len(node.args) >= 3 else None)
                for kw in node.keywords:
                    if kw.arg == "kind":
                        kind = _str_const(kw.value)
                if kind is not None:
                    t.chaos_kind_claims.append(
                        _site(path, node, kind, fname))
            for kw in node.keywords:
                if kw.arg == "site" and _str_const(kw.value) is not None:
                    t.chaos_site_claims.append(
                        _site(path, kw.value, _str_const(kw.value),
                              fname))
        # chaos spec strings: configure("stall:at=3,...") and
        # chaos_spec="..." keywords anywhere
        if fname in _CHAOS_SPEC_FUNCS and node.args \
                and _is_chaos_call(mod, fn):
            _harvest_chaos_spec(t, path, node.args[0])
        for kw in node.keywords:
            if kw.arg in _CHAOS_SPEC_KWARGS:
                _harvest_chaos_spec(t, path, kw.value)
    return t


def _harvest_chaos_spec(t: ContractTables, path: str,
                        node: ast.AST) -> None:
    spec = _str_const(node)
    if spec is None:
        return
    for part in spec.split(";"):
        if _CHAOS_SPEC_RE.match(part.strip()):
            t.chaos_kind_claims.append(
                _site(path, node, part.strip().split(":", 1)[0],
                      "spec"))


# ---------------------------------------------------------------------------
# tree resolution + caching
# ---------------------------------------------------------------------------

_MODULE_CACHE: dict[tuple[str, int], ContractTables] = {}
_TREE_CACHE: dict[str, ContractTables] = {}


def _cached_extract(mod: ModuleInfo,
                    bench_producer: bool) -> ContractTables:
    key = (mod.path, hash((mod.source, bench_producer)))
    if key not in _MODULE_CACHE:
        _MODULE_CACHE[key] = extract_module(mod, bench_producer)
        if len(_MODULE_CACHE) > 512:
            _MODULE_CACHE.pop(next(iter(_MODULE_CACHE)))
    return _MODULE_CACHE[key]


def find_repo_root(path: str | Path) -> Path | None:
    """Nearest ancestor holding both ``chip_smoke.py`` and the
    ``hpc_patterns_tpu_torch`` package — the live tree the tables merge
    over. None for a module outside any repo checkout."""
    p = Path(path).resolve()
    for parent in [p] + list(p.parents):
        if (parent / "chip_smoke.py").is_file() \
                and (parent / "hpc_patterns_tpu_torch").is_dir():
            return parent
    return None


def _is_fixture(path: str | Path) -> bool:
    return "fixtures" in Path(path).parts


def tree_files(root: Path) -> list[tuple[Path, bool]]:
    """(file, is_bench_producer) for every harvested tree file: the
    port's package, ``chip_smoke.py`` and its tests as producers and
    consumers of every contract EXCEPT gate keys, whose producer side is
    the port's benches (``bench*.py`` at the package's top) only."""
    out: list[tuple[Path, bool]] = []
    pkg = root / "hpc_patterns_tpu_torch"
    for f in iter_python_files([pkg]):
        is_bench = f.parent == pkg and f.name.startswith("bench")
        out.append((f, is_bench))
    smoke = root / "chip_smoke.py"
    if smoke.is_file():
        out.append((smoke, False))
    tests = root / "tests"
    if tests.is_dir():
        for f in sorted(tests.glob("test_torch_*.py")):
            out.append((f, False))
    return [(f, b) for f, b in out if not _is_fixture(f)]


def live_tables(root: Path) -> ContractTables:
    """The merged tables for one repo checkout, cached for the
    process lifetime (an analyzer run sees one immutable tree)."""
    key = str(root)
    if key in _TREE_CACHE:
        return _TREE_CACHE[key]
    tables = ContractTables(root=key)
    files: list[str] = []
    for f, is_bench in tree_files(root):
        try:
            mod = ModuleInfo.parse(f)
        except SyntaxError:
            continue  # parse-error is the engine's finding, not ours
        tables.merge(_cached_extract(mod, bench_producer=is_bench))
        files.append(str(f))
    tables.files = tuple(files)
    _TREE_CACHE[key] = tables
    return tables


def tables_for(mod: ModuleInfo) -> ContractTables:
    """The tables a rule should judge this module against: the live
    repo tree when the module belongs to one, the module alone when
    it is a fixture (or floats free of any checkout)."""
    if not _is_fixture(mod.path):
        root = find_repo_root(mod.path)
        if root is not None:
            return live_tables(root)
    tables = ContractTables()
    tables.merge(_cached_extract(mod, bench_producer=True))
    tables.files = (mod.path,)
    return tables


def site_path(mod: ModuleInfo, tables: ContractTables) -> str:
    """The form of ``mod``'s path its sites carry in ``tables``: the
    resolved path in a live tree's (merged from the repo root), the
    path as given in a self-contained module's."""
    return str(Path(mod.path).resolve()) if tables.root else mod.path


def tables_for_paths(paths) -> ContractTables:
    """The ``--contract-report`` entry point: the live tree's tables
    when the first path sits inside a repo checkout, else the merged
    tables of exactly the files given (every file a bench producer —
    the fixture/self-contained convention)."""
    paths = list(paths)
    root = find_repo_root(paths[0]) if paths else None
    if root is not None:
        return live_tables(root)
    tables = ContractTables()
    files: list[str] = []
    for f in iter_python_files(paths):
        try:
            mod = ModuleInfo.parse(f)
        except SyntaxError:
            continue
        tables.merge(_cached_extract(mod, bench_producer=True))
        files.append(str(f))
    tables.files = tuple(files)
    return tables


# ---------------------------------------------------------------------------
# --contract-report rendering
# ---------------------------------------------------------------------------


def _rel(path: str, root: str) -> str:
    try:
        return str(Path(path).relative_to(root)) if root else path
    except ValueError:
        return path


def _fmt_sites(sites: list[Site], root: str, limit: int = 2) -> str:
    locs = [f"{_rel(s.path, root)}:{s.line}" for s in sites[:limit]]
    extra = len(sites) - limit
    return ", ".join(locs) + (f" (+{extra})" if extra > 0 else "")


def format_contract_report(tables: ContractTables) -> str:
    """The informational twin of ``--vmem-report``: the full
    producer/consumer tables, one section per contract."""
    root = tables.root
    lines: list[str] = []
    lines.append(f"contractlint report over "
                 f"{len(tables.files)} file(s)"
                 + (f" [{root}]" if root else " [self-contained]"))

    lines.append("\ngate keys (harness/regress.py SPECS -> bench "
                 "detail emitters):")
    for s in tables.gate_specs:
        key = s.name.split(".", 1)[1] if s.name.startswith(
            "detail.") else s.name
        producers = tables.detail_keys.get(key, [])
        status = (_fmt_sites(producers, root) if producers
                  else "MISSING EMITTER")
        lines.append(f"  {s.name:<40} [{s.detail:<13}] <- {status}")

    lines.append("\nmetric names consumed by string "
                 "(report/explain/autofit) -> producers:")
    for s in sorted(tables.gauges_consumed,
                    key=lambda s: (s.name, s.path, s.line)):
        producers = tables.gauges_produced.get(s.name, [])
        status = (_fmt_sites(producers, root) if producers else
                  ("prefix match" if tables.gauge_has_producer(s.name)
                   else "MISSING PRODUCER"))
        lines.append(f"  {s.name:<40} @ "
                     f"{_rel(s.path, root)}:{s.line} <- {status}")
    for s in sorted(tables.spans_consumed,
                    key=lambda s: (s.name, s.path, s.line)):
        producers = tables.spans_produced.get(s.name, [])
        status = (_fmt_sites(producers, root) if producers
                  else "MISSING PRODUCER")
        lines.append(f"  {s.name:<40} @ "
                     f"{_rel(s.path, root)}:{s.line} <- {status} "
                     f"(device window)")

    lines.append("\nmetric names produced "
                 f"({len(tables.gauges_produced)} exact, "
                 f"{len(tables.gauge_prefixes)} f-string prefixes):")
    for name in sorted(tables.gauges_produced):
        lines.append(f"  {name:<40} "
                     f"{_fmt_sites(tables.gauges_produced[name], root)}")
    for s in sorted(tables.gauge_prefixes, key=lambda s: s.name):
        lines.append(f"  {s.name + '{...}':<40} "
                     f"{_rel(s.path, root)}:{s.line}")

    lines.append("\nRunLog record kinds (written vs dispatched):")
    all_kinds = sorted(set(tables.kinds_produced)
                       | set(tables.kinds_consumed)
                       | set(tables.forensic_kinds))
    for kind in all_kinds:
        p = tables.kinds_produced.get(kind, [])
        c = tables.kinds_consumed.get(kind, [])
        flags = []
        if not p:
            flags.append("NEVER WRITTEN")
        if not c:
            flags.append("forensic" if kind in tables.forensic_kinds
                         else "NEVER DISPATCHED")
        lines.append(
            f"  {kind:<28} written x{len(p):<3} dispatched "
            f"x{len(c):<3}" + (f"  [{', '.join(flags)}]" if flags
                               else ""))

    lines.append("\ndevice-subtrack bands (harness/trace.py "
                 "TRACK_BANDS):")
    for band in sorted(tables.declared_bands.values(),
                       key=lambda b: b.base):
        lines.append(f"  {band.name:<14} {band.base:>3}..{band.hi:<3} "
                     f"@ {_rel(band.site.path, root)}:{band.site.line}")
    if tables.band_literals:
        lines.append("  hand-written band bases (should come from "
                     "track_band):")
        for s in tables.band_literals:
            lines.append(f"    {s.name} = {s.detail} @ "
                         f"{_rel(s.path, root)}:{s.line}")

    lines.append("\nchaos contract (harness/chaos.py):")
    lines.append(f"  kinds: {', '.join(sorted(tables.chaos_kinds))}")
    lines.append(f"  sites: {', '.join(sorted(tables.chaos_sites))}")
    bad_sites = [s for s in tables.chaos_site_claims
                 if s.name not in tables.chaos_sites]
    bad_kinds = [s for s in tables.chaos_kind_claims
                 if s.name not in tables.chaos_kinds]
    lines.append(f"  site claims: {len(tables.chaos_site_claims)} "
                 f"({len(bad_sites)} unknown), kind claims: "
                 f"{len(tables.chaos_kind_claims)} "
                 f"({len(bad_kinds)} unknown)")
    return "\n".join(lines)
