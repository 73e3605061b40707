"""contractlint rules: judging the whole-tree producer/consumer tables.

Second pass over :mod:`hpc_patterns_tpu_torch.analysis.contracts`'s
tables (the counterpart of ``hpc_patterns_tpu/analysis/contract_rules.py``).
Every rule here anchors its findings INSIDE the module currently
under analysis (output stays stable per-file, like every other rule
family), but judges that module's sites against the tables merged
over the tree the module belongs to — so deleting a gated key's
emitter in a bench surfaces at the surviving ``SPECS`` row in
``harness/regress.py``, at review time, instead of as the gate's
runtime coverage-loss warning after a bench run already happened.

The five rules and the seams they pin (each drifted at least once in
review before this existed):

- ``gate-key-orphan`` — ``harness/regress.py`` gate keys vs. bench
  ``detail`` emitters; metric/span names consumed by string in
  report/explain/autofit vs. ``metrics.gauge(...)`` producers.
- ``record-kind-drift`` — RunLog ``kind=`` literals written vs. the
  kinds report/collect/autofit/explain dispatch on, both directions;
  ``FORENSIC_KINDS`` in ``harness/runlog.py`` declares the kinds
  written for the record stream / replay tooling on purpose.
- ``wire-field-compat`` — the migration wire codec field-by-field:
  reads absent-tolerant unless in ``REQUIRED_WIRE_FIELDS``;
  write/read sets must match.
- ``track-band-collision`` — Perfetto device-subtrack bands come
  from the ``harness/trace.py`` ``TRACK_BANDS`` registry; overlaps
  and hand-picked integers are findings (pallaslint's collective-id
  registry discipline, applied to trace tracks).
- ``chaos-site-drift`` — chaos site/kind names claimed at injection
  sites and spelled in specs vs. ``harness/chaos.py``'s declarations.
"""

from __future__ import annotations

import ast
from types import SimpleNamespace
from typing import Iterable

from hpc_patterns_tpu_torch.analysis import contracts
from hpc_patterns_tpu_torch.analysis.contracts import Site
from hpc_patterns_tpu_torch.analysis.core import (AnalysisConfig, Finding,
                                                  ModuleInfo, Rule, register,
                                                  walk)


def _at(site: Site) -> SimpleNamespace:
    """A Finding anchor for a table Site (duck-types an AST node)."""
    return SimpleNamespace(lineno=site.line, col_offset=site.col)


@register
class GateKeyOrphanRule(Rule):
    """Every consumer-by-string of a bench/telemetry name must have a
    live producer. Three contracts share the shape: (a) a
    ``MetricSpec("detail.<key>", ...)`` row in the regression gate
    with no ``<key>`` emitted by any bench-tree dict; (b) a metric
    name read by string (``gauges.get("mem.hbm_pages")``) with no
    ``.gauge/.counter/.histogram`` producer; (c) a device-window span
    name (``_windows(records, "serve.chunk")``) nothing
    ``mark_dispatch``\\ es. All three are the "emitter deleted, gate
    silently stops gating" failure the gate's runtime coverage-loss
    warning patches over — this is the review-time version."""

    name = "gate-key-orphan"
    family = "contractlint"
    summary = ("gate key / string-consumed metric name has no live "
               "emitter anywhere in the tree")
    hint = ("restore the emitter (bench detail dict key, "
            "metrics.gauge(...) call, or mark_dispatch span), or "
            "delete the consumer row if the metric is gone for good")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        t = contracts.tables_for(mod)
        here = contracts.site_path(mod, t)
        for s in t.gate_specs:
            if s.path != here or not s.name.startswith("detail."):
                continue
            key = s.name.split(".", 1)[1]
            if key not in t.detail_keys:
                yield self.finding(mod, _at(s), (
                    f"{s.detail} gate key {s.name!r} has no emitter: "
                    f"no bench-tree dict ever writes {key!r}"))
        for s in t.gauges_consumed:
            if s.path != here:
                continue
            if not t.gauge_has_producer(s.name):
                yield self.finding(mod, _at(s), (
                    f"metric {s.name!r} is consumed by string here "
                    f"but no gauge/counter/histogram call produces "
                    f"it"))
        for s in t.spans_consumed:
            if s.path != here:
                continue
            if s.name not in t.spans_produced:
                yield self.finding(mod, _at(s), (
                    f"device-window span {s.name!r} is consumed here "
                    f"but nothing mark_dispatch()es it"))


@register
class RecordKindDriftRule(Rule):
    """RunLog record kinds, both directions. A kind DISPATCHED on
    (``rec["kind"] == "trace"`` and friends) that nothing writes is a
    dead consumer branch — usually a renamed producer. A kind WRITTEN
    (``kind="..."`` keyword, ``{"kind": "..."}`` literal,
    ``rec["kind"] = "..."``) that nothing dispatches on is telemetry
    nobody reads — unless it is declared in ``harness/runlog.py``'s
    ``FORENSIC_KINDS``, the explicit list of kinds written for the
    raw record stream / replay tooling rather than for a dispatcher."""

    name = "record-kind-drift"
    family = "contractlint"
    summary = ("record kind written but never dispatched on (or "
               "dispatched but never written)")
    hint = ("rename the drifted side, or — if the kind is write-only "
            "by design — add it to FORENSIC_KINDS in "
            "harness/runlog.py")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        t = contracts.tables_for(mod)
        here = contracts.site_path(mod, t)
        for kind, sites in t.kinds_consumed.items():
            if kind in t.kinds_produced:
                continue
            for s in sites:
                if s.path == here:
                    yield self.finding(mod, _at(s), (
                        f"record kind {kind!r} is dispatched on here "
                        f"but nothing in the tree ever writes it"))
        for kind, sites in t.kinds_produced.items():
            if kind in t.kinds_consumed or kind in t.forensic_kinds:
                continue
            for s in sites:
                if s.path == here:
                    yield self.finding(mod, _at(s), (
                        f"record kind {kind!r} is written here but "
                        f"nothing dispatches on it (declare it in "
                        f"FORENSIC_KINDS if write-only by design)"))


def _function_defs(mod: ModuleInfo) -> Iterable[ast.FunctionDef]:
    for node in walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _required_wire_fields(mod: ModuleInfo) -> tuple[set[str], bool]:
    """(fields, declared) from a module-level REQUIRED_WIRE_FIELDS
    tuple/set/list literal."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "REQUIRED_WIRE_FIELDS":
            elems = contracts._str_tuple_elems(node.value) or []
            return {e.value for e in elems}, True
    return set(), False


@register
class WireFieldCompatRule(Rule):
    """The migration wire codec, field by field. Inside any
    ``*to_wire`` function the written field set is every string key
    stored into the wire dict; inside any ``*from_wire`` function a
    read is ``wire["k"]`` (absent-INTOLERANT), ``wire.get("k", ...)``
    (tolerant), or a ``"k" in wire`` guarded access (tolerant — the
    ``transport`` / ``segments`` fields' discipline). Findings:
    an intolerant read of a field not listed in the module's
    ``REQUIRED_WIRE_FIELDS`` literal (an old producer's wire kills
    the new consumer), a field written but never read (dead bytes on
    the wire), and a field read but never written (guaranteed
    KeyError or silently-dead fallback)."""

    name = "wire-field-compat"
    family = "contractlint"
    summary = ("wire codec field sets drifted, or a read is "
               "absent-intolerant without being REQUIRED")
    hint = ("read optional fields with .get()/an `in` guard, list "
            "genuinely mandatory ones in REQUIRED_WIRE_FIELDS, and "
            "keep to_wire/from_wire field sets in lockstep")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        required, declared = _required_wire_fields(mod)
        writes: dict[str, ast.AST] = {}
        reads: dict[str, ast.AST] = {}
        intolerant: dict[str, ast.AST] = {}
        have_to = have_from = False
        for fn in _function_defs(mod):
            if fn.name.endswith("to_wire"):
                have_to = True
                for node in walk(fn):
                    if isinstance(node, ast.Dict):
                        for k in node.keys:
                            key = contracts._str_const(k) \
                                if k is not None else None
                            if key is not None:
                                writes.setdefault(key, k)
                    elif isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.targets[0],
                                           ast.Subscript):
                        key = contracts._str_const(
                            node.targets[0].slice)
                        if key is not None:
                            writes.setdefault(key, node.targets[0])
            elif fn.name.endswith("from_wire"):
                have_from = True
                params = {a.arg for a in (
                    fn.args.posonlyargs + fn.args.args
                    + fn.args.kwonlyargs)}
                guarded: set[str] = set()
                subs: list[tuple[str, ast.AST]] = []
                for node in walk(fn):
                    if isinstance(node, ast.Compare) \
                            and len(node.ops) == 1 \
                            and isinstance(node.ops[0],
                                           (ast.In, ast.NotIn)) \
                            and isinstance(node.comparators[0],
                                           ast.Name) \
                            and node.comparators[0].id in params:
                        key = contracts._str_const(node.left)
                        if key is not None:
                            guarded.add(key)
                            reads.setdefault(key, node.left)
                    elif isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr == "get" \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id in params \
                            and node.args:
                        key = contracts._str_const(node.args[0])
                        if key is not None:
                            reads.setdefault(key, node.args[0])
                    elif isinstance(node, ast.Subscript) \
                            and isinstance(node.value, ast.Name) \
                            and node.value.id in params \
                            and isinstance(node.ctx, ast.Load):
                        key = contracts._str_const(node.slice)
                        if key is not None:
                            reads.setdefault(key, node)
                            subs.append((key, node))
                # judge subscripts only after the whole walk — the
                # `"k" in wire` guard may sit after the read in a
                # conditional expression
                for key, node in subs:
                    if key not in guarded:
                        intolerant.setdefault(key, node)
        if not (have_to or have_from):
            return
        for key, node in sorted(intolerant.items()):
            if key in required:
                continue
            yield self.finding(mod, node, (
                f"absent-intolerant read wire[{key!r}] of a field "
                f"not in REQUIRED_WIRE_FIELDS"
                + ("" if declared else " (no REQUIRED_WIRE_FIELDS "
                   "literal declared in this module)")))
        if have_to and have_from:
            for key, node in sorted(writes.items()):
                if key not in reads:
                    yield self.finding(mod, node, (
                        f"wire field {key!r} is written by to_wire "
                        f"but from_wire never reads it"))
            for key, node in sorted(reads.items()):
                if key not in writes:
                    yield self.finding(mod, node, (
                        f"wire field {key!r} is read by from_wire "
                        f"but to_wire never writes it"))


@register
class TrackBandCollisionRule(Rule):
    """Perfetto device-subtrack allocation. ``harness/trace.py``'s
    ``TRACK_BANDS`` literal is the single declared source of subtrack
    bands (decode, admit, migration, spinup, residency); modules
    unpack their base/width via ``track_band("<name>")``. Findings:
    two declared bands overlapping, a ``FOO_TRACK_BASE = <int>``
    hand-picked outside the registry (the pre-registry idiom that
    produced the 64/72/80 near-misses), a ``track_band()`` reference
    to an undeclared band name, and a literal ``track=<int>``
    argument landing outside every declared band."""

    name = "track-band-collision"
    family = "contractlint"
    summary = ("trace track bands overlap, or a track id bypasses "
               "the TRACK_BANDS registry")
    hint = ("declare the band in harness/trace.py TRACK_BANDS and "
            "unpack it with track_band('<name>') instead of "
            "hand-picking integers")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        t = contracts.tables_for(mod)
        here = contracts.site_path(mod, t)
        for band in t.declared_bands.values():
            if band.site.path != here:
                continue
            for other in t.declared_bands.values():
                if other.name != band.name and band.overlaps(other):
                    yield self.finding(mod, _at(band.site), (
                        f"track band {band.name!r} "
                        f"({band.base}..{band.hi}) overlaps "
                        f"{other.name!r} ({other.base}..{other.hi})"))
        for s in t.band_literals:
            if s.path == here:
                yield self.finding(mod, _at(s), (
                    f"hand-picked track base {s.name} = {s.detail} "
                    f"bypasses the TRACK_BANDS registry"))
        if not t.declared_bands:
            return
        for s in t.band_refs:
            if s.path == here and s.name not in t.declared_bands:
                yield self.finding(mod, _at(s), (
                    f"track_band({s.name!r}) names a band "
                    f"TRACK_BANDS does not declare"))
        for s in t.track_literals:
            if s.path != here:
                continue
            track = int(s.detail)
            if t.band_covering(track) is None:
                yield self.finding(mod, _at(s), (
                    f"literal track={track} falls outside every "
                    f"declared TRACK_BANDS band"))


@register
class ChaosSiteDriftRule(Rule):
    """Chaos site/kind names. ``harness/chaos.py`` declares the
    legal injection sites (``SITES``) and fault kinds (``KINDS``);
    every ``chaos.maybe_inject("<site>", ...)`` claim, ``site=``
    keyword, recorded injection kind, and ``"kind:key=val"`` spec
    string must spell a declared name — a typo'd site silently
    injects nothing and a typo'd kind dies at parse time in the one
    run (the chaos soak) least equipped to debug it."""

    name = "chaos-site-drift"
    family = "contractlint"
    summary = ("chaos site/kind name not declared in "
               "harness/chaos.py SITES/KINDS")
    hint = ("match the literal to chaos.SITES/chaos.KINDS, or add "
            "the new site/kind to the declaration first")

    def check(self, mod: ModuleInfo, config: AnalysisConfig
              ) -> Iterable[Finding]:
        t = contracts.tables_for(mod)
        here = contracts.site_path(mod, t)
        if t.chaos_sites:
            for s in t.chaos_site_claims:
                if s.path == here and s.name not in t.chaos_sites:
                    yield self.finding(mod, _at(s), (
                        f"chaos site {s.name!r} is claimed here but "
                        f"SITES declares only: "
                        + ", ".join(sorted(t.chaos_sites))))
        if t.chaos_kinds:
            for s in t.chaos_kind_claims:
                if s.path == here and s.name not in t.chaos_kinds:
                    yield self.finding(mod, _at(s), (
                        f"chaos kind {s.name!r} is claimed here but "
                        f"KINDS declares only: "
                        + ", ".join(sorted(t.chaos_kinds))))
