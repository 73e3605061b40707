"""torchlint core: findings, suppressions, baseline, and the rule engine.

The analyzer catches, at review time, the hazard classes the port has
paid for or carries: a host view of a tensor a later call writes in
place (the JAX package's "poisoned cache", in torch's
form: ``self.pos.cpu().numpy()`` on the CPU is a view of the tensor
the chunk step updates in place), a device readback inside a function
whose job is to keep the card's queue fed, a kernel build per call,
rank-dependent collective schedules, and — over ``csrc/`` — mbarrier
and flag imbalance and shared-memory overflow.

Model (the counterpart of ``hpc_patterns_tpu/analysis/core.py``):

- a :class:`Rule` inspects one parsed module (:class:`ModuleInfo`) and
  yields :class:`Finding`\\ s — ``file:line:col``, rule id, message and
  a fix hint. A Python module carries its ``ast``; a CUDA source
  (``*.cu``/``*.cuh``) carries its text only (``lang == "cuda"``) and
  is read by the kernel family (``cuda_rules.py``, ``smem.py``);
- ``# torchlint: disable=<rule>[,<rule>]`` (``// torchlint:
  disable=...`` in a CUDA source) suppresses findings on its own line
  (trailing comment) or the next code line (standalone comment). The
  rule name is mandatory and must be registered: a bare or unknown
  ``disable`` is itself a finding (``bad-suppression``);
- a baseline file (``--baseline``) tolerates known findings by exact
  ``(path, rule, line)``. The shipped tree carries none: every finding
  is fixed or suppressed with a reason on the line;
- the engine walks ``*.py``, ``*.cu`` and ``*.cuh`` files, runs every
  registered rule, and partitions findings into live / suppressed /
  baselined.

Everything here is stdlib: the analyzer never imports the code under
analysis (nor torch), so it cannot be crashed or biased by import-time
side effects.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

#: the source suffixes the engine reads: Python for every family but the
#: kernel one, CUDA for the kernel family
PY_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")

# Functions whose bodies are dispatch-critical (host-sync rule) when no
# @dispatch_critical marker is present. The JAX package's list
# (hpc_patterns_tpu/analysis/core.py) less the two names the port has no
# function for (_admit_row: the port admits inside _admit; _dequant: the
# port dequantizes inside the kernels' plain versions), plus the port's
# own dispatch paths. A "Class.method" entry matches that method only.
DEFAULT_DISPATCH_CRITICAL = frozenset({
    # the engine's overlapped dispatch/admission path and the eager
    # collective completion helper
    "_dispatch_chunk", "_dispatch_spec", "_admit", "_try_admit",
    "_ready_in_span",
    # preemption, shedding and the admission high-water check (chunk
    # boundaries inside the serving loop)
    "_maybe_preempt", "_preempt", "_shed_expired", "_queue_order",
    "_admissible", "_can_resume",
    # the serving plane's round, migration export/transfer and install
    "service_round", "export_migration", "install_migration",
    "_dispatch_migration", "_install_pending", "_complete_migrations",
    # tiered memory: the residency manager's transfer pipeline and the
    # engine's swap machinery
    "_dispatch_prefetch", "_install_prefetched", "_complete_prefetches",
    "_residency_balance", "_swap_out", "pull_payload", "push_payload",
    "_close_ripe_evicts", "_detach_row", "_attach_row",
    # prefix sharing: host trie/list work inside the admission window
    "_prefix_match", "_memo_match", "_request_need", "_insert_prefix",
    "_alloc_pages", "_incref_pages", "_decref_pages",
    "_reclaim_cache_pages", "_row_swappable", "_row_freeable_pages",
    # quantized decode: the KV quantize and the scale write ride the
    # step's own dispatch
    "_quantize_rows", "_scale_write", "matmul_weight",
    # the elastic plane's round-boundary paths
    "_autoscale_round", "_spin_up", "_begin_drain", "_drain_step",
    "_kill_replica", "_recover_casualties", "_resume_request",
    "_route_again", "_checkpoint_replica", "_probe_replica_chaos",
    "_shed_request",
    # autofit's apply paths and the per-round attainment gauge
    "from_fitted", "ladder_from", "_judge_window", "_emit_attainment",
    # the device-side migration pair and its transport resolution
    "send_migration", "recv_migration", "_resolve_transport",
    # the request-trace stamps: a perf_counter read and host list work
    "begin_request", "stamp_transition", "finish_request",
    "export_history", "install_history", "restamp_submit",
    # the port's own: the command queue's enqueue paths (they also
    # carry @dispatch_critical), and the plane router's per-replica
    # round and its reply merge
    "Command.submit", "_enqueue", "_replica_round", "_merge_round",
})

# rule names are kebab-case identifiers; anything after the last name
# (the mandatory one-line justification) is ignored by the parser but
# required by review convention
_SUPPRESS_RE = re.compile(
    r"(?:#|//)\s*torchlint:\s*disable"
    r"(?:\s*=\s*(?P<rules>[A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*))?"
)


@dataclass(frozen=True)
class Finding:
    """One hazard: ``rule`` id, location, message, and a fix hint."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    @property
    def key(self) -> tuple[str, str, int]:
        """Baseline identity: exact (path, rule, line)."""
        return (self.path, self.rule, self.line)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        text = f"{loc}: {self.rule}: {self.message}"
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text


@dataclass
class ModuleInfo:
    """One parsed module plus the lookups every rule wants. A CUDA
    source has ``lang == "cuda"`` and an empty ``tree``."""

    path: str
    source: str
    tree: ast.Module | None
    lang: str = "python"
    #: first-segment import aliases, e.g. {"np": "numpy",
    #: "dist": "torch.distributed", "partial": "functools.partial"}
    aliases: dict[str, str] = field(default_factory=dict)
    #: child -> parent for every node
    parents: dict[ast.AST, ast.AST] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str | Path, source: str | None = None
              ) -> "ModuleInfo":
        path = str(path)
        if source is None:
            source = Path(path).read_text()
        key = (path, hash(source))
        hit = _PARSED.get(key)
        if hit is not None:
            return hit
        info = cls._parse(path, source)
        _PARSED[key] = info
        if len(_PARSED) > 1024:
            _PARSED.pop(next(iter(_PARSED)))
        return info

    @classmethod
    def _parse(cls, path: str, source: str) -> "ModuleInfo":
        if path.endswith(CUDA_SUFFIXES):
            return cls(path=path, source=source, tree=None, lang="cuda")
        tree = ast.parse(source, filename=path)
        info = cls(path=path, source=source, tree=tree)
        for node in walk(tree):
            for child in ast.iter_child_nodes(node):
                info.parents[child] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    info.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    info.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
        return info

    @property
    def is_python(self) -> bool:
        return self.lang == "python"

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, with the
        first segment resolved through the module's import aliases —
        ``np.asarray`` -> ``numpy.asarray``, ``dist.all_reduce`` ->
        ``torch.distributed.all_reduce`` — so rules match semantics, not
        spelling. None for anything that isn't a plain dotted chain."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        parts[0] = self.aliases.get(parts[0], parts[0])
        return ".".join(parts)


#: parsed modules by (path, source hash): the engine and the contract
#: tables read each file once per process
_PARSED: dict[tuple[str, int], ModuleInfo] = {}

_WALKS: dict[int, tuple[ast.AST, list]] = {}


def walk(node: ast.AST) -> list[ast.AST]:
    """``ast.walk(node)`` as a list, memoized: the rules and the contract
    extraction walk the same trees (and their functions) many times."""
    hit = _WALKS.get(id(node))
    if hit is not None and hit[0] is node:
        return hit[1]
    out = list(ast.walk(node))
    _WALKS[id(node)] = (node, out)
    if len(_WALKS) > 200_000:
        _WALKS.clear()
    return out


class Rule:
    """One hazard class. Subclasses set ``name``/``hint`` and implement
    :meth:`check` over a parsed module. ``lang`` says which sources the
    rule reads; the engine never hands it another kind."""

    name: str = "?"
    #: one-line description for --list-rules
    summary: str = ""
    #: rule family for --list-rules grouping: torchlint (Python-level),
    #: shardlint (SPMD), cudalint (in-kernel, over csrc/), contractlint
    #: (cross-module producer/consumer contracts)
    family: str = "torchlint"
    lang: str = "python"
    hint: str = ""

    def check(self, mod: ModuleInfo, config: "AnalysisConfig"
              ) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node, message: str,
                hint: str | None = None) -> Finding:
        return Finding(
            rule=self.name, path=mod.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            hint=self.hint if hint is None else hint,
        )


@dataclass
class AnalysisConfig:
    """Tunables threaded to every rule."""

    dispatch_critical: frozenset[str] = DEFAULT_DISPATCH_CRITICAL
    #: rule names to run; None = all registered
    select: frozenset[str] | None = None


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to the global registry."""
    rule = rule_cls()
    if rule.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    _REGISTRY[rule.name] = rule
    return rule_cls


def registered_rules() -> dict[str, Rule]:
    # the rule modules self-register on import; imported lazily so core
    # stays importable without the rule set (the runtime helpers' case)
    from hpc_patterns_tpu_torch.analysis import contract_rules  # noqa: F401
    from hpc_patterns_tpu_torch.analysis import cuda_rules  # noqa: F401
    from hpc_patterns_tpu_torch.analysis import rules  # noqa: F401

    return dict(_REGISTRY)


# -- suppressions ----------------------------------------------------------


def _comments(mod: ModuleInfo) -> list[tuple[int, int, str]]:
    """(line, col, text) of every comment: Python's through tokenize,
    CUDA's ``//`` comments outside string literals."""
    if mod.is_python:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(mod.source).readline)
            return [(t.start[0], t.start[1], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
        except tokenize.TokenError:  # pragma: no cover - ast parsed it
            return []
    out = []
    for lineno, line in enumerate(mod.source.splitlines(), 1):
        in_str = False
        i = 0
        while i < len(line) - 1:
            c = line[i]
            if c == '"' and (i == 0 or line[i - 1] != "\\"):
                in_str = not in_str
            elif not in_str and line.startswith("//", i):
                out.append((lineno, i, line[i:]))
                break
            i += 1
    return out


def parse_suppressions(
    mod: ModuleInfo, known_rules: frozenset[str]
) -> tuple[dict[int, set[str]], list[Finding]]:
    """``# torchlint: disable=<rule>``: {line: {rules}} plus the
    bad-suppression findings for bare/unknown forms. A trailing comment
    covers its own line; a standalone comment covers the next CODE line
    (justifications may continue over following comment lines)."""
    by_line: dict[int, set[str]] = {}
    bad: list[Finding] = []
    lines = mod.source.splitlines()
    lead = "#" if mod.is_python else "//"
    for line, col, text in _comments(mod):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        names = [r.strip() for r in (m.group("rules") or "").split(",")
                 if r.strip()]
        standalone = lines[line - 1][:col].strip() == ""
        target = line
        if standalone:
            target = line + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].lstrip().startswith(lead)):
                target += 1
        if not names:
            bad.append(Finding(
                rule="bad-suppression", path=mod.path, line=line, col=col,
                message="torchlint: disable without a rule name",
                hint="name the rule: # torchlint: disable=<rule> — blanket "
                     "suppressions hide new hazard classes",
            ))
            continue
        for n in names:
            if n not in known_rules:
                bad.append(Finding(
                    rule="bad-suppression", path=mod.path, line=line,
                    col=col,
                    message=f"torchlint: disable of unknown rule {n!r}",
                    hint="registered rules: "
                         + ", ".join(sorted(known_rules)),
                ))
        by_line.setdefault(target, set()).update(
            n for n in names if n in known_rules)
    return by_line, bad


# -- baseline --------------------------------------------------------------


def load_baseline(path: str | Path) -> set[tuple[str, str, int]]:
    """Known-finding keys from a baseline JSON (see
    :func:`write_baseline`)."""
    data = json.loads(Path(path).read_text())
    return {
        (f["path"], f["rule"], int(f["line"]))
        for f in data.get("findings", [])
    }


def write_baseline(path: str | Path, findings: list[Finding]) -> None:
    data = {
        "comment": "torchlint baseline — tolerated findings by exact "
                   "(path, rule, line); regenerate with "
                   "--write-baseline. Repo policy is fix-or-suppress: "
                   "this file should stay empty or absent.",
        "findings": [
            {"path": f.path, "rule": f.rule, "line": f.line,
             "message": f.message}
            for f in findings
        ],
    }
    Path(path).write_text(json.dumps(data, indent=2) + "\n")


# -- engine ----------------------------------------------------------------


@dataclass
class Report:
    """One analysis run: live findings plus everything accounted away."""

    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    n_files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_rule(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return counts


def iter_source_files(paths: Iterable[str | Path],
                      suffixes: tuple[str, ...] = PY_SUFFIXES
                      + CUDA_SUFFIXES) -> Iterator[Path]:
    """Files with one of ``suffixes`` under each path (a file is taken
    as-is), skipping ``__pycache__``/hidden dirs, in sorted order for
    stable output."""
    for p in paths:
        p = Path(p)
        if p.is_file():
            yield p
            continue
        found = sorted(f for f in p.rglob("*") if f.suffix in suffixes
                       and f.is_file())
        for f in found:
            if any(part.startswith((".", "__pycache__"))
                   for part in f.parts[len(p.parts):-1]):
                continue
            yield f


def iter_python_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    """``*.py`` only (the contract tables' walk)."""
    return iter_source_files(paths, PY_SUFFIXES)


def analyze_file(
    path: str | Path,
    config: AnalysisConfig | None = None,
    rules: dict[str, Rule] | None = None,
) -> tuple[list[Finding], list[Finding]]:
    """(live, suppressed) findings for one file. Syntax errors become a
    single ``parse-error`` finding: an unparseable file is a file the
    analyzer is blind to, which CI must not read as clean."""
    config = config or AnalysisConfig()
    rules = rules if rules is not None else registered_rules()
    # suppression validity is judged against the FULL registry: running
    # a rule subset (--select) must not turn a valid suppression of an
    # unselected rule into a bad-suppression finding
    known = frozenset(rules) | {"parse-error"}
    if config.select is not None:
        rules = {k: v for k, v in rules.items() if k in config.select}
    try:
        mod = ModuleInfo.parse(path)
    except SyntaxError as e:
        return [Finding(
            rule="parse-error", path=str(path), line=e.lineno or 1,
            col=e.offset or 0, message=f"unparseable: {e.msg}",
            hint="torchlint cannot vouch for a file it cannot parse",
        )], []
    suppress_map, bad = parse_suppressions(mod, known)
    raw: list[Finding] = list(bad)
    if config.select is not None:
        # hygiene findings respect the selection too (parse-error
        # always survives: a blind file is never a clean file)
        raw = [f for f in raw if f.rule in config.select]
    for rule in rules.values():
        if rule.lang == mod.lang:
            raw.extend(rule.check(mod, config))
    live: list[Finding] = []
    suppressed: list[Finding] = []
    seen: set[tuple[str, int, int]] = set()
    for f in sorted(raw, key=lambda f: (f.line, f.col, f.rule)):
        # rules walking nested defs can visit a statement from both
        # the outer and the inner function — one hazard, one finding
        if (f.rule, f.line, f.col) in seen:
            continue
        seen.add((f.rule, f.line, f.col))
        # bad-suppression is never itself suppressible
        if (f.rule != "bad-suppression"
                and f.rule in suppress_map.get(f.line, ())):
            suppressed.append(f)
        else:
            live.append(f)
    return live, suppressed


def run_paths(
    paths: Iterable[str | Path],
    config: AnalysisConfig | None = None,
    baseline: set[tuple[str, str, int]] | None = None,
) -> Report:
    """Analyze every file under ``paths``; the CLI's engine."""
    report = Report()
    rules = registered_rules()
    for f in iter_source_files(paths):
        live, suppressed = analyze_file(f, config, rules)
        report.n_files += 1
        report.suppressed.extend(suppressed)
        for finding in live:
            if baseline and finding.key in baseline:
                report.baselined.append(finding)
            else:
                report.findings.append(finding)
    return report
