"""The port's lint framework: parsed modules, rules, findings and
suppressions.

``collect_modules`` parses every target file once into a ``SourceModule``
(text, AST, suppression table); every rule runs over the same parsed
modules.  Vocabulary:

* ``Finding``: one violation at ``file:line``, with its rule id.  Sorted
  and rendered stably, so ``--json`` output diffs cleanly.
* suppression: ``# qldpc: ignore[R007]`` (several ids comma-separated) on
  the offending line, or on a comment-only line directly above it.  A
  suppression that masks no finding of a rule that ran is itself reported
  as ``R000``, so stale escapes cannot accumulate.
* ``Rule``: ``check(module, ctx)`` yields a module's findings;
  ``finish(ctx)`` yields findings outside the Python modules (the CUDA
  sources, ``chip_smoke.py``), once per run.
* baseline: a checked-in budget of justified findings per (file, rule)
  (``Baseline``, ``analysis/baseline.json``, the JAX package's format);
  findings within a budget are counted as baselined and fail nothing, and
  an entry with no live finding is reported stale.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Iterator

__all__ = ["Finding", "Rule", "SourceModule", "AnalysisContext",
           "AnalysisResult", "Baseline", "BaselineEntry", "collect_modules",
           "run_analysis", "package_root", "repo_root",
           "UNUSED_SUPPRESSION_RULE_ID"]

# the engine's own rule: a suppression comment that masks nothing
UNUSED_SUPPRESSION_RULE_ID = "R000"

_IGNORE_RE = re.compile(r"#\s*qldpc:\s*ignore\[([A-Z0-9,\s]+)\]")


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    file: str          # path relative to the analysed root, posix
    line: int
    rule: str
    message: str
    col: int = 0

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


@dataclass
class Suppression:
    """One ``# qldpc: ignore[...]`` comment and the line it masks."""

    file: str
    comment_line: int
    target_line: int
    rules: frozenset
    used: set = field(default_factory=set)


class SourceModule:
    """One parsed file: text, AST and suppression table, parsed once."""

    def __init__(self, rel: str, text: str, tree: ast.Module):
        self.rel = rel
        self.text = text
        self.tree = tree
        self.lines = text.splitlines()
        self.suppressions: list[Suppression] = list(self._suppressions())

    @classmethod
    def parse(cls, rel: str, text: str) -> "SourceModule":
        return cls(rel, text, ast.parse(text, filename=rel))

    def _suppressions(self) -> Iterator[Suppression]:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, SyntaxError):
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _IGNORE_RE.search(tok.string)
            if not m:
                continue
            rules = frozenset(r.strip() for r in m.group(1).split(",")
                              if r.strip())
            line = tok.start[0]
            # a trailing comment guards its own line, a comment-only line
            # the next one
            code_before = self.lines[line - 1][:tok.start[1]].strip()
            yield Suppression(self.rel, line,
                              line if code_before else line + 1, rules)

    def suppression_for(self, line: int, rule: str) -> Suppression | None:
        for s in self.suppressions:
            if s.target_line == line and rule in s.rules:
                return s
        return None


class AnalysisContext:
    """What rules may consult: every parsed module by relative path, the
    root the paths are relative to, and memoized cross-module indexes."""

    def __init__(self, modules: list[SourceModule], root: str):
        self.modules = modules
        self.by_rel = {m.rel: m for m in modules}
        self.root = root
        self._caches: dict = {}

    def cache(self, key, build):
        if key not in self._caches:
            self._caches[key] = build()
        return self._caches[key]


class Rule:
    """Base class: subclasses set ``id`` / ``title`` and yield findings."""

    id: str = "R???"
    title: str = ""

    def applies(self, rel: str) -> bool:
        return True

    def check(self, module: SourceModule,
              ctx: AnalysisContext) -> Iterable[Finding]:
        return ()

    def finish(self, ctx: AnalysisContext) -> Iterable[Finding]:
        return ()


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------
@dataclass
class BaselineEntry:
    file: str
    rule: str
    count: int
    reason: str

    def to_dict(self) -> dict:
        return {"file": self.file, "rule": self.rule, "count": self.count,
                "reason": self.reason}


class Baseline:
    """Budget of justified findings per (file, rule)."""

    def __init__(self, entries: Iterable[BaselineEntry] = ()):
        self.entries = list(entries)
        self._budget = {(e.file, e.rule): e for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """The baseline at ``path``; an empty one where there is none."""
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        return cls(BaselineEntry(e["file"], e["rule"], int(e["count"]),
                                 e.get("reason", ""))
                   for e in doc.get("entries", []))

    def save(self, path: str) -> None:
        doc = {"version": 1,
               "entries": [e.to_dict() for e in sorted(
                   self.entries, key=lambda e: (e.file, e.rule))]}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def entry_for(self, file: str, rule: str) -> BaselineEntry | None:
        return self._budget.get((file, rule))

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      previous: "Baseline" = None) -> "Baseline":
        """Budgets from live findings, keeping the reasons of surviving
        (file, rule) entries of ``previous``."""
        counts: dict = {}
        for f in findings:
            counts[(f.file, f.rule)] = counts.get((f.file, f.rule), 0) + 1
        entries = []
        for (file, rule), n in sorted(counts.items()):
            prev = previous.entry_for(file, rule) if previous else None
            reason = prev.reason if prev else \
                "unreviewed (added by --update-baseline)"
            entries.append(BaselineEntry(file, rule, n, reason))
        return cls(entries)


def package_root() -> str:
    """The port package's directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    return os.path.dirname(package_root())


def _iter_py_files(path: str, base: str) -> Iterator[str]:
    if os.path.isfile(path):
        if path.endswith(".py"):
            yield os.path.relpath(path, base).replace(os.sep, "/")
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, fn),
                                      base).replace(os.sep, "/")


def collect_modules(paths: Iterable[str], base: str) -> list[SourceModule]:
    """Parse every Python file under ``paths`` (relative to ``base`` or
    absolute) once.  A path that matches nothing raises; a file that does
    not parse becomes an empty module with its ``parse_error``."""
    rels: list[str] = []
    for raw in paths:
        p = raw if os.path.isabs(raw) else os.path.join(base, raw)
        if not os.path.exists(p):
            raise FileNotFoundError(f"lint target {raw!r} does not exist")
        found = list(_iter_py_files(p, base))
        if not found:
            raise FileNotFoundError(f"lint target {raw!r} holds no Python")
        rels.extend(found)
    modules = []
    for rel in dict.fromkeys(rels):
        with open(os.path.join(base, rel), encoding="utf-8") as fh:
            text = fh.read()
        try:
            modules.append(SourceModule.parse(rel, text))
        except SyntaxError as e:
            mod = SourceModule(rel, "", ast.Module(body=[], type_ignores=[]))
            mod.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
            modules.append(mod)
    return modules


@dataclass
class AnalysisResult:
    findings: list      # unsuppressed, unbaselined: what fails the run
    suppressed: int     # masked by inline suppressions
    files: int
    rules: list         # rule ids that ran
    baselined: int = 0  # absorbed by baseline budgets
    stale_baseline: list = field(default_factory=list)  # entries unused

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_dict(self) -> dict:
        counts: dict = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {"version": 1, "files": self.files, "rules": self.rules,
                "findings": [f.to_dict() for f in sorted(self.findings)],
                "counts": {k: counts[k] for k in sorted(counts)},
                "suppressed": self.suppressed, "baselined": self.baselined,
                "stale_baseline": [e.to_dict()
                                   for e in self.stale_baseline]}


def run_analysis(modules: list[SourceModule], rules: Iterable[Rule],
                 root: str, baseline: Baseline = None) -> AnalysisResult:
    """Run ``rules`` over ``modules``: their findings, then the inline
    suppressions (tracking use), then the unused suppressions as R000,
    then the ``baseline`` budgets (the JAX package's order)."""
    rules = list(rules)
    ctx = AnalysisContext(modules, root)
    raw: list[Finding] = []
    for module in modules:
        if getattr(module, "parse_error", None):
            raw.append(Finding(module.rel, 1, UNUSED_SUPPRESSION_RULE_ID,
                               module.parse_error))
            continue
        for rule in rules:
            if rule.applies(module.rel):
                raw.extend(rule.check(module, ctx))
    for rule in rules:
        raw.extend(rule.finish(ctx))
    kept: list[Finding] = []
    suppressed = 0
    for f in raw:
        module = ctx.by_rel.get(f.file)
        sup = module.suppression_for(f.line, f.rule) if module else None
        if sup is not None:
            sup.used.add(f.rule)
            suppressed += 1
        else:
            kept.append(f)
    ran = {r.id for r in rules}
    for module in modules:
        for sup in module.suppressions:
            dead = [r for r in sorted(sup.rules)
                    if r in ran and r not in sup.used]
            if dead:
                kept.append(Finding(
                    module.rel, sup.comment_line, UNUSED_SUPPRESSION_RULE_ID,
                    f"unused suppression for {', '.join(dead)}: the finding "
                    f"it masked is gone; delete the comment"))
    baseline = baseline or Baseline()
    by_key: dict = {}
    for f in kept:
        by_key.setdefault((f.file, f.rule), []).append(f)
    final: list[Finding] = []
    baselined = 0
    for key, fs in by_key.items():
        entry = baseline.entry_for(*key)
        budget = entry.count if entry else 0
        fs.sort()
        baselined += min(budget, len(fs))
        final.extend(fs[budget:])
    # only entries of a rule that ran can be judged stale
    stale = [e for e in baseline.entries
             if e.rule in ran and (e.file, e.rule) not in by_key]
    return AnalysisResult(findings=sorted(final), suppressed=suppressed,
                          files=len(modules),
                          rules=sorted(r.id for r in rules),
                          baselined=baselined, stale_baseline=stale)
