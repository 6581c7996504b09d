"""The invariant-linter walker and CLI of the port.

The port of ``netrep_tpu/analysis/linter.py``: walks a tree of Python
sources, runs every rule in :mod:`netrep_tpu_torch.analysis.rules` over
each parsed module, applies inline suppressions, and renders a human
report or one machine JSON line (the JAX package's ``lint_v`` schema).

Suppression grammar (one comment, same line as the finding or the line
directly above it)::

    # netrep: allow(<rule>[, <rule>...]) — <reason>

The separator may be an em dash, ``--``, or ``:``; the reason is
REQUIRED — a suppression without one is itself a finding
(``suppression-syntax``, not suppressible) because an unexplained
exception is indistinguishable from a silenced bug. Honored suppressions
are counted and reported; suppressions that match no finding are listed
as stale (informational — they do not fail the lint, so a fixed
violation does not force a lockstep comment removal, but the report
keeps them visible until someone does).

Exit codes: 0 clean, 2 unsuppressed findings or an unknown rule — the
shape ``perf --check`` already uses.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import sys
import tokenize

from .rules import Finding, Module, default_rules

#: version of the ``--json`` output shape (the JAX package's: readers key
#: on ``lint_v`` to classify the line)
LINT_SCHEMA = 1

#: the meta-rule name for malformed suppressions; never suppressible
SYNTAX_RULE = "suppression-syntax"

_ALLOW_RE = re.compile(
    r"#\s*netrep:\s*allow\(\s*([A-Za-z0-9_,\s-]*?)\s*\)\s*"
    r"(?:—|--|:)?\s*(.*?)\s*$"
)


@dataclasses.dataclass
class Suppression:
    """One parsed ``# netrep: allow(...)`` comment."""

    path: str
    line: int
    rules: tuple[str, ...]
    reason: str
    used: int = 0


def _comments(source: str) -> list[tuple[int, str]]:
    """(line, text) of every COMMENT token — tokenize, not line-scanning,
    so a docstring DESCRIBING the suppression grammar is not parsed as a
    suppression (the linter's own docs would otherwise self-flag)."""
    out: list[tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        pass  # the AST parse already reported the file as broken
    return out


def parse_suppressions(path: str,
                       source: str) -> tuple[list[Suppression],
                                             list[Finding]]:
    """Scan comment tokens for allow-comments; malformed ones (no reason,
    or an empty rule list) come back as ``suppression-syntax`` findings."""
    sups: list[Suppression] = []
    bad: list[Finding] = []
    for i, text in _comments(source):
        m = _ALLOW_RE.search(text)
        if not m:
            if "netrep: allow" in text:
                bad.append(Finding(
                    SYNTAX_RULE, path, i,
                    "unparseable suppression — the grammar is "
                    "'# netrep: allow(<rule>) — <reason>'",
                ))
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2)
        if not rules:
            bad.append(Finding(
                SYNTAX_RULE, path, i,
                "suppression names no rule — use "
                "'# netrep: allow(<rule>) — <reason>'",
            ))
            continue
        if not reason:
            bad.append(Finding(
                SYNTAX_RULE, path, i,
                f"suppression for {', '.join(rules)} carries no reason — "
                "an unexplained exception is indistinguishable from a "
                "silenced bug",
            ))
            continue
        sups.append(Suppression(path, i, rules, reason))
    return sups, bad


def _apply_suppressions(findings: list[Finding],
                        sups: list[Suppression]
                        ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (kept, suppressed); same line or line above."""
    by_pos: dict[tuple[int, str], Suppression] = {}
    for s in sups:
        for r in s.rules:
            by_pos[(s.line, r)] = s
    kept, suppressed = [], []
    for f in findings:
        if f.rule == SYNTAX_RULE:
            kept.append(f)
            continue
        s = by_pos.get((f.line, f.rule)) or by_pos.get((f.line - 1, f.rule))
        if s is not None:
            s.used += 1
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


@dataclasses.dataclass
class LintReport:
    """Everything one lint run produced, pre-rendering."""

    findings: list[Finding]
    suppressed: list[Finding]
    suppressions: list[Suppression]
    files: int
    rules: tuple[str, ...]
    parse_errors: list[Finding]

    @property
    def ok(self) -> bool:
        return not (self.findings or self.parse_errors)

    @property
    def stale(self) -> list[Suppression]:
        """Unused suppressions whose rules were all ACTIVE this run — a
        ``--rule``-filtered run must not report the other rules'
        suppressions as stale."""
        active = set(self.rules)
        return [s for s in self.suppressions
                if s.used == 0 and set(s.rules) <= active]

    def to_json(self) -> dict:
        return {
            "lint_v": LINT_SCHEMA,
            "ok": self.ok,
            "files": self.files,
            "rules": list(self.rules),
            "findings": [dataclasses.asdict(f)
                         for f in self.findings + self.parse_errors],
            "suppressed": [dataclasses.asdict(f) for f in self.suppressed],
            "suppressions": [dataclasses.asdict(s)
                             for s in self.suppressions],
            "stale_suppressions": [dataclasses.asdict(s)
                                   for s in self.stale],
        }

    def render(self) -> str:
        lines = []
        for f in sorted(self.findings + self.parse_errors,
                        key=lambda f: (f.path, f.line)):
            lines.append(f.render())
        per_rule: dict[str, int] = {}
        for f in self.suppressed:
            per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
        tally = ", ".join(f"{r}: {n}" for r, n in sorted(per_rule.items()))
        lines.append(
            f"{len(self.findings) + len(self.parse_errors)} finding(s) "
            f"over {self.files} file(s), {len(self.suppressed)} "
            f"suppressed ({tally or 'none'})"
        )
        for s in self.stale:
            lines.append(
                f"{s.path}:{s.line}: stale suppression for "
                f"{', '.join(s.rules)} (matched no finding)"
            )
        return "\n".join(lines)


def _iter_sources(paths: list[str]):
    for root in paths:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def package_root() -> str:
    """The port's package directory (``netrep_tpu_torch/``) — the default
    (and tier-1-gated) lint target, and the root ``pkg_rel`` is taken
    against for rule scoping."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_paths(paths: list[str] | None = None,
               rules=None,
               rule_names: list[str] | None = None) -> LintReport:
    """Lint files/trees and return the :class:`LintReport`.

    ``paths`` defaults to the package itself. ``rule_names`` filters the
    active set (the CLI's ``--rule``)."""
    if rules is None:
        rules = default_rules()
    if rule_names:
        known = {r.name for r in rules}
        unknown = set(rule_names) - known
        if unknown:
            raise ValueError(
                f"unknown rule(s) {sorted(unknown)}; "
                f"available: {sorted(known)}"
            )
        rules = [r for r in rules if r.name in rule_names]
    pkg = package_root()
    roots = [pkg] if paths is None else paths
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    suppressions: list[Suppression] = []
    parse_errors: list[Finding] = []
    files = 0
    for path in _iter_sources(roots):
        files += 1
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            parse_errors.append(Finding(
                "parse-error", path, 0, f"unreadable: {e}"))
            continue
        rel = os.path.relpath(os.path.abspath(path), pkg)
        pkg_rel = None if rel.startswith("..") else rel
        try:
            mod = Module(path, source, pkg_rel=pkg_rel)
        except SyntaxError as e:
            parse_errors.append(Finding(
                "parse-error", path, e.lineno or 0, f"syntax error: {e.msg}"))
            continue
        sups, bad = parse_suppressions(path, source)
        raw: list[Finding] = list(bad)
        for rule in rules:
            raw.extend(rule.check(mod))
        kept, supd = _apply_suppressions(raw, sups)
        findings.extend(kept)
        suppressed.extend(supd)
        suppressions.extend(sups)
    return LintReport(
        findings=findings, suppressed=suppressed,
        suppressions=suppressions, files=files,
        rules=tuple(r.name for r in rules), parse_errors=parse_errors,
    )


def lint_source(source: str, path: str = "<fixture>.py",
                rules=None, rule_names: list[str] | None = None
                ) -> LintReport:
    """Lint one in-memory source string — the fixture entry point
    ``tests/test_torch_lint.py`` drives every rule through."""
    if rules is None:
        rules = default_rules()
    if rule_names:
        rules = [r for r in rules if r.name in rule_names]
    mod = Module(path, source, pkg_rel=None)
    sups, bad = parse_suppressions(path, source)
    raw: list[Finding] = list(bad)
    for rule in rules:
        raw.extend(rule.check(mod))
    kept, supd = _apply_suppressions(raw, sups)
    return LintReport(
        findings=kept, suppressed=supd, suppressions=sups, files=1,
        rules=tuple(r.name for r in rules), parse_errors=[],
    )


def main_lint(args) -> int:
    """The ``python -m netrep_tpu_torch lint`` entry point (argparse
    namespace with ``json``, ``rule``, ``paths``)."""
    try:
        report = lint_paths(
            paths=args.paths or None,
            rule_names=args.rule or None,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report.to_json()))
    else:
        print(report.render())
    return 0 if report.ok else 2
