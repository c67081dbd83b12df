"""The port's invariant lint driver (the twin of
``src/repro/analysis/lint.py``): ``python -m repro_torch.analysis.lint
[paths]``, by default over the port's package directory.

Runs the port's AST rules (:mod:`repro_torch.analysis.rules`) over the
given files/directories and exits nonzero on any finding; the port's
tree lints clean (DESIGN.md §11).

Suppression: a deliberate exception carries ``# lint: ok[rule-name]``
on the flagged line (or the line directly above), with its reason; a
bare ``# lint: ok`` suppresses every rule on that line. Use sparingly —
the pragma is greppable on purpose.

Programmatic surface (what the fixture tests drive)::

    from repro_torch.analysis.lint import lint_source, lint_paths
    findings = lint_source(code, "snippet.py", rules={"scatter-drop"})
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from typing import Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.rules import ALL_RULES, RULES_BY_NAME, Finding

#: the port's package directory, what the CLI lints by default
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRAGMA = re.compile(r"#\s*lint:\s*ok(?:\[([a-z0-9, -]+)\])?")


def _select(rules: Optional[Iterable[str]]):
    if rules is None:
        return ALL_RULES
    names = set(rules)
    unknown = names - set(RULES_BY_NAME)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; "
            f"known: {sorted(RULES_BY_NAME)}")
    return tuple(r for r in ALL_RULES if r.name in names)


def _suppressed(finding: Finding, lines: Sequence[str]) -> bool:
    for lineno in (finding.line, finding.line - 1):
        if 1 <= lineno <= len(lines):
            m = _PRAGMA.search(lines[lineno - 1])
            if m:
                if m.group(1) is None:
                    return True
                allowed = {s.strip() for s in m.group(1).split(",")}
                if finding.rule in allowed:
                    return True
    return False


def lint_source(source: str, filename: str = "<string>",
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one source string; returns the (pragma-filtered) findings."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Finding(filename, e.lineno or 0, e.offset or 0,
                        "syntax", f"syntax error: {e.msg}")]
    lines = source.splitlines()
    findings: List[Finding] = []
    for rule in _select(rules):
        findings.extend(f for f in rule.check(tree, filename)
                        if not _suppressed(f, lines))
    return sorted(findings, key=lambda f: (f.file, f.line, f.col, f.rule))


def _py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: Iterable[str],
               rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint every .py file under ``paths`` (files or directories)."""
    findings: List[Finding] = []
    for path in _py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), path, rules=rules))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's invariant lint (DESIGN.md §11)")
    ap.add_argument("paths", nargs="*", default=[PACKAGE_DIR],
                    help="files or directories to lint (default: the "
                         "repro_torch package)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name:14s} {r.summary}")
        return 0

    rules: Optional[Set[str]] = None
    if args.rules:
        rules = {s.strip() for s in args.rules.split(",") if s.strip()}
    paths = args.paths or [PACKAGE_DIR]
    findings = lint_paths(paths, rules=rules)
    for f in findings:
        print(f)
    n_files = len(_py_files(paths))
    if findings:
        print(f"\n{len(findings)} finding(s) in {n_files} file(s)",
              file=sys.stderr)
        return 1
    print(f"clean: {n_files} file(s), "
          f"{len(rules) if rules else len(ALL_RULES)} rule(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
