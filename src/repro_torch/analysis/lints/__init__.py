"""Lint layer: walk the source tree once, run every applicable rule.

``run_lints(root)`` returns the full finding list (pre-baseline); the CLI
layers the suppression baseline on top via :class:`repro_torch.analysis.
findings.Report`.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, Iterator, List, Optional

from ..findings import Finding, assign_fingerprints, make_finding
from .base import LintContext
from .rules import LINT_RULES  # noqa: F401  (public registry)

# Directories linted, relative to the repo root: the port's package.  Tests
# and chip_smoke.py are out of scope: they intentionally read device values
# back and time with ad-hoc clocks.
LINT_ROOTS = ("src/repro_torch",)


def iter_python_files(root: str,
                      roots: Iterable[str] = LINT_ROOTS) -> Iterator[str]:
    """Absolute paths of every linted .py file, deterministic order."""
    for rel in roots:
        base = os.path.join(root, rel)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_file(root: str, path: str) -> List[Finding]:
    relpath = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError) as e:
        return [make_finding("parse-error", "error", relpath,
                             getattr(e, "lineno", 0) or 0,
                             f"could not parse: {e}")]
    ctx = LintContext(path=path, relpath=relpath, source=source, tree=tree,
                      lines=source.splitlines())
    out: List[Finding] = []
    for rule in LINT_RULES:
        if rule.applies(relpath):
            out.extend(rule.run(ctx))
    return out


def run_lints(root: str,
              files: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint the tree under ``root`` (or just ``files``) and return findings
    with stable per-file fingerprints, sorted by location."""
    paths = list(files) if files is not None else list(iter_python_files(root))
    findings: List[Finding] = []
    for path in paths:
        findings.extend(lint_file(root, path))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.context))
    return assign_fingerprints(findings)
