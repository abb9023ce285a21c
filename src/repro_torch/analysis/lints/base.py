"""Lint infrastructure: per-file AST context and the rule protocol.

Rules are small classes with an ``id``, a ``severity`` and a ``run(ctx)``
generator of raw findings; the registry (``lints/__init__.py``) walks the
source tree once, parses each file once and hands the shared
:class:`LintContext` to every applicable rule.  Helpers here do the common
AST chores: resolving dotted call names through import aliases, walking
statements in execution order and iterating function scopes.

A copy of the reference's ``repro/analysis/lints/base.py`` (pure Python).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..findings import Finding, make_finding


@dataclasses.dataclass
class LintContext:
    """One parsed source file, shared by every rule."""
    path: str                   # absolute
    relpath: str                # repo-relative, forward slashes
    source: str
    tree: ast.AST
    lines: List[str]

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class LintRule:
    """Base rule.  Subclasses set ``id``/``severity``/``description`` and
    implement ``run``; ``applies`` scopes a rule to specific files (default:
    every Python file under the linted roots)."""
    id: str = ""
    severity: str = "error"
    description: str = ""

    def applies(self, relpath: str) -> bool:
        return True

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: LintContext, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        return make_finding(self.id, self.severity, ctx.relpath, line,
                            message, context=ctx.line_text(line))


def dotted_name(node: ast.AST) -> Optional[str]:
    """'np.random.seed' for Attribute chains rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> fully qualified module/attribute for every import in
    the file (``import torch.nn.functional as F`` -> {'F':
    'torch.nn.functional'}; ``from torch import nn`` -> {'nn': 'torch.nn'};
    ``from numpy.random import rand`` -> {'rand': 'numpy.random.rand'})."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve_call(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """Fully qualified dotted name of a call target, through import
    aliases: ``F.relu(x)`` -> 'torch.nn.functional.relu'."""
    name = dotted_name(node.func)
    if name is None:
        return None
    head, _, tail = name.partition(".")
    full_head = aliases.get(head, head)
    return f"{full_head}.{tail}" if tail else full_head


def assignment_targets(stmt: ast.stmt) -> Set[str]:
    """Plain names (re)bound by a statement, tuple targets included."""
    out: Set[str] = set()

    def collect(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)
        elif isinstance(t, ast.Starred):
            collect(t.value)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            collect(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For,
                           ast.AsyncFor)):
        collect(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                collect(item.optional_vars)
    return out


FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def function_scopes(tree: ast.AST) -> Iterator[Tuple[ast.AST, List[ast.stmt]]]:
    """Every function-like scope in the file (module included), with its
    statement list.  Lambdas yield their body expression wrapped in an
    ``ast.Expr`` so scope walkers see a uniform statement list."""
    yield tree, list(getattr(tree, "body", []))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, list(node.body)
        elif isinstance(node, ast.Lambda):
            expr = ast.Expr(value=node.body)
            ast.copy_location(expr, node.body)
            yield node, [expr]


def expr_calls(node: Optional[ast.AST]) -> Iterator[ast.Call]:
    """Call nodes inside one expression in evaluation (post-)order — inner
    calls before the call consuming their result — without descending into
    nested function/lambda scopes (those are separate scopes)."""
    if node is None:
        return
    if isinstance(node, FunctionNode):
        return
    for child in ast.iter_child_nodes(node):
        yield from expr_calls(child)
    if isinstance(node, ast.Call):
        yield node


def scope_events(body: List[ast.stmt]) -> Iterator[Tuple[str, object]]:
    """A scope's calls and name bindings as one linear event stream:
    ``('call', Call)`` / ``('bind', set_of_names)``, in approximate
    execution order.  Compound statements contribute their header
    expressions, then their bodies; loop bodies are walked TWICE — the
    second pass models the next iteration, so state consumed in a loop body
    without an interleaving rebind is caught as cross-iteration reuse.
    Nested function/lambda scopes are skipped (they are their own scopes)."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            for c in expr_calls(stmt.iter):
                yield "call", c
            for _ in range(2):
                yield "bind", assignment_targets(stmt)
                yield from scope_events(stmt.body)
            yield from scope_events(stmt.orelse)
        elif isinstance(stmt, ast.While):
            for _ in range(2):
                for c in expr_calls(stmt.test):
                    yield "call", c
                yield from scope_events(stmt.body)
            yield from scope_events(stmt.orelse)
        elif isinstance(stmt, ast.If):
            for c in expr_calls(stmt.test):
                yield "call", c
            yield "push", None
            yield from scope_events(stmt.body)
            yield "alt", None
            yield from scope_events(stmt.orelse)
            yield "pop", None
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                for c in expr_calls(item.context_expr):
                    yield "call", c
            yield "bind", assignment_targets(stmt)
            yield from scope_events(stmt.body)
        elif isinstance(stmt, ast.Try):
            yield from scope_events(stmt.body)
            for h in stmt.handlers:
                yield "push", None
                yield from scope_events(h.body)
                yield "alt", None
                yield "pop", None
            yield from scope_events(stmt.orelse)
            yield from scope_events(stmt.finalbody)
        elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            for c in expr_calls(getattr(stmt, "value", None)):
                yield "call", c
            yield "bind", assignment_targets(stmt)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            for c in expr_calls(stmt.value):
                yield "call", c
        else:
            for c in expr_calls(stmt):
                yield "call", c
