"""The port's lint rules.

Five rule classes, each encoding one bug class this codebase guards
against; where the reference (``repro/analysis/lints/rules.py``) has the
same bug class, the rule keeps its id:

- ``hidden-host-sync``      — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                              ``.numpy()`` / ``float(t)`` / ``int(t)`` /
                              ``np.asarray(t)`` on device tensors inside
                              ``core/engine.py`` / ``core/runner.py``;
                              everything but the baselined one-fetch sites
                              breaks the one-fetch-per-round contract.
- ``wall-clock``            — ``time.time()`` anywhere but
                              ``telemetry/provenance.py``; timing uses the
                              monotonic ``perf_counter`` family.
- ``unseeded-np-random``    — module-level ``np.random.*`` draws off the
                              global (unseeded) numpy state.
- ``unseeded-torch-random`` — a torch draw (``torch.rand*``, ``randperm``,
                              ``bernoulli``, ``normal_``, ``nn.init.*``, ...)
                              without ``generator=``: it reads the global
                              torch state, which no seed of the run's
                              streams fixes (the port's counterpart of the
                              reference's ``prng-key-reuse``: the port
                              draws from explicit generators).
- ``mutable-default-arg``   — the classic shared-mutable-default trap.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from ..findings import Finding
from .base import (FunctionNode, LintContext, LintRule, assignment_targets, dotted_name,
                   expr_calls, function_scopes, import_aliases, resolve_call, scope_events)


# ---------------------------------------------------------------------------
# hidden-host-sync
# ---------------------------------------------------------------------------

_SYNC_FILES = ("src/repro_torch/core/engine.py", "src/repro_torch/core/runner.py")

# call targets whose results are host values regardless of their arguments
_HOST_MODULE_PREFIX = ("numpy.", "os.", "time.", "math.")
_HOST_BUILTINS = {"range", "len", "int", "str", "bool", "list", "tuple",
                  "dict", "sorted", "enumerate", "zip", "min", "max", "sum",
                  "abs", "isinstance", "getattr", "hasattr", "float"}
# repo-specific: the unpack_* helpers only ever see the already-fetched
# stacked round vector — THE whitelisted fetch path — the evaluations return
# fetched accuracies and ``_fetch_together`` the host path's one fetch
_HOST_WHITELIST_FNS = {"unpack_fetch", "unpack_block_fetch", "evaluate", "evaluate_sweep",
                       "_fetch_together"}
# tensor methods whose results are host values: the fetches themselves
# (reported separately) and the metadata
_FETCH_METHODS = {"item", "tolist", "numpy", "cpu"}
_META_METHODS = {"numel", "size", "dim", "element_size", "data_ptr", "stride",
                 "get_device", "is_contiguous"}
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "requires_grad"}


class HiddenHostSync(LintRule):
    id = "hidden-host-sync"
    severity = "error"
    description = (".item()/.tolist()/.cpu()/.numpy()/float()/int()/np.asarray on a "
                   "device tensor in the round engine outside the baselined fetch sites")

    def applies(self, relpath: str) -> bool:
        return relpath in _SYNC_FILES

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        aliases = import_aliases(ctx.tree)
        for _scope, body in function_scopes(ctx.tree):
            host: Set[str] = set()
            found: List[Finding] = []

            def is_host(e: Optional[ast.AST]) -> bool:
                """Conservative 'definitely a host value' — False means the
                expression may hold a live device tensor."""
                if e is None or isinstance(e, ast.Constant):
                    return True
                if isinstance(e, ast.Name):
                    return e.id in host
                if isinstance(e, ast.Attribute):
                    if e.attr in _META_ATTRS:
                        return True
                    base = dotted_name(e)
                    if base is not None:
                        head = base.split(".")[0]
                        if aliases.get(head, head) in ("numpy", "os", "time", "math"):
                            return True
                    return is_host(e.value)
                if isinstance(e, (ast.Subscript, ast.Starred)):
                    return is_host(e.value)
                if isinstance(e, (ast.BinOp, ast.BoolOp, ast.Compare, ast.UnaryOp, ast.IfExp,
                                  ast.Tuple, ast.List, ast.Set, ast.Dict, ast.JoinedStr,
                                  ast.FormattedValue, ast.Slice)):
                    return all(is_host(c) for c in ast.iter_child_nodes(e)
                               if not isinstance(c, (ast.operator, ast.boolop, ast.cmpop,
                                                     ast.unaryop, ast.expr_context)))
                if isinstance(e, ast.Call):
                    return call_result_is_host(e)
                if isinstance(e, (ast.ListComp, ast.SetComp, ast.DictComp,
                                  ast.GeneratorExp)):
                    return all(is_host(g.iter) for g in e.generators)
                return False

            def call_result_is_host(call: ast.Call) -> bool:
                if isinstance(call.func, ast.Attribute) and (
                        call.func.attr in _FETCH_METHODS | _META_METHODS
                        or is_host(call.func.value)):     # a method of a host value
                    return True
                full = resolve_call(call, aliases)
                if full is None:
                    return False
                if full.rsplit(".", 1)[-1] in _HOST_WHITELIST_FNS:
                    return True
                return full in _HOST_BUILTINS or full.startswith(_HOST_MODULE_PREFIX)

            def check(call: ast.Call) -> None:
                """Findings for the sync idioms on device arguments."""
                full = resolve_call(call, aliases)
                if isinstance(call.func, ast.Attribute) and call.func.attr in _FETCH_METHODS:
                    if not is_host(call.func.value):
                        found.append(self.finding(
                            ctx, call,
                            f".{call.func.attr}() on a device tensor is a device->host "
                            f"transfer that blocks the host; go through the stacked fetch "
                            f"(baseline the intended fetch sites)"))
                    return
                args_host = all(is_host(a) for a in call.args)
                if full in ("numpy.asarray", "numpy.array") and not args_host:
                    found.append(self.finding(
                        ctx, call,
                        f"{full}() on a device tensor is a device->host transfer; "
                        f"whitelist intended fetch sites in the baseline"))
                elif full in ("float", "int") and not args_host:
                    found.append(self.finding(
                        ctx, call,
                        f"{full}() on a device tensor blocks on a host sync; fetch "
                        f"through the stacked round vector instead"))

            self._walk(body, host, is_host, check)
            yield from found

    def _walk(self, body, host, is_host, check) -> None:
        """Statement-order walk maintaining the host-name set; ``check``
        emits findings as a side effect."""
        for stmt in body:
            if isinstance(stmt, FunctionNode) or isinstance(stmt, ast.ClassDef):
                continue
            # comprehension variables iterate host values -> host for the
            # duration of this statement ([float(v) for v in fetched])
            tmp: Set[str] = set()
            for node in ast.walk(stmt):
                if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                     ast.GeneratorExp)):
                    for g in node.generators:
                        if is_host(g.iter):
                            tmp |= _target_names(g.target)
            tmp -= host
            host |= tmp
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = getattr(stmt, "value", None)
                for c in expr_calls(value):
                    check(c)
                if is_host(value):
                    host |= assignment_targets(stmt)
                else:
                    host -= assignment_targets(stmt)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                for c in expr_calls(stmt.iter):
                    check(c)
                if is_host(stmt.iter):
                    host |= assignment_targets(stmt)
                else:
                    host -= assignment_targets(stmt)
                self._walk(stmt.body, host, is_host, check)
                self._walk(stmt.orelse, host, is_host, check)
            elif isinstance(stmt, ast.While):
                for c in expr_calls(stmt.test):
                    check(c)
                self._walk(stmt.body, host, is_host, check)
            elif isinstance(stmt, ast.If):
                for c in expr_calls(stmt.test):
                    check(c)
                self._walk(stmt.body, host, is_host, check)
                self._walk(stmt.orelse, host, is_host, check)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    for c in expr_calls(item.context_expr):
                        check(c)
                self._walk(stmt.body, host, is_host, check)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, host, is_host, check)
                for h in stmt.handlers:
                    self._walk(h.body, host, is_host, check)
                self._walk(stmt.orelse, host, is_host, check)
                self._walk(stmt.finalbody, host, is_host, check)
            else:
                for c in expr_calls(stmt):
                    check(c)
            host -= tmp


def _target_names(t: ast.AST) -> Set[str]:
    out: Set[str] = set()
    if isinstance(t, ast.Name):
        out.add(t.id)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            out |= _target_names(e)
    elif isinstance(t, ast.Starred):
        out |= _target_names(t.value)
    return out


# ---------------------------------------------------------------------------
# wall-clock
# ---------------------------------------------------------------------------

class WallClock(LintRule):
    id = "wall-clock"
    severity = "error"
    description = "time.time() outside telemetry/provenance.py"

    EXEMPT = ("src/repro_torch/telemetry/provenance.py",)

    def applies(self, relpath: str) -> bool:
        return relpath not in self.EXEMPT

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                full = resolve_call(node, aliases)
                if full in ("time.time", "time.time_ns"):
                    yield self.finding(
                        ctx, node,
                        "time.time() steps under NTP; use time.perf_counter "
                        "(timing) or telemetry.provenance (wall-clock stamps)")


# ---------------------------------------------------------------------------
# unseeded-np-random
# ---------------------------------------------------------------------------

class UnseededNpRandom(LintRule):
    id = "unseeded-np-random"
    severity = "error"
    description = "module-level np.random.* draw off the global numpy state"

    # constructors / seeding calls that are fine at module level
    OK = {"default_rng", "Generator", "RandomState", "seed", "SeedSequence",
          "PCG64", "Philox", "MT19937", "SFC64", "BitGenerator"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        aliases = import_aliases(ctx.tree)
        module_body = list(getattr(ctx.tree, "body", []))
        for kind, payload in scope_events(module_body):
            if kind != "call":
                continue
            full = resolve_call(payload, aliases)
            if not full or not full.startswith("numpy.random."):
                continue
            fn = full.split(".")[-1]
            if fn in self.OK:
                continue
            yield self.finding(
                ctx, payload,
                f"module-level np.random.{fn}() draws from the global "
                f"unseeded state; thread an np.random.default_rng(seed) "
                f"Generator instead")


# ---------------------------------------------------------------------------
# unseeded-torch-random
# ---------------------------------------------------------------------------

#: torch functions that draw (``torch.<name>``), all of which take
#: ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
                "normal", "poisson", "rand_like", "randn_like", "randint_like"}
#: in-place tensor draws (``t.normal_()``), all of which take ``generator=``
_TENSOR_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_", "exponential_",
                 "geometric_", "cauchy_", "log_normal_"}


class UnseededTorchRandom(LintRule):
    id = "unseeded-torch-random"
    severity = "error"
    description = "a torch draw without generator= reads the global torch state"

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if any(kw.arg == "generator" for kw in node.keywords):
                continue
            full = resolve_call(node, aliases) or ""
            head, _, name = full.rpartition(".")
            if head == "torch" and name in _TORCH_DRAWS:
                what = f"torch.{name}()"
            elif head == "torch.nn.init" and not name.startswith("calculate"):
                what = f"nn.init.{name}()"
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _TENSOR_DRAWS \
                    and not full.startswith("torch.nn.init."):
                what = f".{node.func.attr}()"
            else:
                continue
            yield self.finding(
                ctx, node,
                f"{what} without generator= draws from the global torch state; pass "
                f"the run's torch.Generator")


# ---------------------------------------------------------------------------
# mutable-default-arg
# ---------------------------------------------------------------------------

class MutableDefaultArg(LintRule):
    id = "mutable-default-arg"
    severity = "error"
    description = "mutable default argument shared across calls"

    _MUTABLE_CALLS = {"list", "dict", "set", "bytearray",
                      "collections.defaultdict", "collections.OrderedDict"}

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                bad = isinstance(d, (ast.List, ast.Dict, ast.Set))
                if isinstance(d, ast.Call):
                    full = resolve_call(d, aliases)
                    bad = full in self._MUTABLE_CALLS
                if bad:
                    name = getattr(node, "name", "<lambda>")
                    yield self.finding(
                        ctx, d,
                        f"mutable default argument in '{name}' is shared "
                        f"across calls; default to None and construct inside")


LINT_RULES: List[LintRule] = [
    HiddenHostSync(),
    WallClock(),
    UnseededNpRandom(),
    UnseededTorchRandom(),
    MutableDefaultArg(),
]
