"""Layer 1: the round entries' invariants, held on one traced call (the
counterpart of the reference's ``analysis/jaxpr_audit.py``, which proves
them on the lowered program text).

PyTorch runs eagerly, so the auditor runs the entry once under
``launch/op_analysis.py``'s counter and reads what it did.  The reference's
four invariants:

1. **No float64.**  The attack/selection arithmetic is an f32 lane; a
   float64 operand or result anywhere in the call (a Python double promoted
   by ``torch.tensor(0.1)``-style code, a ``float64`` numpy array moved in)
   is a finding.
2. **No host sync inside the entry.**  The counter's host transfers
   (``.item()``, ``.tolist()``, ``.cpu()``, ``float(t)``, ``nonzero``, ...)
   must be 0: the round's data leaves only through the caller's one stacked
   fetch.  On the card the call also runs under
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
   synchronizing CUDA call.
3. **Carry in place** (donation's counterpart).  An entry that carries
   theta updates it in place: every leaf of the returned theta has the
   input leaf's ``data_ptr``.
4. **One stacked fetch.**  The entry's outputs other than the carry count
   exactly the pinned leaves (accept -> 1, sweep -> 3, ...).

Every check returns :class:`~repro_torch.analysis.findings.Finding`
objects, so the CLI treats program violations and lint hits alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .findings import Finding, make_finding

BAD_DTYPES = ("float64", "complex128")


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of an entry's argument or result: a module's parameters,
    the elements of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tree_leaves(x)]
    return []


@dataclasses.dataclass
class ProgramAudit:
    """Everything the auditor measured about one program cell."""
    name: str
    findings: List[Finding]
    aten_ops: int = 0
    carry_leaves: int = 0
    carried_in_place: int = 0
    outputs: int = 0
    fetch_leaves: int = 0
    transfers: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def budget_row(self) -> Dict[str, Any]:
        """The numbers pinned in ``analysis/torch/budgets/programs.json``."""
        return {"aten_ops": self.aten_ops, "carry_leaves": self.carry_leaves,
                "carried_in_place": self.carried_in_place, "outputs": self.outputs,
                "fetch_leaves": self.fetch_leaves,
                "host_transfers": sum(self.transfers.values()),
                "kernel_entries": dict(sorted(self.kernels.items())),
                "launches": dict(sorted(self.launches.items()))}


@contextlib.contextmanager
def _sync_errors(device: torch.device):
    """On the card: every synchronizing CUDA call raises."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _device_of(args) -> torch.device:
    leaves = tree_leaves(args)
    return leaves[0].device if leaves else torch.device("cpu")


def audit_fn(fn: Callable, args: tuple, *, name: str, carry_argnums: Tuple[int, ...] = (),
             expected_fetch_leaves: Optional[int] = None) -> ProgramAudit:
    """Run ``fn(*args)`` once and hold it to the four invariants.

    ``carry_argnums`` names the arguments the entry carries (updated in
    place and returned as the first result: theta); ``expected_fetch_leaves``
    pins the count of the other results' leaves.  Returns the audit with its
    findings; the call's results are dropped."""
    from ..kernels import build
    from ..launch.op_analysis import OpCounter
    findings: List[Finding] = []
    path = f"program:{name}"
    device = _device_of(args)
    carried = [t for i in carry_argnums for t in tree_leaves(args[i])]
    ptrs = [t.data_ptr() for t in carried]
    launches0 = dict(build.LAUNCHES)
    counter = OpCounter(track_memory=False)
    try:
        with _sync_errors(device), counter:
            out = fn(*args)
    except RuntimeError as e:
        if device.type != "cuda" or "synchroniz" not in str(e):
            raise
        findings.append(make_finding(
            "host-sync-in-program", "error", path, 0,
            f"a synchronizing CUDA call inside the entry: {e}", context=f"{name}:sync"))
        return ProgramAudit(name=name, findings=findings)
    a = counter.result
    audit = ProgramAudit(name=name, findings=findings, aten_ops=a.ops,
                         transfers=dict(a.host_transfers), kernels=dict(a.kernels),
                         launches={k: v - launches0.get(k, 0)
                                   for k, v in build.LAUNCHES.items()
                                   if v != launches0.get(k, 0)})

    for dtype in sorted(set(a.dtypes) & set(BAD_DTYPES)):
        findings.append(make_finding(
            "f64-in-program", "error", path, 0,
            f"a {dtype} operand or result in the traced entry (pin the literal or the "
            f"array to float32)", context=f"{name}:{dtype}"))
    for kind, n in sorted(a.host_transfers.items()):
        findings.append(make_finding(
            "host-transfer-in-program", "error", path, 0,
            f"{n} host read(s) of kind '{kind}' inside the entry -- data may only leave "
            f"through the caller's stacked fetch", context=f"{name}:{kind}"))

    results = out if isinstance(out, tuple) else (out,)
    leaves = tree_leaves(results)
    audit.outputs = len(leaves)
    audit.carry_leaves = len(carried)
    if carried:
        returned = tree_leaves(results[0])
        audit.carried_in_place = sum(1 for t, p in zip(returned, ptrs) if t.data_ptr() == p)
        if len(returned) != len(carried) or audit.carried_in_place != len(carried):
            findings.append(make_finding(
                "carry-not-in-place", "error", path, 0,
                f"{audit.carried_in_place} of {len(carried)} carry leaves come back in place "
                f"({len(returned)} returned): theta must be updated where it lies",
                context=f"{name}:carry"))
        audit.fetch_leaves = audit.outputs - len(returned)
    else:
        audit.fetch_leaves = audit.outputs
    if expected_fetch_leaves is not None and audit.fetch_leaves != expected_fetch_leaves:
        findings.append(make_finding(
            "fetch-contract", "error", path, 0,
            f"{audit.fetch_leaves} non-carry outputs, the contract pins "
            f"{expected_fetch_leaves} stacked fetch leaves", context=f"{name}:fetch"))
    return audit


__all__ = ["BAD_DTYPES", "ProgramAudit", "audit_fn", "tree_leaves"]
