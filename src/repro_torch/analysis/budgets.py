"""Checked-in program budgets: op and transfer counts, and library builds
and kernel launches a driver cell adds (the reference's
``repro/analysis/budgets.py``).

Two baseline files under ``analysis/torch/budgets/``:

* ``programs.json``     — per program cell (``analysis/programs.py``), the
  measured :meth:`ProgramAudit.budget_row`: the aten operations outside the
  kernels, the carry leaves and how many came back in place, the output
  arity, the fetch leaves, the host transfers, the kernel entries and (on
  the card) the launches by kernel.  Pinning these means a change cannot
  silently add a host read, lose the in-place carry, grow the round's fetch
  or add a launch.
* ``compile_counts.json`` — per driver cell, in the reference's fixed
  :data:`DRIVER_CELLS` order, the kernel libraries the cell built or loaded
  for the first time in this process and the launches by kernel it added
  (``telemetry.metrics.jit_cache_stats`` deltas).  PyTorch runs eagerly:
  what the reference's compile counts catch (a retrace) has its
  counterpart in a library built again; a ``*-again`` cell must add none.

Rows are keyed by device (``@cpu``, ``@cuda``), and a sharded cell's also
by the ranks it was measured over (``@d1``, ``@d2``: the reference's
``@d{N}`` device count; the CPU pins both, the card one), and each
device's rows carry the torch version they were pinned under: a version mismatch downgrades mismatches to
warnings (operation counts drift across torch versions).
``--update-baselines`` merges only the cells measured in this run.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Callable, Dict, List, Tuple

import torch

from .findings import Finding, make_finding

BUDGET_DIR = os.path.join("analysis", "torch", "budgets")
PROGRAMS_FILE = "programs.json"
COMPILES_FILE = "compile_counts.json"


def budget_meta(device: str) -> Dict[str, Any]:
    meta = {"torch": torch.__version__}
    if device == "cuda":
        meta["card"] = torch.cuda.get_device_name(0)
    return meta


def cell_key(name: str, device: str, ranks: int = 1) -> str:
    """A row's key: the cell, then, for a sharded cell, the ranks it was
    measured over (``@d{N}``, the reference's device-count suffix), then the
    device."""
    return f"{name}@d{ranks}@{device}" if "@sharded" in name else f"{name}@{device}"


def budget_path(root: str, filename: str) -> str:
    return os.path.join(root, BUDGET_DIR, filename)


def load_budget(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {"meta": {}, "cells": {}}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def merge_budget(path: str, measured: Dict[str, Dict[str, Any]], device: str) -> None:
    """Read-modify-write: update only the cells measured in this run (and
    this device's meta), so the other device's rows survive."""
    doc = load_budget(path)
    doc.setdefault("meta", {})[device] = budget_meta(device)
    cells = doc.setdefault("cells", {})
    cells.update(measured)
    doc["cells"] = {k: cells[k] for k in sorted(cells)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def compare_budget(path: str, measured: Dict[str, Dict[str, Any]], kind: str,
                   device: str) -> Tuple[List[Finding], List[str]]:
    """Findings for every measured cell that deviates from the checked-in
    baseline.  ``kind`` labels the finding rule (``program-budget`` /
    ``compile-budget``)."""
    findings: List[Finding] = []
    notes: List[str] = []
    relpath = os.path.relpath(path, os.getcwd()) if os.path.isabs(path) else path
    doc = load_budget(path)
    if not any(k.endswith(f"@{device}") for k in doc["cells"]):
        findings.append(make_finding(
            f"{kind}-baseline-missing", "error", relpath, 0,
            f"no {kind} baseline for {device} checked in — run `python -m "
            f"repro_torch.analysis --update-baselines --device {device}` and commit",
            context=f"{kind}@{device}"))
        return findings, notes

    severity = "error"
    base_torch = doc.get("meta", {}).get(device, {}).get("torch")
    if base_torch != torch.__version__:
        severity = "warning"
        notes.append(
            f"{kind}: {device} baseline pinned under torch {base_torch}, running "
            f"{torch.__version__} — mismatches downgraded to warnings "
            f"(regenerate with --update-baselines)")

    for key in sorted(measured):
        row = measured[key]
        base = doc["cells"].get(key)
        if base is None:
            findings.append(make_finding(
                f"{kind}-cell-missing", severity, relpath, 0,
                f"cell '{key}' has no checked-in baseline — run --update-baselines",
                context=key))
            continue
        diffs = [f"{f}: {base.get(f)} -> {row[f]}" for f in sorted(row) if base.get(f) != row[f]]
        if diffs:
            findings.append(make_finding(
                f"{kind}-mismatch", severity, relpath, 0,
                f"cell '{key}' deviates from baseline ({'; '.join(diffs)})", context=key))
    return findings, notes


# ---------------------------------------------------------------------------
# the driver cells: library builds and launches
# ---------------------------------------------------------------------------

def _run_pigeon(ctx, block: int):
    from ..core.protocol import run_pigeon
    run_pigeon(ctx.module, ctx.data, ctx.pcfg, engine="batched", block=block,
               device=ctx.device)


def _run_splitfed(ctx, block: int):
    from ..core.protocol import run_splitfed
    run_splitfed(ctx.module, ctx.data, ctx.pcfg, engine="batched", block=block,
                 device=ctx.device)


def _run_sweep(ctx, block: int):
    from ..core.engine import run_pigeon_sweep
    run_pigeon_sweep(ctx.module, ctx.data, ctx.pcfg, seeds=(0, 1), block=block,
                     device=ctx.device)


def _run_pool(ctx, block: int):
    import dataclasses as _dc

    from ..core.jobs import JobSpec, run_job_pool
    specs = [JobSpec(name=f"job{s}", module=ctx.module, data=ctx.data,
                     pcfg=_dc.replace(ctx.pcfg, seed=s)) for s in (0, 1)]
    run_job_pool(specs, block=block, device=ctx.device)


# Fixed measurement order — the deltas are defined BY this order (a later
# cell reusing a library an earlier cell loaded is the steady state the
# budget proves).
DRIVER_CELLS: List[Tuple[str, Callable]] = [
    ("pigeon/block1", lambda ctx: _run_pigeon(ctx, 1)),
    ("pigeon/block2", lambda ctx: _run_pigeon(ctx, 2)),
    ("pigeon/block2-again", lambda ctx: _run_pigeon(ctx, 2)),
    ("splitfed/block1", lambda ctx: _run_splitfed(ctx, 1)),
    ("splitfed/block2", lambda ctx: _run_splitfed(ctx, 2)),
    ("sweep/block1", lambda ctx: _run_sweep(ctx, 1)),
    ("sweep/block2", lambda ctx: _run_sweep(ctx, 2)),
    ("pool/block2", lambda ctx: _run_pool(ctx, 2)),
    ("pool/block2-again", lambda ctx: _run_pool(ctx, 2)),
]


def _library_state() -> Tuple[set, Dict[str, int]]:
    from ..telemetry.metrics import jit_cache_stats
    stats = jit_cache_stats()
    return set(stats["libraries"]) | set(stats["build_seconds"]), stats["launches"]


def measure_compile_counts(ctx) -> Tuple[Dict[str, Dict[str, Any]], List[Finding]]:
    """Run every driver cell on the tiny task: the libraries each built or
    loaded first in this process, and the launches it added.  The
    ``*-again`` cells pin the steady state: a repeat run must add ZERO
    library builds."""
    device = ctx.device.type
    rows: Dict[str, Dict[str, Any]] = {}
    findings: List[Finding] = []
    for name, run in DRIVER_CELLS:
        libs0, launches0 = _library_state()
        run(ctx)
        libs1, launches1 = _library_state()
        key = cell_key(name, device)
        rows[key] = {"library_builds": len(libs1 - libs0),
                     "launches": {k: v - launches0.get(k, 0) for k, v in sorted(launches1.items())
                                  if v != launches0.get(k, 0)}}
        if name.endswith("-again") and rows[key]["library_builds"]:
            findings.append(make_finding(
                "repeat-build", "error", f"driver:{key}", 0,
                f"a repeat run built or loaded {rows[key]['library_builds']} kernel "
                f"libraries again", context=key))
    return rows, findings


def measure_program_budgets(ctx, cells) -> Tuple[Dict[str, Dict[str, Any]], List[Finding]]:
    """Audit every program cell; returns (budget rows, invariant findings).
    A sharded cell runs in a process group of one rank (gloo on the CPU,
    NCCL on the card), closed after the cell unless one was already up,
    and is keyed ``@d1`` (:func:`measure_sharded_ranks` measures more)."""
    from ..launch.mesh import group_of_one
    from .program_audit import audit_fn
    rows: Dict[str, Dict[str, Any]] = {}
    findings: List[Finding] = []
    device = ctx.device.type
    backend = "nccl" if device == "cuda" else "gloo"
    for cell in cells:
        key = cell_key(cell.name, device)
        with (group_of_one(backend) if cell.placement == "sharded"
              else contextlib.nullcontext()):
            fn, args, carry = cell.realize(ctx)
            audit = audit_fn(fn, args, name=key, carry_argnums=carry,
                             expected_fetch_leaves=cell.fetch_leaves(ctx))
        findings.extend(audit.findings)
        rows[key] = audit.budget_row()
    return rows, findings


def _audit_rank(names: List[str], device: str, ranks: int):
    """One spawned rank's audits of the sharded cells ``names`` (the group
    is up): (rows, findings as tuples)."""
    from .program_audit import audit_fn
    from .programs import build_context, select_cells
    torch.set_num_threads(1)
    ctx = build_context(device)
    rows, found = {}, []
    for cell in select_cells(names=tuple(names)):
        key = cell_key(cell.name, device, ranks)
        fn, args, carry = cell.realize(ctx)
        audit = audit_fn(fn, args, name=key, carry_argnums=carry,
                         expected_fetch_leaves=cell.fetch_leaves(ctx))
        rows[key] = audit.budget_row()
        found.extend(audit.findings)
    return rows, found


def measure_sharded_ranks(names: List[str], device: str, ranks: int,
                          deadline_s: float = 240.0
                          ) -> Tuple[Dict[str, Dict[str, Any]], List[Finding]]:
    """The sharded cells ``names`` audited over ``ranks`` spawned gloo ranks
    on this host (the CPU): rank 0's rows, keyed ``@d{ranks}``, and every
    rank's findings."""
    from ..launch.mesh import spawn
    if device != "cpu":
        raise ValueError("the spawned ranks' audits run on the CPU (one card holds one "
                         "rank: the card's rows are @d1)")
    results = spawn(_audit_rank, ranks, "gloo", deadline_s, args=(list(names), device, ranks),
                    threads=1)
    return results[0][0], [f for _, found in results for f in found]


__all__ = ["BUDGET_DIR", "COMPILES_FILE", "DRIVER_CELLS", "PROGRAMS_FILE", "budget_meta",
           "budget_path", "cell_key", "compare_budget", "load_budget", "measure_compile_counts",
           "measure_program_budgets", "measure_sharded_ranks", "merge_budget"]
