"""``python -m repro_torch.analysis`` — the two-layer static analyzer (the
reference's ``repro/analysis/cli.py``).

Modes:

* default / ``--check``   — run the requested layers, print open findings,
  exit nonzero if any survive the baselines (the CI gate);
* ``--update-baselines``  — regenerate the budget baselines for the cells
  measured on this device (merge, not overwrite) and exit 0.  Lint
  suppressions are NOT auto-added: edit ``analysis/torch/lint_baseline.json``
  by hand and include a justification line.

Layers (``--layers``): ``lints`` (AST rules), ``programs`` (the round
entries' invariants on one traced call, and their op budgets),
``compiles`` (the driver cells' library builds and launches).  ``--device``
runs the programs on ``cpu`` (the plain versions) or ``cuda`` (the kernels;
each entry under ``set_sync_debug_mode("error")``); rows are keyed by it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .findings import Baseline, Report, repo_root

LAYERS = ("lints", "programs", "compiles")
LINT_BASELINE = os.path.join("analysis", "torch", "lint_baseline.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                description="round-entry auditor + the port's lint pass")
    p.add_argument("--check", action="store_true",
                   help="explicit CI-gate mode (the default behaviour)")
    p.add_argument("--update-baselines", action="store_true",
                   help="regenerate budget baselines for measured cells")
    p.add_argument("--json", metavar="PATH",
                   help="write the findings report (provenance-stamped) here")
    p.add_argument("--layers", default=",".join(LAYERS), help=f"comma list of {LAYERS}")
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                   help="where the program and driver cells run")
    p.add_argument("--ranks", default="1",
                   help="comma list of the rank counts the sharded cells are measured over "
                        "(@d1 in this process; more spawned on the CPU, e.g. 1,2)")
    p.add_argument("--root", default=None,
                   help="repo root to analyze (default: this checkout)")
    return p


def run(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.check and args.update_baselines:
        print("--check and --update-baselines are mutually exclusive", file=sys.stderr)
        return 2
    root = repo_root(args.root)
    layers = tuple(s for s in args.layers.split(",") if s)
    ranks_list = sorted({int(n) for n in args.ranks.split(",") if n} | {1})
    for layer in layers:
        if layer not in LAYERS:
            print(f"unknown layer {layer!r} (choose from {LAYERS})", file=sys.stderr)
            return 2

    report = Report(baseline=Baseline.load(os.path.join(root, LINT_BASELINE)))

    if "lints" in layers:
        from .lints import run_lints
        report.extend(run_lints(root))

    need_programs = "programs" in layers
    need_compiles = "compiles" in layers
    if need_programs or need_compiles:
        from .. import resolve_device
        from . import budgets
        from .programs import build_context, select_cells
        ctx = build_context(resolve_device(args.device))
        # compile budgets FIRST: the program audits would otherwise load the
        # libraries and zero out the deltas being measured
        for layer, kind, filename in (("compiles", "compile-budget", budgets.COMPILES_FILE),
                                      ("programs", "program-budget", budgets.PROGRAMS_FILE)):
            if layer not in layers:
                continue
            if layer == "compiles":
                rows, inv = budgets.measure_compile_counts(ctx)
            else:
                rows, inv = budgets.measure_program_budgets(ctx, select_cells())
                for n in ranks_list[1:]:
                    more, more_inv = budgets.measure_sharded_ranks(
                        [c.name for c in select_cells(placements=("sharded",))],
                        args.device, n)
                    rows.update(more)
                    inv = list(inv) + list(more_inv)
            report.extend(inv)
            path = budgets.budget_path(root, filename)
            if args.update_baselines:
                budgets.merge_budget(path, rows, args.device)
                report.notes.append(f"updated {len(rows)} {layer} cells in {path}")
            else:
                fs, notes = budgets.compare_budget(path, rows, kind, args.device)
                report.extend(fs)
                report.notes.extend(notes)

    open_findings = report.open_findings
    doc = report.to_dict()
    if "lints" not in layers:           # without the lint pass every suppression looks stale
        doc["stale_suppressions"] = []
    try:
        from ..telemetry.provenance import provenance
        doc["provenance"] = provenance(tool="repro_torch.analysis", layers=list(layers),
                                       device=args.device)
    except Exception:  # noqa: BLE001 — the report must still be written
        pass
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True, default=str)
            f.write("\n")

    for note in report.notes:
        print(f"note: {note}")
    stale = doc["stale_suppressions"]
    if stale:
        print(f"note: {len(stale)} stale suppression(s) in the lint baseline can be deleted")
    for f in open_findings:
        print(f.located())
    n_sup = len(doc.get("suppressed", []))
    print(f"{len(open_findings)} open finding(s), {n_sup} suppressed "
          f"(layers={','.join(layers)}; device={args.device})")
    if args.update_baselines:
        return 0
    return 1 if any(f.severity == "error" for f in open_findings) else 0


def main() -> None:
    sys.exit(run())
