"""Static analysis for the round entries and the port's source tree (the
reference's ``repro.analysis``).

Layer 1 (``program_audit`` / ``programs`` / ``budgets``) holds invariants on
one traced call of each batched round entry — no float64, no host read, the
carry in place, one stacked fetch — and pins op, transfer, build and launch
budgets under ``analysis/torch/budgets/``.  Layer 2 (``lints``) is the
port's AST rule pass with a justification-enforcing suppression baseline.
Entry point: ``python -m repro_torch.analysis`` (see ``cli.py``).
"""
from .findings import Baseline, Finding, Report, make_finding  # noqa: F401
from .program_audit import BAD_DTYPES, ProgramAudit, audit_fn, tree_leaves  # noqa: F401
