"""Findings engine: the common currency of both analysis layers.

A :class:`Finding` is one violation — a lint hit at a file:line, an
invariant break inside a traced round entry, or a budget mismatch against a
checked-in baseline.  Findings are *stable*: the fingerprint hashes the
rule, the file and the normalized source context (NOT the line number), so
unrelated edits that shift lines do not churn the baseline file.

The baseline (``analysis/torch/lint_baseline.json``) is the suppression
mechanism for *intentional* findings — e.g. the drivers' whitelisted
stacked-fetch ``.cpu().numpy()`` sites.  Every suppression MUST carry a one-line
``justification``; a suppression without one is itself reported as a
finding, so the "new suppressions need a reason" contributor rule is
machine-enforced rather than review-enforced.

A copy of the reference's ``repro/analysis/findings.py`` (pure Python).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis violation.

    ``path`` is repo-relative with forward slashes; ``context`` is the
    normalized source line (lints) or a program/cell identifier (audits);
    ``fingerprint`` identifies the finding across line shifts."""
    rule: str
    severity: str
    path: str
    line: int
    message: str
    context: str = ""
    fingerprint: str = ""

    def located(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def fingerprint(rule: str, path: str, context: str, index: int = 0) -> str:
    """Stable identity of a finding: rule + file + normalized context +
    occurrence index (disambiguates identical lines in one file)."""
    norm = " ".join(context.split())
    h = hashlib.sha1(f"{rule}|{path}|{norm}|{index}".encode()).hexdigest()
    return h[:16]


def make_finding(rule: str, severity: str, path: str, line: int, message: str,
                 context: str = "", index: int = 0) -> Finding:
    return Finding(rule=rule, severity=severity, path=path, line=line,
                   message=message, context=context,
                   fingerprint=fingerprint(rule, path, context, index))


def assign_fingerprints(findings: Iterable[Finding]) -> List[Finding]:
    """Re-derive fingerprints with per-(rule, path, context) occurrence
    indices, in input order — call once after collecting a file's findings
    so duplicate source lines stay distinguishable."""
    seen: Dict[str, int] = {}
    out = []
    for f in findings:
        key = f"{f.rule}|{f.path}|{' '.join(f.context.split())}"
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        out.append(dataclasses.replace(
            f, fingerprint=fingerprint(f.rule, f.path, f.context, idx)))
    return out


# ---------------------------------------------------------------------------
# baseline suppressions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Baseline:
    """The checked-in suppression list.  ``entries`` maps fingerprint ->
    {rule, file, justification, context}."""
    path: str
    entries: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        entries = {e["fingerprint"]: e for e in raw.get("suppressions", [])}
        return cls(path=path, entries=entries)

    def save(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        rows = sorted(self.entries.values(),
                      key=lambda e: (e.get("file", ""), e.get("rule", ""),
                                     e.get("context", "")))
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump({"suppressions": rows}, f, indent=2, sort_keys=True)
            f.write("\n")

    def suppresses(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def unjustified(self) -> List[Dict[str, Any]]:
        """Suppressions missing the mandatory one-line justification."""
        return [e for e in self.entries.values()
                if not str(e.get("justification", "")).strip()]

    def stale(self, findings: Iterable[Finding]) -> List[Dict[str, Any]]:
        """Suppressions whose finding no longer exists (safe to delete)."""
        live = {f.fingerprint for f in findings}
        return [e for fp, e in sorted(self.entries.items()) if fp not in live]

    def add(self, finding: Finding, justification: str) -> None:
        self.entries[finding.fingerprint] = {
            "fingerprint": finding.fingerprint, "rule": finding.rule,
            "file": finding.path, "context": " ".join(finding.context.split()),
            "justification": justification,
        }


@dataclasses.dataclass
class Report:
    """A full analysis run: raw findings + the baseline they were filtered
    against.  ``open_findings`` is what gates CI."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    baseline: Optional[Baseline] = None
    notes: List[str] = dataclasses.field(default_factory=list)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def open_findings(self) -> List[Finding]:
        if self.baseline is None:
            return list(self.findings)
        out = [f for f in self.findings if not self.baseline.suppresses(f)]
        for e in self.baseline.unjustified():
            out.append(make_finding(
                "unjustified-suppression", "error",
                os.path.basename(self.baseline.path), 0,
                f"suppression {e['fingerprint']} ({e.get('rule')}) has no "
                f"justification — add a one-line reason",
                context=e["fingerprint"]))
        return out

    def to_dict(self) -> Dict[str, Any]:
        suppressed = ([] if self.baseline is None else
                      [f.to_dict() for f in self.findings
                       if self.baseline.suppresses(f)])
        return {
            "open": [f.to_dict() for f in self.open_findings],
            "suppressed": suppressed,
            "stale_suppressions": ([] if self.baseline is None
                                   else self.baseline.stale(self.findings)),
            "notes": list(self.notes),
        }


def repo_root(explicit: Optional[str] = None) -> str:
    """The working tree the analyzer audits: ``explicit`` when given, else
    the checkout containing this package (src/repro_torch/analysis ->
    repo)."""
    if explicit:
        return os.path.abspath(explicit)
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))
