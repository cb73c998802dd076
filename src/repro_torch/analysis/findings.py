"""Shared finding/report structure of the plan analyzer, plus the baseline.

Mirrors ``src/repro/analysis/findings.py`` (framework-free there too); the
port keeps its own copy, so its analyzer imports nothing of the reference.

A ``Finding`` is identified by ``(rule, path, symbol)`` — deliberately NOT
by line number, so a committed baseline survives unrelated edits to the
same file. ``line`` is carried for human navigation only. Baselined
findings may carry a ``justification`` string (the inline "why this is
accepted" record the satellite tasks require); ``Report.new_against``
is the CI gate — it returns only findings whose identity is absent from
the baseline, so the gate fails on NEW findings and never on accepted
ones.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

SEVERITIES = ("error", "warn")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result. ``rule`` is the check's stable name,
    ``path`` a repo-relative file (or ``<plan>`` for plan analysis),
    ``symbol`` the enclosing function/class or plan entity. ``context``
    names the submission a plan finding belongs to (``tenant/plan_id``,
    threaded from the study daemon) — like ``line`` it is carried for
    human navigation only and is NOT part of the identity, so the lint
    baseline stays line-free AND tenant-free."""
    rule: str
    path: str
    symbol: str
    message: str
    severity: str = "error"
    line: int = 0
    context: str = ""

    @property
    def key(self) -> tuple:
        return (self.rule, self.path, self.symbol)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        ctx = f" [{self.context}]" if self.context else ""
        return f"[{self.severity}] {self.rule} {loc} ({self.symbol}){ctx}: " \
               f"{self.message}"


class Report:
    """An ordered collection of findings with JSON/text emission and the
    baseline diff the CI gate runs on."""

    def __init__(self, findings=()):
        self.findings: list[Finding] = list(findings)

    def add(self, rule, path, symbol, message, *, severity="error",
            line=0, context="") -> None:
        assert severity in SEVERITIES, severity
        self.findings.append(Finding(rule, str(path), str(symbol), message,
                                     severity=severity, line=int(line),
                                     context=str(context)))

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def new_against(self, baseline: dict | None) -> list[Finding]:
        """Findings not accepted by ``baseline`` (a dict loaded by
        :func:`load_baseline`; None = empty baseline)."""
        accepted = baseline_keys(baseline)
        return [f for f in self.findings if f.key not in accepted]

    def to_json(self) -> dict:
        return {"schema": 1,
                "findings": [dataclasses.asdict(f) for f in self.findings]}

    def render(self) -> str:
        if not self.findings:
            return "no findings"
        return "\n".join(f.render() for f in self.findings)


def baseline_keys(baseline: dict | None) -> set:
    if not baseline:
        return set()
    return {(f["rule"], f["path"], f["symbol"])
            for f in baseline.get("findings", ())}


def load_baseline(path) -> dict | None:
    """Parse a baseline file; None when absent or unreadable (an empty
    baseline — every finding is then new)."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    return data if isinstance(data.get("findings"), list) else None


def write_baseline(report: Report, path, *,
                   previous: dict | None = None) -> dict:
    """Write ``report``'s findings as the new baseline, carrying forward
    the ``justification`` strings of entries that persist from
    ``previous`` (identity match) — accepting a finding is an explicit
    edit, not something a refresh silently drops."""
    kept = {}
    for f in (previous or {}).get("findings", ()):
        kept[(f["rule"], f["path"], f["symbol"])] = f.get("justification")
    entries = []
    for f in report.findings:
        entry = {"rule": f.rule, "path": f.path, "symbol": f.symbol,
                 "message": f.message, "severity": f.severity,
                 "justification": kept.get(f.key)
                 or "TODO: justify or fix"}
        entries.append(entry)
    data = {"schema": 1, "findings": entries}
    pathlib.Path(path).write_text(json.dumps(data, indent=2) + "\n")
    return data
