"""Findings — the one result type every analysis pass emits; the port of
the JAX package's ``analysis/report.py``.

A ``Finding`` is one detected violation (or warning): which check, which
subject, what happened, and optionally the offending program slice. The
JAX module's ``slice_jaxpr`` prints a jaxpr and has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass(frozen=True)
class Finding:
    check: str           # "commutativity", "traced-branch", "dtype-overflow", ...
    subject: str         # merge kind or entry-point name
    detail: str          # human-readable one-liner
    severity: str = "error"   # "error" fails the gate; "warning" is advisory
    jaxpr_slice: str = ""     # the offending program slice, possibly truncated

    def __str__(self) -> str:
        head = f"[{self.severity.upper()}] {self.subject}: {self.check} — {self.detail}"
        if self.jaxpr_slice:
            body = "\n".join(
                "    | " + line for line in self.jaxpr_slice.splitlines()
            )
            return f"{head}\n{body}"
        return head


def errors(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def format_findings(findings: Sequence[Finding], header: str = "") -> str:
    if not findings:
        return f"{header}: clean" if header else "clean"
    lines = [header] if header else []
    lines += [str(f) for f in findings]
    return "\n".join(lines)


@dataclass
class SectionResult:
    """One runner section of the static checks: named, timed, carrying
    its findings."""

    name: str
    findings: List[Finding] = field(default_factory=list)
    seconds: float = 0.0
    skipped: str = ""  # non-empty = skipped, value says why

    @property
    def ok(self) -> bool:
        return not errors(self.findings)


def summarize(sections: Sequence[SectionResult]) -> dict:
    """The machine-readable runner summary (per-section pass/fail,
    finding counts, wall-clock) to trend instead of parsing text. Stable shape: top-level ``ok`` /
    ``total_seconds`` / ``sections``; per section ``ok`` / ``seconds``
    / ``errors`` / ``warnings`` / ``checks`` (the sorted set of firing
    check names — empty when clean)."""
    return {
        "ok": all(s.ok for s in sections),
        "total_seconds": round(sum(s.seconds for s in sections), 3),
        "sections": {
            s.name: {
                "ok": s.ok,
                "seconds": round(s.seconds, 3),
                "errors": len(errors(s.findings)),
                "warnings": len(s.findings) - len(errors(s.findings)),
                "checks": sorted({f.check for f in s.findings}),
                **({"skipped": s.skipped} if s.skipped else {}),
            }
            for s in sections
        },
    }


def write_summary(sections: Sequence[SectionResult], path: str) -> dict:
    import json

    doc = summarize(sections)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc
