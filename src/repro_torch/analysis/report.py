"""The one report type every static-analysis pass emits into.

A :class:`Violation` is a single finding — which pass produced it, a
stable diagnostic code, the offending location and an exact message.  An
:class:`AnalysisReport` aggregates the findings of one analysis run
together with the machine-checkable certificates the passes emitted
(today: the overflow certificate of ``ranges.py`` and the schedule
certificate of ``schedule_check.py``), and serializes to JSON for the
CI artifact.

Baselines.  ``python -m repro_torch.analysis --baseline FILE`` compares the
run's violation *keys* (pass:code:location — deliberately excluding the
message, which may carry run-dependent numbers) against a committed
snapshot: pre-existing findings are reported but don't fail the run, new
ones do.  ``--write-baseline`` snapshots the current state — the ratchet
only ever shrinks.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Optional

__all__ = [
    "AnalysisError",
    "AnalysisReport",
    "Violation",
    "load_baseline",
    "write_baseline",
]

#: Severity levels, in increasing order of badness.
SEVERITIES = ("warning", "error")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding of one pass.

    ``pass_name``  "overflow" | "schedule" | "concurrency" | "purity".
    ``code``       stable diagnostic code (e.g. ``OVF001``) — the baseline
                   key and the thing tests assert on.
    ``location``   where: ``<network>.L<idx>`` for compiler passes,
                   ``<file>:<line>`` for the AST lints.
    ``message``    the exact human-readable diagnostic.
    ``severity``   "error" (fails strict/CI) or "warning".
    """

    pass_name: str
    code: str
    location: str
    message: str
    severity: str = "error"

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got "
                f"{self.severity!r}")

    @property
    def key(self) -> str:
        """Stable baseline identity (message excluded — it may carry
        run-dependent numbers)."""
        return f"{self.pass_name}:{self.code}:{self.location}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Violation":
        return cls(**d)

    def __str__(self) -> str:
        return (f"[{self.pass_name}:{self.code}] {self.severity} at "
                f"{self.location}: {self.message}")


@dataclasses.dataclass
class AnalysisReport:
    """Aggregated result of one static-analysis run.

    ``subject``      what was analyzed (e.g. ``"gesture@4/7b x4cores"``).
    ``passes``       names of the passes that ran.
    ``violations``   every finding, in pass order.
    ``certificates`` machine-checkable pass artifacts by pass name — each
                     is plain JSON whose inequalities an independent
                     checker re-verifies (``ranges.check_certificate``).
    """

    subject: str
    passes: tuple = ()
    violations: tuple = ()
    certificates: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings don't fail a run)."""
        return not self.errors

    @property
    def errors(self) -> tuple:
        return tuple(v for v in self.violations if v.severity == "error")

    @property
    def warnings(self) -> tuple:
        return tuple(v for v in self.violations if v.severity == "warning")

    def merge(self, other: "AnalysisReport") -> "AnalysisReport":
        """Fold another report in (CLI aggregates per-config reports)."""
        certs = dict(self.certificates)
        for k, v in other.certificates.items():
            certs[f"{other.subject}:{k}" if k in certs else k] = v
        return AnalysisReport(
            subject=self.subject,
            passes=tuple(dict.fromkeys(self.passes + other.passes)),
            violations=self.violations + other.violations,
            certificates=certs,
        )

    def summary(self) -> str:
        head = (f"{self.subject}: "
                f"{len(self.passes)} pass(es), "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")
        lines = [head]
        lines += [f"  {v}" for v in self.violations]
        if not self.violations:
            lines.append("  certified: no violations")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "subject": self.subject,
            "passes": list(self.passes),
            "violations": [v.to_dict() for v in self.violations],
            "certificates": self.certificates,
            "ok": self.ok,
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "AnalysisReport":
        return cls(
            subject=d["subject"],
            passes=tuple(d.get("passes", ())),
            violations=tuple(
                Violation.from_dict(v) for v in d.get("violations", ())),
            certificates=dict(d.get("certificates", {})),
        )


class AnalysisError(RuntimeError):
    """Raised by ``spidr.compile(..., check="strict")`` on any error-level
    finding.  Carries the full :class:`AnalysisReport` as ``.report``."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        super().__init__(
            "static analysis found "
            f"{len(report.errors)} violation(s) in {report.subject}:\n"
            + "\n".join(f"  {v}" for v in report.errors)
            + "\n(compile with check='warn' to proceed anyway, or fix the "
            "deployment)")


# ---------------------------------------------------------------------------
# Baseline ratchet.
# ---------------------------------------------------------------------------
def load_baseline(path: str) -> set:
    """Read a committed baseline: the set of waived violation keys."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return set(data.get("waived", ()))


def write_baseline(path: str, violations: Iterable[Violation]) -> dict:
    """Snapshot the current findings as the new baseline file."""
    data: dict[str, Any] = {
        "waived": sorted({v.key for v in violations}),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return data


def new_violations(violations: Iterable[Violation],
                   baseline: set) -> tuple:
    """Findings not waived by the baseline — the ones that fail CI."""
    return tuple(v for v in violations if v.key not in baseline)
