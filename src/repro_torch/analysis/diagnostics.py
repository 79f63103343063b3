# The port's copy of repro/analysis/diagnostics.py: the same names and arithmetic.
"""Structured diagnostics shared by every static-analysis pass.

A :class:`Diagnostic` is one finding: a stable rule id (``SCH001`` /
``PLN004`` / ``JAX002`` — catalogued in ``docs/analysis.md``), a severity,
a human-locatable position, a one-line message and an optional fix hint.
Passes return plain lists of diagnostics; :class:`DiagnosticReport`
aggregates them for the CLI (``launch/lint.py``) and for callers that want
to *raise* on errors (:class:`DiagnosticError`), e.g.
``compile_schedule(..., validate=True)``.

Severities:

  * ``error``   — the artifact is wrong: the schedule would deadlock /
    read stale buffers, the plan cannot execute, or the cost model and
    the compiled program disagree (drift).  Non-zero CLI exit.
  * ``warning`` — suspicious but executable (deprecated plan version,
    probable jax pitfall).  ``--strict`` escalates selected warnings.
  * ``info``    — certification telemetry (what was proven, with numbers).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding."""

    rule: str          # stable rule id, e.g. "SCH001"
    severity: str      # "error" | "warning" | "info"
    location: str      # where: "zb-h1[P=4,m=8] stage 2", "plan.schedule",
                       # or "src/repro/foo.py:42"
    message: str       # what is wrong (one line)
    hint: str = ""     # how to fix it (optional, one line)

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def format(self) -> str:
        s = f"{self.severity}[{self.rule}] {self.location}: {self.message}"
        if self.hint:
            s += f"  (hint: {self.hint})"
        return s

    def to_json(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, str]) -> "Diagnostic":
        return Diagnostic(rule=d["rule"], severity=d["severity"],
                          location=d["location"], message=d["message"],
                          hint=d.get("hint", ""))


@dataclasses.dataclass
class DiagnosticReport:
    """An ordered collection of diagnostics with summary helpers."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)

    def extend(self, diags: Iterable[Diagnostic]) -> "DiagnosticReport":
        self.diagnostics.extend(diags)
        return self

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def rules(self) -> List[str]:
        """Distinct rule ids present, sorted (mutation tests key on this)."""
        return sorted({d.rule for d in self.diagnostics})

    @property
    def ok(self) -> bool:
        return not self.errors()

    def format(self, *, min_severity: str = INFO) -> str:
        keep = _SEVERITIES[: _SEVERITIES.index(min_severity) + 1]
        lines = [d.format() for d in self.diagnostics if d.severity in keep]
        lines.append(f"{len(self.errors())} error(s), "
                     f"{len(self.warnings())} warning(s), "
                     f"{len(self.diagnostics)} diagnostic(s) total")
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            "diagnostics": [d.to_json() for d in self.diagnostics],
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    def raise_if_errors(self, context: str = "") -> None:
        if not self.ok:
            raise DiagnosticError(self.errors(), context=context)


class DiagnosticError(ValueError):
    """Raised by validate/strict paths when error-severity findings exist.

    Carries the structured diagnostics so callers (and tests) can inspect
    rule ids instead of parsing the message.
    """

    def __init__(self, diagnostics: List[Diagnostic], context: str = ""):
        self.diagnostics = list(diagnostics)
        head = f"{context}: " if context else ""
        lines = "\n".join(d.format() for d in self.diagnostics)
        super().__init__(f"{head}{len(self.diagnostics)} error "
                         f"diagnostic(s)\n{lines}")

    def rules(self) -> List[str]:
        return sorted({d.rule for d in self.diagnostics})


def error(rule: str, location: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule, ERROR, location, message, hint)


def warning(rule: str, location: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule, WARNING, location, message, hint)


def info(rule: str, location: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule, INFO, location, message, hint)
