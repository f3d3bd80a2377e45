"""Structured diagnostics for the static plan and launch verifier.

A copy of ``repro/analysis/diagnostics.py``: every analysis pass
(``planlint``, ``launch_check``, ``trace_audit``) answers with a list of
:class:`Diagnostic`s — rule id, severity, the segment and geometry it
fired on, and a fix hint — collected into a :class:`Report` that the CLI
serializes as JSON and ``verify_or_raise`` turns into a hard error.  The
formatting is the reference's, character for character.

Severities:

* ``error``   — the plan is infeasible or provably wrong (shared memory
  over what a CTA may hold, an out-of-bounds input window, overlapping
  output tiles, a grid beyond the card's limits, a cast the dtype policy
  does not own).  The CLI exits 1; ``verify_or_raise`` raises.
* ``warning`` — legal but suspicious (over the policy's budget, but
  within what a CTA may hold).
* ``info``    — facts worth surfacing (a grid too large to enumerate in
  full, a 16-byte vector path the channel count denies).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List

ERROR = "error"
WARNING = "warning"
INFO = "info"

SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: which rule, how bad, where, and how to fix it."""
    rule: str           # e.g. "PL101"
    severity: str       # one of SEVERITIES
    message: str        # what is wrong, with the numbers
    segment: str = ""   # which chain/network segment (e.g. "block3/fused3")
    geometry: str = ""  # the shapes the rule evaluated
    hint: str = ""      # how to fix it

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def format(self) -> str:
        loc = f" [{self.segment}]" if self.segment else ""
        geo = f" ({self.geometry})" if self.geometry else ""
        hint = f"  hint: {self.hint}" if self.hint else ""
        return (f"{self.severity.upper():7s} {self.rule}{loc}: "
                f"{self.message}{geo}{hint}")


@dataclasses.dataclass
class Report:
    """All diagnostics of one analysis run, CI-serializable."""
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)

    def extend(self, diags: Iterable[Diagnostic]) -> "Report":
        self.diagnostics.extend(diags)
        return self

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No error-severity diagnostics (warnings/info do not fail)."""
        return not self.errors

    def rules(self, severity: str | None = None) -> List[str]:
        return sorted({d.rule for d in self.diagnostics
                       if severity is None or d.severity == severity})

    def summary(self) -> str:
        n = {s: sum(1 for d in self.diagnostics if d.severity == s)
             for s in SEVERITIES}
        return (f"{n[ERROR]} error(s), {n[WARNING]} warning(s), "
                f"{n[INFO]} info")

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "summary": self.summary(),
            "diagnostics": [dataclasses.asdict(d) for d in self.diagnostics],
        }

    def format(self, *, max_lines: int | None = None) -> str:
        order = {ERROR: 0, WARNING: 1, INFO: 2}
        diags = sorted(self.diagnostics, key=lambda d: order[d.severity])
        lines = [d.format() for d in diags]
        if max_lines is not None and len(lines) > max_lines:
            lines = lines[:max_lines] + [
                f"... {len(lines) - max_lines} more"]
        return "\n".join(lines + [self.summary()])
