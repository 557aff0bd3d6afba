"""EvaluationOutcome: pass/fail with an explanation tree.

Reference: offer/evaluate/EvaluationOutcome.java — every stage returns
one of these, and the "why did placement fail" record they form is the
operator-facing feature SURVEY.md section 5.1 flags as the single most
loved: keep it.

Port of ``dcos_commons_tpu/offer/outcome.py``,
line for line but the imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class EvaluationOutcome:
    passed: bool
    source: str                     # stage / rule name
    reason: str
    children: List["EvaluationOutcome"] = field(default_factory=list)

    @staticmethod
    def ok(source: str, reason: str = "") -> "EvaluationOutcome":
        return EvaluationOutcome(True, source, reason or "passed")

    @staticmethod
    def fail(source: str, reason: str) -> "EvaluationOutcome":
        return EvaluationOutcome(False, source, reason)

    def to_dict(self) -> dict:
        return {
            "passed": self.passed,
            "source": self.source,
            "reason": self.reason,
            "children": [c.to_dict() for c in self.children],
        }

    def flatten(self, indent: int = 0) -> List[str]:
        mark = "PASS" if self.passed else "FAIL"
        lines = [f"{'  ' * indent}{mark} {self.source}: {self.reason}"]
        for child in self.children:
            lines.extend(child.flatten(indent + 1))
        return lines
