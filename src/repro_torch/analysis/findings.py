"""The finding model of the port's analysis passes (the part of the JAX
package's ``repro.analysis.findings`` that the capture sentinel uses).

A **finding** is one violated invariant, anchored to a source location
when the pass is static, or to a synthetic location (``<retrace-smoke>``,
line 0) when it is checked live.  Every finding carries a **rule id**
(one of ``RULES``), a one-line **message** and a **classification**
(``finding`` is actionable).

The lints, the shape/budget check and the digest audit, with their
rules and the baseline, are not ported yet (ROADMAP.md queue 1, item
11); ``RULES`` holds the one rule the sentinel reports.
"""
from __future__ import annotations

import dataclasses

# rule id -> the one-line rationale printed next to every finding.
RULES = {
    "retrace": (
        "a warm-path serve recompiled: the compile-once contract "
        "(same bucket + same design point = one executable) is broken"
    ),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                    # repo-relative, or "<pass>" for semantic
    line: int                    # 1-based; 0 for semantic findings
    scope: str                   # enclosing qualname ("<module>" at top)
    message: str                 # one-line site-specific rationale
    classification: str = "finding"

    def format(self, explain: bool = True) -> str:
        """``file:line: [rule] message`` — clickable in a terminal."""
        loc = f"{self.path}:{self.line}" if self.line else self.path
        head = f"{loc}: [{self.rule}] {self.message}"
        if explain and self.rule in RULES:
            head += f"\n    why: {RULES[self.rule]}"
        return head
