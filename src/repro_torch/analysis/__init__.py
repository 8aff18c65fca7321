"""Analysis for the compile-once seam (the port's counterpart of the JAX
package's ``repro.analysis``, its capture sentinel).

* ``retrace`` — the compile-once contract, checked live on the warm
  paths (``retrace_smoke``) and exported as the ``assert_no_retrace``
  guard that ``serve.warm(require_no_retrace=True)`` boots under;
* ``findings`` — the ``Finding`` record the passes report.

The AST lints, the shape/budget check and the digest audit are
ROADMAP.md queue 1, item 11.
"""
from repro_torch.analysis.findings import RULES, Finding
from repro_torch.analysis.retrace import (
    RetraceError,
    assert_no_retrace,
    retrace_smoke,
)

__all__ = [
    "RULES", "Finding",
    "RetraceError", "assert_no_retrace", "retrace_smoke",
]
