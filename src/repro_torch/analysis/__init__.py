"""Static analysis for the port: ``python -m repro_torch.analysis`` (the
counterpart of the JAX package's ``repro.analysis``).

Four passes over the invariants the port's flexibility bargain rests on:

* ``lint`` — AST rules (host-sync vs the hot-path inventory,
  capture-sync inside CUDA-graph captures, tracer-gate, swallowed-error)
  over ``src/repro_torch``;
* ``retrace`` — the compile-once contract, checked live on the warm
  paths (also exported as the ``assert_no_retrace`` guard that
  ``serve.warm(require_no_retrace=True)`` boots under);
* ``digest`` — ``stable_digest`` identity / collision / cross-process
  determinism over a spec x config x bucket grid;
* ``shapes`` — output shape/dtype agreement between the two delivery
  lowerings, plus every kernel's shared memory at its worst admitted
  geometry against the card's limits.

Findings diff against ``tools/torch_analysis_baseline.json`` so accepted
findings never block CI; new ones do.
"""
from repro_torch.analysis.findings import (
    RULES,
    Finding,
    baseline_counts,
    diff_baseline,
    load_baseline,
    save_baseline,
    summarize,
)
from repro_torch.analysis.lint import HOT_PATHS, lint_file, lint_tree
from repro_torch.analysis.retrace import (
    RetraceError,
    assert_no_retrace,
    retrace_smoke,
)

__all__ = [
    "RULES", "Finding", "baseline_counts", "diff_baseline",
    "load_baseline", "save_baseline", "summarize",
    "HOT_PATHS", "lint_file", "lint_tree",
    "RetraceError", "assert_no_retrace", "retrace_smoke",
]
