"""The capture sentinel: the compile-once contract as a reusable guard
(the port's counterpart of the JAX package's ``repro.analysis.retrace``).

``Engine.cache_stats()["traces"]`` counts executables made ready: CUDA
graph captures on the card, executable builds on the CPU.  The sentinel
turns that counter into an assertion usable two ways:

* ``with assert_no_retrace(engine):`` around any warm-path block —
  raises ``RetraceError`` with the count if anything was captured;
* ``serve.warm(..., require_no_retrace=True)`` — a boot guard: a
  replica whose store holds no record of a signature it has to make
  fails fast instead of silently paying the capture on its first
  requests (see ``repro_torch.serve.cache.warm``).

``retrace_smoke`` is the live pass: it compiles one small spec and
drives the three warm paths that must not capture again (a same-bucket
second hypergraph, query changes, a batch size within a bucket's pad).
"""
from __future__ import annotations

import contextlib

from repro_torch.analysis.findings import Finding


class RetraceError(AssertionError):
    """A region that promised zero retraces compiled something."""

    def __init__(self, traces: int, allow: int, label: str):
        self.traces = traces
        self.allow = allow
        self.label = label
        super().__init__(
            f"{label}: {traces} retrace(s) inside a no-retrace region "
            f"(allowed {allow}) — the compile-once contract is broken"
        )


@contextlib.contextmanager
def assert_no_retrace(engine, *, allow: int = 0, label: str = "no_retrace"):
    """Assert the engine's trace counter moves by at most ``allow``
    inside the block.  Yields a callable returning the delta so far."""
    before = engine.cache_stats()["traces"]

    def delta() -> int:
        return engine.cache_stats()["traces"] - before

    yield delta
    traces = delta()
    if traces > allow:
        raise RetraceError(traces, allow, label)


def _same_bucket_pair(device):
    from repro_torch.core import bucket_dim
    from repro_torch.data import powerlaw_hypergraph

    hg = powerlaw_hypergraph(47, 33, mean_cardinality=4, seed=0,
                             device=device)
    want = (bucket_dim(47), bucket_dim(33), bucket_dim(hg.nnz))
    for seed in range(1, 60):
        hg2 = powerlaw_hypergraph(52, 36, mean_cardinality=4, seed=seed,
                                  device=device)
        got = (bucket_dim(52), bucket_dim(36), bucket_dim(hg2.nnz))
        if got == want:
            return hg, hg2
    raise AssertionError("no same-bucket draw found")


def retrace_smoke(device=None) -> list[Finding]:
    """Live check of the warm paths that must never capture again: the
    same-bucket second hypergraph, query changes, and batch-size
    changes inside one bucket pad.  ``device``: where the Engine runs
    (default the card)."""
    import numpy as np

    from repro_torch.algorithms import shortest_paths_spec
    from repro_torch.core import Engine

    eng = Engine(device=device)
    findings: list[Finding] = []
    hg, hg2 = _same_bucket_pair(eng.device)
    compiled = eng.compile(shortest_paths_spec(hg, 0, 8))
    compiled.run()                                   # first trace: expected
    compiled.run_batch(np.arange(8, dtype=np.int32))  # batch trace: expected

    def check(label: str, fn) -> None:
        try:
            with assert_no_retrace(eng, label=label):
                fn()
        except RetraceError as err:
            findings.append(Finding(
                rule="retrace", path="<retrace-smoke>", line=0,
                scope=label, message=str(err),
            ))

    check("same-bucket-second-hypergraph", lambda: compiled.run(hg2))
    check("query-change", lambda: [
        compiled.run(query=s) for s in (0, 3, 11, 46)
    ])
    check("batch-size-within-pad", lambda: compiled.run_batch(
        np.arange(5, dtype=np.int32)
    ))
    return findings
