"""MESH core in PyTorch: the port's counterpart of ``repro.core``.

* ``hypergraph`` — the ``HyperGraph`` structure (bipartite incidence COO,
  int32 id tensors on one device).
* ``api``        — the programming model: ``Program`` / ``ProcedureOut``,
  message combiners, ``tree_map`` over attribute and message trees.
* ``engine``     — the single-device superstep executor (``compute``,
  and the in-place pair and halting loop every path runs).
* ``executor``   — the ``Engine`` facade, local backend: ``run`` for
  iterative specs, ``analyze`` for batch analytics (``AnalyticsSpec``),
  ``compile`` for compile-once serving.
* ``serving``    — ``CompiledAlgorithm`` (``run`` / ``run_batch`` /
  ``warmup``), shape buckets (``bucket_dim``) and cache signatures.
* ``device``     — where entry points run (the card unless asked).
"""
from repro_torch.core.api import (
    Program,
    ProcedureOut,
    constant_initial_msg,
    tree_leaves,
    tree_map,
)
from repro_torch.core.engine import compute, deliver
from repro_torch.core.executor import (
    AnalyticsResult,
    AnalyticsSpec,
    Engine,
    ExecutionConfig,
    Result,
)
from repro_torch.core.hypergraph import HyperGraph
from repro_torch.core.serving import CompiledAlgorithm, bucket_dim

__all__ = [
    "AnalyticsResult",
    "AnalyticsSpec",
    "CompiledAlgorithm",
    "Engine",
    "ExecutionConfig",
    "HyperGraph",
    "ProcedureOut",
    "Program",
    "Result",
    "bucket_dim",
    "compute",
    "constant_initial_msg",
    "deliver",
    "tree_leaves",
    "tree_map",
]
