"""MESH core in PyTorch: the port's counterpart of ``repro.core``.

* ``hypergraph`` — the ``HyperGraph`` structure (bipartite incidence COO,
  int32 id tensors on one device).
* ``clique``     — the clique-expansion representation (``to_graph``,
  built on the host) and its size estimator ``clique_expansion_size``.
* ``api``        — the programming model: ``Program`` / ``ProcedureOut``,
  message combiners, ``tree_map`` over attribute and message trees.
* ``engine``     — the single-device superstep executor (``compute``,
  and the in-place pair and halting loop every path runs).
* ``distributed`` — the same pairs over ``torch.distributed``, one
  process per rank (the ``replicated`` and ``sharded`` backends).
* ``executor``   — the ``Engine`` facade: ``run`` for iterative specs
  (bipartite or clique; local, or over a mesh and a partition plan:
  ``select_backend``, ``select_partition``), ``analyze`` for batch
  analytics (``AnalyticsSpec``), ``compile`` for compile-once serving,
  ``explain`` for every axis's candidates and predicted costs.
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
from repro_torch.core.clique import Graph, clique_expansion_size, to_graph
from repro_torch.core.engine import compute, deliver
from repro_torch.core.executor import (
    AnalyticsResult,
    AnalyticsSpec,
    Engine,
    ExecutionConfig,
    Result,
    select_backend,
    select_delivery,
    select_partition,
    select_representation,
)
from repro_torch.core.hypergraph import HyperGraph
from repro_torch.core.serving import CompiledAlgorithm, bucket_dim

__all__ = [
    "AnalyticsResult",
    "AnalyticsSpec",
    "CompiledAlgorithm",
    "Engine",
    "ExecutionConfig",
    "Graph",
    "HyperGraph",
    "ProcedureOut",
    "Program",
    "Result",
    "bucket_dim",
    "clique_expansion_size",
    "compute",
    "constant_initial_msg",
    "deliver",
    "select_backend",
    "select_delivery",
    "select_partition",
    "select_representation",
    "tree_leaves",
    "to_graph",
    "tree_map",
]
