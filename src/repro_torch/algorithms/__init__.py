"""Hypergraph applications written against the port's MESH API — each
the PyTorch counterpart of a ``repro.algorithms`` module."""
from repro_torch.algorithms.components import (
    connected_components,
    connected_components_spec,
)
from repro_torch.algorithms.graph_pagerank import graph_pagerank
from repro_torch.algorithms.label_propagation import (
    label_propagation,
    label_propagation_spec,
)
from repro_torch.algorithms.pagerank import (
    pagerank,
    pagerank_entropy,
    pagerank_entropy_seq,
    pagerank_entropy_spec,
    pagerank_spec,
    vertex_pagerank_spec,
)
from repro_torch.algorithms.random_walk import random_walk, random_walk_spec
from repro_torch.algorithms.spec import AlgorithmSpec
from repro_torch.algorithms.sssp import shortest_paths, shortest_paths_spec

__all__ = [
    "AlgorithmSpec",
    "connected_components",
    "connected_components_spec",
    "graph_pagerank",
    "label_propagation",
    "label_propagation_spec",
    "pagerank",
    "pagerank_entropy",
    "pagerank_entropy_seq",
    "pagerank_entropy_spec",
    "pagerank_spec",
    "random_walk",
    "random_walk_spec",
    "shortest_paths",
    "shortest_paths_spec",
    "vertex_pagerank_spec",
]
