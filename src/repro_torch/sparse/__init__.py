"""Sparse/ragged primitives: the segment ops under the MESH engine
(index gathers + ``scatter_reduce`` folds), the GNN side's
message-passing reductions (K2a for float sums), node gathers and
per-graph readouts (on DTensors too: each rank's own edges and nodes),
``embedding_bag`` (a gather + a per-bag reduce: its sum on K2a) and the
host-side neighbour sampler, in PyTorch."""
from repro_torch.sparse.segment import (
    MONOIDS,
    Monoid,
    derive_monoid_for,
    edge_sharded,
    graph_segment,
    mp_segment_max,
    mp_segment_min,
    mp_segment_sum,
    resolve_monoid,
    segment_count,
    segment_logsumexp,
    segment_mean,
    segment_normalize,
    segment_reduce,
    segment_softmax,
    segment_std,
)
from repro_torch.sparse.embedding_bag import EmbeddingBagSpec, embedding_bag
from repro_torch.sparse.gather import gather_nodes, take_local
from repro_torch.sparse.sampler import NeighborSampler, SampledBlock, build_csr

__all__ = [
    "MONOIDS",
    "Monoid",
    "derive_monoid_for",
    "edge_sharded",
    "gather_nodes",
    "graph_segment",
    "mp_segment_max",
    "mp_segment_min",
    "mp_segment_sum",
    "resolve_monoid",
    "segment_count",
    "segment_logsumexp",
    "segment_mean",
    "segment_normalize",
    "segment_reduce",
    "segment_softmax",
    "segment_std",
    "take_local",
    "embedding_bag",
    "EmbeddingBagSpec",
    "NeighborSampler",
    "SampledBlock",
    "build_csr",
]
