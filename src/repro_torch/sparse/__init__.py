"""Sparse/ragged primitives: the segment ops under the MESH engine
(index gathers + ``scatter_reduce`` folds) and the GNN side's
message-passing reductions (K2a for float sums), in PyTorch.
``embedding_bag`` and the neighbour sampler join with ROADMAP item
12d."""
from repro_torch.sparse.segment import (
    MONOIDS,
    Monoid,
    derive_monoid_for,
    edge_sharded,
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

__all__ = [
    "MONOIDS",
    "Monoid",
    "derive_monoid_for",
    "edge_sharded",
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
]
