"""Sparse/ragged primitives: the segment ops under the MESH engine
(index gathers + ``scatter_reduce`` folds), in PyTorch."""
from repro_torch.sparse.segment import (
    MONOIDS,
    Monoid,
    derive_monoid_for,
    resolve_monoid,
    segment_reduce,
)

__all__ = [
    "MONOIDS",
    "Monoid",
    "derive_monoid_for",
    "resolve_monoid",
    "segment_reduce",
]
