"""Batch hypergraph analytics: hyperedge intersections and h-motifs, in
PyTorch — the port of ``repro.motifs``.

* ``intersect`` — hyperedge-pair intersection sizes: a dense-bitset path
  (the hand-written CUDA kernel on the card, its plain version on the
  CPU) and a sorted-merge path (``torch.searchsorted`` over padded
  member lists), selected by ``select_intersect_kernel``.
* ``hmotifs`` — the 26 h-motif classes (Lee et al. 2020), connected-
  triple enumeration over the overlap graph, the exact census (host
  numpy, as in the reference).
* ``sampling`` — the uniform linked-pair sampling estimator (MoCHy-A
  style) with normal-approximation confidence intervals.

Callers should route through ``Engine.analyze``
(``repro_torch.core.executor``).
"""
from repro_torch.motifs.hmotifs import (
    CLASS_OF_PATTERN,
    Census,
    N_HMOTIF_CLASSES,
    build_overlap_graph,
    classify_patterns,
    connected_triples,
    exact_census,
    materialize_pair_sizes,
    overlap_pairs,
    overlap_pairs_with_counts,
    pair_sizes_lookup,
)
from repro_torch.motifs.intersect import (
    INTERSECT_KERNELS,
    PairIndex,
    batch_intersections,
    build_index,
    pair_index_from_numpy,
    select_intersect_kernel,
)
from repro_torch.motifs.sampling import (
    CensusEstimate,
    sample_triples,
    sampled_census,
)

__all__ = [
    "CLASS_OF_PATTERN",
    "Census",
    "CensusEstimate",
    "INTERSECT_KERNELS",
    "N_HMOTIF_CLASSES",
    "PairIndex",
    "batch_intersections",
    "build_index",
    "build_overlap_graph",
    "classify_patterns",
    "connected_triples",
    "exact_census",
    "materialize_pair_sizes",
    "overlap_pairs",
    "overlap_pairs_with_counts",
    "pair_index_from_numpy",
    "pair_sizes_lookup",
    "sample_triples",
    "sampled_census",
    "select_intersect_kernel",
]
