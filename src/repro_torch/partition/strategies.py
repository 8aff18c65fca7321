"""The seven MESH partitioning strategies (paper §IV-B); the port's copy
of the JAX package's ``repro.partition.strategies``.

All operate host-side on the incidence COO (NumPy), exactly as GraphX
partitioning runs before the iterative phase; partition *time* is part of
the paper's reported results so each returns it.

Naming follows the paper: "X-cut" means entity set X gets *cut*
(replicated) while the other set is partitioned intact.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hypergraph import _host
from repro_torch.partition.base import PartitionPlan, build_plan

# A large prime for multiplicative hashing (the paper's ``mPrime``).
M_PRIME = np.int64(1_000_000_007)


def _hash(x: np.ndarray, n_parts: int) -> np.ndarray:
    return ((np.abs(x.astype(np.int64)) * M_PRIME) % n_parts).astype(np.int32)


def _finish(name, src, dst, nv, ne, edge_part, n_parts, t0):
    return build_plan(
        name, src, dst, nv, ne, edge_part, n_parts,
        partition_time_s=time.perf_counter() - t0,
    )


def random_vertex_cut(src, dst, nv, ne, n_parts) -> PartitionPlan:
    """Hash by hyperedge: hyperedges partitioned intact, vertices cut."""
    t0 = time.perf_counter()
    part = _hash(dst, n_parts)
    return _finish("random_vertex_cut", src, dst, nv, ne, part, n_parts, t0)


def random_hyperedge_cut(src, dst, nv, ne, n_parts) -> PartitionPlan:
    """Hash by vertex: vertices partitioned intact, hyperedges cut."""
    t0 = time.perf_counter()
    part = _hash(src, n_parts)
    return _finish("random_hyperedge_cut", src, dst, nv, ne, part, n_parts, t0)


def random_both_cut(src, dst, nv, ne, n_parts) -> PartitionPlan:
    """Hash by (src, dst): both sets cut (GraphX EdgePartition2D spirit)."""
    t0 = time.perf_counter()
    key = src.astype(np.int64) * np.int64(1_000_003) + dst.astype(np.int64)
    part = _hash(key, n_parts)
    return _finish("random_both_cut", src, dst, nv, ne, part, n_parts, t0)


def hybrid_vertex_cut(
    src, dst, nv, ne, n_parts, cutoff: int = 100
) -> PartitionPlan:
    """PowerLyra-style: partition hyperedges by dst-hash, except
    high-cardinality hyperedges (> cutoff) get scattered by src-hash
    (Listing 8)."""
    t0 = time.perf_counter()
    card = np.bincount(dst, minlength=ne)
    high = card[dst] > cutoff
    part = np.where(high, _hash(src, n_parts), _hash(dst, n_parts))
    return _finish("hybrid_vertex_cut", src, dst, nv, ne, part, n_parts, t0)


def hybrid_hyperedge_cut(
    src, dst, nv, ne, n_parts, cutoff: int = 100
) -> PartitionPlan:
    """Dual: partition vertices by src-hash, except high-degree vertices
    scattered by dst-hash."""
    t0 = time.perf_counter()
    deg = np.bincount(src, minlength=nv)
    high = deg[src] > cutoff
    part = np.where(high, _hash(dst, n_parts), _hash(src, n_parts))
    return _finish("hybrid_hyperedge_cut", src, dst, nv, ne, part, n_parts, t0)


def _greedy(
    group_ids: np.ndarray,      # entity grouping the loop walks (dst or src)
    member_ids: np.ndarray,     # the other endpoint (src or dst)
    n_groups: int,
    n_members: int,
    n_parts: int,
    chunk: int,
) -> np.ndarray:
    """Aweto-style greedy: assign one group (hyperedge or vertex) at a time
    to the partition with max ``overlap - sqrt(load)`` (Listing 9).

    Overlap = members of this group already replicated on that partition.
    ``chunk > 1`` scores that many groups against a frozen replica state
    before committing — the scalable approximation used for large inputs
    (Aweto itself partitions greedily over independent subsets).
    """
    if n_parts > 64:
        raise ValueError(
            "greedy partitioner tracks replicas in a uint64 bitmask; "
            f"n_parts={n_parts} > 64. Use hybrid/random for wider meshes "
            "or raise the mask width."
        )
    order = np.argsort(group_ids, kind="stable")
    g_sorted = group_ids[order]
    m_sorted = member_ids[order]
    bounds = np.searchsorted(g_sorted, np.arange(n_groups + 1))

    replica_mask = np.zeros(n_members, np.uint64)  # bit p => replica on p
    load = np.zeros(n_parts, np.float64)
    group_part = np.zeros(n_groups, np.int32)
    bits = (np.uint64(1) << np.arange(n_parts, dtype=np.uint64))

    # Iterate groups in descending size (large groups placed first — they
    # constrain the solution most; same heuristic family as Aweto).
    sizes = bounds[1:] - bounds[:-1]
    visit = np.argsort(-sizes, kind="stable")

    for start in range(0, n_groups, chunk):
        batch = visit[start:start + chunk]
        # Score all groups in the batch against the frozen state.
        for g in batch:
            lo, hi = bounds[g], bounds[g + 1]
            if hi == lo:
                group_part[g] = int(np.argmin(load))
                continue
            members = m_sorted[lo:hi]
            masks = replica_mask[members]
            # popcount per partition: overlap[p] = #members with bit p set
            overlap = (
                (masks[:, None] & bits[None, :]) != 0
            ).sum(axis=0).astype(np.float64)
            score = overlap - np.sqrt(load)
            p = int(np.argmax(score))
            group_part[g] = p
            replica_mask[members] |= bits[p]
            load[p] += hi - lo
    return group_part


def greedy_vertex_cut(
    src, dst, nv, ne, n_parts, chunk: int = 1
) -> PartitionPlan:
    """Assign hyperedges greedily; vertices get cut (Listing 9)."""
    t0 = time.perf_counter()
    he_part = _greedy(dst, src, ne, nv, n_parts, chunk)
    part = he_part[dst]
    return _finish("greedy_vertex_cut", src, dst, nv, ne, part, n_parts, t0)


def greedy_hyperedge_cut(
    src, dst, nv, ne, n_parts, chunk: int = 1
) -> PartitionPlan:
    """Assign vertices greedily; hyperedges get cut."""
    t0 = time.perf_counter()
    v_part = _greedy(src, dst, nv, ne, n_parts, chunk)
    part = v_part[src]
    return _finish("greedy_hyperedge_cut", src, dst, nv, ne, part, n_parts, t0)


STRATEGIES = {
    "random_vertex_cut": random_vertex_cut,
    "random_hyperedge_cut": random_hyperedge_cut,
    "random_both_cut": random_both_cut,
    "hybrid_vertex_cut": hybrid_vertex_cut,
    "hybrid_hyperedge_cut": hybrid_hyperedge_cut,
    "greedy_vertex_cut": greedy_vertex_cut,
    "greedy_hyperedge_cut": greedy_hyperedge_cut,
}


def partition(
    name: str, hg, n_parts: int, **kw
) -> PartitionPlan:
    """Partition a HyperGraph with the named strategy (its incidence is
    read on the host, from any device)."""
    src = _host(hg.src)
    dst = _host(hg.dst)
    return STRATEGIES[name](
        src, dst, hg.n_vertices, hg.n_hyperedges, n_parts, **kw
    )
