"""Clique-expansion representation (``toGraph``), in PyTorch.

Expands every hyperedge into a clique over its members — MESH's
constant-folding optimization, valid only for algorithms that never touch
hyperedge state and send symmetric message types (paper §IV-A1).  Built
on the host with NumPy, as the JAX package's ``repro.core.clique`` (a
one-time preprocessing step whose *cost itself* is one of the paper's
measured quantities: Fig. 7's partitioning time includes ``toGraph``);
the ``Graph``'s tensors go to the hypergraph's device.

The pairs are built per cardinality class, not per hyperedge: for each
distinct member count ``k``, one ``triu_indices(k)`` over the
``[edges of size k, k]`` member matrix.  Sorting the key
``lo * 2**32 + hi`` and keeping each run's first (``np.unique``'s
result, computed by one sort on every NumPy) orders them, so ``src``,
``dst`` and ``e_attr`` are the JAX package's, bit for bit, whatever
order the pairs were made in.

``clique_expansion_size`` computes the edge count without materializing
the graph — and, past ``APPROX_PAIR_BUDGET`` pairs, returns the upper
bound ``sum k (k - 1) / 2`` without building any pair (Table I's
"10.3 billion (approximate)" entries).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.hypergraph import HyperGraph

# Above this many (non-deduplicated) pairs, ``clique_expansion_size``
# reports the upper bound instead of counting unique pairs.
APPROX_PAIR_BUDGET = 200_000_000


@dataclasses.dataclass
class Graph:
    """A plain dyadic graph (the underlying-engine view): int32 ``src`` /
    ``dst`` edge lists and float32 ``e_attr`` on one device."""

    src: torch.Tensor
    dst: torch.Tensor
    n_vertices: int
    e_attr: torch.Tensor | None = None
    v_attr: object = None


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _pair_keys(hg: HyperGraph) -> np.ndarray:
    """``lo * 2**32 + hi`` (int64) of every member pair of every
    hyperedge, duplicates included, one cardinality class at a time."""
    src = _host(hg.src).astype(np.int64)
    dst = _host(hg.dst).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    src = src[order]
    counts = np.bincount(dst, minlength=hg.n_hyperedges)
    starts = np.zeros(counts.size, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    keys = []
    for k in np.unique(counts):
        if k < 2:
            continue
        k = int(k)
        edges = np.flatnonzero(counts == k)
        members = src[starts[edges][:, None] + np.arange(k)]
        iu, ju = np.triu_indices(k, k=1)
        a, b = members[:, iu], members[:, ju]
        keys.append((np.minimum(a, b) * 2**32 + np.maximum(a, b)).ravel())
        del members, a, b
    if not keys:
        return np.zeros(0, np.int64)
    return np.concatenate(keys)


def _unique_counts(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(keys, return_counts=True)`` by one in-place sort, on
    every NumPy version: with NumPy 2.3.5, ``np.unique(keys)`` alone took
    30.8 s on DBLP's pair keys where the counting form took 0.45 s."""
    keys.sort()
    first = np.empty(keys.size, bool)
    first[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    return keys[starts], np.diff(np.append(starts, keys.size))


def clique_expansion_size(hg: HyperGraph) -> int:
    """Number of (undirected, pair-deduplicated) clique edges =
    |{(u,v): u<v, exists e with u,v in e}| — without materializing cliques
    beyond the dedup of pairs; the upper bound ``sum k (k - 1) / 2``
    past ``APPROX_PAIR_BUDGET`` pairs."""
    card = _host(hg.cardinalities()).astype(np.int64)
    pair_budget = int((card * (card - 1) // 2).sum())
    if pair_budget > APPROX_PAIR_BUDGET:
        return pair_budget  # approximate (upper bound), like Table I.
    return len(_unique_pairs(hg))


def _unique_pairs(hg: HyperGraph) -> np.ndarray:
    """The sorted unique ``(lo, hi)`` member pairs, ``[P, 2]`` int64."""
    uniq, _ = _unique_counts(_pair_keys(hg))
    return np.stack([uniq // 2**32, uniq % 2**32], axis=1)


def to_graph(
    hg: HyperGraph,
    edge_attr_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> Graph:
    """Materialize the clique expansion, symmetrized (message flow in
    both directions): ``src = [u, v]``, ``dst = [v, u]`` over the sorted
    unique pairs ``u < v``.

    ``edge_attr_fn`` maps the array of shared-hyperedge *counts* per pair to
    the edge attribute (the paper's "user-defined functions applied to the
    set of all hyperedges common to v1 and v2" — we expose the count, the
    common case); by default the count as float32.
    """
    uniq_keys, counts = _unique_counts(_pair_keys(hg))
    u = (uniq_keys // 2**32).astype(np.int32)
    v = (uniq_keys % 2**32).astype(np.int32)
    del uniq_keys
    attr = (edge_attr_fn(counts) if edge_attr_fn is not None
            else counts.astype(np.float32))
    dev = hg.device
    e_attr = torch.as_tensor(np.asarray(attr), device=dev)
    return Graph(
        src=torch.as_tensor(np.concatenate([u, v]), device=dev),
        dst=torch.as_tensor(np.concatenate([v, u]), device=dev),
        n_vertices=hg.n_vertices,
        e_attr=torch.cat([e_attr, e_attr]),
        v_attr=hg.v_attr,
    )
