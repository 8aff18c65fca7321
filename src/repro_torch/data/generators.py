"""Synthetic hypergraph generators matching the paper's dataset regimes.

Table I of the paper spans four qualitatively different shapes:

  apache      V << E        (3.3k vertices, 78k hyperedges), mild skew
  dblp        V ~= E        (899k vs 783k), low skew, small cardinalities
  friendster  V >> E        (7.9M vs 1.6M), heavy-tailed
  orkut       E >> V        (2.3M vs 15.3M), heavy-tailed

Each regime scales down with ``scale`` while preserving ratio and tail
exponents.  Sampling is host numpy (``default_rng(seed)``), draw for draw
the JAX package's generator, so the same seed gives the same ``src`` /
``dst``; the result lands on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hypergraph import HyperGraph


@dataclasses.dataclass(frozen=True)
class Regime:
    name: str
    n_vertices: int
    n_hyperedges: int
    mean_cardinality: float
    cardinality_alpha: float  # power-law tail exponent for |e|
    popularity_alpha: float   # vertex popularity tail exponent


DATASET_REGIMES: dict[str, Regime] = {
    "apache": Regime("apache", 3_316, 78_080, 5.2, 2.2, 1.6),
    "dblp": Regime("dblp", 899_393, 782_659, 3.4, 2.8, 2.4),
    "friendster": Regime("friendster", 7_944_949, 1_620_991, 14.5, 1.9, 2.0),
    "orkut": Regime("orkut", 2_322_299, 15_301_901, 7.0, 2.0, 1.8),
}


def _powerlaw_ints(
    rng: np.random.Generator, n: int, alpha: float, xmin: int, xmax: int
) -> np.ndarray:
    """Discrete power-law sample via inverse transform on the continuous
    Pareto, clipped to [xmin, xmax]."""
    u = rng.random(n)
    x = xmin * (1.0 - u) ** (-1.0 / (alpha - 1.0))
    return np.clip(x.astype(np.int64), xmin, xmax)


def powerlaw_hypergraph(
    n_vertices: int,
    n_hyperedges: int,
    mean_cardinality: float = 5.0,
    cardinality_alpha: float = 2.2,
    popularity_alpha: float = 2.0,
    max_cardinality: int | None = None,
    seed: int = 0,
    device=None,
) -> HyperGraph:
    """Sample a hypergraph with power-law cardinalities and power-law
    vertex popularity (rich-get-richer membership)."""
    rng = np.random.default_rng(seed)
    max_card = max_cardinality or max(int(mean_cardinality * 40), 16)
    card = _powerlaw_ints(rng, n_hyperedges, cardinality_alpha, 1, max_card)
    # rescale to hit the target mean (power-law means drift with clipping)
    ratio = mean_cardinality / max(card.mean(), 1e-9)
    if ratio > 1.0:
        card = np.minimum(
            (card * ratio).astype(np.int64) + 1, max_card
        )
    card = np.maximum(card, 1)
    nnz = int(card.sum())

    # vertex popularity ~ Zipf over a permuted id space
    pop = 1.0 / np.arange(1, n_vertices + 1) ** (1.0 / popularity_alpha)
    pop /= pop.sum()
    perm = rng.permutation(n_vertices)
    members = rng.choice(n_vertices, size=nnz, p=pop)
    members = perm[members].astype(np.int32)

    dst = np.repeat(np.arange(n_hyperedges, dtype=np.int32), card)
    # dedupe members within a hyperedge (first occurrence kept; residual
    # duplicates are harmless and match multiset membership semantics)
    key = dst.astype(np.int64) * np.int64(n_vertices) + members
    _, first_idx = np.unique(key, return_index=True)
    keep = np.zeros(nnz, bool)
    keep[first_idx] = True
    src, dst = members[keep], dst[keep]

    return HyperGraph.from_coo(src, dst, n_vertices, n_hyperedges,
                               device=device)


def make_dataset(
    name: str, scale: float = 1.0, seed: int = 0, device=None
) -> HyperGraph:
    """Instantiate one of the Table-I regimes, optionally scaled down."""
    r = DATASET_REGIMES[name]
    nv = max(int(r.n_vertices * scale), 8)
    ne = max(int(r.n_hyperedges * scale), 4)
    return powerlaw_hypergraph(
        n_vertices=nv,
        n_hyperedges=ne,
        mean_cardinality=r.mean_cardinality,
        cardinality_alpha=r.cardinality_alpha,
        popularity_alpha=r.popularity_alpha,
        seed=seed,
        device=device,
    )
