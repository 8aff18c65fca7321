"""Uniform pair-sampling h-motif estimator (MoCHy-A style).

Exact enumeration touches every connected triple — quadratic-plus in the
overlap degree, infeasible for the paper's heavy regimes.  The estimator
samples **linked hyperedge pairs** uniformly (with replacement) from the
``L`` edges of the overlap graph; for a sampled pair (a, b), every
completion c ∈ N(a) ∪ N(b) yields a connected triple.  A triple with
``k`` linked pairs among its three (k ∈ {2, 3}) is reachable from
exactly ``k`` sampled pairs, so crediting ``1/k`` per discovery and
scaling by ``L / s`` gives an unbiased census estimate:

    E[ L/s · Σ_samples Σ_triples 1/k · [class = m] ] = census[m].

Confidence intervals come from the sample variance of the per-draw
contributions (iid by construction, normal approximation).

The port of ``repro.motifs.sampling``: the same draws from
``default_rng(seed)`` and the same float64 arithmetic, so the estimate
is the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from statistics import NormalDist

import numpy as np

from repro_torch.core.hypergraph import HyperGraph
from repro_torch.motifs.hmotifs import (
    N_HMOTIF_CLASSES,
    OverlapGraph,
    build_overlap_graph,
    classify_patterns,
    triple_profiles,
)
from repro_torch.motifs.intersect import (
    PairIndex,
    add_time,
    build_index,
    select_intersect_kernel,
)


@dataclasses.dataclass(frozen=True)
class CensusEstimate:
    """Sampled census with per-class confidence intervals."""

    counts: np.ndarray     # [N_HMOTIF_CLASSES] float64 point estimates
    ci_low: np.ndarray
    ci_high: np.ndarray
    confidence: float
    n_samples: int
    n_pairs: int           # L: linked pairs in the overlap graph
    n_triples_seen: int    # triples classified across all samples

    @property
    def total(self) -> float:
        return float(self.counts.sum())


def sample_triples(
    og: OverlapGraph, n_samples: int, n_hyperedges: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """The estimator's draws and completions: ``(rows, triples)``, the
    draw index and the ``[T, 3]`` (a, b, c) triple of every distinct
    completion.  Needs ``og.n_pairs > 0``."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, og.n_pairs, size=n_samples)
    a, b = og.pairs[draws, 0], og.pairs[draws, 1]

    # Completions: every neighbor of either endpoint (dedup within one
    # sample — c can neighbor both a and b).
    rows_a, cand_a = og.neighbors_flat(a)
    rows_b, cand_b = og.neighbors_flat(b)
    rows = np.concatenate([rows_a, rows_b])
    cand = np.concatenate([cand_a, cand_b])
    keep = (cand != a[rows]) & (cand != b[rows])
    rows, cand = rows[keep], cand[keep]
    e = np.int64(n_hyperedges)
    _, first = np.unique(rows.astype(np.int64) * e + cand,
                         return_index=True)
    rows, cand = rows[first], cand[first]
    triples = np.stack([a[rows], b[rows], cand], axis=1).astype(np.int64)
    return rows, triples


def sampled_census(
    hg: HyperGraph,
    n_samples: int,
    *,
    seed: int = 0,
    confidence: float = 0.95,
    index: PairIndex | None = None,
    kernel: str = "auto",
    tile: int = 2048,
    mesh=None,
    axis: str = "data",
    og: OverlapGraph | None = None,
    pair_sizes: dict | None = None,
    timings: dict | None = None,
) -> CensusEstimate:
    if index is None:
        if kernel == "auto":
            kernel, _ = select_intersect_kernel(hg)
        index = build_index(hg, kernel)
    t0 = time.perf_counter()
    if og is None:
        og = build_overlap_graph(hg)
    n_classes = N_HMOTIF_CLASSES
    zeros = np.zeros(n_classes)
    if og.n_pairs == 0 or n_samples <= 0:
        return CensusEstimate(
            counts=zeros, ci_low=zeros.copy(), ci_high=zeros.copy(),
            confidence=confidence, n_samples=n_samples,
            n_pairs=og.n_pairs, n_triples_seen=0,
        )

    rows, triples = sample_triples(og, n_samples, hg.n_hyperedges, seed)
    add_time(timings, "preprocess_s", t0)

    if len(rows) == 0:
        return CensusEstimate(
            counts=zeros, ci_low=zeros.copy(), ci_high=zeros.copy(),
            confidence=confidence, n_samples=n_samples,
            n_pairs=og.n_pairs, n_triples_seen=0,
        )

    sa, sb, sc, iab, ibc, ica, iabc = triple_profiles(
        index, triples, tile=tile, mesh=mesh, axis=axis,
        pair_sizes=pair_sizes, timings=timings,
    )
    t0 = time.perf_counter()
    cls = classify_patterns(sa, sb, sc, iab, ibc, ica, iabc)
    k = (iab > 0).astype(np.int64) + (ibc > 0) + (ica > 0)

    valid = cls >= 0
    rows_v, cls_v, w_v = rows[valid], cls[valid], 1.0 / k[valid]

    # Per-draw per-class contributions Y_i[m] = Σ_t 1/k(t); estimator is
    # L · mean_i(Y_i); draws completing no triple contribute Y_i = 0.
    per_draw = np.zeros(n_samples * n_classes)
    np.add.at(per_draw, rows_v * n_classes + cls_v, w_v)
    per_draw = per_draw.reshape(n_samples, n_classes)
    mean = per_draw.mean(axis=0)
    scale = float(og.n_pairs)
    counts = scale * mean
    if n_samples > 1:
        var = per_draw.var(axis=0, ddof=1)
        z = NormalDist().inv_cdf(0.5 + confidence / 2.0)
        half = z * scale * np.sqrt(var / n_samples)
    else:
        half = np.full(n_classes, np.inf)
    add_time(timings, "classify_s", t0)
    return CensusEstimate(
        counts=counts,
        ci_low=np.maximum(counts - half, 0.0),
        ci_high=counts + half,
        confidence=confidence,
        n_samples=n_samples,
        n_pairs=og.n_pairs,
        n_triples_seen=int(valid.sum()),
    )
