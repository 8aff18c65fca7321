r"""H-motif classification and the exact census.

An *h-motif* (Lee et al., "Hypergraph Motifs: Concepts, Algorithms, and
Discoveries", 2020) describes the overlap pattern of a connected triple
of distinct hyperedges {a, b, c} by the emptiness of the seven regions
of their Venn diagram:

    a\(b∪c), b\(a∪c), c\(a∪b), (a∩b)\c, (b∩c)\a, (c∩a)\b, a∩b∩c

Two triples have the same h-motif iff their emptiness patterns match up
to a permutation of the three hyperedges.  After dropping patterns that
cannot occur (an empty hyperedge, duplicate hyperedges, a disconnected
triple) exactly **26** equivalence classes remain — ``N_HMOTIF_CLASSES``
is derived programmatically below and asserted in the tests.

Every region size follows from seven intersection numbers
(|a|, |b|, |c|, |a∩b|, |b∩c|, |c∩a|, |a∩b∩c|) by inclusion–exclusion,
so the census is: enumerate connected triples (host-side, over the
hyperedge-overlap graph — the clique expansion of the *dual*
hypergraph), batch the intersection numbers through the tiled kernel
(``repro_torch.motifs.intersect``), classify, histogram.

The port of ``repro.motifs.hmotifs``: host numpy as in the reference,
with the intersection batches on the index's device.  ``timings``, where
a function takes it, accumulates the wall time of its phases:
``preprocess_s`` (triple enumeration or sampling), ``intersect_s`` and
``intersect_calls`` (``batch_intersections``), ``classify_s``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from repro_torch.core.hypergraph import HyperGraph
from repro_torch.motifs.intersect import (
    PairIndex,
    _clean_incidence,
    add_time,
    batch_intersections,
    build_index,
    select_intersect_kernel,
)

# Region r in 1..7 is the Venn cell whose members belong exactly to the
# hyperedges named by the bits of r (bit 0 = a, bit 1 = b, bit 2 = c);
# an emptiness pattern packs "region r is non-empty" into bit r-1.
_N_PATTERNS = 128


def _permute_pattern(p: int, perm: tuple[int, int, int]) -> int:
    q = 0
    for r in range(1, 8):
        pr = 0
        for i in range(3):
            if (r >> i) & 1:
                pr |= 1 << perm[i]
        if (p >> (r - 1)) & 1:
            q |= 1 << (pr - 1)
    return q


def _pattern_valid(p: int) -> bool:
    """Can ``p`` be the pattern of a connected triple of distinct,
    non-empty hyperedges?"""
    regs = [r for r in range(1, 8) if (p >> (r - 1)) & 1]
    for x in range(3):
        if not any((r >> x) & 1 for r in regs):
            return False  # hyperedge x empty
    for x, y in ((0, 1), (0, 2), (1, 2)):
        if not any(((r >> x) & 1) != ((r >> y) & 1) for r in regs):
            return False  # no region distinguishes x from y: duplicates
    links = sum(
        any(((r >> x) & 1) and ((r >> y) & 1) for r in regs)
        for x, y in ((0, 1), (0, 2), (1, 2))
    )
    return links >= 2  # 3 nodes: ≥2 overlap links <=> connected


def _build_tables() -> tuple[np.ndarray, int]:
    perms = list(itertools.permutations(range(3)))
    canon = np.array(
        [min(_permute_pattern(p, pm) for pm in perms)
         for p in range(_N_PATTERNS)],
        np.int32,
    )
    classes = sorted(
        {int(canon[p]) for p in range(_N_PATTERNS) if _pattern_valid(p)}
    )
    class_of = np.full(_N_PATTERNS, -1, np.int32)
    for p in range(_N_PATTERNS):
        if _pattern_valid(p):
            class_of[p] = classes.index(int(canon[p]))
    return class_of, len(classes)


#: pattern -> h-motif class id (0..25), -1 for impossible patterns.
CLASS_OF_PATTERN, N_HMOTIF_CLASSES = _build_tables()


def classify_patterns(
    sa, sb, sc, iab, ibc, ica, iabc
) -> np.ndarray:
    """Map intersection numbers of (a, b, c) triples to h-motif class
    ids (vectorized; -1 = impossible, i.e. duplicate hyperedges)."""
    sa, sb, sc, iab, ibc, ica, iabc = (
        np.asarray(x, np.int64) for x in (sa, sb, sc, iab, ibc, ica, iabc)
    )
    abc = iabc
    ab = iab - iabc
    bc = ibc - iabc
    ca = ica - iabc
    a = sa - iab - ica + iabc
    b = sb - iab - ibc + iabc
    c = sc - ibc - ica + iabc
    pattern = (
        ((a > 0).astype(np.int32) << 0)
        | ((b > 0).astype(np.int32) << 1)
        | ((ab > 0).astype(np.int32) << 2)
        | ((c > 0).astype(np.int32) << 3)
        | ((ca > 0).astype(np.int32) << 4)
        | ((bc > 0).astype(np.int32) << 5)
        | ((abc > 0).astype(np.int32) << 6)
    )
    return CLASS_OF_PATTERN[pattern]


# --------------------------------------------------------------------------
# overlap graph + connected-triple enumeration (host-side preprocessing)
# --------------------------------------------------------------------------

def overlap_pairs_with_counts(
    hg: HyperGraph,
) -> tuple[np.ndarray, np.ndarray]:
    """``([L, 2], [L])`` hyperedge id pairs (a < b) sharing ≥ 1 vertex,
    plus the shared-vertex count |a∩b| per pair — the edge list (and
    edge attribute) of the clique expansion of the *dual* hypergraph.

    Vectorized by degree bucketing: vertices of equal degree d emit
    their C(d, 2) member pairs in one ``triu_indices`` shot, so the
    host-side loop runs over *distinct degrees*, not vertices.
    """
    src, dst = _clean_incidence(hg)
    if len(src) == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.int64)
    order = np.lexsort((dst, src))
    o, m = src[order], dst[order].astype(np.int64)
    counts = np.bincount(o, minlength=hg.n_vertices)
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    e = np.int64(hg.n_hyperedges)
    chunks = []
    for d in np.unique(counts):
        if d < 2:
            continue
        owners = np.where(counts == d)[0]
        rows = m[starts[owners][:, None] + np.arange(d)[None, :]]
        iu, ju = np.triu_indices(int(d), k=1)
        a, b = rows[:, iu].ravel(), rows[:, ju].ravel()
        chunks.append(np.minimum(a, b) * e + np.maximum(a, b))
    if not chunks:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.int64)
    keys, n_shared = np.unique(np.concatenate(chunks), return_counts=True)
    pairs = np.stack([keys // e, keys % e], axis=1)
    return pairs, n_shared.astype(np.int64)


def overlap_pairs(hg: HyperGraph) -> np.ndarray:
    """``[L, 2]`` hyperedge id pairs (a < b) sharing at least one vertex
    — the edge list of the overlap (line) graph."""
    return overlap_pairs_with_counts(hg)[0]


@dataclasses.dataclass(frozen=True)
class OverlapGraph:
    """CSR adjacency over hyperedges sharing a vertex."""

    pairs: np.ndarray    # [L, 2] int64, a < b
    indptr: np.ndarray   # [E + 1]
    nbrs: np.ndarray     # [2L]

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])

    def neighbors_flat(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Concatenated neighbor lists for ``ids``; returns (owner row
        index per entry, neighbor id per entry)."""
        counts = self.indptr[ids + 1] - self.indptr[ids]
        starts = self.indptr[ids]
        total = int(counts.sum())
        flat = np.repeat(starts, counts)
        csum = np.concatenate(([0], np.cumsum(counts)[:-1]))
        flat = flat + (np.arange(total) - np.repeat(csum, counts))
        return np.repeat(np.arange(len(ids)), counts), self.nbrs[flat]


def build_overlap_graph(
    hg: HyperGraph, pairs: np.ndarray | None = None
) -> OverlapGraph:
    if pairs is None:
        pairs = overlap_pairs(hg)
    u = np.concatenate([pairs[:, 0], pairs[:, 1]])
    v = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.searchsorted(u, np.arange(hg.n_hyperedges + 1))
    return OverlapGraph(pairs=pairs, indptr=indptr, nbrs=v)


def connected_triples(og: OverlapGraph, n_hyperedges: int) -> np.ndarray:
    """``[T, 3]`` sorted hyperedge id triples whose overlap graph is
    connected (each triple exactly once)."""
    if og.n_pairs == 0:
        return np.zeros((0, 3), np.int64)
    if n_hyperedges >= (1 << 21):
        raise ValueError(
            "exact census enumeration needs n_hyperedges < 2^21; use the "
            "sampling estimator"
        )
    a, b = og.pairs[:, 0], og.pairs[:, 1]
    rows_a, cand_a = og.neighbors_flat(a)
    rows_b, cand_b = og.neighbors_flat(b)
    rows = np.concatenate([rows_a, rows_b])
    cand = np.concatenate([cand_a, cand_b])
    keep = (cand != a[rows]) & (cand != b[rows])
    rows, cand = rows[keep], cand[keep]
    tri = np.sort(
        np.stack([a[rows], b[rows], cand], axis=1), axis=1
    ).astype(np.int64)
    e = np.int64(n_hyperedges)
    key = (tri[:, 0] * e + tri[:, 1]) * e + tri[:, 2]
    _, first = np.unique(key, return_index=True)
    return tri[first]


# --------------------------------------------------------------------------
# exact census
# --------------------------------------------------------------------------

def triple_profiles(
    index: PairIndex,
    triples: np.ndarray,
    *,
    tile: int = 2048,
    mesh=None,
    axis: str = "data",
    pair_sizes: dict | None = None,
    timings: dict | None = None,
) -> tuple[np.ndarray, ...]:
    """The 7 intersection numbers per triple, via the batch kernel.

    ``pair_sizes`` optionally maps encoded (a<b) pair keys to
    materialized intersection sizes (the dual-clique-expansion path);
    pairs found there skip the kernel.  The cardinalities and the
    table lookups count as ``classify_s`` in ``timings``.
    """
    a, b, c = triples[:, 0], triples[:, 1], triples[:, 2]
    t0 = time.perf_counter()
    card = index.cardinalities()
    sa, sb, sc = card[a], card[b], card[c]
    add_time(timings, "classify_s", t0)

    def pair_counts(x, y):
        if pair_sizes is not None:
            t0 = time.perf_counter()
            e = np.int64(index.n_hyperedges)
            lo, hi = np.minimum(x, y), np.maximum(x, y)
            out = pair_sizes_lookup(pair_sizes, lo * e + hi)
            add_time(timings, "classify_s", t0)
            return out
        return batch_intersections(
            index, x, y, tile=tile, mesh=mesh, axis=axis, timings=timings
        ).astype(np.int64)

    iab = pair_counts(a, b)
    ibc = pair_counts(b, c)
    ica = pair_counts(c, a)
    iabc = batch_intersections(
        index, a, b, c, tile=tile, mesh=mesh, axis=axis, timings=timings
    ).astype(np.int64)
    return sa, sb, sc, iab, ibc, ica, iabc


def pair_sizes_lookup(pair_sizes: dict, keys: np.ndarray) -> np.ndarray:
    sorted_keys, sizes = pair_sizes["keys"], pair_sizes["sizes"]
    pos = np.searchsorted(sorted_keys, keys)
    pos = np.minimum(pos, max(len(sorted_keys) - 1, 0))
    hit = sorted_keys[pos] == keys if len(sorted_keys) else np.zeros(
        len(keys), bool
    )
    out = np.where(hit, sizes[pos] if len(sizes) else 0, 0)
    return out.astype(np.int64)


def materialize_pair_sizes(
    hg: HyperGraph,
    pairs: np.ndarray | None = None,
    n_shared: np.ndarray | None = None,
) -> dict:
    """Precompute |a∩b| for every overlapping pair — what the clique
    expansion of the dual hypergraph materializes (§IV-A's
    representation tradeoff, applied to batch analytics).  Lookups for
    *distinct* pairs absent from the table are 0 — exact, since absence
    means the pair shares no vertex.  The table holds a < b pairs only:
    self-pairs (|e ∩ e| = |e|) are the caller's job."""
    if pairs is None or n_shared is None:
        pairs, n_shared = overlap_pairs_with_counts(hg)
    e = np.int64(hg.n_hyperedges)
    return {"keys": pairs[:, 0] * e + pairs[:, 1], "sizes": n_shared}


@dataclasses.dataclass(frozen=True)
class Census:
    """Exact h-motif census."""

    counts: np.ndarray          # [N_HMOTIF_CLASSES] int64
    n_triples: int              # connected triples classified
    n_duplicate_triples: int    # triples dropped (duplicate hyperedges)
    n_pairs: int                # overlapping hyperedge pairs examined

    @property
    def total(self) -> int:
        return int(self.counts.sum())


def exact_census(
    hg: HyperGraph,
    *,
    index: PairIndex | None = None,
    kernel: str = "auto",
    tile: int = 2048,
    mesh=None,
    axis: str = "data",
    pair_sizes: dict | None = None,
    og: OverlapGraph | None = None,
    timings: dict | None = None,
) -> Census:
    """Enumerate and classify every connected 3-hyperedge pattern."""
    if index is None:
        if kernel == "auto":
            kernel, _ = select_intersect_kernel(hg)
        index = build_index(hg, kernel)
    t0 = time.perf_counter()
    if og is None:
        og = build_overlap_graph(hg)
    triples = connected_triples(og, hg.n_hyperedges)
    add_time(timings, "preprocess_s", t0)
    if len(triples) == 0:
        return Census(
            counts=np.zeros(N_HMOTIF_CLASSES, np.int64),
            n_triples=0, n_duplicate_triples=0, n_pairs=og.n_pairs,
        )
    profiles = triple_profiles(
        index, triples, tile=tile, mesh=mesh, axis=axis,
        pair_sizes=pair_sizes, timings=timings,
    )
    t0 = time.perf_counter()
    cls = classify_patterns(*profiles)
    valid = cls >= 0
    counts = np.bincount(cls[valid], minlength=N_HMOTIF_CLASSES).astype(
        np.int64
    )
    add_time(timings, "classify_s", t0)
    return Census(
        counts=counts,
        n_triples=int(valid.sum()),
        n_duplicate_triples=int((~valid).sum()),
        n_pairs=og.n_pairs,
    )
