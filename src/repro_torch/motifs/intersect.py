"""Tiled hyperedge-pair intersection sizes, in PyTorch.

Motif classification (``repro_torch.motifs.hmotifs``) reduces to one
primitive: given batches of hyperedge id pairs (or triples), return the
size of the member-set intersection.  Two interchangeable paths behind
one cost model, as in the JAX package's ``repro.motifs.intersect``:

* ``bitset`` — each hyperedge's member set packed into 32-bit words
  (``[E, ceil(|V|/32)]`` int32 holding the reference's uint32 bits); an
  intersection is AND + popcount over the words.  On the card it is the
  hand-written kernel (``repro_torch.kernels.isect``): one launch per
  batch, rows gathered inside the kernel.  On the CPU it is the kernel's
  plain version, ``tile`` pairs at a time.
* ``merge`` — each hyperedge's *sorted* member list padded with the
  sentinel ``n_vertices`` to the max cardinality; membership counted by
  per-row ``torch.searchsorted``.  Plain torch on every device.

The index is built on the host (numpy) and lives on the hypergraph's
device; ids and results cross as numpy arrays, as the reference's do.
With a mesh (the sharded backend) every rank holds the whole index, runs
its block of the pairs through the same path and the blocks meet in one
``all_gather``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.hypergraph import HyperGraph
from repro_torch.kernels.isect import isect_cuda, pair_intersect_bitset

INTERSECT_KERNELS = ("auto", "bitset", "merge")

# On the card a merge tile is one Python step of several launches, so it
# is widened until its temporaries (a few [tile, K] int64 arrays) reach
# this size; results do not depend on the tile.
MERGE_TILE_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class PairIndex:
    """Preprocessed per-hyperedge member structure for one kernel path.

    ``data`` is ``[E, W]`` int32 bit words (bitset; the reference's
    uint32 lanes, bit for bit) or ``[E, K]`` int32 sorted members padded
    with the sentinel ``n_vertices`` (merge).
    """

    kind: str                 # "bitset" | "merge"
    n_vertices: int
    n_hyperedges: int
    data: torch.Tensor

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes(self) -> int:
        return int(self.data.numel()) * 4

    def cardinalities(self) -> np.ndarray:
        """|e| per hyperedge, recovered from the index itself (bitset:
        ``popcount(row & row)``, the pre-gathered kernel on the card)."""
        if self.kind == "merge":
            card = (self.data < self.n_vertices).sum(dim=1)
        else:
            card = isect_cuda(self.data, self.data)
        return card.cpu().numpy().astype(np.int64)


def add_time(timings: dict | None, key: str, t0: float) -> None:
    """Add the seconds since ``t0`` to ``timings[key]`` (when given)."""
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _clean_incidence(hg: HyperGraph) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (src, dst) with masked incidences dropped and duplicate
    memberships collapsed (intersection counts are *set* sizes)."""
    src = hg.src.cpu().numpy()
    dst = hg.dst.cpu().numpy()
    if hg.e_mask is not None:
        keep = hg.e_mask.cpu().numpy() > 0
        src, dst = src[keep], dst[keep]
    if len(src) == 0:
        return src.astype(np.int32), dst.astype(np.int32)
    key = dst.astype(np.int64) * np.int64(max(hg.n_vertices, 1)) + src
    _, first = np.unique(key, return_index=True)
    return src[first].astype(np.int32), dst[first].astype(np.int32)


def build_index(hg: HyperGraph, kernel: str) -> PairIndex:
    """Build the per-hyperedge member structure for one kernel path on
    the host, and put it on the hypergraph's device."""
    src, dst = _clean_incidence(hg)
    nv, ne = hg.n_vertices, hg.n_hyperedges
    if kernel == "bitset":
        w = max((nv + 31) // 32, 1)
        bits = np.zeros((max(ne, 1), w), np.uint32)
        if len(src):
            np.bitwise_or.at(
                bits,
                (dst, src >> 5),
                np.left_shift(np.uint32(1), (src & 31).astype(np.uint32)),
            )
        data = bits.view(np.int32)
    elif kernel == "merge":
        if len(src):
            card = np.bincount(dst, minlength=ne)
            k = max(int(card.max()), 1)
        else:
            k = 1
        data = np.full((max(ne, 1), k), nv, np.int32)
        if len(src):
            order = np.lexsort((src, dst))
            s, d = src[order], dst[order]
            bounds = np.searchsorted(d, np.arange(ne + 1))
            pos = np.arange(len(s)) - bounds[d]
            data[d, pos] = s
    else:
        raise ValueError(
            f"unknown intersection kernel {kernel!r}; pick one of "
            f"{INTERSECT_KERNELS[1:]}"
        )
    return PairIndex(kernel, nv, ne, torch.as_tensor(data, device=hg.device))


def pair_index_from_numpy(kind: str, n_vertices: int, n_hyperedges: int,
                          data, device=None) -> PairIndex:
    """A port ``PairIndex`` from host arrays (a JAX index's
    ``np.asarray(index.data)`` included): a ``uint32`` bitset is viewed
    as int32, ``int32`` members are kept; onto ``device`` (default: the
    CPU)."""
    arr = np.array(data)  # a copy: the source may be a read-only buffer
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype != np.int32 or arr.ndim != 2:
        raise TypeError(f"index data must be 2-D uint32 or int32, got "
                        f"{arr.dtype} of shape {arr.shape}")
    dev = torch.device("cpu" if device is None else device)
    return PairIndex(kind, int(n_vertices), int(n_hyperedges),
                     torch.as_tensor(arr, device=dev))


def select_intersect_kernel(
    hg: HyperGraph, *, bitset_budget_bytes: int = 256 << 20
) -> tuple[str, dict]:
    """Bitset vs sorted-merge for one hypergraph (the reference's cost
    model, unchanged).

    Per-pair work: bitset touches ``W = ceil(|V|/32)`` words; merge does
    ``K (log2 K + 1)`` compares for max cardinality ``K``.  Small
    vocabularies keep ``W`` below the merge work (pick bitset); large
    vocabularies blow the word count (and the ``E x W`` index memory)
    up, so merge wins.
    """
    nv, ne = hg.n_vertices, hg.n_hyperedges
    card = hg.cardinalities().cpu().numpy()
    k = max(int(card.max()) if card.size else 1, 1)
    w = max((nv + 31) // 32, 1)
    bitset_cost = float(w)
    merge_cost = float(k * (math.log2(k) + 1.0))
    bitset_bytes = ne * w * 4
    why: dict[str, Any] = {
        "bitset_words_per_pair": w,
        "merge_ops_per_pair": merge_cost,
        "bitset_index_bytes": bitset_bytes,
        "bitset_budget_bytes": bitset_budget_bytes,
    }
    if bitset_bytes > bitset_budget_bytes:
        why["reason"] = "bitset index exceeds memory budget"
        return "merge", why
    if bitset_cost <= merge_cost:
        why["reason"] = "vocabulary small: word lanes beat sort-merge"
        return "bitset", why
    why["reason"] = "vocabulary large: sort-merge beats word lanes"
    return "merge", why


def _tile_merge(members, nv, a, b, c):
    ra = members.index_select(0, a)

    def contains(rows, probe):
        idx = torch.searchsorted(rows, probe)
        idx.clamp_(max=rows.shape[1] - 1)
        return rows.gather(1, idx) == probe

    hit = contains(members.index_select(0, b), ra) & (ra < nv)
    if c is not None:
        hit &= contains(members.index_select(0, c), ra)
    return hit.sum(dim=1, dtype=torch.int32)


def _batch_merge(members, nv, ea, eb, ec, tile):
    n = ea.shape[0]
    if members.device.type != "cpu":
        tile = max(tile, MERGE_TILE_BYTES // (8 * members.shape[1]))
    out = torch.empty(n, dtype=torch.int32, device=members.device)
    for lo in range(0, n, tile):
        sl = slice(lo, min(lo + tile, n))
        out[sl] = _tile_merge(members, nv, ea[sl], eb[sl],
                              ec[sl] if ec is not None else None)
    return out


def batch_intersections(
    index: PairIndex,
    ea,
    eb,
    ec=None,
    *,
    tile: int = 2048,
    mesh=None,
    axis: str = "data",
    timings: dict | None = None,
) -> np.ndarray:
    """Intersection size per (ea[i], eb[i]) pair — or per triple when
    ``ec`` is given — as a host int32 array.

    ``mesh``: pair blocks are tiled across ``mesh[axis]`` (every rank
    calls with the same ids; each runs its block, a whole number of
    ``tile``s, and one ``all_gather_into_tensor`` hands every rank all the
    sizes) — the sharded batch-analytics backend.

    bitset: one kernel launch per call on the card, the plain version
    ``tile`` pairs at a time on the CPU.  merge: ``tile`` pairs at a
    time (widened on the card, ``MERGE_TILE_BYTES``).  ``timings``, when
    given, accumulates ``intersect_s`` (wall time of the call, the copy
    back to the host included) and ``intersect_calls``.
    """
    t0 = time.perf_counter()
    ea = np.asarray(ea, np.int32)
    eb = np.asarray(eb, np.int32)
    n = len(ea)
    if n == 0:
        return np.zeros(0, np.int32)
    arrays = [ea, eb] + ([np.asarray(ec, np.int32)] if ec is not None
                         else [])
    for x in arrays:
        # The kernel reads rows at these ids unchecked.
        if len(x) != n:
            raise ValueError(f"id arrays differ in length: {len(x)} vs {n}")
        if x.min() < 0 or x.max() >= index.n_hyperedges:
            raise ValueError(
                f"hyperedge ids must lie in [0, {index.n_hyperedges})")
    dev = index.data.device
    block = None
    if mesh is not None:
        from repro_torch.core.distributed import all_gather_single
        from repro_torch.launch.mesh import mesh_size

        n_parts = mesh_size(mesh, axis)
        rank = int(mesh.get_local_rank(axis))
        block = -(-n // (n_parts * tile)) * tile
        # Padding pairs are (0, 0): valid rows, their sizes sliced off.
        arrays = [np.pad(x, (0, block * n_parts - n))[rank * block:
                                                      (rank + 1) * block]
                  for x in arrays]
    ids = [torch.as_tensor(x, device=dev) for x in arrays]
    c = ids[2] if ec is not None else None
    if index.kind == "bitset":
        out = pair_intersect_bitset(index.data, ids[0], ids[1], c,
                                    tile=tile)
    else:
        out = _batch_merge(index.data, index.n_vertices, ids[0], ids[1], c,
                           tile)
    if block is not None:
        full = torch.empty(block * n_parts, dtype=out.dtype, device=dev)
        all_gather_single(full, out.contiguous(),
                          group=mesh.get_group(axis))
        out = full[:n]
    res = out.cpu().numpy()
    add_time(timings, "intersect_s", t0)
    if timings is not None:
        timings["intersect_calls"] = timings.get("intersect_calls", 0) + 1
    return res
