"""PageRank over the clique-expanded Graph representation (Fig. 7 baseline).

Only valid for algorithms with no hyperedge state — exactly the restriction
the paper documents.  Weighted by shared-hyperedge count (the ``toGraph``
edge attribute).

This is the ``clique_program`` behind ``vertex_pagerank_spec``: the Engine
facade routes here when ``representation`` resolves to ``clique`` (see
``repro_torch.core.executor.select_representation``).

The edges are sorted by destination once, with their CSR row offsets,
and each iteration's sum by destination is one launch of the sorted
segment-sum kernel (K2b, ``segsum_sorted_cuda``: the same bits on every
run; its plain version on the CPU).  No host sync runs in the loop.  The
out-weights, summed once by source, take ``index_add_``
(``segsum_plain``): on one H100 at DBLP's clique size (33.5 M edges, 0.9
M rows, float32) it measured 0.47 ms against the unsorted kernel K2a's
1.91 ms, while K2b took 0.10 ms against ``index_add_``'s 0.49
(``chip_smoke.py`` phase 11; PERF.md §6).
"""
from __future__ import annotations

import torch

from repro_torch.core.clique import Graph
from repro_torch.kernels.segsum.ops import csr_row_offsets
from repro_torch.kernels.segsum.segsum import segsum_plain, segsum_sorted_cuda


def _sorted_by_dst(g: Graph, w: torch.Tensor):
    """``(src, w, row_offsets)`` of the edges in stable ``dst`` order,
    the offsets checked once (one host sync): ``segsum_sorted_cuda``
    reads the rows they name unchecked."""
    nv = g.n_vertices
    order = torch.sort(g.dst, stable=True).indices
    dst_s = g.dst[order]
    off = csr_row_offsets(dst_s, nv)
    n = dst_s.shape[0]
    valid = (off[1:] >= off[:-1]).all() & (off[0] == 0) & (off[-1] == n)
    if not bool(valid):
        raise ValueError(
            f"graph edges must have destinations in [0, {nv})")
    return g.src[order], w[order], off


def graph_pagerank(
    g: Graph, iters: int = 30, alpha: float = 0.15
) -> torch.Tensor:
    nv = g.n_vertices
    w = (g.e_attr if g.e_attr is not None
         else torch.ones(g.src.shape, dtype=torch.float32,
                         device=g.src.device))
    w = w.to(torch.float32)
    out_w = segsum_plain(w[:, None], g.src, nv)[:, 0]
    out_w = torch.clamp(out_w, min=1e-12)
    src_s, w_s, off = _sorted_by_dst(g, w)
    rank = torch.ones(nv, dtype=torch.float32, device=g.src.device)
    for _ in range(iters):
        contrib = (rank / out_w).index_select(0, src_s) * w_s
        agg = segsum_sorted_cuda(contrib[:, None], off, nv)[:, 0]
        rank = alpha + (1.0 - alpha) * agg
    return rank
