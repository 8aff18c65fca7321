"""Fanout neighbor sampler (GraphSAGE-style) for minibatch GNN training,
the port's own copy of the JAX package's ``repro.sparse.sampler`` (which
is numpy only): the same code and the same ``seed``-driven
``np.random`` stream, so that a block is bitwise the reference's.

The full graph lives host-side in CSR (NumPy); each step samples a k-hop
block with fixed fanouts, producing *static-shape* arrays (padded with a
sink node) that a training step takes as they are, whatever the draw.
This is the real sampler the ``minibatch_lg`` shape requires — 233k
nodes / 115M edges stay on host, only the sampled block ships to the
device (``torch.from_numpy(...).to(device)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def build_csr(
    src: np.ndarray, dst: np.ndarray, n_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Sort a COO edge list into CSR (indptr, indices) keyed by dst.

    ``indices[indptr[v]:indptr[v+1]]`` = in-neighbors of ``v``.
    """
    order = np.argsort(dst, kind="stable")
    sorted_src = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, sorted_src.astype(np.int32)


@dataclasses.dataclass
class SampledBlock:
    """One k-hop sampled computation block, padded to static shape.

    ``nodes`` lists unique node ids layer-by-layer (seeds first);
    ``edge_src``/``edge_dst`` index into ``nodes`` (local ids).  Padding
    edges point at local sink ``len(nodes)-1`` with ``edge_mask`` 0.
    """

    nodes: np.ndarray       # [n_block] global node ids (int32)
    edge_src: np.ndarray    # [n_edges] local ids
    edge_dst: np.ndarray    # [n_edges] local ids
    edge_mask: np.ndarray   # [n_edges] float32 {0,1}
    seed_count: int

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])


class NeighborSampler:
    """Uniform fanout sampler over a host-side CSR graph."""

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        fanouts: tuple[int, ...],
        seed: int = 0,
    ):
        self.indptr = indptr
        self.indices = indices
        self.fanouts = tuple(fanouts)
        self._rng = np.random.default_rng(seed)

    def _sample_neighbors(self, frontier: np.ndarray, fanout: int):
        """For each node in frontier sample ``fanout`` in-neighbors
        (with replacement when degree < fanout, mask 0 when degree == 0)."""
        deg = (self.indptr[frontier + 1] - self.indptr[frontier]).astype(
            np.int64
        )
        offsets = self.indptr[frontier]
        draw = self._rng.integers(
            0, np.maximum(deg, 1)[:, None], size=(len(frontier), fanout)
        )
        flat_idx = (offsets[:, None] + draw).reshape(-1)
        flat_idx = np.minimum(flat_idx, len(self.indices) - 1)
        nbrs = self.indices[flat_idx].reshape(len(frontier), fanout)
        mask = (deg > 0)[:, None] & np.ones((1, fanout), dtype=bool)
        return nbrs, mask

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        seeds = np.asarray(seeds, dtype=np.int32)
        all_src: list[np.ndarray] = []
        all_dst: list[np.ndarray] = []
        all_mask: list[np.ndarray] = []
        frontier = seeds
        layers = [seeds]
        for fanout in self.fanouts:
            nbrs, mask = self._sample_neighbors(frontier, fanout)
            dst = np.repeat(frontier, fanout)
            src = nbrs.reshape(-1)
            all_src.append(src)
            all_dst.append(dst)
            all_mask.append(mask.reshape(-1))
            frontier = src
            layers.append(src)
        # Build local id space: unique nodes, seeds first.
        cat = np.concatenate(layers)
        uniq, inv = np.unique(cat, return_inverse=True)
        # remap seeds to the front
        seed_pos = inv[: len(seeds)]
        perm = np.full(len(uniq), -1, dtype=np.int64)
        order = list(dict.fromkeys(seed_pos.tolist()))
        rest = [i for i in range(len(uniq)) if i not in set(order)]
        new_order = np.array(order + rest, dtype=np.int64)
        perm[new_order] = np.arange(len(uniq))
        nodes = uniq[new_order].astype(np.int32)
        global_to_local = {int(g): i for i, g in enumerate(nodes)}
        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)
        mask = np.concatenate(all_mask).astype(np.float32)
        loc = np.vectorize(global_to_local.__getitem__, otypes=[np.int64])
        edge_src = loc(src).astype(np.int32)
        edge_dst = loc(dst).astype(np.int32)
        return SampledBlock(
            nodes=nodes,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=mask,
            seed_count=len(seeds),
        )

    def padded_block_shape(self, batch_nodes: int) -> tuple[int, int]:
        """Static (n_nodes, n_edges) upper bound for jit."""
        n_edges = 0
        frontier = batch_nodes
        n_nodes = batch_nodes
        for fanout in self.fanouts:
            n_edges += frontier * fanout
            frontier = frontier * fanout
            n_nodes += frontier
        return n_nodes, n_edges

    def sample_padded(self, seeds: np.ndarray) -> SampledBlock:
        """Sample then pad nodes/edges to the static upper bound."""
        block = self.sample(seeds)
        n_nodes_max, n_edges_max = self.padded_block_shape(len(seeds))
        n_nodes_max += 1  # sink node
        nodes = np.full(n_nodes_max, 0, dtype=np.int32)
        nodes[: block.n_nodes] = block.nodes
        sink = n_nodes_max - 1
        pad_e = n_edges_max - len(block.edge_src)
        edge_src = np.concatenate(
            [block.edge_src, np.full(pad_e, sink, np.int32)]
        )
        edge_dst = np.concatenate(
            [block.edge_dst, np.full(pad_e, sink, np.int32)]
        )
        mask = np.concatenate(
            [block.edge_mask, np.zeros(pad_e, np.float32)]
        )
        return SampledBlock(
            nodes=nodes,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=mask,
            seed_count=block.seed_count,
        )
