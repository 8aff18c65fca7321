"""GraphBatch: the one device-side graph container of the GNN side, the
counterpart of the JAX package's ``repro.models.gnn.graph``.

Every GNN (GAT / PNA / NequIP / MACE) and every shape regime (full
graph, sampled block, batched molecules) lowers to this one structure;
message passing is an index gather + ``sparse.mp_segment_*`` over
``edge_src`` / ``edge_dst``, the primitive the MESH engine runs on.  It
is a plain dataclass of tensors (the JAX package registers a pytree).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass
class GraphBatch:
    edge_src: torch.Tensor           # [E] int32
    edge_dst: torch.Tensor           # [E] int32
    edge_mask: torch.Tensor          # [E] float32 {0, 1}
    n_nodes: int
    node_feat: torch.Tensor | None = None    # [N, F]
    positions: torch.Tensor | None = None    # [N, 3]
    species: torch.Tensor | None = None      # [N] int32
    node_mask: torch.Tensor | None = None    # [N] float32
    graph_ids: torch.Tensor | None = None    # [N] int32 (batched molecules)
    n_graphs: int = 1
    labels: Any = None

    # Fields cut along the edges by the edge-sharded step.
    EDGE_FIELDS = ("edge_src", "edge_dst", "edge_mask")


_ARRAY_FIELDS = ("edge_src", "edge_dst", "edge_mask", "node_feat",
                 "positions", "species", "node_mask", "graph_ids", "labels")


def random_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int | None = None,
    with_positions: bool = False,
    n_species: int = 8,
    n_classes: int = 8,
    n_graphs: int = 1,
    seed: int = 0,
    device=None,
) -> GraphBatch:
    """Synthetic graph batch (tests, smoke runs), drawn with the JAX
    package's numpy calls in its order, so one seed gives one graph in
    both packages; on ``device`` (the card unless the caller asks for
    the CPU).

    Random pairs, self-loops allowed; for batched molecules
    (``n_graphs > 1``) nodes are split contiguously and edges stay
    within a graph.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if n_graphs > 1:
        per = n_nodes // n_graphs
        gid = np.repeat(np.arange(n_graphs), per).astype(np.int32)
        gid = np.pad(gid, (0, n_nodes - len(gid)),
                     constant_values=n_graphs - 1)
        base = (rng.integers(0, per, size=(2, n_edges))).astype(np.int32)
        graph_of_edge = rng.integers(0, n_graphs, size=n_edges)
        src = (graph_of_edge * per + base[0]).astype(np.int32)
        dst = (graph_of_edge * per + base[1]).astype(np.int32)
    else:
        gid = np.zeros(n_nodes, np.int32)
        src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
        dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)

    def on(x):
        return torch.from_numpy(x).to(dev)

    batch = GraphBatch(
        edge_src=on(src),
        edge_dst=on(dst),
        edge_mask=torch.ones((n_edges,), dtype=torch.float32, device=dev),
        n_nodes=n_nodes,
        node_mask=torch.ones((n_nodes,), dtype=torch.float32, device=dev),
        graph_ids=on(gid),
        n_graphs=n_graphs,
    )
    if d_feat:
        batch.node_feat = on(
            rng.standard_normal((n_nodes, d_feat)).astype(np.float32))
    if with_positions:
        batch.positions = on(
            (rng.standard_normal((n_nodes, 3)) * 2.0).astype(np.float32))
        batch.species = on(
            rng.integers(0, n_species, size=n_nodes).astype(np.int32))
    batch.labels = on(rng.integers(0, n_classes, size=n_nodes).astype(
        np.int32))
    return batch


def graph_from_jax(g, device=None) -> GraphBatch:
    """The JAX package's ``GraphBatch`` (device arrays or numpy) as the
    port's on ``device``: every array field through numpy, the static
    ``n_nodes`` / ``n_graphs`` as they are."""
    dev = resolve_device(device)
    fields = {}
    for name in _ARRAY_FIELDS:
        x = getattr(g, name)
        fields[name] = None if x is None else torch.from_numpy(
            np.array(x, copy=True)).to(dev)
    return GraphBatch(n_nodes=int(g.n_nodes), n_graphs=int(g.n_graphs),
                      **fields)
