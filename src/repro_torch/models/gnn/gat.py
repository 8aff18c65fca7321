"""GAT (Veličković et al., arXiv:1710.10903), the counterpart of the JAX
package's ``repro.models.gnn.gat``: edge scores from the two endpoints'
projections -> segment softmax over each destination's edges -> the
weighted message sum (``mp_segment_sum``: K2a on the card).  Node rows
reach the edges through ``sparse.gather.gather_nodes``, so a graph of
DTensors (a partitioned cell) runs on each rank's own edges and nodes."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.models.params import normal, tree_from_jax
from repro_torch.sparse.gather import gather_nodes
from repro_torch.sparse.segment import mp_segment_sum, segment_softmax


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    d_in: int = 1433
    negative_slope: float = 0.2


def init_params(gen: torch.Generator, cfg: GATConfig):
    """Random float32 weights drawn from ``gen`` on its device, in the
    JAX package's shapes and scales (weights to compare with it come
    through ``params_from_jax``)."""
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        layers.append({
            "w": normal(gen, (d_in, heads, d_out), d_in**-0.5),
            "a_src": normal(gen, (heads, d_out), 0.1),
            "a_dst": normal(gen, (heads, d_out), 0.1),
        })
        d_in = d_out * heads
    return {"layers": layers}


def params_from_jax(tree, cfg: GATConfig, device=None):
    """The JAX package's parameters (numpy leaves) as the port's tree."""
    return tree_from_jax(tree, device)


def forward(params, cfg: GATConfig, g: GraphBatch) -> torch.Tensor:
    x = g.node_feat
    n = g.n_nodes
    src, dst = g.edge_src, g.edge_dst
    live = g.edge_mask[:, None] > 0
    for i, lp in enumerate(params["layers"]):
        h = torch.einsum("nf,fhd->nhd", x, lp["w"])      # [N, H, D]
        e_src = (h * lp["a_src"]).sum(-1)                # [N, H]
        e_dst = (h * lp["a_dst"]).sum(-1)
        logits = F.leaky_relu(gather_nodes(e_src, src)
                              + gather_nodes(e_dst, dst),
                              cfg.negative_slope)       # [E, H]
        logits = torch.where(live, logits, -1e30)
        alpha = segment_softmax(logits, dst, n)          # [E, H]
        alpha = alpha * g.edge_mask[:, None]
        msg = gather_nodes(h, src) * alpha[..., None]    # [E, H, D]
        agg = mp_segment_sum(msg, dst, n)                # [N, H, D]
        if i == cfg.n_layers - 1:
            x = agg.mean(dim=1)                          # average heads
        else:
            x = F.elu(agg.reshape(n, -1))                # concat heads
    return x


def loss_fn(params, cfg: GATConfig, g: GraphBatch) -> torch.Tensor:
    logits = forward(params, cfg, g)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, g.labels.long()[:, None])[:, 0]
    m = g.node_mask if g.node_mask is not None else torch.ones_like(nll)
    return (nll * m).sum() / m.sum().clamp(min=1.0)
