"""PNA (Corso et al., arXiv:2004.05718), the counterpart of the JAX
package's ``repro.models.gnn.pna``: multi-aggregator message passing,
4 aggregators (mean / max / min / std) x 3 degree scalers (identity /
amplification / attenuation) -> a 12-fold concat -> a linear tower.
Node rows reach the edges through ``sparse.gather.gather_nodes`` and
the per-molecule readout folds through ``sparse.graph_segment``, so a
graph of DTensors (a partitioned cell) runs on each rank's own edges
and nodes."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.models.params import normal, tree_from_jax
from repro_torch.sparse.gather import gather_nodes
from repro_torch.sparse.segment import (
    graph_segment,
    mp_segment_max,
    mp_segment_min,
    mp_segment_sum,
    segment_mean,
    segment_std,
)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    n_classes: int = 8
    d_in: int = 16
    delta: float = 2.0  # avg log-degree normalizer (dataset statistic)


def init_params(gen: torch.Generator, cfg: PNAConfig):
    """Random float32 weights drawn from ``gen``, in the JAX package's
    shapes and scales."""
    layers = []
    d_in = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "w_pre": normal(gen, (2 * d_in, cfg.d_hidden),
                            (2 * d_in) ** -0.5),
            "w_post": normal(gen, (12 * cfg.d_hidden + d_in, cfg.d_hidden),
                             (12 * cfg.d_hidden) ** -0.5),
        })
        d_in = cfg.d_hidden
    return {
        "layers": layers,
        "readout": normal(gen, (cfg.d_hidden, cfg.n_classes),
                          cfg.d_hidden**-0.5),
    }


def params_from_jax(tree, cfg: PNAConfig, device=None):
    """The JAX package's parameters (numpy leaves) as the port's tree."""
    return tree_from_jax(tree, device)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def forward(params, cfg: PNAConfig, g: GraphBatch) -> torch.Tensor:
    x = g.node_feat
    n = g.n_nodes
    src, dst = g.edge_src, g.edge_dst
    deg = mp_segment_sum(g.edge_mask, dst, n)
    logd = torch.log1p(deg)
    amp = (logd / cfg.delta)[:, None]
    att = (cfg.delta / logd.clamp(min=1e-3))[:, None]

    for lp in params["layers"]:
        msg_in = torch.cat([gather_nodes(x, src), gather_nodes(x, dst)],
                           dim=-1)
        msg = torch.relu(msg_in @ lp["w_pre"]) * g.edge_mask[:, None]
        mean = segment_mean(msg, dst, n)
        mx = _finite_or_zero(mp_segment_max(msg, dst, n))
        mn = _finite_or_zero(mp_segment_min(msg, dst, n))
        std = segment_std(msg, dst, n)
        aggs = []
        for a in (mean, mx, mn, std):
            aggs.extend([a, a * amp, a * att])
        h = torch.cat(aggs + [x], dim=-1)
        x = torch.relu(h @ lp["w_post"])
    return x @ params["readout"]


def loss_fn(params, cfg: PNAConfig, g: GraphBatch) -> torch.Tensor:
    logits = forward(params, cfg, g)
    if g.graph_ids is not None and g.n_graphs > 1:
        # graph-level readout: mean-pool nodes per molecule
        pooled = graph_segment(logits, g.graph_ids, g.n_graphs)
        count = graph_segment(
            torch.ones_like(g.graph_ids, dtype=torch.float32), g.graph_ids,
            g.n_graphs)
        logits = pooled / count.clamp(min=1.0)[:, None]
        labels = graph_segment(g.labels, g.graph_ids, g.n_graphs, "max")
    else:
        labels = g.labels
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    return nll.mean()
