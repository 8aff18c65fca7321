"""NequIP (arXiv:2101.03164) and MACE (arXiv:2206.07697), the
counterpart of the JAX package's ``repro.models.gnn.equivariant``:
E(3)-equivariant interatomic potentials on the irrep tensor-product
regime.

Features are dicts ``{l: [N, C, 2l+1]}``; message passing is gather ->
(CG tensor product with the edge spherical harmonics, weighted by the
radial MLP) -> segment sum, one ``mp_segment_sum`` of ``[E, C, 2l3+1]``
a CG path (15 paths at ``l_max = 2``: up to 15 K2a launches a layer on
the card).  MACE adds the many-body expansion: its A-basis (one message
pass) is self-coupled ``correlation_order - 1`` times through CG
products on the nodes.

Node rows reach the edges through ``sparse.gather.gather_nodes``, the
species through ``take_local``, the CG products run on each rank's own
rows (``models.sharding.rows_einsum``), the per-molecule energies fold
through ``sparse.graph_segment``, and zero features are made as the
graph's arrays are laid out, so a graph of DTensors (a partitioned
cell) runs on each rank's own edges and nodes.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.models.gnn.irreps import (
    allowed_paths,
    bessel_basis,
    real_cg,
    sph_harm,
)
from repro_torch.models.params import normal, tree_from_jax
from repro_torch.models.sharding import rows_einsum, zeros_like_rows
from repro_torch.sparse.gather import gather_nodes, take_local
from repro_torch.sparse.segment import graph_segment, mp_segment_sum


@dataclasses.dataclass(frozen=True)
class EquivariantConfig:
    name: str = "nequip"
    kind: str = "nequip"           # nequip | mace
    n_layers: int = 5
    d_hidden: int = 32             # channels per irrep order
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    correlation_order: int = 1     # mace: 3
    n_species: int = 8
    radial_hidden: int = 64


def _paths(cfg: EquivariantConfig):
    return allowed_paths(cfg.l_max)


@lru_cache(maxsize=None)
def _cg_const(l1: int, l2: int, l3: int, device: torch.device,
              dtype: torch.dtype = torch.float32):
    """The CG table in ``dtype`` (the weights' type: float32) on
    ``device``, made once per device and type."""
    return torch.from_numpy(np.asarray(real_cg(l1, l2, l3))).to(
        device=device, dtype=dtype)


def init_params(gen: torch.Generator, cfg: EquivariantConfig):
    """Random float32 weights drawn from ``gen``, in the JAX package's
    shapes and scales."""
    paths = _paths(cfg)
    c = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            # radial MLP: n_rbf -> hidden -> (n_paths * C) weights
            "radial_w1": normal(gen, (cfg.n_rbf, cfg.radial_hidden),
                                cfg.n_rbf**-0.5),
            "radial_w2": normal(gen, (cfg.radial_hidden, len(paths) * c),
                                cfg.radial_hidden**-0.5),
            # per-l linear channel mixers for aggregated messages & self
            "mix_msg": {str(l): normal(gen, (c, c), c**-0.5)
                        for l in range(cfg.l_max + 1)},
            "mix_self": {str(l): normal(gen, (c, c), c**-0.5)
                         for l in range(cfg.l_max + 1)},
            # gate scalars for the l > 0 nonlinearity
            "gate": normal(gen, (c, cfg.l_max * c), c**-0.5),
        }
        if cfg.kind == "mace" and cfg.correlation_order > 1:
            # per-order, per-path contraction weights
            lp["corr_w"] = [
                {f"{l1}_{l2}_{l3}": normal(gen, (c,), 0.1)
                 for (l1, l2, l3) in paths}
                for _ in range(2, cfg.correlation_order + 1)
            ]
        layers.append(lp)
    return {
        "species_embed": normal(gen, (cfg.n_species, c), 1.0),
        "layers": layers,
        "readout": normal(gen, (c, 1), c**-0.5),
    }


def params_from_jax(tree, cfg: EquivariantConfig, device=None):
    """The JAX package's parameters (numpy leaves) as the port's tree."""
    return tree_from_jax(tree, device)


def _tensor_product_msg(cfg, lp, feats, g, sh, radial):
    """One message pass: for each CG path, couple source features (l1)
    with the edge SH (l2) into destination irrep l3, weighted by the
    radial MLP, and sum by destination."""
    paths = _paths(cfg)
    c = cfg.d_hidden
    n = g.n_nodes
    w = F.silu(radial @ lp["radial_w1"]) @ lp["radial_w2"]
    w = w.reshape(-1, len(paths), c) * g.edge_mask[:, None, None]
    src = {l: gather_nodes(feats[l], g.edge_src)
           for l in feats}                             # [E, C, 2l+1]
    out = {str(l): zeros_like_rows(feats["0"], (n, c, 2 * l + 1), w.dtype)
           for l in range(cfg.l_max + 1)}
    for pi, (l1, l2, l3) in enumerate(paths):
        cg = _cg_const(l1, l2, l3, w.device, w.dtype)
        msg = rows_einsum("eci,ej,ijk->eck", src[str(l1)], sh[str(l2)],
                          cg) * w[:, pi, :, None]
        out[str(l3)] = out[str(l3)] + mp_segment_sum(msg, g.edge_dst, n)
    return out


def _self_product(cfg, lp, a_basis):
    """MACE's many-body contraction: couple the A-basis with itself
    ``correlation_order - 1`` times through CG paths."""
    paths = _paths(cfg)
    current = a_basis
    total = dict(a_basis)
    for order_idx in range(cfg.correlation_order - 1):
        weights = lp["corr_w"][order_idx]
        nxt = {str(l): torch.zeros_like(a_basis[str(l)])
               for l in range(cfg.l_max + 1)}
        for (l1, l2, l3) in paths:
            cg = _cg_const(l1, l2, l3, a_basis["0"].device,
                           a_basis["0"].dtype)
            prod = rows_einsum(
                "nci,ncj,ijk->nck", current[str(l1)], a_basis[str(l2)], cg,
            ) * weights[f"{l1}_{l2}_{l3}"][None, :, None]
            nxt[str(l3)] = nxt[str(l3)] + prod
        current = nxt
        for l in nxt:
            total[l] = total[l] + nxt[l]
    return total


def _update(cfg, lp, feats, msgs):
    """Self-interaction + message mix + gated nonlinearity (equivariant:
    the linear maps act on channels only; l > 0 gated by the sigmoid of
    scalar gates)."""
    c = cfg.d_hidden
    new = {}
    scalars = torch.einsum("nci,cd->ndi", msgs["0"], lp["mix_msg"]["0"]) + (
        torch.einsum("nci,cd->ndi", feats["0"], lp["mix_self"]["0"]))
    new["0"] = F.silu(scalars)
    if cfg.l_max > 0:
        gates = torch.sigmoid(
            (new["0"][..., 0] @ lp["gate"]).reshape(-1, cfg.l_max, c))
    for l in range(1, cfg.l_max + 1):
        mixed = torch.einsum(
            "nci,cd->ndi", msgs[str(l)], lp["mix_msg"][str(l)]
        ) + torch.einsum(
            "nci,cd->ndi", feats[str(l)], lp["mix_self"][str(l)])
        new[str(l)] = mixed * gates[:, l - 1, :, None]
    return new


def forward(params, cfg: EquivariantConfig, g: GraphBatch) -> torch.Tensor:
    """Returns per-graph energies ``[n_graphs]``."""
    n = g.n_nodes
    c = cfg.d_hidden
    rel = (gather_nodes(g.positions, g.edge_src)
           - gather_nodes(g.positions, g.edge_dst))
    dist = torch.sqrt(torch.sum(rel**2, -1).clamp(min=1e-12))
    unit = rel / dist[:, None]
    sh = {str(l): sph_harm(l, unit) for l in range(cfg.l_max + 1)}
    radial = bessel_basis(dist, cfg.n_rbf, cfg.cutoff)

    dt = params["species_embed"].dtype
    feats = {"0": take_local(params["species_embed"], g.species)[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[str(l)] = zeros_like_rows(g.positions, (n, c, 2 * l + 1), dt)

    site_energy = zeros_like_rows(g.positions, (n,), dt)
    for lp in params["layers"]:
        msgs = _tensor_product_msg(cfg, lp, feats, g, sh, radial)
        if cfg.kind == "mace" and cfg.correlation_order > 1:
            msgs = _self_product(cfg, lp, msgs)
        feats = _update(cfg, lp, feats, msgs)
        # per-layer readout (MACE-style; harmless for NequIP)
        site_energy = site_energy + (feats["0"][..., 0]
                                     @ params["readout"])[:, 0]

    if g.node_mask is not None:
        site_energy = site_energy * g.node_mask
    if g.graph_ids is not None and g.n_graphs > 1:
        return graph_segment(site_energy, g.graph_ids, g.n_graphs)
    return site_energy.sum()[None]


def loss_fn(params, cfg: EquivariantConfig, g: GraphBatch) -> torch.Tensor:
    """Energy MSE (labels: a per-graph scalar target)."""
    energy = forward(params, cfg, g)
    target = g.labels.float()
    if target.dim() == 1 and target.shape[0] != energy.shape[0]:
        target = torch.zeros_like(energy)
    return torch.mean(torch.square(energy - target))


def forces(params, cfg: EquivariantConfig, g: GraphBatch) -> torch.Tensor:
    """F = -dE/dpositions through autograd (through K2a's gradient on
    the card); equivariant by construction since E is invariant."""
    pos = g.positions.detach().requires_grad_(True)
    energy = forward(params, cfg, dataclasses.replace(g, positions=pos))
    (grad,) = torch.autograd.grad(energy.sum(), pos)
    return -grad
