"""Edge-sharded GNN training: the MESH replicated backend applied to the
GNN family, the counterpart of the JAX package's
``repro.launch.gnn_sharded`` over a ``torch.distributed`` group.

* Edge arrays (``GraphBatch.EDGE_FIELDS``) are cut into one contiguous
  shard a rank;
* node arrays and parameters are replicated;
* every message-passing reduction computes this rank's partial and
  merges it with ``all_reduce`` (SUM / MAX / MIN) through
  ``sparse.edge_sharded``, the semantics of the hypergraph engine's
  replicated backend.

Gradients: the JAX package differentiates through ``shard_map``, whose
transpose inserts the cross-shard sums.  Here each rank back-propagates
``loss / world``: the merges' backward all-reduce their cotangents (so
each edge shard's part of a gradient sees the whole cotangent of the
merged value), and one ``all_reduce`` of the gradients afterwards sums
the ranks' edge parts and the world copies of the node-side part
(a world-th each), which gives the unsharded loss's gradient.

Per rank: O(E/P x hidden + N x hidden) memory; collectives: the merges
(one forward, one backward a reduction) and the gradients' one.  The
JAX package holds its step to the sum-aggregation models; here the max /
min merges split a tied cotangent among the tied rows of every rank, so
PNA's sharded step equals its plain step too.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.sparse.segment import edge_sharded
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.step import TrainState
from repro_torch.train.tree import leaves


def edge_shard(g: GraphBatch, rank: int, world: int) -> GraphBatch:
    """Rank ``rank``'s contiguous share of ``g``'s edges (views; the
    first ``E % world`` ranks take one edge more)."""
    e = g.edge_src.shape[0]
    lo = rank * (e // world) + min(rank, e % world)
    hi = lo + e // world + (rank < e % world)
    return dataclasses.replace(
        g, **{f: getattr(g, f)[lo:hi] for f in GraphBatch.EDGE_FIELDS})


def make_edge_sharded_step(mod, cfg, group=None,
                           opt_cfg: AdamWConfig | None = None):
    """Returns ``step(state, batch) -> (state, metrics)`` for the GNN
    module ``mod`` (``gat``, ``pna`` or ``equivariant``): the full
    ``batch`` on every rank of ``group`` (``None``: the default group),
    its edges sharded here.  Updates the state in place with
    ``adamw_update``, as ``train.make_train_step`` does; the metrics are
    0-d tensors (the loss is the same on every rank)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if group is None:
        group = dist.group.WORLD

    def step(state: TrainState, batch: GraphBatch):
        world = dist.get_world_size(group)
        local = edge_shard(batch, dist.get_rank(group), world)
        p_leaves = leaves(state.params)
        for p in p_leaves:
            p.grad = None
        with edge_sharded(group):
            loss = mod.loss_fn(state.params, cfg, local)
            (loss / world).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in p_leaves]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        grads = [f.view_as(g) for f, g in
                 zip(flat.split([g.numel() for g in grads]), grads)]
        _, opt_state, opt_metrics = adamw_update(opt_cfg, grads,
                                                 state.opt_state,
                                                 state.params)
        for p in p_leaves:
            p.grad = None
        return TrainState(state.params, opt_state), {
            "loss": loss.detach(), **opt_metrics}

    return step
