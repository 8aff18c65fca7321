"""Train-step factory, the counterpart of the JAX package's
``repro.train.step``: ``loss_fn(params, batch) -> scalar`` becomes
``step(state, batch) -> (state, metrics)``.

Gradient (micro-batch) accumulation: the batch is cut into
``accum_steps`` micro-batches on dim 0 of every leaf; each one's
``loss.backward()`` adds its gradients into the float32 masters'
``.grad`` (the JAX package's sum through ``lax.scan``), then the sum and
the loss are divided by ``accum_steps``.  The step updates the state in
place (``adamw_update``) and returns it; its metrics are 0-d tensors
(nothing is read to the host).

A partitioned state (DTensor parameters and moments) and batch take the
same step: the gradients accumulate into DTensor ``.grad``s and are
laid out as their parameters before the update.  A partitioned
micro-batch holds the JAX package's contiguous rows ``x[i n:(i + 1)
n]`` (``_micro_batches``): the batch's leaves (token ids, labels, a
mask: no activation) are gathered once and each rank keeps its shard of
each micro-batch.  Other rows would change the loss wherever it sees
the grouping: a masked batch averages each micro-batch over its own
mask count, and a MoE LM's load-balance loss is a product of two means
over each micro-batch's tokens.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.sharding import is_dtensor
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.tree import leaves


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def init_train_state(params) -> TrainState:
    """Turns on every parameter's gradient and zeroes the moments and the
    step."""
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=adamw_init(params))


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    opt_cfg: AdamWConfig = AdamWConfig(),
    accum_steps: int = 1,
):
    """``loss_fn(params, batch) -> scalar``; the batch (a dict of tensors)
    micro-batched on dim 0 of every leaf when ``accum_steps > 1``."""

    def train_step(state: TrainState, batch):
        params = state.params
        p_leaves = leaves(params)
        for p in p_leaves:
            p.grad = None
        micro = [batch] if accum_steps == 1 else _micro_batches(
            batch, accum_steps)
        loss = None
        for mb in micro:
            mb_loss = loss_fn(params, mb)
            mb_loss.backward()
            mb_loss = mb_loss.detach().float()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = [_laid_out_as(p.grad, p) if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for p in p_leaves]
        if accum_steps > 1:
            loss = loss / accum_steps
            for g in grads:
                g.div_(accum_steps)
        _, opt_state, opt_metrics = adamw_update(opt_cfg, grads,
                                                 state.opt_state, params)
        for p in p_leaves:
            p.grad = None
        return TrainState(params, opt_state), {"loss": loss, **opt_metrics}

    return train_step


def _micro_batches(batch: dict, n: int) -> list[dict]:
    """``batch`` cut into ``n`` micro-batches of contiguous rows on dim 0
    (a partitioned batch: see the module's docstring)."""
    from repro_torch.models.sharding import distribute

    whole = {key: x.full_tensor() if is_dtensor(x) else x
             for key, x in batch.items()}
    m = next(iter(whole.values())).shape[0] // n
    return [{key: distribute(x[i * m:(i + 1) * m], batch[key].device_mesh,
                             batch[key].placements)
             if is_dtensor(batch[key]) else x[i * m:(i + 1) * m]
             for key, x in whole.items()} for i in range(n)]


def _laid_out_as(g, p):
    """Gradient ``g`` in parameter ``p``'s placements (a DTensor gradient
    may come out ``Partial`` or laid out otherwise)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def train_state_from_jax(state, cfg, device=None,
                         params_from_jax=None) -> TrainState:
    """The JAX package's ``TrainState`` (its leaves as numpy arrays,
    ``jax.tree.map(np.asarray, state)``) as the port's on ``device``: the
    parameters and both moments through the model family's
    ``params_from_jax(tree, cfg, device)`` (the transformer's unless
    given: a GNN module's for a GNN state; the moments share the
    parameters' tree), the step as a 0-d int32 tensor, gradients on."""
    from repro_torch.core.device import resolve_device

    if params_from_jax is None:
        from repro_torch.models.transformer import params_from_jax

    dev = resolve_device(device)
    opt = state.opt_state if hasattr(state, "opt_state") else state[1]
    params = params_from_jax(state[0], cfg, dev)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, {
        "mu": params_from_jax(opt["mu"], cfg, dev),
        "nu": params_from_jax(opt["nu"], cfg, dev),
        "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                             device=dev),
    })
