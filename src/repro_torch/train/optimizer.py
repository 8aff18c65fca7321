"""AdamW on the port's parameter trees, the counterpart of the JAX
package's ``repro.train.optimizer`` (no optax there, no ``torch.optim``
here).

Float32 moments whatever the parameters' type; decoupled weight decay;
global-norm gradient clipping; linear warmup then cosine decay, with the
JAX package's numbers.  Where the JAX package returns new trees, the
port updates the parameters, the moments and the step in place under
``torch.no_grad()`` (moving each parameter's version counter, which
drops its kept compute-type cast).  ``grad_norm`` and ``lr`` come back
as 0-d tensors on the parameters' device: nothing is read to the host.

A tree is a ``ParamTree``, a dict, a list or a tuple of tensors (see
``train.tree``; a gradient list in the parameters' leaf order will do
for ``grads``).  Leaves may be DTensors (a partitioned state): the
update then runs on each rank's own shards, and ``global_norm`` is one
replicated scalar from one all-reduce per mesh dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.sharding import is_dtensor
from repro_torch.train.tree import leaves, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def zeros_like_tree(tree):
    """A tree of ``tree``'s structure with float32 zeros on its devices
    and no gradient: a ``ParamTree`` for a ``ParamTree``; a DTensor's
    zeros in its placements."""
    return unflatten(tree, [
        torch.zeros_like(t, dtype=torch.float32).detach() if is_dtensor(t)
        else torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for t in leaves(tree)])


def adamw_init(params: Params):
    """``{"mu", "nu"}``: float32 zeros in ``params``' structure, and
    ``"step"``: a 0-d int32 zero, on the parameters' device (replicated
    on their mesh, for DTensor parameters)."""
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)
    return {
        "mu": zeros_like_tree(params),
        "nu": zeros_like_tree(params),
        "step": step,
    }


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then cosine decay to 10% of
    ``lr`` at ``total_steps``; ``step`` an int or a tensor, the result a
    0-d float32 tensor (on the step's device)."""
    s = (step.to(torch.float32) if isinstance(step, torch.Tensor)
         else torch.tensor(step, dtype=torch.float32))
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of every tensor of ``tree`` together.  Of
    DTensor leaves: each rank sums the squares of its own shards, a
    leaf's replicated copies weighted by one over their count (a power
    of two on the production meshes: exact), and the sum is all-reduced
    once per mesh dim into one replicated scalar; no host read."""
    xs = leaves(tree)
    if not any(is_dtensor(x) for x in xs):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in xs))
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = next(x for x in xs if is_dtensor(x)).device_mesh
    total = None
    for x in xs:
        local = x.to_local() if is_dtensor(x) else x
        sq = torch.sum(torch.square(local.float()))
        copies = (math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                            if not p.is_shard())
                  if is_dtensor(x) else mesh.size())
        if copies > 1:
            sq = sq / copies
        total = sq if total is None else total + sq
    total = DTensor.from_local(total, mesh, (Partial(),) * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.redistribute(mesh, (Replicate(),) * mesh.ndim))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step, in place: ``grads`` in ``params``' structure (or the
    list of its leaves' gradients), clipped to a global norm of
    ``grad_clip``, the step counted, the float32 moments and the
    parameters updated with bias correction and decoupled weight decay.
    Returns ``(params, opt_state, {"grad_norm", "lr"})``."""
    step = opt_state["step"]
    step.add_(1)
    g_leaves = leaves(grads)
    gnorm = global_norm(g_leaves)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for p, g, mu, nu in zip(leaves(params), g_leaves,
                            leaves(opt_state["mu"]),
                            leaves(opt_state["nu"])):
        g = g.float() * clip
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * torch.square(g))
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
