"""Mixture-of-Experts FFN with sort-based capacity dispatch, the
counterpart of the JAX package's ``repro.models.moe``, in stock torch
(the JAX package computes it outside any Pallas kernel).

Top-k routing -> flatten (token, k) slots -> stable argsort by expert ->
each expert owns a padded ``[capacity, d]`` block -> batched expert
products -> weighted combine back by slot.  Slots beyond capacity are
dropped (GShard/Switch semantics) into slot ``E * capacity``, which
gathers the padded zero row.

The JAX package's primitives map one to one: ``jnp.argsort`` (stable)
to ``torch.argsort(stable=True)``; ``jax.lax.top_k`` (ties to the lower
index) to a stable descending sort; ``jnp.searchsorted(side="left")``
to ``torch.searchsorted(right=False)``; ``jax.ops.segment_sum`` to
``index_add_``.  No step reads a value back to the host.

``n_groups > 1`` (the JAX package's grouped dispatch, vmapped over
groups): tokens are split into equal groups and each is dispatched on
its own with a per-group capacity; here the groups run in a Python loop
and the expert products over all groups at once.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cast_weight


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    n_shared_experts: int = 0      # always-on experts (llama4-style)
    router_z_loss: float = 1e-3
    n_groups: int = 1              # dispatch groups (see module docstring)


def moe_init(gen: torch.Generator, cfg: MoEConfig, d_model: int,
             dtype=torch.float32):
    e, f = cfg.n_experts, cfg.d_ff
    s_in = d_model**-0.5
    s_out = f**-0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dtype)

    params = {
        "router": normal((d_model, e), s_in),
        "w_gate": normal((e, d_model, f), s_in),
        "w_up": normal((e, d_model, f), s_in),
        "w_down": normal((e, f, d_model), s_out),
    }
    if cfg.n_shared_experts:
        from repro_torch.models.layers import swiglu_init

        params["shared"] = swiglu_init(
            gen, d_model, f * cfg.n_shared_experts, dtype
        )
    return params


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # pad to lane multiple


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: largest first, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(xt, logits, cfg: MoEConfig, cap: int):
    """Route one token group: returns (x_e [E, cap, d], the combine's
    inputs).  All shapes static; no cross-group interaction."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                   # [t, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                        # [t*k]
    flat_p = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = torch.arange(sorted_e.numel(), device=dev)
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                                   right=False)
    pos_in_e = pos_in_e - seg_start[sorted_e]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))

    token_of_slot = order // k
    gather_idx = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    gather_idx[dest] = token_of_slot
    gather_idx = gather_idx[: e * cap]
    x_pad = torch.cat([xt, xt.new_zeros(1, d)], dim=0)
    x_e = x_pad[gather_idx].reshape(e, cap, d)
    slot_w = torch.where(keep, flat_p[order], torch.zeros_like(flat_p))
    return x_e, (dest, token_of_slot, slot_w, keep, flat_e, probs)


def _combine_group(y_e, aux_in, t: int, cap: int, e: int):
    dest, token_of_slot, slot_w, keep, _, _ = aux_in
    d = y_e.shape[-1]
    y_flat = y_e.reshape(e * cap, d)
    y_pad = torch.cat([y_flat, y_flat.new_zeros(1, d)], dim=0)
    slot_dest = torch.where(keep, dest, torch.full_like(dest, e * cap))
    y_slot = y_pad[slot_dest] * slot_w[:, None].to(y_e.dtype)
    return y_slot.new_zeros(t, d).index_add_(0, token_of_slot, y_slot)


def _experts(params, x_e, compute_dtype):
    """SwiGLU of every expert on its ``[..., E, cap, d]`` block."""
    w_gate = cast_weight(params["w_gate"], compute_dtype)
    w_up = cast_weight(params["w_up"], compute_dtype)
    w_down = cast_weight(params["w_down"], compute_dtype)
    gf = x_e @ w_gate
    uf = x_e @ w_up
    return (F.silu(gf) * uf) @ w_down


def moe_ffn(params, x, cfg: MoEConfig, compute_dtype=torch.bfloat16):
    """x: [..., d]; flattened internally.  Returns (y, aux) where aux
    carries the load-balance and router-z losses."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d).to(compute_dtype)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k

    # group count: requested, shrunk to the largest divisor of t; tiny
    # T (decode) stays global, as in the JAX package.
    g = max(1, min(cfg.n_groups, t))
    if t < 64 * cfg.n_experts:
        g = 1
    while t % g != 0:
        g -= 1
    tg = t // g
    cap = capacity(cfg, tg)

    logits = (xt @ cast_weight(params["router"], compute_dtype)).float()

    if g == 1:
        x_e, aux_in = _dispatch_group(xt, logits, cfg, cap)
        y_e = _experts(params, x_e, compute_dtype)
        y = _combine_group(y_e, aux_in, t, cap, e)
        flat_e = aux_in[4]
        probs = aux_in[5]
    else:
        xg = xt.reshape(g, tg, d)
        lg = logits.reshape(g, tg, e)
        routed = [_dispatch_group(xg[i], lg[i], cfg, cap) for i in range(g)]
        x_e = torch.stack([r[0] for r in routed])      # [G, E, cap, d]
        y_e = _experts(params, x_e, compute_dtype)
        y = torch.cat([_combine_group(y_e[i], routed[i][1], tg, cap, e)
                       for i in range(g)])
        flat_e = torch.cat([r[1][4] for r in routed])
        probs = torch.cat([r[1][5] for r in routed])

    if cfg.n_shared_experts:
        from repro_torch.models.layers import swiglu

        y = y + swiglu(params["shared"], xt, compute_dtype)

    # Switch load-balance loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, device=x.device).index_add_(
        0, flat_e, torch.ones(flat_e.numel(), device=x.device)
    ) / (t * k)
    lb_loss = e * torch.sum(me * ce)
    z_loss = cfg.router_z_loss * torch.mean(
        torch.square(torch.logsumexp(logits.reshape(-1, e), dim=-1))
    )
    aux = {"lb_loss": lb_loss, "z_loss": z_loss}
    return y.reshape(orig_shape).to(x.dtype), aux
