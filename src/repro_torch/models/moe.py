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
to ``torch.searchsorted(right=False)``.  The combine's
``jax.ops.segment_sum`` over each token's slots becomes a gather of the
token's ``k`` slots by the sort's inverse permutation, summed over
``k``: a fixed order with no atomic add (``index_add_`` on the card
adds in whatever order its threads meet), so a run repeats bit for bit
on the card.  No step reads a value back to the host.

``n_groups > 1`` (the JAX package's grouped dispatch, vmapped over
groups): tokens are split into equal groups and each is dispatched on
its own with a per-group capacity.  ``_dispatch`` and ``_combine`` take
the groups' leading dim as the JAX package's ``jax.vmap`` does: one
sort along the last dim, one ``searchsorted`` on ``[G, E]``, and the
gathers over the groups' rows flattened with a per-group offset.  The
dispatched rows are laid out expert-major, ``[E, G, cap, d]`` (the JAX
package's ``[G, E, cap, d]`` transposed), so each expert's product is
one batched matmul over its ``G cap`` rows: torch's broadcast of
``[G, E, cap, d] @ [E, d, f]`` would copy the weights once a group
(48 GiB for qwen3-moe-235b-a22b's 32 groups of 128 experts).

Partitioned (DTensor tokens, ``_moe_ffn_partitioned``): the JAX
package's layout, where the tokens are cut over the data axes and whole
on every ``model`` rank, and the experts are cut over ``model``, so a
``model`` rank already holds every token its experts could take (no
all-to-all).  Each rank routes its own token groups where the groups
divide the data ranks (``constrain(xg, "dp")``), else every group on
every rank (the replicated fallback, and the global route, whose
capacity and slot order span all tokens: its tokens are gathered over
the data axes).  It keeps its own experts' rows of the dispatch (a
slice), runs them against its experts' weights gathered over ``data``,
and combines its slots into a partial ``[t, d]`` that is summed over
``model`` (with the shared expert's, one all-reduce).  The router's
sums (each expert's probability mass and slot count, the squared
log-sum-exp) are summed over the data ranks' tokens before the losses
are formed, so the aux loss is the global one.  Routing and dispatch
run on local tensors (``local_map``), the router product and every
collective on DTensors (their gradients follow DTensor's rules).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _weight, cast_weight, swiglu, swiglu_init
from repro_torch.models.sharding import is_dtensor


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
        params["shared"] = swiglu_init(
            gen, d_model, f * cfg.n_shared_experts, dtype
        )
    return params


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # pad to lane multiple


def n_groups(cfg: MoEConfig, t: int) -> int:
    """Dispatch groups of ``t`` tokens: requested, shrunk to the largest
    divisor of ``t``; tiny ``t`` (decode) stays global, as in the JAX
    package."""
    g = max(1, min(cfg.n_groups, t))
    if t < 64 * cfg.n_experts:
        g = 1
    while t % g != 0:
        g -= 1
    return g


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: largest first, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_offsets(g: int, stride: int, dev) -> torch.Tensor:
    """``[G, 1]``: where each group's rows start once the groups are
    flattened, ``stride`` rows a group."""
    return (torch.arange(g, device=dev) * stride)[:, None]


def _dispatch(xg, logits, cfg: MoEConfig, cap: int, lo: int = 0,
              n: int | None = None):
    """Route ``G`` token groups at once (the JAX package's vmap of its
    ``_dispatch_group``): ``xg [G, t, d]``, float32 ``logits [G, t, E]``
    -> (``x_e [n, G, cap, d]``, the rows of experts ``lo .. lo + n``
    (all by default), expert-major, and the combine's inputs ``(dest,
    token_of_slot, slot_w, keep, flat_e, probs, inv)``, each with the
    leading group dim; ``inv`` is the position in the sorted order of
    each (token, k) slot).  All shapes static; no group sees
    another."""
    g, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    n = e if n is None else n
    dev = xg.device
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                   # [G, t, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(g, t * k)
    flat_p = top_p.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, right=False)
    pos_in_e = (torch.arange(t * k, device=dev)
                - torch.gather(seg_start, 1, sorted_e))
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))

    token_of_slot = order // k
    gather_idx = torch.full((g, e * cap + 1), t, dtype=torch.long,
                            device=dev)
    gather_idx.scatter_(1, dest, token_of_slot)
    rows = gather_idx[:, lo * cap:(lo + n) * cap] + _group_offsets(
        g, t + 1, dev)
    rows = rows.reshape(g, n, cap).transpose(0, 1)     # expert-major
    x_pad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    x_e = x_pad.reshape(g * (t + 1), d)[rows.reshape(-1)].reshape(
        n, g, cap, d)
    slot_w = torch.where(keep, torch.gather(flat_p, 1, order),
                         torch.zeros_like(flat_p))
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(t * k, device=dev).expand(g, t * k))
    return x_e, (dest, token_of_slot, slot_w, keep, flat_e, probs, inv)


def _dispatch_group(xt, logits, cfg: MoEConfig, cap: int):
    """Route one token group (the JAX package's ``_dispatch_group``):
    ``_dispatch`` of one group, without its group dim."""
    x_e, aux_in = _dispatch(xt[None], logits[None], cfg, cap)
    return x_e[:, 0], tuple(a[0] for a in aux_in)


def _combine(y_e, aux_in, t: int, cap: int, lo: int = 0):
    """``y_e [n, G, cap, d]`` (experts ``lo .. lo + n``, expert-major)
    back to ``[G t, d]``: each token's ``k`` slots, in their top-k
    order, each its expert's row weighted (a slot of another rank's
    expert, or a dropped one, reads the padded zero row), summed over
    ``k``."""
    dest, _, slot_w, keep, _, _, inv = aux_in
    n, g, _, d = y_e.shape
    k = dest.shape[1] // t
    dev = y_e.device
    y_pad = torch.cat([y_e.reshape(n * g * cap, d), y_e.new_zeros(1, d)])
    local = dest - lo * cap                      # [G, t k]: e_local cap + pos
    mine = keep & (local >= 0) & (local < n * cap)
    flat = ((local // cap) * (g * cap) + _group_offsets(g, cap, dev)
            + local % cap)
    slot_dest = torch.where(mine, flat, torch.full_like(flat, n * g * cap))
    row = torch.gather(slot_dest, 1, inv)
    w = torch.gather(slot_w, 1, inv).to(y_e.dtype)
    y_slot = y_pad[row.reshape(-1)]
    return (y_slot.reshape(g * t, k, d) * w.reshape(g * t, k, 1)).sum(1)


def _swiglu_experts(x_e, w_gate, w_up, w_down):
    """SwiGLU of each expert on its rows, ``x_e [E, ..., d]`` (one
    batched product an expert over all its rows), the weights ``[E, d,
    f]`` / ``[E, f, d]`` already in the compute type."""
    rows = x_e.reshape(x_e.shape[0], -1, x_e.shape[-1])
    gf = rows @ w_gate
    uf = rows @ w_up
    return ((F.silu(gf) * uf) @ w_down).reshape(x_e.shape)


def _experts(params, x_e, compute_dtype):
    """SwiGLU of every expert on its rows, ``x_e [E, ..., d]``."""
    return _swiglu_experts(x_e, *(_weight(params[key], compute_dtype)
                                  for key in ("w_gate", "w_up", "w_down")))


def _router_sums(logits, k: int) -> torch.Tensor:
    """``[2 E + 1]`` sums over the rows of float32 ``logits [t, E]``:
    each expert's softmax probability, each expert's top-k slots, and
    the squared log-sum-exp.  Sums of disjoint rows add up to the sums
    of all of them."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    _, top_e = _top_k(probs, k)
    count = torch.zeros(e, device=logits.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(),
                                         device=logits.device))
    z = torch.square(torch.logsumexp(logits, dim=-1)).sum()
    return torch.cat([probs.sum(dim=0), count, z[None]])


def _router_losses(sums, t: int, cfg: MoEConfig):
    """(load-balance loss, z-loss) from ``_router_sums`` over all ``t``
    tokens: the Switch loss ``E sum_e (mean prob_e x slot share_e)``
    and ``router_z_loss`` times the mean squared log-sum-exp."""
    e, k = cfg.n_experts, cfg.top_k
    me = sums[:e] / t
    ce = sums[e:2 * e] / (t * k)
    return e * torch.sum(me * ce), cfg.router_z_loss * (sums[2 * e] / t)


def moe_ffn(params, x, cfg: MoEConfig, compute_dtype=torch.bfloat16):
    """x: [..., d]; flattened internally.  Returns (y, aux) where aux
    carries the load-balance and router-z losses.  A DTensor ``x`` takes
    ``_moe_ffn_partitioned``."""
    if is_dtensor(x):
        return _moe_ffn_partitioned(params, x, cfg, compute_dtype)
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d).to(compute_dtype)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    g = n_groups(cfg, t)
    tg = t // g
    cap = capacity(cfg, tg)

    logits = (xt @ cast_weight(params["router"], compute_dtype)).float()
    x_e, aux_in = _dispatch(xt.reshape(g, tg, d), logits.reshape(g, tg, e),
                            cfg, cap)
    y = _combine(_experts(params, x_e, compute_dtype), aux_in, tg, cap)

    if cfg.n_shared_experts:
        y = y + swiglu(params["shared"], xt, compute_dtype)

    lb_loss, z_loss = _router_losses(_router_sums(logits, k), t, cfg)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss}
    return y.reshape(orig_shape).to(x.dtype), aux


# --------------------------------------------------------------------------
# partitioned
# --------------------------------------------------------------------------

def own_groups(g: int, rows: int) -> int | None:
    """The groups each of ``rows`` data ranks routes on its own tokens:
    ``g / rows`` where ``rows`` divides ``g`` (the JAX package's
    ``constrain(xg, "dp", ...)``), else None: every rank routes all
    ``g`` groups on the tokens gathered over the data axes (its
    replicated fallback; the global route's one group, whose capacity
    and slot order span every token, is one such)."""
    return g // rows if g % rows == 0 else None


def expert_range(w, mesh) -> tuple[int, int, int | None]:
    """``(first expert, experts, mesh dim)`` this rank holds of DTensor
    expert weight ``w [E, ...]``: the slice its ``Shard(0)`` placement
    gives it, and the mesh dim that cuts the experts (None where no
    dim does: every rank holds them all)."""
    from repro_torch.models.sharding import local_box

    cut = [i for i, p in enumerate(w.placements) if p.is_shard(0)]
    (n, *_), (lo, *_) = local_box(w.shape, mesh, w.placements)
    return lo, n, (cut[0] if cut else None)


def partitioned_router_losses(sums, t: int, cfg: MoEConfig):
    """``_router_losses`` of the router's sums, a DTensor ``Partial`` over
    the data ranks that cut the tokens: summed over them first (one
    all-reduce of ``2 E + 1`` floats), so both losses are the global
    ones, replicated."""
    from torch.distributed.tensor import Replicate

    mesh = sums.device_mesh
    sums = sums.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return _router_losses(sums, t, cfg)


def _moe_ffn_partitioned(params, x, cfg: MoEConfig, compute_dtype):
    """``moe_ffn`` of DTensor tokens ``x [..., d]`` (cut over the data
    axes or whole, whole over ``model``): see the module docstring."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.sharding import constrain, local_box

    x = constrain(x, "dp", *(None,) * (x.dim() - 1))
    mesh = x.device_mesh
    orig_shape = x.shape
    d = x.shape[-1]
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, d).to(compute_dtype)
    t = xt.shape[0]
    g = n_groups(cfg, t)

    # the mesh dims that cut the tokens (the data axes, where the batch
    # divides), and this rank's token rows
    row_dims = [i for i, p in enumerate(xt.placements) if p.is_shard(0)]
    rows = math.prod(mesh.size(i) for i in row_dims)
    (t_own, _), (row_lo, _) = local_box(xt.shape, mesh, xt.placements)
    g_own = own_groups(g, rows)
    if g_own is None:  # every group on every rank: the tokens gathered
        x_route = xt.redistribute(mesh, tuple(
            Replicate() if i in row_dims else p
            for i, p in enumerate(xt.placements)))
    else:
        x_route = xt
    routed = tuple(x_route.placements)
    logits = (x_route @ _weight(params["router"], compute_dtype)).float()

    weights = [_weight(params[key], compute_dtype)
               for key in ("w_gate", "w_up", "w_down")]
    lo, n_local, expert_dim = expert_range(weights[0], mesh)
    w_pl = tuple(Shard(0) if i == expert_dim else Replicate()
                 for i in range(mesh.ndim))
    weights = [w.redistribute(mesh, w_pl) for w in weights]

    def cut(i, shard, whole):
        """A placement on mesh dim ``i``: ``shard`` on the dims that cut
        the tokens, ``whole`` on the one that cuts the experts."""
        if i in row_dims:
            return shard
        return whole if i == expert_dim else Replicate()

    gathered = g_own is None
    n_dims = range(mesh.ndim)
    # what this rank's result is of the layer's: its own rows, and a
    # partial sum over the experts' dim
    y_pl = tuple(cut(i, Shard(0), Partial()) for i in n_dims)
    # the gradients the body gives: of its own rows (or a partial sum
    # over the data ranks, where it routed gathered tokens), partial
    # over the experts' dim; the weights' partial over the data ranks
    row_grad = Partial() if gathered else Shard(0)
    route_grad = tuple(cut(i, row_grad, Partial()) for i in n_dims)
    w_grad = tuple(cut(i, Partial(), Shard(0)) for i in n_dims)

    def experts_body(x_l, lg_l, wg, wu, wd):
        t_r = x_l.shape[0]
        g_r = g if gathered else g_own
        tg = t_r // g_r
        cap = capacity(cfg, tg)
        x_e, aux_in = _dispatch(x_l.reshape(g_r, tg, d),
                                lg_l.reshape(g_r, tg, e), cfg, cap,
                                lo, n_local)
        y = _combine(_swiglu_experts(x_e, wg, wu, wd), aux_in, tg, cap, lo)
        return y[row_lo:row_lo + t_own] if gathered else y

    y = local_map(
        experts_body, out_placements=list(y_pl),
        in_placements=(routed, routed, w_pl, w_pl, w_pl),
        in_grad_placements=(route_grad, route_grad, w_grad, w_grad,
                            w_grad),
        device_mesh=mesh)(x_route, logits, *weights)

    if cfg.n_shared_experts:
        # a partial sum over 'model' too: one all-reduce for both
        y = y + swiglu(params["shared"], xt, compute_dtype)
    y = y.redistribute(mesh, tuple(xt.placements))

    def sums_body(lg_l):
        own = lg_l[row_lo:row_lo + t_own] if gathered else lg_l
        return _router_sums(own, k)

    # each rank's sums over its own rows: partial over the data ranks
    sums = local_map(sums_body, out_placements=[
        cut(i, Partial(), Replicate()) for i in n_dims],
        in_placements=(routed,),
        in_grad_placements=(tuple(cut(i, row_grad, Replicate())
                                  for i in n_dims),),
        device_mesh=mesh)(logits)
    lb_loss, z_loss = partitioned_router_losses(sums, t, cfg)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss}
    return y.reshape(orig_shape).to(x.dtype), aux
