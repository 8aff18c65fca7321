"""Shared neural layers (plain torch), the counterpart of the JAX
package's ``repro.models.layers``.

Parameters are nested dict-likes of float32 tensors (the port's
``ParamTree`` modules, or plain dicts); every ``*_init`` takes an
explicit ``torch.Generator`` and draws on its device.  Compute is
bfloat16 by default against float32 master weights, as in the JAX
package, with its numerics: ``rmsnorm`` / ``layernorm`` in float32 with
eps 1e-6, ``rope``'s angles in float32, cross entropy in float32.

``dense``, ``swiglu`` and ``unembed`` read each weight in the compute
type through ``cast_weight``.  Without a gradient (serving) the cast is
made once and kept on the weight (the same bits as the JAX package's
per-call ``astype``) until the weight changes in place (its version
counter) or is replaced: a decode step then reads the bfloat16 copies
(2 bytes a weight), not the float32 masters plus a cast (4 + 2 + 2).
While a gradient is being taken of the weight (training), each call
casts afresh, differentiably, as ``astype`` does, and keeps nothing; the
optimizer's in-place update moves the version counter, so no kept cast
outlives a step.

Under DTensor placements (the partitioned LM, ``models.sharding``) the
same functions take DTensors: a kept cast is a DTensor keyed by the
master DTensor's own version counter; ``rope`` runs on each rank's own
shard (``local_map``); ``embed`` and the fused cross entropy are
vocab-parallel over the ``model`` axis that shards the table's vocab
(``_embed_partitioned``, ``_vocab_parallel_ce``): no rank gathers the
vocab or a chunk's ``[B, chunk, V]`` logits.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.sharding import (all_reduce_over, is_dtensor,
                                         local_offset, mesh_dims_sharding)
from repro_torch.sparse.gather import take_rows

Params = Any

DEFAULT_COMPUTE_DTYPE = torch.bfloat16


def cast_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``.  While a gradient is being taken of ``w``, a
    fresh differentiable cast, kept nowhere; otherwise the cast kept on
    the weight, remade when the weight's version counter moves (an
    in-place change) or ``dtype`` differs from the kept one's."""
    if w.dtype == dtype:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(dtype)
    key = (dtype, w._version)
    kept = getattr(w, "_compute_cast", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    out = w.detach().to(dtype)
    w._compute_cast = (key, out)
    return out


def gather_fsdp(w):
    """A DTensor weight made whole over the data axes (``pod``, ``data``:
    FSDP's all-gather before a use; its gradient comes back as a
    reduce-scatter) and left cut over ``model`` (tensor parallel), so
    the product is the Megatron column- or row-parallel one; any other
    tensor itself."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def _weight(w, dtype):
    """``w`` in ``dtype`` (``cast_weight``) and whole over the data axes
    (``gather_fsdp``: the cast is gathered, half a float32's bytes)."""
    return gather_fsdp(cast_weight(w, dtype))


def release_casts(params) -> None:
    """Drop the kept compute-type casts of every weight in ``params``
    (an ``nn.Module``); the next call casts again."""
    for p in params.parameters():
        if hasattr(p, "_compute_cast"):
            del p._compute_cast


class ParamTree(torch.nn.Module):
    """A nested dict of weights as an ``nn.Module``: a tensor becomes a
    registered ``Parameter`` (with no gradient, as serving needs:
    ``train.init_train_state`` turns gradients on), a dict a child
    ``ParamTree`` and a list or tuple an ``nn.ModuleList`` of them.
    ``tree["key"]`` reads a child as the JAX package's functions read
    their parameter pytrees, and ``.to()``, ``state_dict()`` and
    ``parameters()`` work as on any module."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, torch.nn.ModuleList(
                    ParamTree(x) for x in val))
            else:
                self.register_parameter(key, torch.nn.Parameter(
                    val, requires_grad=False))

    def __getitem__(self, key):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32):
    return {"w": _normal(gen, (d_in, d_out), d_in**-0.5, dtype)}


def dense(params, x, compute_dtype=DEFAULT_COMPUTE_DTYPE):
    """``...d,df->...f`` in ``compute_dtype``."""
    return x.to(compute_dtype) @ _weight(params["w"], compute_dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    s_in = d_model**-0.5
    s_out = d_ff**-0.5
    return {
        "w_gate": _normal(gen, (d_model, d_ff), s_in, dtype),
        "w_up": _normal(gen, (d_model, d_ff), s_in, dtype),
        "w_down": _normal(gen, (d_ff, d_model), s_out, dtype),
    }


def swiglu(params, x, compute_dtype=DEFAULT_COMPUTE_DTYPE):
    from repro_torch.models.sharding import constrain

    x = x.to(compute_dtype)
    g = x @ _weight(params["w_gate"], compute_dtype)
    u = x @ _weight(params["w_up"], compute_dtype)
    tp_spec = ("dp",) + (None,) * (x.dim() - 2) + ("tp",)
    h = constrain(F.silu(g) * u, *tp_spec)
    return h @ _weight(params["w_down"], compute_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Rotary position embedding, angles in float32 as the JAX package.

    x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq].
    A DTensor ``x`` is rotated shard by shard (``local_map``: the angles
    are made on each rank for its own rows; ``positions`` must then be
    whole along ``seq``, as every caller's are).
    """
    if is_dtensor(x):
        from torch.distributed.tensor.experimental import local_map

        pos_pl = positions.placements if is_dtensor(positions) else None
        return local_map(_rope, out_placements=list(x.placements),
                         in_placements=(x.placements, pos_pl, None),
                         device_mesh=x.device_mesh)(x, positions, theta)
    return _rope(x, positions, theta)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    head_dim = x.shape[-1]
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)  # theta a host scalar, in float32
    angles = positions[..., None].float() * freq  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32):
    return {"table": _normal(gen, (vocab, d_model), d_model**-0.5, dtype)}


def embed(params, ids, compute_dtype=DEFAULT_COMPUTE_DTYPE):
    """Rows of the table by id, as ``jnp.take`` (its ``fill`` mode): an id
    in ``[-V, 0)`` counts from the end, and a row for an id outside
    ``[-V, V)`` is NaN (``sparse.gather.take_rows``).  A DTensor table
    (and DTensor ids) takes ``_embed_partitioned``."""
    return gather_rows(params["table"], ids).to(compute_dtype)


def gather_rows(table, ids):
    """``take_rows(table, ids)``; for a DTensor table (and DTensor ids),
    its vocab-parallel form ``_embed_partitioned``."""
    if is_dtensor(table):
        return _embed_partitioned(table, ids)
    return take_rows(table, ids)


def _vocab_split(table, vocab_dim: int):
    """``(placements, model dims)`` to compute over a DTensor table with:
    its vocab dim kept where the mesh shards it, every other dim whole
    (the FSDP all-gather of ``d_model`` over ``data``); and the mesh dims
    that shard the vocab."""
    from torch.distributed.tensor import Replicate

    pl = tuple(p if p.is_shard() and p.dim == vocab_dim else Replicate()
               for p in table.placements)
    return pl, mesh_dims_sharding(pl, vocab_dim)


def _embed_partitioned(table, ids):
    """Vocab-parallel ``take_rows``: each rank gathers the rows of its own
    vocab shard (zero for an id another rank holds, NaN for one outside
    ``[-V, V)`` on every rank), and the ``Partial`` sum over the vocab's
    mesh dims is all-reduced: the rows are whole over them, and follow
    ``ids``' placements elsewhere.  Ids cut over a mesh dim that also
    cuts the vocab (a retrieval's candidates over every axis) are first
    gathered over it, so that each rank of it looks up its group's ids,
    and the summed rows are scattered back to the ids' layout (a
    reduce-scatter); ids cut over other dims alone gather nothing."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab = table.shape[0]
    tpl, vdims = _vocab_split(table, 0)
    table = table.redistribute(mesh, tpl)
    ipl = tuple(ids.placements)
    gpl = tuple(Replicate() if i in vdims else p for i, p in enumerate(ipl))
    if gpl != ipl:
        ids = ids.redistribute(mesh, gpl)
    lo = local_offset(table, 0)
    out_pl = tuple(Partial() if i in vdims else gpl[i]
                   for i in range(mesh.ndim))
    grad_pl = tuple(tpl[i] if i in vdims or not gpl[i].is_shard()
                    else Partial() for i in range(mesh.ndim))

    def body(tbl, idx):
        n = tbl.shape[0]
        idx = torch.where(idx < 0, idx + vocab, idx)
        ok = (idx >= 0) & (idx < vocab)
        mine = (idx >= lo) & (idx < lo + n)
        rows = tbl[(idx - lo).clamp(0, max(n - 1, 0))]
        rows = torch.where(mine[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        return torch.where(ok[..., None], rows, torch.full(
            (), math.nan, dtype=rows.dtype, device=rows.device))

    rows = local_map(body, out_placements=list(out_pl),
                     in_placements=(tpl, gpl),
                     in_grad_placements=(grad_pl, gpl),
                     device_mesh=mesh)(table, ids)
    return rows.redistribute(mesh, ipl)


def unembed(params, x, compute_dtype=DEFAULT_COMPUTE_DTYPE):
    """Tied output projection: logits over the vocab."""
    return x.to(compute_dtype) @ _weight(params["table"], compute_dtype).T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy in float32 (stable logsumexp)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(),
                              dim=-1)[..., 0]
    nll = lse - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def fused_unembed_cross_entropy(
    table: torch.Tensor,
    x: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    chunk: int = 512,
    compute_dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """Unembed + softmax cross entropy, a sequence chunk at a time, so the
    ``[B, S, V]`` logits never exist whole.  ``table`` is ``[V, D]``
    (tied) or ``[D, V]`` (an untied ``lm_head``).  The chunk's logits are
    float32 sums of ``compute_dtype`` products (the JAX package's
    ``preferred_element_type``).  While a gradient is being taken, each
    chunk is rematerialised in the backward (non-reentrant
    ``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``),
    so no chunk's float32 logits outlive its forward.  A DTensor ``x``
    takes the vocab-parallel form (``_vocab_parallel_ce``)."""
    if is_dtensor(x):
        return _vocab_parallel_ce(table, x, labels, mask, chunk,
                                  compute_dtype)
    tbl = cast_weight(table, compute_dtype)
    if table.shape[0] != x.shape[-1]:  # [V, d] -> [d, V]
        tbl = tbl.T
    nll_sum, msum = _chunked_nll(x, tbl, labels, mask, chunk, compute_dtype)
    return nll_sum / torch.clamp(msum, min=1.0)


def _chunked_nll(x, tbl, labels, mask, chunk: int, compute_dtype,
                 lo: int = 0, mesh=None, dims=()):
    """``(sum of the masked NLL, sum of the mask)`` of ``x [b, s, d]``'s
    rows against the table columns ``tbl [d, V_local]`` (the vocab from
    ``lo``, cut over the mesh dims ``dims``; all of it by default), a
    sequence chunk at a time (``s`` if ``chunk`` does not divide it:
    the smoke shapes), each chunk rematerialised in the backward while
    a gradient is being taken."""
    b, s, _ = x.shape
    if s % chunk != 0:
        chunk = s
    tbl_f = tbl.float()

    def chunk_nll(xck, tbl_f, lck, mck):
        logits = xck.to(compute_dtype).float() @ tbl_f
        return (_VocabParallelNLL.apply(logits, lck, lo, mesh, dims)
                * mck).sum()

    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or tbl.requires_grad)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    msum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        m = (mask[:, sl].float() if mask is not None
             else torch.ones(b, chunk, device=x.device))
        if remat:
            nll = torch.utils.checkpoint.checkpoint(
                chunk_nll, x[:, sl], tbl_f, labels[:, sl], m,
                use_reentrant=False)
        else:
            nll = chunk_nll(x[:, sl], tbl_f, labels[:, sl], m)
        nll_sum = nll_sum + nll
        msum = msum + m.sum()
    return nll_sum, msum


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` of float32 logits
    whose vocab is cut over the mesh dims ``dims`` (this rank holds
    columns ``lo .. lo + V_local``): the row max all-reduced (max), then
    the sum of ``exp(logit - max)`` and the label's logit (taken by the
    rank that holds it, 0 elsewhere) in one sum all-reduce.  The
    gradient is local and is autograd's of ``torch.logsumexp`` and
    ``take_along_dim`` on one rank, term for term: ``g exp(logit -
    lse)``, and ``-g`` added at the label on the rank that holds it."""

    @staticmethod
    def forward(ctx, logits, labels, lo, mesh, dims):
        n = logits.shape[-1]
        m = all_reduce_over(logits.amax(dim=-1), "max", mesh, dims)
        sum_exp = torch.exp(logits - m[..., None]).sum(dim=-1)
        idx = labels.long() - lo
        mine = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)[..., None]
        ll = torch.take_along_dim(logits, idx, dim=-1)[..., 0]
        ll = torch.where(mine, ll, torch.zeros((), dtype=ll.dtype,
                                               device=ll.device))
        both = all_reduce_over(torch.stack([sum_exp, ll]), "sum", mesh,
                               dims)
        lse = torch.log(both[0]) + m
        ctx.save_for_backward(logits, lse, idx, mine)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine = ctx.saved_tensors
        grad = g[..., None] * (logits - lse[..., None]).exp()
        at_label = torch.where(mine, -g, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))
        return (grad + torch.zeros_like(logits).scatter_add_(
            -1, idx, at_label[..., None]), None, None, None, None)


def _vocab_parallel_ce(table, x, labels, mask, chunk: int, compute_dtype):
    """``fused_unembed_cross_entropy`` of a DTensor ``x [B, S, D]``: the
    table gathered over every mesh dim but the ones that cut its vocab
    (FSDP), each rank's chunk logits ``[b, chunk, V_local]`` only, the
    NLL by ``_VocabParallelNLL``.  Each rank sums its own rows' NLL and
    mask; the two sums, ``Partial`` over the batch's mesh dims, are
    all-reduced together, and their quotient is the replicated mean."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    tbl = cast_weight(table, compute_dtype)
    if tbl.shape[0] != x.shape[-1]:  # [V, d] -> [d, V]
        tbl = tbl.T
    tpl, vdims = _vocab_split(tbl, 1)
    tbl = tbl.redistribute(mesh, tpl)
    xpl = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                for p in x.placements)
    x = x.redistribute(mesh, xpl)
    bdims = mesh_dims_sharding(xpl, 0)
    rows_pl = tuple(Replicate() if i not in bdims else xpl[i]
                    for i in range(mesh.ndim))
    labels = labels.redistribute(mesh, rows_pl) if is_dtensor(labels) \
        else labels
    if mask is not None and is_dtensor(mask):
        mask = mask.redistribute(mesh, rows_pl)
    lo = local_offset(tbl, 1)
    sum_pl = tuple(Partial() if i in bdims else Replicate()
                   for i in range(mesh.ndim))
    x_grad = tuple(Partial() if i in vdims else xpl[i]
                   for i in range(mesh.ndim))
    t_grad = tuple(Partial() if i in bdims else tpl[i]
                   for i in range(mesh.ndim))

    def body(x_l, tbl_l, labels_l, mask_l):
        return torch.stack(_chunked_nll(x_l, tbl_l, labels_l, mask_l, chunk,
                                        compute_dtype, lo, mesh, vdims))

    lab_pl = rows_pl if is_dtensor(labels) else None
    mask_pl = rows_pl if is_dtensor(mask) else None
    sums = local_map(
        body, out_placements=list(sum_pl),
        in_placements=(xpl, tpl, lab_pl, mask_pl),
        in_grad_placements=(x_grad, t_grad, lab_pl, mask_pl),
        device_mesh=mesh)(x, tbl, labels, mask)
    sums = sums.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return sums[0] / torch.clamp(sums[1], min=1.0)
