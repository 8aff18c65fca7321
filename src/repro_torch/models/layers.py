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
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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
    return x.to(compute_dtype) @ cast_weight(params["w"], compute_dtype)


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
    g = x @ cast_weight(params["w_gate"], compute_dtype)
    u = x @ cast_weight(params["w_up"], compute_dtype)
    tp_spec = ("dp",) + (None,) * (x.dim() - 2) + ("tp",)
    h = constrain(F.silu(g) * u, *tp_spec)
    return h @ cast_weight(params["w_down"], compute_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Rotary position embedding, angles in float32 as the JAX package.

    x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq].
    """
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
    ``[-V, V)`` is NaN (``sparse.gather.take_rows``)."""
    return take_rows(params["table"], ids).to(compute_dtype)


def unembed(params, x, compute_dtype=DEFAULT_COMPUTE_DTYPE):
    """Tied output projection: logits over the vocab."""
    return x.to(compute_dtype) @ cast_weight(params["table"],
                                             compute_dtype).T


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
    so no chunk's float32 logits outlive its forward."""
    b, s, d = x.shape
    if s % chunk != 0:
        chunk = s  # degenerate fallback (smoke shapes)
    tbl = cast_weight(table, compute_dtype).float()
    if table.shape[0] != d:  # [V, d] -> [d, V]
        tbl = tbl.T

    def chunk_nll(xck, lck, mck):
        logits = xck.to(compute_dtype).float() @ tbl
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, lck[..., None].long(),
                                  dim=-1)[..., 0]
        return ((lse - ll) * mck).sum()

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
                chunk_nll, x[:, sl], labels[:, sl], m, use_reentrant=False)
        else:
            nll = chunk_nll(x[:, sl], labels[:, sl], m)
        nll_sum = nll_sum + nll
        msum = msum + m.sum()
    return nll_sum / torch.clamp(msum, min=1.0)
