"""Transformer LM family (dense / GQA / local:global interleave / MoE /
MoE:dense interleave), the counterpart of the JAX package's
``repro.models.transformer``; one implementation covers all five LM
architectures, their differences pure config.

The weights are a ``Transformer`` module (a ``ParamTree``: float32
master weights, read as the JAX package reads its parameter pytree).
Where the JAX package stacks each position ``j`` of a layer period into
``[n_periods, ...]`` leaves and scans over periods, the port keeps one
block per layer in ``params["layers"]`` (layer ``i`` is period ``i //
period``, position ``i % period``) and runs them in a Python loop; the
numbers are the same.  ``params_from_jax`` unstacks a JAX parameter
pytree into it.

Attention: window-free layers go through ``attention.causal_attention``
(K4, and its backward kernels in training) in ``encode``, ``forward``
and ``prefill``; local layers and decode are plain torch (see
``models.attention``).  While a gradient is being taken, ``remat``
rematerialises each layer in the backward (non-reentrant
``torch.utils.checkpoint``: the JAX package's per-layer
``jax.checkpoint``; its period-level one adds nothing to a Python
loop), and ``scan_layers`` reaches ``blocked_attention`` as its
``use_scan`` (its block remat), as in the JAX package; without a
gradient neither changes anything.  Kept quirks of the JAX package:
``prefill`` returns the last token's logits only and stores K/V in
bfloat16 whatever ``compute_dtype`` is; ``serve_step`` writes one
position into a cache of static length (here in place) and attends over
that whole length under a mask; ``parallel_block`` adds attention and FFN to
the same residual.

Partitioned (``launch.tasks``' LM cells on a ``DeviceMesh``): the same
functions take DTensor weights, batches and caches, placed by the JAX
package's rules, and every rank computes on its own shards.  The
``constrain`` calls are the JAX package's ``with_sharding_constraint``
sites; ``_split_heads`` gathers a projection whose head count does not
divide the ``model`` axis before it is viewed as heads (the JAX
package's replicated fallback); the attention routes run on each rank's
own heads (``attention.on_local_heads``); the loss is vocab-parallel;
``serve_step`` writes position ``pos`` only on the rank whose sequence
shard holds it and decodes over the split-KV cache
(``attention.decode_attention``); a MoE layer routes and runs its
rank's own experts (``moe.moe_ffn``) and its aux loss is a replicated
scalar, beside a dense layer's replicated 0 (``_no_aux``).

Layouts: activations [B, S, D]; caches {k,v}: [L, B, S, KvH, hd].
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamTree,
    dense,
    dense_init,
    embed,
    embed_init,
    fused_unembed_cross_entropy,
    rmsnorm,
    rmsnorm_init,
    rope,
    swiglu,
    swiglu_init,
    unembed,
)
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_init
from repro_torch.models.sharding import (_divides, _resolve, constrain,
                                         is_dtensor, local_offset)

Params = Any


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    moe: MoEConfig | None = None
    moe_interleave: int = 1           # layer i is MoE iff i % k == k-1
    # (n_local, n_global) attention pattern per period; None = all full.
    local_global: tuple[int, int] | None = None
    window: int = 1024
    parallel_block: bool = False      # command-r style parallel attn+ffn
    tie_embeddings: bool = True
    remat: bool = True
    attn_block_size: int = 1024
    context_parallel_threshold: int = 16384
    compute_dtype: Any = torch.bfloat16
    scan_layers: bool = True

    @property
    def period(self) -> int:
        attn_p = 1 if self.local_global is None else sum(self.local_global)
        moe_p = self.moe_interleave if self.moe is not None else 1
        return math.lcm(attn_p, moe_p)

    @property
    def layer_kinds(self) -> tuple[tuple[bool, bool], ...]:
        """(is_local, is_moe) per position within one period."""
        kinds = []
        for j in range(self.period):
            if self.local_global is None:
                is_local = False
            else:
                n_local, _ = self.local_global
                is_local = (j % sum(self.local_global)) < n_local
            if self.moe is None:
                is_moe = False
            else:
                is_moe = (j % self.moe_interleave) == self.moe_interleave - 1
            kinds.append((is_local, is_moe))
        return tuple(kinds)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period != 0:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by period={self.period}")
        return self.n_layers // self.period

    def flops_per_token(self) -> float:
        """Forward matmul FLOPs per token (the 2N term of 6ND)."""
        d, hd = self.d_model, self.head_dim
        attn_proj = 2 * d * (self.n_heads + 2 * self.n_kv_heads) * hd
        attn_proj += 2 * self.n_heads * hd * d
        total = 0.0
        for (_is_local, is_moe) in self.layer_kinds:
            if is_moe:
                ffn = 2 * 3 * d * self.moe.d_ff * self.moe.top_k
                ffn += 2 * 3 * d * self.moe.d_ff * self.moe.n_shared_experts
                ffn += 2 * d * self.moe.n_experts
            else:
                ffn = 2 * 3 * d * self.d_ff
            total += attn_proj + ffn
        total *= self.n_periods
        total += 2 * d * self.vocab
        return total

    def kind(self, layer: int) -> tuple[bool, bool]:
        """(is_local, is_moe) of layer ``layer``."""
        return self.layer_kinds[layer % self.period]


class Transformer(ParamTree):
    """An LM's weights: ``embed``, one block per layer in ``layers``,
    ``ln_out`` and, untied, ``lm_head``."""


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: LMConfig, is_moe: bool):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "ln_attn": rmsnorm_init(d, device=gen.device),
        "wq": dense_init(gen, d, h * hd),
        "wk": dense_init(gen, d, kvh * hd),
        "wv": dense_init(gen, d, kvh * hd),
        "wo": dense_init(gen, h * hd, d),
        "ln_ffn": rmsnorm_init(d, device=gen.device),
    }
    if is_moe:
        p["moe"] = moe_init(gen, cfg.moe, d)
    else:
        p["ffn"] = swiglu_init(gen, d, cfg.d_ff)
    return p


def init_params(gen: torch.Generator, cfg: LMConfig) -> Transformer:
    """Random float32 weights drawn from ``gen`` on its device, in the
    JAX package's scales (its random streams are its own: weights to
    compare with it come through ``params_from_jax``)."""
    tree = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model),
        "layers": [_layer_init(gen, cfg, cfg.kind(i)[1])
                   for i in range(cfg.n_layers)],
        "ln_out": rmsnorm_init(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab)
    return Transformer(tree)


def params_from_jax(tree, cfg: LMConfig, device=None) -> Transformer:
    """The JAX package's parameter pytree (its leaves as numpy arrays,
    ``jax.tree.map(np.asarray, params)``) as a ``Transformer`` on
    ``device``: each ``[n_periods, ...]`` stack of period position ``j``
    unstacked into layers ``j, j + period, ...``.  Tied embeddings, an
    untied ``lm_head``, ``moe`` and its ``shared`` expert carry over."""
    from repro_torch.core.device import resolve_device

    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    def take(x, p):
        if isinstance(x, dict):
            return {k: take(v, p) for k, v in x.items()}
        return np.asarray(x)[p]

    stacks = tree["layers"]
    if len(stacks) != cfg.period:
        raise ValueError(f"{len(stacks)} period stacks for period "
                         f"{cfg.period}")
    layers = []
    for i in range(cfg.n_layers):
        p, j = divmod(i, cfg.period)
        layers.append(conv(take(stacks[j], p)))
    out = {"embed": conv(tree["embed"]), "layers": layers,
           "ln_out": conv(tree["ln_out"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = conv(tree["lm_head"])
    return Transformer(out)


def param_count(cfg: LMConfig) -> int:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_p = d * (h + 2 * kvh) * hd + h * hd * d + 2 * d
    total = 0
    for (_l, is_moe) in cfg.layer_kinds:
        if is_moe:
            ffn = d * cfg.moe.n_experts
            ffn += cfg.moe.n_experts * 3 * d * cfg.moe.d_ff
            ffn += cfg.moe.n_shared_experts * 3 * d * cfg.moe.d_ff
        else:
            ffn = 3 * d * cfg.d_ff
        total += attn_p + ffn
    total *= cfg.n_periods
    total += cfg.vocab * d + d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    return total


def active_param_count(cfg: LMConfig) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_p = d * (h + 2 * kvh) * hd + h * hd * d + 2 * d
    total = 0
    for (_l, is_moe) in cfg.layer_kinds:
        if is_moe:
            ffn = d * cfg.moe.n_experts
            ffn += (
                cfg.moe.top_k + cfg.moe.n_shared_experts
            ) * 3 * d * cfg.moe.d_ff
        else:
            ffn = 3 * d * cfg.d_ff
        total += attn_p + ffn
    total *= cfg.n_periods
    total += cfg.vocab * d + d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    return total


# --------------------------------------------------------------------------
# layer bodies
# --------------------------------------------------------------------------

def _head_axis(y, n: int):
    """``"tp"`` where ``n`` heads divide the ``model`` axis of DTensor
    ``y``'s mesh, else None (the heads replicated)."""
    mesh = y.device_mesh
    return "tp" if _divides(n, _resolve(mesh, "tp"), mesh) else None


def _split_heads(y, n: int, hd: int):
    """``[B, S, n hd] -> [B, S, n, hd]``.  A DTensor is first laid out as
    ``constrain`` will want the heads: cut over ``model`` only where
    ``n`` divides it, else gathered, so no view splits a sharded dim
    unevenly."""
    b, s, _ = y.shape
    if is_dtensor(y):
        y = constrain(y, "dp", None, _head_axis(y, n))
    return y.reshape(b, s, n, hd)


def _merge_heads(o):
    """``[B, S, H, hd] -> [B, S, H hd]``; a DTensor's gradient is laid out
    by heads as the forward was before the view splits it again."""
    b, s, h, hd = o.shape
    flat = o.reshape(b, s, h * hd)
    if is_dtensor(flat):
        flat = constrain(flat, "dp", None, _head_axis(o, h))
    return flat


def _qkv(lp, x, cfg: LMConfig, positions):
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rmsnorm(lp["ln_attn"], x)
    q = _split_heads(dense(lp["wq"], xn, cfg.compute_dtype), h, hd)
    k = _split_heads(dense(lp["wk"], xn, cfg.compute_dtype), kvh, hd)
    v = _split_heads(dense(lp["wv"], xn, cfg.compute_dtype), kvh, hd)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention_block(lp, x, cfg: LMConfig, is_local: bool, positions):
    s = x.shape[1]
    q, k, v = _qkv(lp, x, cfg, positions)
    if is_local and s > cfg.window:
        route = functools.partial(attn.chunked_local_attention,
                                  window=cfg.window)
    elif not is_local:
        route = attn.causal_attention
    elif s <= 2 * cfg.attn_block_size:
        route = functools.partial(attn.naive_attention, causal=True,
                                  window=cfg.window)
    else:
        route = functools.partial(attn.blocked_attention, causal=True,
                                  window=cfg.window,
                                  block_size=cfg.attn_block_size,
                                  use_scan=cfg.scan_layers)
    o = attn.on_local_heads(route, q, k, v)
    out = constrain(dense(lp["wo"], _merge_heads(o), cfg.compute_dtype),
                    "dp", None, None)
    return out, (k, v)


def _ffn_block(lp, x, cfg: LMConfig, is_moe: bool):
    xn = rmsnorm(lp["ln_ffn"], x)
    if is_moe:
        y, aux = moe_ffn(lp["moe"], xn, cfg.moe, cfg.compute_dtype)
        return constrain(y, "dp", None, None), aux["lb_loss"] + aux["z_loss"]
    y = swiglu(lp["ffn"], xn, cfg.compute_dtype)
    return constrain(y, "dp", None, None), _no_aux(x)


def _no_aux(x):
    """A dense layer's aux loss: 0, replicated beside DTensor activations
    (a MoE layer's aux is then a replicated DTensor, and llama4 adds the
    two in turn)."""
    if not is_dtensor(x):
        return torch.zeros((), dtype=torch.float32, device=x.device)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    zero = torch.zeros((), dtype=torch.float32, device=x.to_local().device)
    return DTensor.from_local(zero, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _residual(lp, x, a, cfg: LMConfig, is_moe: bool):
    """The layer's output from its attention output ``a``."""
    if cfg.parallel_block:
        f, aux = _ffn_block(lp, x, cfg, is_moe)
        return x + a + f, aux
    x = x + a
    f, aux = _ffn_block(lp, x, cfg, is_moe)
    return x + f, aux


def _logits(params, cfg: LMConfig, x):
    x = rmsnorm(params["ln_out"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cfg.compute_dtype)
    else:
        logits = dense(params["lm_head"], x, cfg.compute_dtype)
    spec = ("dp",) + (None,) * (logits.dim() - 2) + ("tp",)
    return constrain(logits, *spec)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------

def _layer(lp, x, cfg: LMConfig, is_local: bool, is_moe: bool, positions):
    """One layer: (its output, its aux loss)."""
    a, _kv = _attention_block(lp, x, cfg, is_local, positions)
    return _residual(lp, x, a, cfg, is_moe)


def _grad_taken(x, lp) -> bool:
    """Is a gradient being taken through this layer (of ``x`` or of one
    of its weights)?"""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in lp.parameters()))


def encode(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens [B, S] -> (final hidden states [B, S, D], aux loss).  With
    ``cfg.remat``, while a gradient is being taken, each layer is
    rematerialised in the backward, so its internals are not kept."""
    _, s = tokens.shape
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    x = constrain(x, "dp", None, None)
    positions = _positions(s, tokens.device)
    aux = None
    for i, lp in enumerate(params["layers"]):
        is_local, is_moe = cfg.kind(i)
        if cfg.remat and _grad_taken(x, lp):
            x, a_aux = torch.utils.checkpoint.checkpoint(
                _layer, lp, x, cfg, is_local, is_moe, positions,
                use_reentrant=False)
        else:
            x, a_aux = _layer(lp, x, cfg, is_local, is_moe, positions)
        aux = a_aux if aux is None else aux + a_aux
    return x, aux


def forward(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens [B, S] -> (logits [B, S, V], scalar aux loss)."""
    x, aux = encode(params, cfg, tokens)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: LMConfig, batch) -> torch.Tensor:
    """The training loss: the chunked cross entropy (each chunk
    rematerialised for the gradient) plus 1e-2 times the MoE aux loss.
    Differentiable through every layer: ``loss.backward()`` runs K4's
    backward kernels on the window-free layers."""
    x, aux = encode(params, cfg, batch["tokens"])
    x = rmsnorm(params["ln_out"], x)
    table = (
        params["embed"]["table"] if cfg.tie_embeddings
        else params["lm_head"]["w"]
    )
    ce = fused_unembed_cross_entropy(
        table, x, batch["labels"], batch.get("mask"),
        compute_dtype=cfg.compute_dtype,
    )
    if cfg.moe is None:
        return ce  # the aux loss is 0
    return ce + 1e-2 * aux  # partitioned: both replicated scalars


# --------------------------------------------------------------------------
# decode (KV cache)
# --------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    from repro_torch.core.device import resolve_device

    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params, cfg: LMConfig, tokens: torch.Tensor):
    """Full-sequence forward that also returns the KV cache, the serving
    warm-up path.  Returns (last-token logits [B, V], cache with K/V in
    bfloat16 [L, B, S, KvH, hd])."""
    _, s = tokens.shape
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    positions = _positions(s, tokens.device)
    ks, vs = [], []
    for i, lp in enumerate(params["layers"]):
        is_local, is_moe = cfg.kind(i)
        a, (k, v) = _attention_block(lp, x, cfg, is_local, positions)
        x, _ = _residual(lp, x, a, cfg, is_moe)
        # A DTensor layer's K/V go to the split-KV layout (the sequence
        # over 'model', as the JAX package's out_shardings lay the cache
        # out) as they are made, not after the stack.
        ks.append(constrain(k.to(torch.bfloat16), "dp", "tp", None, None))
        vs.append(constrain(v.to(torch.bfloat16), "dp", "tp", None, None))
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def serve_step(params, cfg: LMConfig, cache, token: torch.Tensor, pos):
    """One decode step: token [B] ids at position ``pos`` (an int or a
    0-d integer tensor) against a cache of static max length -> (logits
    [B, V], the cache, written in place at ``pos``)."""
    b = token.shape[0]
    dev = token.device
    x = embed(params["embed"], token[:, None], cfg.compute_dtype)
    if is_dtensor(pos):
        pos = pos.to_local()  # replicated
    if isinstance(pos, torch.Tensor):
        at = pos.to(device=dev, dtype=torch.long).reshape(1)
        positions = at.reshape(1, 1).to(torch.int32)
    else:  # a host int: nothing copied to the card
        at = None
        positions = torch.full((1, 1), pos, dtype=torch.int32, device=dev)
    h, hd = cfg.n_heads, cfg.head_dim
    for i, lp in enumerate(params["layers"]):
        is_local, is_moe = cfg.kind(i)
        q, k, v = _qkv(lp, x, cfg, positions)
        _write_position(cache["k"], i, k, pos, at)
        _write_position(cache["v"], i, v, pos, at)
        kc, vc = cache["k"][i], cache["v"][i]
        o = attn.decode_attention(
            q, kc, vc, pos + 1,
            window=cfg.window if is_local else None,
        )
        a = dense(lp["wo"], o.reshape(b, 1, h * hd), cfg.compute_dtype)
        x, _ = _residual(lp, x, a, cfg, is_moe)
    return _logits(params, cfg, x)[:, 0], cache


def _write_position(cache, layer: int, new, pos, at) -> None:
    """Write ``new [B, 1, KvH, hd]`` into layer ``layer`` of ``cache [L,
    B, S, KvH, hd]`` at position ``pos`` (a host int, or a 0-d tensor
    whose ``[1]`` long copy is ``at``), in place.  A DTensor cache is
    written on its ranks' own shards: ``new`` with every KV head and the
    cache's batch placement, and position ``pos`` only on the rank whose
    sequence shard holds it (with a tensor ``pos``, a masked write of
    the old value elsewhere: no host read)."""
    seq = cache.shape[2]
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard

        mesh = cache.device_mesh
        want = tuple(Shard(0) if p.is_shard(1) else Replicate()
                     for p in cache.placements)
        new = new.redistribute(mesh, want).to_local()
        off = local_offset(cache, 2)
        cache = cache.to_local()
    else:
        off = 0
    c = cache[layer]
    s_l = c.shape[1]
    if at is None:
        if off <= pos < off + s_l:
            c[:, pos - off:pos - off + 1].copy_(new)
        return
    if s_l == seq:  # every position is this rank's
        c.index_copy_(1, at, new.to(c.dtype))
        return
    new = new.to(c.dtype)
    idx = at - off
    inside = (idx >= 0) & (idx < s_l)
    idx = idx.clamp(0, s_l - 1)
    c.index_copy_(1, idx, torch.where(inside.view(1, 1, 1, 1), new,
                                      c.index_select(1, idx)))
