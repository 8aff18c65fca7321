"""Attention: GQA, blocked (flash-style) softmax streaming, sliding-window
chunked locality and KV-cache decode in plain torch, the counterpart of
the JAX package's ``repro.models.attention``, with its numbers: the
``-1e30`` mask sentinel, float32 scores in the blocked, chunked and
decode forms (``naive_attention`` computes them in ``q``'s type and
only then casts to float32), ``p`` rounded to ``v``'s type before the
product, and the ``1e-30`` clamp of the denominator.

``causal_attention`` is the route of window-free causal attention with
no query offset (``transformer``'s prefill and ``encode``): the K4
kernel through ``kernels.flash.flash_attention``, which reads each
query head's KV head by index.  On a CPU tensor ``flash_attention``
takes its plain version, so the route is the same on both devices.  It
replaces both of the JAX package's branches for such layers
(``naive_attention`` up to twice the block size, ``blocked_attention``
above it), and differs from them in one place: in bfloat16,
``naive_attention`` rounds the scores to bfloat16 before its float32
softmax, and K4 keeps them in float32 (as ``blocked_attention`` does).
A score ``s`` then moves by up to ``|s| 2**-8`` and ``p`` by as much
relative, so the outputs agree within a few bfloat16 steps, not
bitwise.  Windowed (local) layers and decode stay plain torch, as in
the JAX package, which has no kernel for them.

``bidirectional_attention`` is the same route with ``causal=False``,
the attention of encoders over a whole sequence (BERT4Rec's ``encode``,
where the JAX package calls ``naive_attention(causal=False)``, which
stays the plain form and the oracle).  Every key enters every query's
softmax; K4 stops at ``Sk`` and pads nothing, so no key is added.

Training differentiates through the same route: ``flash_attention``
takes K4's hand-written backward while a gradient is being taken (its
plain version on a CPU tensor), the gradient the JAX package takes by
autodiff of its stock-op forms.

Layouts:
  q:      [B, Sq, H,  hd]
  k, v:   [B, Sk, KvH, hd]     (GQA: H = KvH * rep)
  out:    [B, Sq, H,  hd]
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels.flash.ops import flash_attention

NEG_INF = -1e30


def _split_gqa(q, n_kv: int):
    b, s, h, d = q.shape
    rep = h // n_kv
    return q.reshape(b, s, n_kv, rep, d)


def _merge_gqa(o):
    b, s, kvh, rep, d = o.shape
    return o.reshape(b, s, kvh * rep, d)


def _inv_sqrt(d: int) -> float:
    """``1 / sqrt(float32(d))`` in float32, as the JAX package forms it,
    as a host scalar (a tensor made on the card from a Python number
    would be a copy that waits for the stream)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def causal_attention(q, k, v):
    """Window-free causal attention from position 0 through K4:
    ``q [B, S, H, hd]``, ``k, v [B, S, KvH, hd]`` -> ``[B, S, H, hd]``.
    The kernel takes ``[B, H, S, hd]``: the operands are transposed into
    it (copies) and the result transposed back (a view)."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True)
    return o.transpose(1, 2)


def bidirectional_attention(q, k, v):
    """Attention of every query over every key through K4 (``causal=
    False``): ``q [B, S, H, hd]``, ``k, v [B, Sk, KvH, hd]`` -> ``[B, S,
    H, hd]``, transposed into and out of K4's ``[B, H, S, hd]`` as in
    ``causal_attention``.  ``block_k`` is ``Sk``: ``flash_attention``
    refuses a bidirectional ``Sk`` that is no multiple of its
    ``block_k``, since the JAX kernel would pad keys into the softmax;
    K4 pads none, so one block of all the keys is the exact call."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=False,
                        block_k=max(k.shape[1], 1))
    return o.transpose(1, 2)


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Reference attention; materializes the full score matrix."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    qg = _split_gqa(q, kvh)
    # sqrt(float32(d)) rounded to q's type, a CPU scalar operand.
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k) / torch.tensor(
        d, dtype=torch.float32).sqrt().to(q.dtype)
    scores = scores.float()
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrst,btgd->bsgrd", p.to(v.dtype), v)
    return _merge_gqa(o)


def blocked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      block_size: int = 1024, use_scan: bool = True):
    """Streaming-softmax attention over KV blocks (the FlashAttention
    recurrence in plain torch): the scores never take more than ``Sq *
    block_size`` per head.

    The blocks run in a Python loop, and with a static ``q_offset`` a
    block wholly past every query (causal) or before every query's
    window is skipped, as the JAX package's unrolled form does.  That
    changes no bit of the result: on such a block every ``p`` is exactly
    0 and the running max does not move.  ``use_scan`` selects, as in the
    JAX package, whether the block body is rematerialised for the
    gradient (its scanned form is the one it checkpoints): while a
    gradient is being taken with ``use_scan``, each block runs under
    non-reentrant ``torch.utils.checkpoint``, so a block's float32
    scores do not outlive its forward."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    rep = h // kvh
    if sk % block_size != 0:
        # pad KV to a block multiple with masked slots
        pad = block_size - sk % block_size
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_blocks = k.shape[1] // block_size
    qg = _split_gqa(q, kvh).float()
    scale = _inv_sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros(b, kvh, rep, sq, d, device=q.device)
    m = torch.full((b, kvh, rep, sq), NEG_INF, device=q.device)
    l = torch.zeros(b, kvh, rep, sq, device=q.device)
    static_offset = isinstance(q_offset, int)

    def block_update(acc, m, l, k_blk, v_blk, lo: int):
        s = torch.einsum("bsgrd,btgd->bgrst", qg, k_blk.float()) * scale
        kpos = lo + torch.arange(block_size, device=q.device)
        mask = (kpos[None, :] < sk).expand(sq, block_size)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        # bf16 probabilities into the AV product (flash-style); the
        # accumulator stays float32.
        acc = acc * corr[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p.to(v.dtype), v_blk).float()
        return acc, m_new, l

    remat = use_scan and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for blk_idx in range(n_blocks):
        lo = blk_idx * block_size
        if static_offset and causal and lo > q_offset + sq - 1:
            continue
        if (static_offset and window is not None
                and (lo + block_size) <= q_offset - window + 1):
            continue
        k_blk = k[:, lo:lo + block_size]
        v_blk = v[:, lo:lo + block_size]
        if remat:
            acc, m, l = torch.utils.checkpoint.checkpoint(
                block_update, acc, m, l, k_blk, v_blk, lo,
                use_reentrant=False)
        else:
            acc, m, l = block_update(acc, m, l, k_blk, v_blk, lo)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = torch.movedim(o, 3, 1)  # [b, sq, kvh, rep, d]
    return _merge_gqa(o).to(q.dtype)


def chunked_local_attention(q, k, v, *, window: int):
    """Sliding-window attention with chunked locality: queries in chunk i
    attend to chunks {i-1, i} masked to the window.

    Requires seq % window == 0; window == chunk size.
    """
    b, s, h, d = q.shape
    _, _, kvh, _ = k.shape
    if s % window != 0:
        raise ValueError(f"sequence {s} is no multiple of the window "
                         f"{window}")
    n_chunks = s // window
    rep = h // kvh
    qc = q.reshape(b, n_chunks, window, kvh, rep, d)
    kc = k.reshape(b, n_chunks, window, kvh, d)
    vc = v.reshape(b, n_chunks, window, kvh, d)
    # previous chunk (zero for chunk 0, masked below)
    kprev = torch.nn.functional.pad(kc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    vprev = torch.nn.functional.pad(vc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    kcat = torch.cat([kprev, kc], dim=2)  # [b, n, 2W, kvh, d]
    vcat = torch.cat([vprev, vc], dim=2)
    scale = _inv_sqrt(d)
    s_ = torch.einsum("bnsgrd,bntgd->bngrst", qc.float(),
                      kcat.float()) * scale
    qpos = torch.arange(window, device=q.device)[:, None] + window
    kpos = torch.arange(2 * window, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    # chunk 0 has no previous chunk
    first = torch.arange(n_chunks, device=q.device)[:, None, None] > 0
    mask = mask[None] & (first | (kpos[None] >= window))
    s_ = torch.where(mask[None, :, None, None], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1).to(q.dtype)
    o = torch.einsum("bngrst,bntgd->bnsgrd", p, vcat.to(q.dtype))
    return o.reshape(b, s, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token decode: q [B, 1, H, hd] against a [B, S, KvH, hd]
    cache filled up to ``cache_len`` (an int or a 0-d tensor).  Window
    (if set) restricts to the last ``window`` positions."""
    b, sq, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    qg = _split_gqa(q, kvh)
    scale = _inv_sqrt(d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                          k_cache.to(qg.dtype).float()) * scale
    kpos = torch.arange(s, device=q.device)
    mask = kpos < cache_len
    if window is not None:
        mask = mask & (kpos >= cache_len - window)
    scores = torch.where(mask[None, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bgrst,btgd->bsgrd", p.float(),
                     v_cache.to(q.dtype).float())
    return _merge_gqa(o).to(q.dtype)
