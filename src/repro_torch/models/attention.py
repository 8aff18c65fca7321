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

Under DTensor placements (the partitioned LM) every route runs on each
rank's own heads (``on_local_heads``: ``local_map`` over ``[B / dp, S,
H / tp, hd]``, K4 included, forward and backward), and a rank whose
query heads are a slice of the replicated KV heads passes the kernel
only the KV heads those query heads read.  ``decode_attention`` over a
cache whose sequence is cut over the mesh (split-KV) computes each
rank's partial softmax over its own positions and merges them by their
log-sum-exp: a max all-reduce, then sum all-reduces of the softmax's
denominator and of the output; no rank gathers the cache.

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
from repro_torch.models.sharding import (all_reduce_over, is_dtensor,
                                         local_offset, mesh_dims_sharding)

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


def kv_head_slice(h: int, kvh: int, tp: int, rank: int):
    """The KV heads ``[lo, hi)`` that query heads ``rank * H / tp .. (rank
    + 1) * H / tp`` read (query head ``j`` reads KV head ``j // (H /
    KvH)``), or None where those query heads do not read them in K4's
    grouped order (``H_local`` a multiple of ``hi - lo``, each KV head
    read by an equal run of query heads)."""
    rep, hl = h // kvh, h // tp
    a = rank * hl
    lo, hi = a // rep, (a + hl - 1) // rep + 1
    n = hi - lo
    if hl % n or any((a + j) // rep - lo != j // (hl // n)
                     for j in range(hl)):
        return None
    return lo, hi


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (an attention route over ``[B, S, H, hd]`` /
    ``[B, S, KvH, hd]``) on each rank's own heads when ``q`` is a
    DTensor (``local_map``), else ``fn`` itself.

    The batch keeps ``q``'s placement on the data axes and the sequence
    must be whole.  On ``model``: query and KV heads both cut (each
    rank's KV heads are its query heads' own); or the query heads cut
    and the KV heads replicated (``H_local % KvH_local`` need not hold
    for all KvH): the rank slices the KV heads its own query heads read
    by its coordinate on ``model`` (``kv_head_slice``), and their
    gradient is a ``Partial`` sum over ``model``; or, where the slice is
    not in K4's grouped order, the query heads gathered too (the JAX
    package's replicated fallback)."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    qpl, kpl = list(q.placements), list(k.placements)
    kgrad = list(kpl)
    slice_on = None
    for i, (qp, kp) in enumerate(zip(qpl, kpl)):
        if qp.is_shard(1) or kp.is_shard(1):
            raise ValueError("attention on local heads needs the whole "
                             "sequence on every rank")
        if qp.is_shard(0) or kp.is_shard(0):      # a data axis
            qpl[i] = kpl[i] = kgrad[i] = (qp if qp.is_shard(0)
                                          else Replicate())
            continue
        if qp.is_shard(2) and kp.is_shard(2):
            continue
        if qp.is_shard(2):                        # KV heads replicated
            tp = mesh.size(i)
            coords = [kv_head_slice(h, kvh, tp, r) for r in range(tp)]
            if all(c is not None for c in coords) and slice_on is None:
                slice_on = i
                kpl[i], kgrad[i] = Replicate(), Partial()
                continue
        qpl[i] = kpl[i] = kgrad[i] = Replicate()
    q = q.redistribute(mesh, tuple(qpl))
    k = k.redistribute(mesh, tuple(kpl))
    v = v.redistribute(mesh, tuple(kpl))

    def body(q_l, k_l, v_l):
        if slice_on is not None:
            lo, hi = kv_head_slice(h, kvh, mesh.size(slice_on),
                                   mesh.get_local_rank(slice_on))
            k_l, v_l = k_l[:, :, lo:hi], v_l[:, :, lo:hi]
        return fn(q_l, k_l, v_l)

    return local_map(body, out_placements=list(qpl),
                     in_placements=(tuple(qpl), tuple(kpl), tuple(kpl)),
                     in_grad_placements=(tuple(qpl), tuple(kgrad),
                                         tuple(kgrad)),
                     device_mesh=mesh)(q, k, v)


def causal_attention(q, k, v):
    """Window-free causal attention from position 0 through K4:
    ``q [B, S, H, hd]``, ``k, v [B, S, KvH, hd]`` -> ``[B, S, H, hd]``.
    The kernel takes ``[B, H, S, hd]``: the operands are transposed into
    it (copies) and the result transposed back (a view).  DTensors run
    K4 on each rank's own heads (``on_local_heads``)."""
    if is_dtensor(q):
        return on_local_heads(causal_attention, q, k, v)
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
    K4 pads none, so one block of all the keys is the exact call.
    DTensors run K4 on each rank's own rows and heads
    (``on_local_heads``)."""
    if is_dtensor(q):
        return on_local_heads(bidirectional_attention, q, k, v)
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
    (if set) restricts to the last ``window`` positions.  A DTensor
    cache takes ``_decode_split_kv``."""
    if is_dtensor(k_cache):
        return _decode_split_kv(q, k_cache, v_cache, cache_len,
                                window=window)
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


def _decode_split_kv(q, k_cache, v_cache, cache_len, *, window=None):
    """``decode_attention`` over a DTensor cache, its sequence cut over
    some mesh dims (split-KV) and its batch over others.  ``q`` is
    gathered to every head (``[B, 1, H, hd]``: a few KB) with the
    cache's batch placement; each rank scores its own positions (global
    index = its shard's offset + local index), and the partial softmaxes
    merge by their log-sum-exp: the row max all-reduced (max), then the
    float32 sum of ``exp(s - max)`` (sum), so that each rank normalises
    its probabilities and rounds them to ``q``'s type as
    ``decode_attention`` does before the product with V, whose partial
    outputs are summed last (sum).  Where no mesh dim of more than one
    rank cuts the sequence, each rank runs ``decode_attention`` itself on
    its rows.  The result has ``q``'s new placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    cpl = tuple(k_cache.placements)
    if any(p.is_shard() and p.dim not in (0, 1) for p in cpl):
        raise ValueError("a split-KV cache cuts its batch and sequence only")
    seq_dims = mesh_dims_sharding(cpl, 1)
    qpl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cpl)
    q = q.redistribute(mesh, qpl)
    v_cache = v_cache.redistribute(mesh, cpl)
    off = local_offset(k_cache, 1)
    if is_dtensor(cache_len):
        cache_len = cache_len.full_tensor()
    d = q.shape[-1]
    kvh = k_cache.shape[2]
    scale = _inv_sqrt(d)

    def body(q_l, kc, vc):
        if not any(mesh.size(i) > 1 for i in seq_dims):
            # the whole sequence is this rank's: nothing to merge
            return decode_attention(q_l, kc, vc, cache_len, window=window)
        s_l = kc.shape[1]
        qg = _split_gqa(q_l, kvh)
        scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                              kc.to(qg.dtype).float()) * scale
        kpos = off + torch.arange(s_l, device=q_l.device)
        mask = kpos < cache_len
        if window is not None:
            mask = mask & (kpos >= cache_len - window)
        scores = torch.where(mask[None, None, None, None, :], scores,
                             NEG_INF)
        m = all_reduce_over(scores.amax(dim=-1, keepdim=True), "max", mesh,
                            seq_dims)
        e = torch.exp(scores - m)
        l_ = all_reduce_over(e.sum(dim=-1, keepdim=True), "sum", mesh,
                             seq_dims)
        p = (e / l_).to(q_l.dtype)
        o = torch.einsum("bgrst,btgd->bsgrd", p.float(),
                         vc.to(q_l.dtype).float())
        o = all_reduce_over(o, "sum", mesh, seq_dims)
        return _merge_gqa(o).to(q_l.dtype)

    return local_map(body, out_placements=list(qpl),
                     in_placements=(qpl, cpl, cpl),
                     device_mesh=mesh)(q, k_cache, v_cache)
