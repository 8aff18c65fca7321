"""Public wrapper for the attention kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash.flash import FlashAttentionFn, flash_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Attention forward, ``[B, H, S, D]`` layout (``q [B, H, Sq, D]``,
    ``k, v [B, KvH, Sk, D]`` with ``H`` a multiple of ``KvH``: query head
    ``h`` reads KV head ``h // (H // KvH)``, the grouped-query order of
    the JAX package's model; float32 or bfloat16) -> ``[B, H, Sq, D]`` in
    the type of ``q``: the hand-written CUDA kernels (``csrc/flash.cu``;
    bfloat16 on the tensor cores, float32 there in three TF32 passes or
    on the FMA units, ``flash_plan``) on a CUDA
    tensor, their plain version on a CPU one.  JAX's ``interpret``
    flag has no counterpart.

    The JAX package pads ``Sq`` and ``Sk`` up to multiples of ``block_q``
    / ``block_k`` with zeros; here nothing is copied: the kernel stops at
    ``Sq`` and gives keys at or past ``Sk`` a ``p`` of 0.  For causal
    attention with ``Sq <= Sk`` that is the padded result, since every
    padding key lies past every real query.  Bidirectional attention
    would let padding keys in, so, as the JAX package does, it raises (a
    ``ValueError``) when ``Sk`` is not a multiple of ``block_k``.  With
    causal ``Sq > Sk`` the JAX kernel lets the zero padding keys at
    positions up to a query's own into its softmax; here, as in
    ``attention_ref``, keys past ``Sk`` do not exist.  ``block_q`` is
    taken for the JAX signature and checked, and ``block_k`` serves that
    ``Sk`` check only: the kernels' tiles are their own (``flash_plan``),
    and the plain version on a CPU tensor runs with its default blocks.

    Differentiable: while a gradient is being taken of q, k or v, the call
    goes through ``FlashAttentionFn`` (the same K4 launch, which also keeps
    each row's log-sum-exp, and the hand-written backward kernels, or on
    a CPU tensor their plain version).  Without one (serving) it is the
    forward alone, as before.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    if not causal and k.shape[2] % block_k:
        raise ValueError(f"bidirectional attention needs Sk a multiple of "
                         f"block_k (pad-free Sk): Sk {k.shape[2]}, block_k "
                         f"{block_k}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal)
    return flash_cuda(q, k, v, causal=causal)
