"""Public wrapper for the attention kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash.flash import flash_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """MHA forward, ``[B, H, S, D]`` layout (``q [B, H, Sq, D]``,
    ``k, v [B, H, Sk, D]``, float32 or bfloat16) -> ``[B, H, Sq, D]`` in
    the type of ``q``: the hand-written CUDA kernel (``csrc/flash.cu``) on
    a CUDA tensor, its plain version on a CPU one.  JAX's ``interpret``
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
    ``Sk`` check only: the kernel's tiles are its own (64 by 64), and the
    plain version on a CPU tensor runs with its default blocks.
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
    return flash_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal)
