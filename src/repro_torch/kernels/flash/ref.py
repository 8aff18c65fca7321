"""Plain oracle for the attention kernel (MHA, optional causal), as the
JAX package's ``repro.kernels.flash.ref``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """``q [B, H, Sq, D]``, ``k, v [B, H, Sk, D]`` -> ``[B, H, Sq, D]`` in
    the type of ``q``: float32 scores over ``sqrt(D)``, the causal mask
    (key ``j`` > query ``i``, both from 0) at ``-1e30``, a float32
    softmax, and ``p`` rounded to the type of ``v`` before a product
    accumulated in float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    if causal:
        mask = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
