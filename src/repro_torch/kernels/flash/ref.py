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


# -- the float32 kernels' three-pass TF32 products, modelled in torch ------
#
# K4's float32 kernels on the tensor cores (csrc/flash.cu, flash_bwd.cu)
# split each operand x into hi = tf32(x) and lo = tf32(x - hi) and sum
# lo.hi + hi.lo + hi.hi in float32.  The model below makes the same
# splits and products on the CPU (a product of two tf32 values is exact in
# float32), for the tests that hold its numbers to the float32 limits;
# nothing else calls it.


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds a finite value: half a
    tf32 unit added to the bits, the 13 low bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, *,
                passes: int = 3) -> torch.Tensor:
    """``a @ b`` in float32 as the kernels' tensor cores take it: three
    passes, ``lo.hi + hi.lo + hi.hi`` of each operand's split (the
    ``lo.lo`` term dropped); one pass, ``hi.hi`` alone (plain TF32)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if passes == 3:
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        out = a_lo @ b_hi + a_hi @ b_lo + out
    return out


def attention_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor | None = None, *, causal: bool = True,
                   passes: int = 3):
    """Float32 attention with every product through ``tf32_matmul``, as
    the float32 kernels compute it (one block, no online rescaling):
    ``q [B, H, Sq, D]``, ``k, v [B, KvH, Sk, D]`` -> ``(out, lse)``, and
    with ``dout`` also ``(dq, dk, dv)`` by the backward kernels'
    recurrence (``p = exp(s - lse)``, ``dS = p (dO v^T - delta)``)."""
    b, h, sq, d = q.shape
    rep = h // k.shape[1]
    kx, vx = (t.float().repeat_interleave(rep, 1) for t in (k, v))
    q = q.float()
    scale = 1.0 / math.sqrt(d)
    mm = lambda x, y: tf32_matmul(x, y, passes=passes)  # noqa: E731
    s = mm(q, kx.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(sq, k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = mm(p, vx) / den
    lse = (m + torch.log(den))[..., 0]
    if dout is None:
        return out, lse
    dout = dout.float()
    p = torch.exp(s - lse[..., None])
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (mm(dout, vx.transpose(-1, -2)) - delta)
    dq = mm(ds, kx) * scale
    dk = (mm(ds.transpose(-1, -2), q) * scale).unflatten(1, (-1, rep)).sum(2)
    dv = mm(p.transpose(-1, -2), dout).unflatten(1, (-1, rep)).sum(2)
    return out, lse, (dq, dk, dv)
