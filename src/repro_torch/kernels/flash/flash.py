"""FlashAttention forward (causal or bidirectional, multi-head or
grouped-query, with an online softmax) in one CUDA kernel per type.

``flash_cuda`` (K4, the TPU's ``repro.kernels.flash.flash.flash_pallas``)
wraps the hand-written Hopper kernels in ``repro_torch/csrc/flash.cu``
(see the note in the source): bfloat16 on the tensor cores (``wgmma``,
K and V in a ring of tiles filled by TMA), float32 on the FMA units
(IEEE float32 products).  ``flash_plan`` is the tiling each one launches with.
``flash_plain`` is their plain PyTorch version, the same recurrence over
key blocks in stock torch ops: the CPU path and the oracle the kernels
are held against on the card.  All use the TPU kernel's numbers: float32
scores scaled by ``1 / sqrt(D)``, the finite mask sentinel ``-1e30``, a
float32 running max, denominator and accumulator, ``p`` rounded to the
type of ``v`` before the product, and the denominator clamped at
``1e-30``.

K and V may hold fewer heads than Q (``[B, KvH, Sk, D]`` with ``H`` a
multiple of ``KvH``): query head ``h`` reads KV head ``h // (H // KvH)``,
the JAX package's ``_split_gqa`` order, by index, with nothing copied.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import check_operand
from repro_torch.kernels.flash.ref import NEG_INF

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can use


class FlashPlan(NamedTuple):
    """How ``csrc/flash.cu`` tiles one head dim and type."""

    kernel: str       # "wgmma" (bfloat16, tensor cores) or "fma" (float32)
    head_dim: int     # the width the kernel computes over, >= D
    block_q: int      # queries per block
    block_k: int      # keys per streamed tile
    stages: int       # K/V tiles in the shared-memory ring
    smem_bytes: int   # dynamic shared memory per block


def flash_plan(d: int, dtype: torch.dtype) -> FlashPlan:
    """The tiling ``flash_launch`` picks for head dim ``d`` and ``dtype``,
    as the source computes it (the card tests hold the two equal).

    bfloat16: ``d`` padded to 64, 128 or 256 (the ``wgmma`` widths), 128
    queries (two warpgroups of 64), 128 keys a tile at width 64 and 64
    above, a ring of two K/V stages, their two mbarriers (64 bytes kept)
    and 1 KB to align the 128-byte swizzle atoms.
    float32: 64 queries by 64 keys, the accumulator in ``16 * NJ``
    columns (``NJ`` = ``ceil(d / 16)`` rounded up to a power of two) and
    Q, K, V, P tiles in float32 with an odd row stride."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if dtype == torch.bfloat16:
        dp = 64 if d <= 64 else 128 if d <= 128 else 256
        bq, bk, stages = 128, (128 if dp == 64 else 64), 2
        return FlashPlan("wgmma", dp, bq, bk, stages,
                         2 * dp * (bq + 2 * stages * bk) + 64 + 1024)
    if dtype == torch.float32:
        nj = 1 << (-(-d // 16) - 1).bit_length()
        return FlashPlan("fma", 16 * nj, 64, 64, 1,
                         ((64 + 2 * 64) * (d + 1) + 64 * 65) * 4)
    raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")


def _kv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """``KvH`` of ``k, v [B, KvH, Sk, D]`` against ``q [B, H, Sq, D]``;
    raises unless ``H`` is a multiple of it and the other dims agree."""
    b, h, _, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape != (b, kvh, sk, d):
        raise ValueError(f"k and v must be [B, KvH, Sk, D] = [{b}, KvH, Sk, "
                         f"{d}], got {tuple(k.shape)} and {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} must be a multiple of the KV "
                         f"heads {kvh}")
    return kvh


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, block_q: int = 128,
                block_k: int = 128) -> torch.Tensor:
    """``q [B, H, Sq, D]``, ``k, v [B, KvH, Sk, D]`` -> ``[B, H, Sq, D]``
    in the type of ``q``: the online-softmax recurrence over key blocks
    of ``block_k``, ``block_q`` queries at a time, so that the float32
    scores never take more than ``B H block_q block_k`` elements.  Causal
    key blocks wholly past a query chunk are skipped (their ``p`` is 0).
    The ``H // KvH`` query heads of a KV head are one broadcast dim."""
    b, h, sq, d = q.shape
    kvh = _kv_heads(q, k, v)
    sk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.view(b, kvh, h // kvh, sq, d)
    kg, vg = k[:, :, None], v[:, :, None]  # [B, KvH, 1, Sk, D]
    out = torch.empty_like(qg)
    for q0 in range(0, sq, block_q):
        qc = qg[:, :, :, q0:q0 + block_q].float()
        rows = qc.shape[3]
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        stat = qc.shape[:4] + (1,)
        m = torch.full(stat, NEG_INF, device=q.device)
        l = torch.zeros(stat, device=q.device)
        acc = torch.zeros(qc.shape, device=q.device)
        k_end = min(sk, q0 + rows) if causal else sk
        for k0 in range(0, k_end, block_k):
            kc = kg[:, :, :, k0:k0 + block_k].float()
            vc = vg[:, :, :, k0:k0 + block_k]
            s = (qc @ kc.transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kc.shape[3], device=q.device)
                s = torch.where(kpos[None, :] <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ vc.float()
            m = m_new
        out[:, :, :, q0:q0 + rows] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.view(b, h, sq, d)


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("flash", ("flash.cu",))
    if lib.flash_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.flash_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.flash_launch.restype = ctypes.c_int
        lib.flash_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_smem_bytes.restype = ctypes.c_int
    return lib


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True) -> torch.Tensor:
    """K4 through the CUDA kernels: same result as ``flash_plain`` (the
    kernels' tiles are their own, ``flash_plan``'s).  A CPU tensor takes
    the plain version with its default blocks; a CUDA tensor launches the
    kernel for its type (counted in ``flash_cuda.launches``) or raises.
    ``q [B, H, Sq, D]``, ``k, v [B, KvH, Sk, D]`` with ``H`` a multiple
    of ``KvH`` (each block reads its KV head by index); ``D`` may be 1 to
    256."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, causal=causal)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no attention kernel for device {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    check_operand("q", q, q.dtype, 4, dev)
    check_operand("k", k, q.dtype, 4, dev)
    check_operand("v", v, q.dtype, 4, dev)
    b, h, sq, d = q.shape
    kvh = _kv_heads(q, k, v)
    sk = k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if sk == 0:
        raise ValueError("attention needs at least one key")
    if max(b * h, sq, sk) >= 2**31:
        raise ValueError("B*H, Sq and Sk must be below 2**31")
    out = torch.empty_like(q)
    if b * h == 0 or sq == 0:
        return out
    rc = _kernel_lib().flash_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, h, kvh, sq, sk, d, 1.0 / (d ** 0.5), int(causal),
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: error {rc}")
    flash_cuda.launches += 1
    return out


flash_cuda.launches = 0
