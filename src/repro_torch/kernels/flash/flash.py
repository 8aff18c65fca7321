"""FlashAttention forward (causal or bidirectional MHA with an online
softmax) in one CUDA kernel.

``flash_cuda`` (K4, the TPU's ``repro.kernels.flash.flash.flash_pallas``)
wraps the hand-written Hopper kernel in ``repro_torch/csrc/flash.cu``
(see the note in the source); ``flash_plain`` is its plain PyTorch
version, the same recurrence over key blocks in stock torch ops: the CPU
path and the oracle the kernel is held against on the card.  Both use
the TPU kernel's numbers: float32 scores scaled by ``1 / sqrt(D)``, the
finite mask sentinel ``-1e30``, a float32 running max, denominator and
accumulator, ``p`` rounded to the type of ``v`` before the product, and
the denominator clamped at ``1e-30``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_operand
from repro_torch.kernels.flash.ref import NEG_INF

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, block_q: int = 128,
                block_k: int = 128) -> torch.Tensor:
    """``q [B, H, Sq, D]``, ``k, v [B, H, Sk, D]`` -> ``[B, H, Sq, D]``
    in the type of ``q``: the online-softmax recurrence over key blocks
    of ``block_k``, ``block_q`` queries at a time, so that the float32
    scores never take more than ``B H block_q block_k`` elements.  Causal
    key blocks wholly past a query chunk are skipped (their ``p`` is 0)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    for q0 in range(0, sq, block_q):
        qc = q[:, :, q0:q0 + block_q].float()
        rows = qc.shape[2]
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        m = torch.full((b, h, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros(b, h, rows, 1, device=q.device)
        acc = torch.zeros(b, h, rows, d, device=q.device)
        k_end = min(sk, q0 + rows) if causal else sk
        for k0 in range(0, k_end, block_k):
            kc = k[:, :, k0:k0 + block_k].float()
            vc = v[:, :, k0:k0 + block_k]
            s = (qc @ kc.transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kc.shape[2], device=q.device)
                s = torch.where(kpos[None, :] <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ vc.float()
            m = m_new
        out[:, :, q0:q0 + rows] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("flash", ("flash.cu",))
    if lib.flash_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.flash_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.flash_launch.restype = ctypes.c_int
    return lib


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True) -> torch.Tensor:
    """K4 through the CUDA kernel: same result as ``flash_plain`` (the
    kernel's tiles are its own, 64 queries by 64 keys).  A CPU tensor
    takes the plain version with its default blocks; a CUDA tensor
    launches the kernel (counted in ``flash_cuda.launches``) or raises.
    ``D`` may be 1 to 256."""
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
    sk = k.shape[2]
    if k.shape != v.shape or k.shape != (b, h, sk, d):
        raise ValueError(f"k and v must be [B, H, Sk, D] = [{b}, {h}, Sk, "
                         f"{d}], got {tuple(k.shape)} and {tuple(v.shape)}")
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
        b * h, sq, sk, d, 1.0 / (d ** 0.5), int(causal), DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: error {rc}")
    flash_cuda.launches += 1
    return out


flash_cuda.launches = 0
