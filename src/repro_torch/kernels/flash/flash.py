"""FlashAttention forward (causal or bidirectional, multi-head or
grouped-query, with an online softmax) in one CUDA kernel per type.

``flash_cuda`` (K4, the TPU's ``repro.kernels.flash.flash.flash_pallas``)
wraps the hand-written Hopper kernels in ``repro_torch/csrc/flash.cu``
(see the note in the source): bfloat16 on the tensor cores (``wgmma``,
K and V in a ring of tiles filled by TMA); float32 at head dims that are
multiples of 8 up to ``TF32_MAX_HEAD_DIM`` on the tensor cores too, as
three TF32 passes (each operand split into a tf32 hi and lo, lo.hi +
hi.lo + hi.hi summed in float32: the dropped lo.lo term is about 2^-22
of a product), and at other head dims on the FMA units (IEEE float32
products).  ``flash_plan`` is the tiling each one launches with.
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

The backward (training) has no TPU kernel: the JAX package takes the
gradient by autodiff of its stock-op attention.  ``FlashAttentionFn`` is
the same gradient: its forward is K4 with each row's log-sum-exp kept
(``flash_cuda(..., return_lse=True)``), its backward
``flash_backward_cuda``, three hand-written kernels queued by one call
(``csrc/flash_bwd.cu``: ``delta = rowsum(dO * O)``, then dK / dV per key
tile and KV head, then dQ per query tile and head, each recomputing
``p = exp(s * scale - lse)``, deterministic; bfloat16 at ``D % 8 == 0``
up to 128 on the tensor cores with ``wgmma`` and TMA, float32 at
``D % 8 == 0`` up to ``TF32_BWD_MAX_HEAD_DIM`` there in three TF32
passes, the rest on the FMA units, ``flash_bwd_plan``), and
``flash_plain_backward`` their plain version, the same recurrence over
key blocks in stock torch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import check_operand, is_fake
from repro_torch.kernels.flash.ref import NEG_INF

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TF32_MAX_HEAD_DIM = 128      # the forward's three-pass TF32 route
TF32_BWD_MAX_HEAD_DIM = 64   # the backward's
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can use


class FlashPlan(NamedTuple):
    """How ``csrc/flash.cu`` tiles one head dim and type."""

    kernel: str       # "wgmma" (bfloat16), "tf32" (float32, three-pass
                      # TF32 on the tensor cores) or "fma" (float32)
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
    float32 with ``d % 8 == 0`` up to ``TF32_MAX_HEAD_DIM``: the
    three-pass TF32 kernel, ``d`` padded to 32, 64 or 128, 128 queries
    (two warpgroups of 64), 64 keys a tile at width 64 and 32 otherwise,
    one stage in shared memory (the next tile waits in registers): the hi
    and lo float32 tiles of Q, K and V's transpose, and 1 KB of
    alignment.
    float32 otherwise: 64 queries by 64 keys on the FMA units, the
    accumulator in ``16 * NJ`` columns (``NJ`` = ``ceil(d / 16)`` rounded
    up to a power of two) and Q, K, V, P tiles in float32 with an odd row
    stride."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if dtype == torch.bfloat16:
        dp = 64 if d <= 64 else 128 if d <= 128 else 256
        bq, bk, stages = 128, (128 if dp == 64 else 64), 2
        return FlashPlan("wgmma", dp, bq, bk, stages,
                         2 * dp * (bq + 2 * stages * bk) + 64 + 1024)
    if dtype == torch.float32 and d % 8 == 0 and d <= TF32_MAX_HEAD_DIM:
        dp = 32 if d <= 32 else 64 if d <= 64 else 128
        bq, bk = 128, (64 if dp == 64 else 32)
        return FlashPlan("tf32", dp, bq, bk, 1,
                         2 * 4 * dp * (bq + 2 * bk) + 1024)
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
                block_k: int = 128, return_lse: bool = False):
    """``q [B, H, Sq, D]``, ``k, v [B, KvH, Sk, D]`` -> ``[B, H, Sq, D]``
    in the type of ``q``: the online-softmax recurrence over key blocks
    of ``block_k``, ``block_q`` queries at a time, so that the float32
    scores never take more than ``B H block_q block_k`` elements.  Causal
    key blocks wholly past a query chunk are skipped (their ``p`` is 0).
    The ``H // KvH`` query heads of a KV head are one broadcast dim.
    ``return_lse``: also each row's log-sum-exp ``m + log l``, ``[B, H,
    Sq]`` float32 (what the backward recomputes ``p`` from)."""
    b, h, sq, d = q.shape
    kvh = _kv_heads(q, k, v)
    sk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.view(b, kvh, h // kvh, sq, d)
    kg, vg = k[:, :, None], v[:, :, None]  # [B, KvH, 1, Sk, D]
    out = torch.empty_like(qg)
    lse = (torch.empty(qg.shape[:4], dtype=torch.float32, device=q.device)
           if return_lse else None)
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
        den = l.clamp_min(1e-30)
        out[:, :, :, q0:q0 + rows] = (acc / den).to(q.dtype)
        if lse is not None:
            lse[:, :, :, q0:q0 + rows] = (m + torch.log(den))[..., 0]
    if lse is not None:
        return out.view(b, h, sq, d), lse.view(b, h, sq)
    return out.view(b, h, sq, d)


def flash_plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, *, causal: bool = True,
                         block_q: int = 128, block_k: int = 128):
    """The gradient of ``flash_plain``: ``(dq, dk, dv)`` in the types and
    shapes of ``q, k, v`` from the forward's ``out`` and row ``lse``
    (``[B, H, Sq]`` float32) and ``dout``, ``block_q`` queries by
    ``block_k`` keys at a time in float32, the backward kernels' plain
    version.  Per block, ``p = exp(s * scale - lse)`` with the forward's
    ``-1e30`` sentinel on masked scores (so their ``p`` is 0),
    ``dS = p (dO v^T - delta)`` with ``delta = rowsum(dO * O)``; ``dV``
    sums ``p`` rounded to the type of ``v`` (as the forward's product
    took it) times ``dO``, ``dK`` and ``dQ`` sum ``dS`` times ``q`` and
    ``k``, scaled by ``1 / sqrt(D)`` once at the end.  ``dK`` and ``dV``
    of a KV head sum its ``H // KvH`` query heads.  Causal key blocks
    wholly past a query chunk are skipped."""
    b, h, sq, d = q.shape
    kvh = _kv_heads(q, k, v)
    sk = k.shape[2]
    rep = h // kvh
    scale = 1.0 / (d ** 0.5)
    qg = q.view(b, kvh, rep, sq, d)
    dog = dout.reshape(b, kvh, rep, sq, d)
    delta = (dog.float() * out.reshape(b, kvh, rep, sq, d).float()).sum(
        -1, keepdim=True)
    lse_g = lse.reshape(b, kvh, rep, sq, 1)
    kg, vg = k[:, :, None], v[:, :, None]  # [B, KvH, 1, Sk, D]
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        qc = qg[:, :, :, q0:q0 + block_q].float()
        doc = dog[:, :, :, q0:q0 + block_q].float()
        rows = qc.shape[3]
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        lc = lse_g[:, :, :, q0:q0 + rows]
        dc = delta[:, :, :, q0:q0 + rows]
        k_end = min(sk, q0 + rows) if causal else sk
        for k0 in range(0, k_end, block_k):
            kc = kg[:, :, :, k0:k0 + block_k].float()
            vc = vg[:, :, :, k0:k0 + block_k].float()
            n = kc.shape[3]
            s = (qc @ kc.transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + n, device=q.device)
                s = torch.where(kpos[None, :] <= qpos, s, NEG_INF)
            p = torch.exp(s - lc)
            ds = p * (doc @ vc.transpose(-1, -2) - dc)
            pv = p.to(v.dtype).float()
            dv[:, :, k0:k0 + n] += (pv.transpose(-1, -2) @ doc).sum(2)
            dk[:, :, k0:k0 + n] += (ds.transpose(-1, -2) @ qc).sum(2)
            dq[:, :, :, q0:q0 + rows] += ds @ kc
    return ((dq * scale).to(q.dtype).view(b, h, sq, d),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("flash", ("flash.cu",))
    if lib.flash_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.flash_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.flash_launch.restype = ctypes.c_int
        lib.flash_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_smem_bytes.restype = ctypes.c_int
    return lib


def _check_forward(q, k, v) -> tuple[int, int, int, int, int, int]:
    """The forward's checks (types, layouts, heads, widths):
    ``(B, H, KvH, Sq, Sk, D)``."""
    if q.dtype not in DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    check_operand("q", q, q.dtype, 4, q.device)
    check_operand("k", k, q.dtype, 4, q.device)
    check_operand("v", v, q.dtype, 4, q.device)
    b, h, sq, d = q.shape
    kvh = _kv_heads(q, k, v)
    sk = k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if sk == 0:
        raise ValueError("attention needs at least one key")
    if max(b * h, sq, sk) >= 2**31:
        raise ValueError("B*H, Sq and Sk must be below 2**31")
    return b, h, kvh, sq, sk, d


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, return_lse: bool = False):
    """K4 through the CUDA kernels: same result as ``flash_plain`` (the
    kernels' tiles are their own, ``flash_plan``'s).  A CPU tensor takes
    the plain version with its default blocks; a CUDA tensor launches the
    kernel for its type (counted in ``flash_cuda.launches``) or raises.
    ``q [B, H, Sq, D]``, ``k, v [B, KvH, Sk, D]`` with ``H`` a multiple
    of ``KvH`` (each block reads its KV head by index); ``D`` may be 1 to
    256.  ``return_lse``: ``(out, lse)``, with each row's log-sum-exp
    (``[B, H, Sq]`` float32) written by the same launch.  A fake tensor
    (``kernels.is_fake``) takes the fake route: the same checks, ``out``
    and ``lse`` allocated, the work (``roofline.analysis.flash_work``)
    charged to the dry-run's trace, no launch."""
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        return flash_plain(q, k, v, causal=causal, return_lse=return_lse)
    dev = q.device
    if dev.type != "cuda" and not fake:
        raise ValueError(f"no attention kernel for device {dev}")
    b, h, kvh, sq, sk, d = _check_forward(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if b * h == 0 or sq == 0:
        return (out, lse) if return_lse else out
    if fake:
        from repro_torch.roofline.analysis import flash_work, kernel_work

        kernel_work("flash", *flash_work(b, h, kvh, sq, sk, d,
                                         q.element_size(), causal,
                                         lse=return_lse))
        return (out, lse) if return_lse else out
    rc = _kernel_lib().flash_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b * h, h, kvh, sq, sk, d, 1.0 / (d ** 0.5), int(causal),
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: error {rc}")
    flash_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_cuda.launches = 0


def _bwd_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("flash_bwd", ("flash_bwd.cu",))
    if lib.flash_bwd_launch.argtypes is None:
        lib.flash_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.flash_bwd_launch.restype = ctypes.c_int
        lib.flash_bwd_route.argtypes = [ctypes.c_int] * 2
        lib.flash_bwd_route.restype = ctypes.c_int
        lib.flash_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_bwd_smem_bytes.restype = ctypes.c_int
    return lib


class FlashBwdPlan(NamedTuple):
    """How ``csrc/flash_bwd.cu`` tiles one head dim and type."""

    kernel: str       # "wgmma" (bfloat16) or "tf32" (float32) on the
                      # tensor cores, or "fma" (FMA units)
    head_dim: int     # the width the kernels compute over, >= D
    block_rows: int   # a block's own rows: keys (dK / dV), queries (dQ)
    block_cols: int   # rows of a streamed tile: queries (dK / dV), keys
    stages: int       # streamed tiles in the shared-memory ring
    dkdv_smem: int    # dynamic shared memory of the dK / dV kernel
    dq_smem: int      # dynamic shared memory of the dQ kernel


def flash_bwd_plan(d: int, dtype: torch.dtype) -> FlashBwdPlan:
    """The route and tiles ``flash_bwd_launch`` picks for head dim ``d``
    and ``dtype``, as the source computes them (the card tests hold the
    two equal).

    bfloat16 with ``d % 8 == 0`` up to 128 (TMA's 16-byte rows; dK and
    dV of ``d`` = 256 would take every register a thread has): the
    tensor-core kernels, ``d`` padded to 64 or 128, 128 rows a block
    (two warpgroups of 64), streamed tiles of 64 rows in a ring of three;
    the two resident and six streamed bf16 tiles, for dK / dV each
    stage's 64 ``lse`` and ``delta`` floats, three mbarriers (64 bytes
    kept) and 1 KB to align the 128-byte swizzle atoms.
    float32 with ``d % 8 == 0`` up to ``TF32_BWD_MAX_HEAD_DIM`` (at 128
    the hi and lo tiles would not fit one block's shared memory): the
    three-pass TF32 kernels, ``d`` padded to 32 or 64, 128 rows a block,
    streamed tiles of 32 rows, one stage in shared memory (the next tile
    waits in registers); the hi and lo float32 tiles of the two resident
    operands and of the streamed ones (dK / dV: Q, dO and both
    transposed, and the tile's 32 ``lse`` and ``delta`` floats; dQ: K, V
    and K transposed), and 1 KB of alignment.
    float32 and bfloat16 otherwise: the FMA tiles, 64 rows square up to
    ``d`` = 128, 32 above; four float32 ``[block, d + 1]`` tiles, one
    (dQ) or two (dK / dV) ``[block, block + 1]`` product tiles and
    ``2 block`` row statistics."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if dtype not in DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= 128:
        dp = 64 if d <= 64 else 128
        rows, cols, stages = 128, 64, 3
        dq = 2 * dp * (2 * rows + 2 * stages * cols) + 64 + 1024
        return FlashBwdPlan("wgmma", dp, rows, cols, stages,
                            dq + stages * 2 * cols * 4, dq)
    if dtype == torch.float32 and d % 8 == 0 and d <= TF32_BWD_MAX_HEAD_DIM:
        dp = 32 if d <= 32 else 64
        rows, cols = 128, 32
        resident = 2 * 2 * 4 * dp * rows
        return FlashBwdPlan("tf32", dp, rows, cols, 1,
                            resident + 4 * 2 * 4 * dp * cols + 2 * cols * 4
                            + 1024,
                            resident + 3 * 2 * 4 * dp * cols + 1024)
    bt = 64 if d <= 128 else 32
    tiles = 4 * bt * (d + 1) + 2 * bt
    return FlashBwdPlan("fma", d, bt, bt, 1,
                        (tiles + 2 * bt * (bt + 1)) * 4,
                        (tiles + bt * (bt + 1)) * 4)


def flash_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True):
    """K4's backward through the CUDA kernels: ``(dq, dk, dv)`` as
    ``flash_plain_backward`` computes them (the bfloat16 tensor-core
    route rounds ``dS`` to bfloat16 before the dK and dQ products; the
    float32 one takes every product in three TF32 passes).  A CPU tensor
    takes the plain version; a CUDA tensor queues the three kernels of
    its route (``flash_bwd_plan``) with one call (counted once in
    ``flash_backward_cuda.launches``) or raises.  ``q, out, dout
    [B, H, Sq, D]``, ``k, v [B, KvH, Sk, D]`` in one type, ``lse [B, H,
    Sq]`` float32 from ``flash_cuda(..., return_lse=True)``.  A fake
    tensor takes the fake route (``flash_cuda``'s; its work is
    ``roofline.analysis.flash_bwd_work``)."""
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        return flash_plain_backward(q, k, v, out, lse, dout, causal=causal)
    dev = q.device
    if dev.type != "cuda" and not fake:
        raise ValueError(f"no attention kernel for device {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        check_operand(name, t, q.dtype, 4, dev)
    check_operand("lse", lse, torch.float32, 3, dev)
    b, h, sq, d = q.shape
    kvh = _kv_heads(q, k, v)
    sk = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (
            b, h, sq):
        raise ValueError("out and dout must be shaped as q, lse [B, H, Sq]")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if sk == 0:
        raise ValueError("attention needs at least one key")
    if max(b * h, sq, sk) >= 2**31:
        raise ValueError("B*H, Sq and Sk must be below 2**31")
    if fake:
        # The fake route: dQ, dK, dV allocated (not the kernels' delta
        # rows), the work charged to the trace.
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if b * h == 0 or sq == 0:
            return dq, dk.zero_(), dv.zero_()
        from repro_torch.roofline.analysis import flash_bwd_work, kernel_work

        kernel_work("flash_bwd", *flash_bwd_work(b, h, kvh, sq, sk, d,
                                                 q.element_size(), causal))
        return dq, dk, dv
    if flash_bwd_plan(d, q.dtype).kernel == "wgmma" and any(
            t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the tensor-core backward reads q, k, v and dout "
                         "by TMA: their data must start 16-byte aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b * h == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    rc = _bwd_lib().flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, h, kvh, sq, sk, d,
        1.0 / (d ** 0.5), int(causal), DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash backward launch failed: error {rc}")
    flash_backward_cuda.launches += 1
    return dq, dk, dv


flash_backward_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K4 with its gradient: the forward keeps q, k, v, the output and the
    row log-sum-exp; the backward is ``flash_backward_cuda`` (the kernels
    on a CUDA tensor, their plain version on a CPU one).  ``apply(q, k,
    v, causal)`` on contiguous ``[B, H, S, D]`` / ``[B, KvH, S, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_cuda(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward_cuda(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None
