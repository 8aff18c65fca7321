"""Hyperedge-pair bitset intersection: AND + popcount over word rows,
summed per pair, in one CUDA kernel.

Two forms, as in the JAX package's ``repro.kernels.isect.isect``:

* ``isect_cuda`` (K3a, the TPU's ``isect_pallas``): pre-gathered rows
  ``a, b [P, W]`` -> ``[P]``;
* ``isect_fused_cuda`` (K3b, the TPU's ``isect_pallas_fused``): rows
  gathered inside the kernel from ``bits [E, W]`` by pair ids
  ``ea, eb [P]``, and by a third id stream ``ec`` for triples (the
  census's ``a & b & c``).

Both wrap the hand-written Hopper kernel in ``repro_torch/csrc/isect.cu``
(a persistent grid whose warps take 32 pairs at a time, each lane one
16-byte slice of a row when ``W % 4 == 0``; K3b keeps the rows whose id
repeats from the pair before in registers, K3a streams its rows through
a shared-memory ring filled by ``cp.async``; a transposed shuffle
reduction leaves lane i with pair i's total; see the note in the
source).  ``isect_plain`` / ``isect_fused_plain``
are their plain PyTorch versions, tiled over pairs so the temporaries
stay ``tile x W``: the CPU path and the oracle the kernel is held
against on the card.  The words are int32 holding the reference's uint32 bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_operand

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 words, as int64.

    The words are widened to int64 and masked to their low 32 bits
    first: an int32 ``>>`` shifts arithmetically, and ``torch.uint32``
    has no shift on the CPU.  SWAR in int64 cannot overflow.
    """
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) >> 24) & 0xFF


def _pairs_plain(rows, n: int, tile: int, device) -> torch.Tensor:
    """``rows(lo, hi)`` -> the ANDed ``[hi - lo, W]`` words of a tile;
    the per-pair popcount sums, tile by tile."""
    out = torch.empty(n, dtype=torch.int32, device=device)
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        out[lo:hi] = popcount_words(rows(lo, hi)).sum(dim=1)
    return out


def isect_plain(a: torch.Tensor, b: torch.Tensor, *,
                tile: int = 2048) -> torch.Tensor:
    """``a, b [P, W]`` int32 -> ``[P]`` int32, ``sum(popcount(a & b))``
    per row, in stock torch ops."""
    return _pairs_plain(lambda lo, hi: a[lo:hi] & b[lo:hi], a.shape[0],
                        tile, a.device)


def isect_fused_plain(bits: torch.Tensor, ea: torch.Tensor,
                      eb: torch.Tensor, ec: torch.Tensor | None = None, *,
                      tile: int = 2048) -> torch.Tensor:
    """``bits [E, W]`` int32, ids ``ea, eb`` (and ``ec``) ``[P]`` ->
    ``[P]`` int32 intersection sizes, in stock torch ops."""
    ids = [t for t in (ea, eb, ec) if t is not None]

    def rows(lo, hi):
        x = bits.index_select(0, ids[0][lo:hi])
        for i in ids[1:]:
            x &= bits.index_select(0, i[lo:hi])
        return x

    return _pairs_plain(rows, ea.shape[0], tile, bits.device)


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("isect", ("isect.cu",))
    if lib.isect_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.isect_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.isect_launch.restype = ctypes.c_int
        lib.isect_fused_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.isect_fused_launch.restype = ctypes.c_int
    return lib


def _vec(w: int, *rows: torch.Tensor) -> int:
    """1 when every row of every operand starts on a 16-byte boundary."""
    return int(w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows))


def isect_cuda(a: torch.Tensor, b: torch.Tensor, *,
               tile: int = 2048) -> torch.Tensor:
    """K3a through the CUDA kernel: same arguments and result as
    ``isect_plain``.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (counted in ``isect_cuda.launches``) or
    raises.  ``tile`` only bounds the plain version's temporaries."""
    if a.device.type == "cpu":
        return isect_plain(a, b, tile=tile)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"no intersection kernel for device {dev}")
    check_operand("a", a, torch.int32, 2, dev)
    check_operand("b", b, torch.int32, 2, dev)
    if a.shape != b.shape:
        raise ValueError(f"a and b differ in shape: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    p, w = a.shape
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    if w == 0:
        return out.zero_()
    rc = _kernel_lib().isect_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), int(w), int(p),
        _vec(w, a, b),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"isect kernel launch failed: error {rc}")
    isect_cuda.launches += 1
    return out


isect_cuda.launches = 0


def isect_fused_cuda(bits: torch.Tensor, ea: torch.Tensor,
                     eb: torch.Tensor, ec: torch.Tensor | None = None, *,
                     tile: int = 2048) -> torch.Tensor:
    """K3b through the CUDA kernel: same arguments and result as
    ``isect_fused_plain``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (counted in
    ``isect_fused_cuda.launches``) or raises.  Ids must lie in
    ``[0, E)``: the kernel does not check them."""
    if bits.device.type == "cpu":
        return isect_fused_plain(bits, ea, eb, ec, tile=tile)
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"no intersection kernel for device {dev}")
    check_operand("bits", bits, torch.int32, 2, dev)
    for name, t in (("ea", ea), ("eb", eb), ("ec", ec)):
        if t is None:
            continue
        check_operand(name, t, torch.int32, 1, dev)
        if t.shape != ea.shape:
            raise ValueError(f"{name} has {t.shape[0]} ids, ea "
                             f"{ea.shape[0]}")
    p = ea.shape[0]
    e, w = bits.shape
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    if e == 0:
        raise ValueError("ids index an empty bitset")
    if w == 0:
        return out.zero_()
    rc = _kernel_lib().isect_fused_launch(
        bits.data_ptr(), ea.data_ptr(), eb.data_ptr(),
        ec.data_ptr() if ec is not None else None, out.data_ptr(), int(w),
        int(p), _vec(w, bits),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"isect_fused kernel launch failed: error {rc}")
    isect_fused_cuda.launches += 1
    return out


isect_fused_cuda.launches = 0
