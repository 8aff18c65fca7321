"""Fused incidence delivery over a dst-sorted, degree-classed CSR layout:
gather + live mask + segment-combine per class, in one CUDA kernel.

``deliver_fused_cuda`` wraps the hand-written Hopper kernel in
``repro_torch/csrc/deliver_fused.cu`` (one thread block per tile of
destination rows, a group of lanes and a register shuffle tree per row,
no atomics; see the note in the source).
``deliver_fused_plain`` is its plain PyTorch version: the same function
on the same arguments, gather -> mask -> ``scatter_reduce``.  The plain
version is the CPU path and the oracle the kernel is held against on
the card; it ignores ``bounds`` (they only narrow where the kernel
looks), so a wrong bound shows up as a disagreement.

``deliver_fused_classes`` runs one launch per degree class and
assembles the class partials through the layout's ``inv_perm`` gather.
``layout_from_numpy`` carries a layout over from any object with the
``DeliveryLayout`` fields whose arrays convert with ``np.asarray``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import check_operand
from repro_torch.kernels.deliver.layout import DeliveryLayout
from repro_torch.sparse.segment import MONOIDS, scatter_fold

# The kernel's codes (csrc/deliver_fused.cu).  "or" reaches it as an
# int32 max, through ``_pallas_leaf`` in ``kernels/deliver/__init__.py``.
_DTYPES = {torch.float32: 0, torch.int32: 1}
_MONOIDS = {"sum": 0, "min": 1, "max": 2, "prod": 3}


def deliver_fused_plain(
    msgs_aug: torch.Tensor,
    act_aug: torch.Tensor | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    bounds: torch.Tensor,
    n_rows: int,
    monoid_name: str,
    *,
    block_n: int = 128,
    block_e: int = 256,
) -> torch.Tensor:
    """One class of fused delivery in stock torch ops.

    msgs_aug: ``[n_src + 1, D]`` messages with the identity row appended.
    act_aug: optional ``[n_src + 1]`` int32 activity (identity row live).
    src / dst: ``[nnz_pad]`` int32 class CSR lanes (dst-sorted, class-local
      rows; padding lanes have ``dst >= n_rows``).
    bounds / block_n / block_e: the tile skip table; unused here.

    Returns ``[n_rows, D]``: per row, the monoid fold of the live senders'
    rows, the identity where there are none.
    """
    del bounds, block_n, block_e
    ident = MONOIDS[monoid_name].identity(msgs_aug.dtype)
    src_l = src.to(torch.int64)
    rows = msgs_aug.index_select(0, src_l)
    if act_aug is not None:
        live = act_aug.index_select(0, src_l) != 0
        rows = torch.where(live[:, None], rows,
                           torch.full((), ident, dtype=rows.dtype,
                                      device=rows.device))
    # Padding lanes (dst >= n_rows) fold into a spare row, sliced off.
    idx = torch.clamp(dst.to(torch.int64), max=n_rows)
    out = torch.full((n_rows + 1, msgs_aug.shape[1]), ident,
                     dtype=msgs_aug.dtype, device=msgs_aug.device)
    return scatter_fold(out, idx, rows, monoid_name)[:n_rows]


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("deliver_fused", ("deliver_fused.cu",))
    fn = lib.deliver_fused_launch
    if fn.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def deliver_fused_cuda(
    msgs_aug: torch.Tensor,
    act_aug: torch.Tensor | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    bounds: torch.Tensor,
    n_rows: int,
    monoid_name: str,
    *,
    block_n: int = 128,
    block_e: int = 256,
) -> torch.Tensor:
    """One class of fused delivery through the CUDA kernel.

    Same arguments and result as ``deliver_fused_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted
    in ``deliver_fused_cuda.launches``) or raises on anything the kernel
    does not take.
    """
    if msgs_aug.device.type == "cpu":
        return deliver_fused_plain(
            msgs_aug, act_aug, src, dst, bounds, n_rows, monoid_name,
            block_n=block_n, block_e=block_e,
        )
    dev = msgs_aug.device
    if dev.type != "cuda":
        raise ValueError(f"no fused delivery kernel for device {dev}")
    if msgs_aug.dtype not in _DTYPES:
        raise TypeError(
            f"kernel takes float32 or int32 messages, got {msgs_aug.dtype}"
        )
    if monoid_name not in _MONOIDS:
        raise ValueError(
            f"kernel takes monoids {sorted(_MONOIDS)}, got {monoid_name!r}"
        )
    check_operand("msgs_aug", msgs_aug, None, 2, dev)
    check_operand("src", src, torch.int32, 1, dev)
    check_operand("dst", dst, torch.int32, 1, dev)
    check_operand("bounds", bounds, torch.int32, 2, dev)
    n_src_aug, d = msgs_aug.shape
    nnz_pad = src.shape[0]
    if dst.shape[0] != nnz_pad:
        raise ValueError(f"src/dst lengths differ: {nnz_pad} vs "
                         f"{dst.shape[0]}")
    if not 0 < block_n <= 4096 or block_e <= 0 or nnz_pad % block_e:
        raise ValueError(f"lanes ({nnz_pad}) must be a multiple of block_e "
                         f"({block_e}) and 0 < block_n ({block_n}) <= 4096")
    n_tiles = -(-max(int(n_rows), 1) // block_n)
    if tuple(bounds.shape) != (n_tiles, 2):
        raise ValueError(f"bounds must be [{n_tiles}, 2], got "
                         f"{tuple(bounds.shape)}")
    if act_aug is not None:
        check_operand("act_aug", act_aug, torch.int32, 1, dev)
        if act_aug.shape[0] != n_src_aug:
            raise ValueError(f"act_aug has {act_aug.shape[0]} rows, "
                             f"msgs_aug {n_src_aug}")
    if n_rows >= 2**31 or n_src_aug * d >= 2**62:
        raise ValueError("class too large for the kernel's indexing")
    out = torch.empty((int(n_rows), d), dtype=msgs_aug.dtype, device=dev)
    if n_rows == 0 or d == 0:
        return out
    rc = _kernel_lib().deliver_fused_launch(
        msgs_aug.data_ptr(),
        act_aug.data_ptr() if act_aug is not None else None,
        src.data_ptr(), dst.data_ptr(), bounds.data_ptr(), out.data_ptr(),
        int(n_rows), int(d), int(nnz_pad), int(block_n), int(block_e),
        _DTYPES[msgs_aug.dtype], _MONOIDS[monoid_name],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"deliver_fused kernel launch failed: error {rc}")
    deliver_fused_cuda.launches += 1
    return out


deliver_fused_cuda.launches = 0


def deliver_fused_classes(
    msgs_aug: torch.Tensor,
    act_aug: torch.Tensor | None,
    layout: DeliveryLayout,
    monoid_name: str,
    *,
    lowering: str = "cuda",
) -> torch.Tensor:
    """One leaf's fused delivery over a degree-classed layout: one launch
    per class, assembled with the ``inv_perm`` gather.

    msgs_aug: ``[n_src + 1, D]`` with the identity row appended.
    act_aug: optional ``[n_src + 1]`` int32 activity, or None.
    lowering: ``cuda`` (the kernel wrapper) or ``plain``.

    Returns ``[n_dst, D]``.
    """
    fn = {"cuda": deliver_fused_cuda, "plain": deliver_fused_plain}[lowering]
    outs = [
        fn(
            msgs_aug, act_aug, layout.class_src[c], layout.class_dst[c],
            layout.class_bounds[c], layout.class_rows[c], monoid_name,
            block_n=layout.block_n, block_e=layout.class_block_e[c],
        )
        for c in range(layout.n_classes)
    ]
    # Class partials stack class-major (matching slot assignment); the
    # appended identity row serves every zero-degree destination.
    return torch.cat(outs + [msgs_aug[-1:]], dim=0).index_select(
        0, layout.inv_perm
    )


def layout_from_numpy(layout, device=None) -> DeliveryLayout:
    """A port ``DeliveryLayout`` from any object with the same fields
    (a JAX one included): every array through ``np.asarray`` as int32,
    onto ``device`` (default: the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.int32), device=dev)
    return DeliveryLayout(
        class_ell=tuple(t(a) for a in layout.class_ell),
        class_src=tuple(t(a) for a in layout.class_src),
        class_dst=tuple(t(a) for a in layout.class_dst),
        class_bounds=tuple(t(a) for a in layout.class_bounds),
        inv_perm=t(layout.inv_perm),
        rem_src=t(layout.rem_src),
        rem_dst=t(layout.rem_dst),
        n_src=int(layout.n_src),
        n_dst=int(layout.n_dst),
        nnz=int(layout.nnz),
        rem_nnz=int(layout.rem_nnz),
        class_widths=tuple(int(w) for w in layout.class_widths),
        class_rows=tuple(int(r) for r in layout.class_rows),
        block_n=int(layout.block_n),
        class_block_e=tuple(int(b) for b in layout.class_block_e),
        class_max_blocks=tuple(int(b) for b in layout.class_max_blocks),
    )
