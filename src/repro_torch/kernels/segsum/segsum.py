"""Segment sum of message rows by destination id, in one CUDA kernel.

Two forms, as the two bodies of the JAX package's
``repro.kernels.segsum.segsum.segsum_pallas``:

* ``segsum_cuda`` (K2a, the unsorted body): ``msgs [E, D]`` and ids
  ``dst [E]`` in any order -> ``[N, D]``;
* ``segsum_sorted_cuda`` (K2b, the sorted body with its block-sparse
  skip): ids non-decreasing, given as CSR row offsets ``[N + 1]``, so
  each output tile reads only its own edges.

Both wrap the hand-written Hopper kernels in ``repro_torch/csrc/segsum.cu``
(see the note in the source).  ``segsum_plain`` / ``segsum_sorted_plain``
are their plain PyTorch versions: the CPU path and the oracle the
kernels are held against on the card (``ref.segment_sum_ref`` is
``segsum_plain`` under the JAX oracle's name).  ``ops.segment_sum_mxu``
chooses the form, as ``segsum_pallas`` does by its ``tile_bounds``.

Every form sums in float32 and returns the type of ``msgs`` (float32 or
bfloat16); ids outside ``[0, N)`` are dropped.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_operand

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_dtype(msgs: torch.Tensor) -> None:
    if msgs.dtype not in DTYPES:
        raise TypeError(f"segment sum takes float32 or bfloat16 messages, "
                        f"got {msgs.dtype}")


def segsum_plain(msgs: torch.Tensor, dst: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``msgs [E, D]`` summed by ``dst [E]`` into ``[num_segments, D]``
    in stock torch ops: float32 ``index_add_`` over the edges whose id
    lies in ``[0, num_segments)``, cast to the type of ``msgs``."""
    _check_dtype(msgs)
    keep = (dst >= 0) & (dst < num_segments)
    out = torch.zeros(num_segments, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    out.index_add_(0, dst[keep].long(), msgs[keep].float())
    return out.to(msgs.dtype)


def segsum_sorted_plain(msgs: torch.Tensor, row_offsets: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """K2b's function in stock torch ops: row ``r`` sums ``msgs`` rows
    ``[row_offsets[r], row_offsets[r + 1])``; edges before
    ``row_offsets[0]`` or after ``row_offsets[-1]`` are dropped.  On the
    CPU it gives the same bits as ``segsum_plain`` on the ids the offsets
    were made from."""
    _check_dtype(msgs)
    off = row_offsets.long()
    ids = torch.repeat_interleave(
        torch.arange(num_segments, device=msgs.device), off.diff())
    out = torch.zeros(num_segments, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    if num_segments:
        out.index_add_(0, ids, msgs[int(off[0]):int(off[-1])].float())
    return out.to(msgs.dtype)


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("segsum", ("segsum.cu",))
    if lib.segsum_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.segsum_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.segsum_launch.restype = ctypes.c_int
        lib.segsum_sorted_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.segsum_sorted_launch.restype = ctypes.c_int
    return lib


def _check_common(msgs: torch.Tensor, num_segments: int, block: int,
                  block_name: str) -> torch.device:
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {dev}")
    _check_dtype(msgs)
    check_operand("msgs", msgs, None, 2, dev)
    if not 0 <= num_segments < 2**31 or msgs.shape[0] >= 2**31:
        raise ValueError(f"num_segments {num_segments} and E "
                         f"{msgs.shape[0]} must lie in [0, 2**31)")
    if block <= 0:
        raise ValueError(f"{block_name} must be positive, got {block}")
    return dev


def segsum_cuda(msgs: torch.Tensor, dst: torch.Tensor, num_segments: int,
                *, block_e: int = 512) -> torch.Tensor:
    """K2a through the CUDA kernel: same arguments and result as
    ``segsum_plain``; ``block_e`` edges per thread block.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted
    in ``segsum_cuda.launches``) or raises.

    The kernel adds into a float32 buffer with atomics, whose order
    changes from run to run: a float sum may differ in its last bits
    between two runs (it is not bitwise repeatable; the sorted form is).
    """
    if msgs.device.type == "cpu":
        return segsum_plain(msgs, dst, num_segments)
    dev = _check_common(msgs, num_segments, block_e, "block_e")
    check_operand("dst", dst, torch.int32, 1, dev)
    e, d = msgs.shape
    if dst.shape[0] != e:
        raise ValueError(f"dst has {dst.shape[0]} ids for {e} messages")
    out = torch.empty(num_segments, d, dtype=msgs.dtype, device=dev)
    if e == 0 or num_segments == 0 or d == 0:
        return out.zero_()
    acc = out if msgs.dtype == torch.float32 else torch.empty(
        num_segments, d, dtype=torch.float32, device=dev)
    rc = _kernel_lib().segsum_launch(
        msgs.data_ptr(), dst.data_ptr(), acc.data_ptr(), out.data_ptr(),
        int(e), int(num_segments), int(d), int(block_e), DTYPES[msgs.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: error {rc}")
    segsum_cuda.launches += 1
    return out


segsum_cuda.launches = 0


def segsum_sorted_cuda(msgs: torch.Tensor, row_offsets: torch.Tensor,
                       num_segments: int, *,
                       block_n: int = 128) -> torch.Tensor:
    """K2b through the CUDA kernel: same arguments and result as
    ``segsum_sorted_plain``; ``block_n`` rows per thread block.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``segsum_sorted_cuda.launches``) or raises.

    ``row_offsets`` must be non-decreasing and lie in ``[0, E]``: the
    kernel reads the rows they name unchecked (``segment_sum_mxu`` makes
    them so).  Each output element is folded in edge order by one lane,
    so the result is the same bits on every run."""
    if msgs.device.type == "cpu":
        return segsum_sorted_plain(msgs, row_offsets, num_segments)
    dev = _check_common(msgs, num_segments, block_n, "block_n")
    check_operand("row_offsets", row_offsets, torch.int32, 1, dev)
    if row_offsets.shape[0] != num_segments + 1:
        raise ValueError(f"row_offsets has {row_offsets.shape[0]} entries, "
                         f"expected num_segments + 1 = {num_segments + 1}")
    e, d = msgs.shape
    out = torch.empty(num_segments, d, dtype=msgs.dtype, device=dev)
    if e == 0 or num_segments == 0 or d == 0:
        return out.zero_()
    rc = _kernel_lib().segsum_sorted_launch(
        msgs.data_ptr(), row_offsets.data_ptr(), out.data_ptr(),
        int(num_segments), int(d), int(block_n), DTYPES[msgs.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segsum_sorted kernel launch failed: error {rc}")
    segsum_sorted_cuda.launches += 1
    return out


segsum_sorted_cuda.launches = 0

