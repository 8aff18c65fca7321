"""Segment sum of message rows by destination id, in CUDA kernels.

Two forms, as the two bodies of the JAX package's
``repro.kernels.segsum.segsum.segsum_pallas``:

* ``segsum_cuda`` (K2a, the unsorted body): ``msgs [E, D]`` and ids
  ``dst [E]`` in any order -> ``[N, D]``, the edges bucketed by output
  tile and each tile summed in shared memory (``k2a_geometry`` sizes
  its launches and scratch);
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
import functools
from typing import NamedTuple

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


# K2a's constants, as in csrc/segsum.cu (kFan, 32 * kMaxMaskWords) and
# its dynamic shared memory budget: a float32 tile and block_n row bins
# (the rest of the 48 KB a block takes without opting in holds the
# touched-row masks and the sorted chunk of edges).
K2A_FAN_IN = 8
K2A_MAX_ROWS = 4096
K2A_SMEM_BYTES = 40960


class K2aGeometry(NamedTuple):
    """What ``segsum_cuda`` sizes K2a's launches and scratch by (see
    ``k2a_geometry``)."""
    n_tiles: int       # output tiles of block_n rows
    vec: int           # elements per message load: 16 bytes, or 1
    d_slice: int       # columns per block (a multiple of vec)
    n_slices: int      # column slices: ceil(d / d_slice)
    smem_bytes: int    # float32 [block_n, d_slice] tile, block_n bins
    grid_items: int    # work items launched: >= the real count
    slots: int         # partials of heavy tiles' combine trees, bound
    tickets: int       # their tickets, bound
    mask_words: int    # touched-row bits per partial
    int_words: int     # int32 scratch, laid out as segsum_launch reads it
    partial_floats: int


def _tree_sizes(k: int) -> tuple[int, int]:
    """(slots, tickets) of the combine tree of a tile of ``k`` work items,
    as ``tree_sizes`` in the source: every level with more than one node
    writes a slot per node and a ticket per group of ``K2A_FAN_IN``."""
    slots = tickets = 0
    while k > 1:
        slots += k
        k = -(-k // K2A_FAN_IN)
        tickets += k
    return slots, tickets


@functools.lru_cache(maxsize=None)
def _tree_rates(block_e: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The largest slots and tickets per edge over heavy tiles, as
    (count, edges) fractions: a tile of k >= 2 items holds at least
    (k - 1) * block_e + 1 edges.  Both peak at a few items (the tree adds
    at most a seventh above level 0), so k up to 1024 covers every k."""
    best = [(0, 1), (0, 1)]
    for k in range(2, 1025):
        edges = (k - 1) * block_e + 1
        for i, size in enumerate(_tree_sizes(k)):
            if size * best[i][1] > best[i][0] * edges:
                best[i] = (size, edges)
    return best[0], best[1]


@functools.lru_cache(maxsize=256)
def k2a_geometry(n_edges: int, n: int, d: int, itemsize: int, block_n: int,
                 block_e: int, aligned: bool = True) -> K2aGeometry:
    """K2a's launch geometry and scratch sizes for ``msgs [n_edges, d]``
    of ``itemsize`` bytes into ``n`` rows, ``block_n`` rows per tile and
    ``block_e`` edges per work item.  ``aligned``: the message base
    address is a multiple of 16 bytes.

    * Messages load 16 bytes at a time (4 float32, 8 bfloat16) when every
      row starts on a 16-byte boundary, else one element.
    * A block's float32 tile, ``block_n x d_slice``, and its ``block_n``
      int32 row bins fit ``K2A_SMEM_BYTES``; wider rows are cut into
      balanced slices, each a multiple of the vector width.
    * Work items are ``max(1, ceil(count / block_e))`` per tile, so at
      most ``n_tiles + ceil(n_edges / block_e)``: the grid.
    * Slots and tickets are bounded by the heaviest rate per edge that a
      tile of several items can have (``_tree_rates``) times the edges.
    """
    if not 0 < block_n <= K2A_MAX_ROWS:
        raise ValueError(f"block_n must lie in [1, {K2A_MAX_ROWS}] for the "
                         f"unsorted kernel, got {block_n}")
    if block_e <= 0:
        raise ValueError(f"block_e must be positive, got {block_e}")
    vec = 16 // itemsize if aligned and d * itemsize % 16 == 0 else 1
    fit = (K2A_SMEM_BYTES - 4 * block_n) // (4 * block_n)
    if fit < vec:
        vec = 1
    max_cols = fit // vec * vec
    slices = -(-d // max_cols)
    d_slice = -(-(-(-d // slices)) // vec) * vec
    n_slices = -(-d // d_slice)
    if n_slices > 65535:
        raise ValueError(f"D = {d} needs {n_slices} column slices of "
                         f"{d_slice}; the grid takes at most 65535")
    n_tiles = -(-n // block_n)
    grid_items = n_tiles + -(-n_edges // block_e)
    (s_num, s_den), (t_num, t_den) = _tree_rates(block_e)
    slots = n_edges * s_num // s_den
    tickets = n_edges * t_num // t_den
    mask_words = -(-block_n // 32)
    int_words = (2 * n_edges + 2 * n_tiles + tickets * n_slices
                 + 4 * (n_tiles + 1) + 1 + grid_items
                 + slots * n_slices * mask_words)
    return K2aGeometry(
        n_tiles, vec, d_slice, n_slices, 4 * block_n * (d_slice + 1),
        grid_items, slots, tickets, mask_words, int_words,
        slots * n_slices * block_n * d_slice)


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("segsum", ("segsum.cu",))
    if lib.segsum_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.segsum_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong] + [ctypes.c_int] * 8 + [
            ctypes.c_longlong] * 3 + [ctypes.c_void_p]
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
                *, block_n: int = 128, block_e: int = 512) -> torch.Tensor:
    """K2a through the CUDA kernels: same arguments and result as
    ``segsum_plain``; output tiles of ``block_n`` rows summed in shared
    memory, ``block_e`` edges per work item (``k2a_geometry``).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernels
    (one call queues them all; counted once in ``segsum_cuda.launches``)
    or raises.

    The order in which a tile adds a row's edges (set by atomics in the
    bucketing and the counting sort) changes from run to run: a float
    sum may differ in its last bits between two runs (it is not bitwise
    repeatable; the sorted form is).
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
    geo = k2a_geometry(e, num_segments, d, msgs.element_size(), block_n,
                       block_e, msgs.data_ptr() % 16 == 0)
    scratch = torch.empty(geo.int_words, dtype=torch.int32, device=dev)
    partials = torch.empty(geo.partial_floats, dtype=torch.float32,
                           device=dev)
    rc = _kernel_lib().segsum_launch(
        msgs.data_ptr(), dst.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        partials.data_ptr(), int(e), int(num_segments), int(d),
        DTYPES[msgs.dtype], int(block_n), int(block_e), geo.vec, geo.d_slice,
        geo.n_slices, geo.grid_items, geo.slots, geo.tickets,
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

