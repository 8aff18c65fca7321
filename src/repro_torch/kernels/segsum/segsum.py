"""Segment sum of message rows by destination id, in CUDA kernels.

Two forms, as the two bodies of the JAX package's
``repro.kernels.segsum.segsum.segsum_pallas``:

* ``segsum_cuda`` (K2a, the unsorted body): ``msgs [E, D]`` and ids
  ``dst [E]`` in any order -> ``[N, D]``, the edges bucketed by output
  tile and each tile summed in shared memory (``k2a_geometry`` sizes
  its launches and scratch);
* ``segsum_sorted_cuda`` (K2b, the sorted body with its block-sparse
  skip): ids non-decreasing, given as CSR row offsets ``[N + 1]``; each
  thread block takes an equal share of the merge path of row ends and
  edges, so long rows are cut across blocks (``k2b_geometry`` sizes its
  grid, scratch and shared memory).

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


# K2b's constants, as in csrc/segsum.cu (kK2bThreads, 1 << kLgFan), and
# the most dynamic shared memory a block may opt into: 227 KB less the
# largest static arrays of a k2b_kernel template that runs, those of
# <bfloat16, 8, false> (s_wval [kK2bWarps][32 * 8] float32, s_ma
# [kK2bThreads] int32 and 48 bytes of scalars; repro_torch.analysis.shapes
# reads every template's from the source and holds the largest equal).
K2B_THREADS = 256
K2B_FAN_IN = 16
K2B_STATIC_BYTES = 4 * (K2B_THREADS // 32) * 32 * 8 + 4 * K2B_THREADS + 48
K2B_SMEM_LIMIT = 232448 - K2B_STATIC_BYTES
# Blocks below which K2b's geometry halves the items a block takes (down
# to block_e): two for each SM of an H100.
K2B_MIN_BLOCKS = 256


class K2bGeometry(NamedTuple):
    """What ``segsum_sorted_cuda`` sizes K2b's launch and scratch by (see
    ``k2b_geometry``)."""
    narrow: bool       # rows of at most 4 bytes: staged, one lane a share
    vec: int           # elements a lane holds per edge
    lanes: int         # lanes per share of a block's items
    items: int         # merge-path items (row ends and edges) per block
    blocks: int        # the grid: >= the real count
    levels: int        # ticket levels of the carries' combine tree
    smem_bytes: int    # dynamic shared memory per block
    carry_floats: int  # float32 pieces: a head and a tail per block


@functools.lru_cache(maxsize=256)
def k2b_geometry(n_edges: int, n: int, d: int, itemsize: int, block_e: int,
                 aligned: bool = True) -> K2bGeometry:
    """K2b's launch geometry and scratch sizes for ``msgs [n_edges, d]``
    of ``itemsize`` bytes into ``n`` rows, ``block_e`` merge-path items
    per block for the widest rows.  ``aligned``: the message base address
    is a multiple of 16 bytes.

    * Narrow rows (``d * itemsize <= 4``: float32 D = 1, bfloat16 D = 1
      or 2) are staged in shared memory and walked one lane per share,
      ``vec = d``; wider rows load 16 bytes at a time (4 float32, 8
      bfloat16) when every row starts on a 16-byte boundary, else one
      element, by groups of ``lanes`` lanes (the vectors of a row rounded
      up to a power of two, at most 32).
    * A block takes ``block_e`` items times 1,024 bytes over the row's
      bytes for wide rows, 64 bytes over them for narrow ones (1 to 16
      times), so that its fixed steps (the searches, the staging, the
      carries) weigh little against its loads; halved (not below
      ``block_e``) while the grid would have fewer than
      ``K2B_MIN_BLOCKS`` blocks.
    * Shared memory holds the block's row offsets and, for narrow rows,
      its message rows after them: ``items`` entries of at most 4 bytes
      (an offset or a row), and the ``items // 8`` edges of a row that
      the block reads again whole (its start in the previous block).
    * The grid is ``ceil((n + n_edges) / items)``: offsets that drop
      edges leave blocks past the real count, which return at once.
    * The combine tree of a row cut across blocks has a ticket level per
      factor of ``K2B_FAN_IN`` in the block count.
    """
    if block_e <= 0:
        raise ValueError(f"block_e must be positive, got {block_e}")
    row_bytes = d * itemsize
    narrow = row_bytes <= 4
    if narrow:
        vec, lanes = d, 1
    else:
        vec = 16 // itemsize if aligned and row_bytes % 16 == 0 else 1
        lanes = min(32, 1 << (d // vec - 1).bit_length())
    scale = (64 if narrow else 1024) // row_bytes
    items = block_e * max(1, min(16, scale))
    while items > block_e and -(-(n + n_edges) // items) < K2B_MIN_BLOCKS:
        items = max(block_e, items // 2)
    blocks = -(-(n + n_edges) // items)
    if blocks >= 2**31:
        raise ValueError(f"{n + n_edges} items need {blocks} blocks of "
                         f"{items}; the grid takes fewer than 2**31")
    levels = 0
    while K2B_FAN_IN ** levels < blocks:
        levels += 1
    if narrow:
        smem = (4 * items + 16 + items // 8 * row_bytes + 15) // 16 * 16
    else:
        smem = 4 * ((items + 1 + 3) // 4 * 4)
    if smem > K2B_SMEM_LIMIT:
        raise ValueError(f"block_e {block_e} needs {smem} bytes of shared "
                         f"memory a block; at most {K2B_SMEM_LIMIT}")
    return K2bGeometry(narrow, vec, lanes, items, blocks, levels, smem,
                       2 * blocks * d)


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("segsum", ("segsum.cu",))
    if lib.segsum_launch.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.segsum_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong] + [ctypes.c_int] * 8 + [
            ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        lib.segsum_launch.restype = ctypes.c_int
        lib.segsum_sorted_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]
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


# K2b's ticket buffers, zeroed, one per (device, stream): the last block
# to arrive at a ticket resets it, so a buffer is zero again when its
# call ends and the next call on its stream (in order after it) needs no
# memset (which cost float32 D = 1 a tenth of its time).  The invariant
# holds only if every call finishes on offsets that keep the contract of
# ``segsum_sorted_cuda``: a launch that fails drops its stream's buffer,
# so the next call starts from a new zeroed one.  A buffer too small for
# a call is replaced by a larger one.
_K2B_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _k2b_tickets(dev: torch.device, stream: int, count: int) -> torch.Tensor:
    buf = _K2B_TICKETS.get((dev.index, stream))
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=dev)
        _K2B_TICKETS[dev.index, stream] = buf
    return buf


def segsum_sorted_cuda(msgs: torch.Tensor, row_offsets: torch.Tensor,
                       num_segments: int, *,
                       block_e: int = 512) -> torch.Tensor:
    """K2b through the CUDA kernel: same arguments and result as
    ``segsum_sorted_plain``; ``block_e`` merge-path items (row ends and
    edges) per thread block, more for rows under 512 bytes
    (``k2b_geometry``).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (counted in ``segsum_sorted_cuda.launches``)
    or raises.

    ``row_offsets`` must be non-decreasing and lie in ``[0, E]``: the
    kernel reads the rows they name unchecked (``segment_sum_mxu`` makes
    them so and checks them).  Offsets that break this may also leave
    the stream's ticket buffer (``_K2B_TICKETS``) nonzero, and every
    later call on that stream would then sum wrongly with no error; a
    launch that returns an error drops the buffer.  Each block folds its edges in order and adds the pieces of
    a row cut across lane groups or blocks in a fixed order, whatever
    order the blocks run in, so the result is the same bits on every
    run."""
    if msgs.device.type == "cpu":
        return segsum_sorted_plain(msgs, row_offsets, num_segments)
    dev = _check_common(msgs, num_segments, block_e, "block_e")
    check_operand("row_offsets", row_offsets, torch.int32, 1, dev)
    if row_offsets.shape[0] != num_segments + 1:
        raise ValueError(f"row_offsets has {row_offsets.shape[0]} entries, "
                         f"expected num_segments + 1 = {num_segments + 1}")
    e, d = msgs.shape
    out = torch.empty(num_segments, d, dtype=msgs.dtype, device=dev)
    if e == 0 or num_segments == 0 or d == 0:
        return out.zero_()
    geo = k2b_geometry(e, num_segments, d, msgs.element_size(), block_e,
                       msgs.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _k2b_tickets(dev, stream, geo.levels * geo.blocks)
    carry = torch.empty(geo.carry_floats, dtype=torch.float32, device=dev)
    rc = _kernel_lib().segsum_sorted_launch(
        msgs.data_ptr(), row_offsets.data_ptr(), out.data_ptr(),
        tickets.data_ptr(), carry.data_ptr(), int(num_segments), int(d),
        DTYPES[msgs.dtype], int(geo.narrow), geo.vec, geo.lanes, geo.items,
        geo.blocks, geo.smem_bytes, stream,
    )
    if rc != 0:
        _K2B_TICKETS.pop((dev.index, stream), None)
        raise RuntimeError(f"segsum_sorted kernel launch failed: error {rc}")
    segsum_sorted_cuda.launches += 1
    return out


segsum_sorted_cuda.launches = 0

