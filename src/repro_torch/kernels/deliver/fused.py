"""Fused incidence delivery over a dst-sorted, degree-classed CSR layout:
gather + live mask + segment-combine for a whole leaf, in one CUDA
kernel launch.

The hand-written Hopper kernel in ``repro_torch/csrc/deliver_fused.cu``
runs every degree class of a layout in one grid (widest class first),
a block per span of a tile's destination rows, a group of lanes and a
register shuffle tree per row, no atomics (see the note in the source).
Its launch plan (``LeafPlan``: spans, the slot -> destination map, the
zero-degree destinations) is built once per layout (``leaf_plan``).

* ``deliver_leaf_cuda`` delivers one leaf: ``[n_src, D]`` messages ->
  ``[n_dst, D]``, one launch, the rows written straight to their
  destinations.
* ``deliver_fused_cuda`` runs the same kernel over one class (a
  one-class plan): ``[n_rows, D]`` class-local partials.
* Both count their launches in ``deliver_fused_cuda.launches``; a CUDA
  graph that holds launches counts them at each replay
  (``captured_launches``, ``count_replay``).
* ``deliver_fused_plain`` is the per-class plain PyTorch version,
  gather -> mask -> ``scatter_reduce``: the CPU path and the oracle the
  kernel is held against on the card; it ignores ``bounds`` (they only
  narrow where the kernel looks), so a wrong bound shows up as a
  disagreement.  ``deliver_fused_classes(..., lowering="plain")``
  assembles its class partials with the layout's ``inv_perm`` gather, as
  the JAX package does, and ``deliver_leaf_plain`` runs it on ``[n_src,
  D]`` messages: the leaf's plain version, independent of the plan.

``layout_from_numpy`` carries a layout over from any object with the
``DeliveryLayout`` fields whose arrays convert with ``np.asarray``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.kernels import check_operand
from repro_torch.kernels.deliver.layout import DeliveryLayout
from repro_torch.sparse.segment import MONOIDS, scatter_fold

# The kernel's codes (csrc/deliver_fused.cu).  "or" reaches it as an
# int32 max, through ``_pallas_leaf`` in ``kernels/deliver/__init__.py``.
_DTYPES = {torch.float32: 0, torch.int32: 1}
_MONOIDS = {"sum": 0, "min": 1, "max": 2, "prod": 3}
_ACT_KINDS = {torch.int32: 1, torch.bool: 2}
_MAX_CLASSES = 16             # kMaxClasses in the source
_MAX_SPAN = 4096              # kMaxSpan in the source
_THREADS = 256                # kThreads in the source
_UNROLL = 4                   # kUnroll in the source
_WARP = 32
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


def class_span(nnz_pad: int, n_rows: int, block_n: int) -> int:
    """Rows per block of one class: about two row steps of the block.

    ``n_rows`` counts the rows that hold the class's lanes (the leaf plan
    passes the class's members, a one-class launch its padded rows).
    Rows with ``m`` lanes each (padding lanes included) are folded by
    groups of ``G`` lanes (``m / 4`` rounded up to a power of two, at most
    a warp: each lane folds about four edges), ``256 / G`` rows a step.
    The span is the tile of ``block_n`` rows halved, or doubled, toward
    ``512 / G`` rows: a class of few long rows spreads over many blocks,
    and a class of one-lane rows fills every block's threads.  It divides
    ``block_n`` or is a multiple of it, at most ``_MAX_SPAN``.  A
    function of the class's sizes alone, as the kernel's determinism
    needs.
    """
    mean = -(-int(nnz_pad) // max(int(n_rows), 1))
    g = 1
    while g * _UNROLL < mean and g < _WARP:
        g *= 2
    target = 2 * _THREADS // g
    span = int(block_n)
    while span > target and span % 2 == 0:
        span //= 2
    while 2 * span <= min(target, _MAX_SPAN):
        span *= 2
    return span


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One layout's launch plan for the leaf kernel.

    order: the classes in launch order, widest first.
    spans / blocks: rows per block and blocks, per class (layout order).
    slot_base: each class's first slot (its rows' offset in the
      class-major slot numbering of ``inv_perm``).
    slot_dst: ``[n_slots]`` int32, slot -> destination (the inverse of
      ``inv_perm``); -1 marks a bucket-padding slot, whose row is dropped.
    zero_dst: ``[n_zero]`` int32, the destinations of live degree 0 (they
      get the identity).
    desc: the kernel's per-class descriptor (CUDA layouts only).
    """

    order: tuple
    spans: tuple
    blocks: tuple
    slot_base: tuple
    slot_dst: torch.Tensor
    zero_dst: torch.Tensor
    desc: object = None


def _class_desc(src, dst, bounds, n_rows, block_e, slot_base, span):
    """One class's descriptor words (the source's ``ClassArgs``)."""
    return [src.data_ptr(), dst.data_ptr(), bounds.data_ptr(),
            int(src.shape[0]), int(n_rows), int(block_e), int(slot_base),
            int(span), -(-int(n_rows) // int(span))]


def _build_leaf_plan(layout: DeliveryLayout) -> LeafPlan:
    n_classes = layout.n_classes
    if n_classes > _MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {_MAX_CLASSES} classes, "
                         f"the layout has {n_classes}")
    rows = [int(r) for r in layout.class_rows]
    slot_base = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    n_slots = int(slot_base[-1])
    inv = layout.inv_perm.cpu().numpy().astype(np.int64)
    live = inv < n_slots
    slot_dst = np.full(n_slots, -1, np.int32)
    slot_dst[inv[live]] = np.flatnonzero(live)
    zero_dst = np.flatnonzero(~live).astype(np.int32)
    # Spans sized by the rows that hold edges: the bucket's padding rows
    # come last and would thin the mean row length.
    members = [int((slot_dst[slot_base[c]:slot_base[c + 1]] >= 0).sum())
               for c in range(n_classes)]
    spans = tuple(class_span(layout.class_src[c].shape[0], members[c],
                             layout.block_n) for c in range(n_classes))
    # Widest first; ties keep the later (larger-width) class first.
    order = tuple(sorted(range(n_classes),
                         key=lambda c: (-layout.class_widths[c], -c)))
    dev = layout.device
    plan = LeafPlan(
        order=order,
        spans=spans,
        blocks=tuple(-(-rows[c] // spans[c]) for c in range(n_classes)),
        slot_base=tuple(int(b) for b in slot_base[:-1]),
        slot_dst=torch.as_tensor(slot_dst, device=dev),
        zero_dst=torch.as_tensor(zero_dst, device=dev),
    )
    if dev.type != "cuda":
        return plan
    words = []
    for c in order:
        words += _class_desc(layout.class_src[c], layout.class_dst[c],
                             layout.class_bounds[c], rows[c],
                             layout.class_block_e[c], plan.slot_base[c],
                             spans[c])
    return dataclasses.replace(
        plan, desc=(ctypes.c_longlong * len(words))(*words))


# Plans by layout identity; an entry goes when its layout is collected.
_PLANS: dict[int, tuple] = {}


def leaf_plan(layout: DeliveryLayout) -> LeafPlan:
    """The launch plan of ``layout``, built at its first use and kept
    while the layout lives."""
    key = id(layout)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is layout:
        return hit[1]
    plan = _build_leaf_plan(layout)
    _PLANS[key] = (weakref.ref(layout), plan)
    weakref.finalize(layout, _PLANS.pop, key, None)
    return plan


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _nvcc

    lib = _nvcc.load("deliver_fused", ("deliver_fused.cu",))
    fn = lib.deliver_fused_launch
    if fn.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_args(msgs, monoid_name, dev):
    if dev.type != "cuda":
        raise ValueError(f"no fused delivery kernel for device {dev}")
    if msgs.dtype not in _DTYPES:
        raise TypeError(
            f"kernel takes float32 or int32 messages, got {msgs.dtype}"
        )
    if monoid_name not in _MONOIDS:
        raise ValueError(
            f"kernel takes monoids {sorted(_MONOIDS)}, got {monoid_name!r}"
        )


def _launch(msgs, act, desc, n_classes, block_n, slot_dst, zero_dst,
            n_zero, out, monoid_name):
    """One launch of the kernel; counted in ``deliver_fused_cuda.launches``
    (the one counter of the kernel, whichever wrapper launches it)."""
    act_kind = 0 if act is None else _ACT_KINDS[act.dtype]
    rc = _kernel_lib().deliver_fused_launch(
        msgs.data_ptr(), act.data_ptr() if act is not None else None,
        act_kind, desc, n_classes, int(block_n), slot_dst, zero_dst,
        int(n_zero), out.data_ptr(), int(msgs.shape[1]),
        _DTYPES[msgs.dtype], _MONOIDS[monoid_name],
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"deliver_fused kernel launch failed: error {rc}")
    deliver_fused_cuda.launches += 1


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
    """One class of fused delivery through the CUDA kernel (a one-class
    plan: no slot map, no zero-degree list).

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
    _check_kernel_args(msgs_aug, monoid_name, dev)
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
    words = _class_desc(src, dst, bounds, n_rows, block_e, 0,
                        class_span(nnz_pad, n_rows, block_n))
    _launch(msgs_aug, act_aug, (ctypes.c_longlong * len(words))(*words), 1,
            block_n, None, None, 0, out, monoid_name)
    return out


deliver_fused_cuda.launches = 0


def captured_launches(capture) -> int:
    """Run ``capture`` (the capture of a CUDA graph) and return the
    kernel launches it recorded.  A capture runs nothing, so the counter
    is put back; each replay of the graph adds them (``count_replay``),
    which keeps ``deliver_fused_cuda.launches`` a count of launches that
    ran."""
    before = deliver_fused_cuda.launches
    try:
        capture()
    finally:
        recorded = deliver_fused_cuda.launches - before
        deliver_fused_cuda.launches = before
    return recorded


def count_replay(recorded: int) -> None:
    """One replay of a graph that recorded ``recorded`` launches."""
    deliver_fused_cuda.launches += recorded


def deliver_leaf_plain(
    msgs: torch.Tensor,
    active: torch.Tensor | None,
    layout: DeliveryLayout,
    monoid_name: str,
) -> torch.Tensor:
    """One leaf in stock torch ops: the identity row (and a live flag)
    appended, then ``deliver_fused_classes(..., lowering="plain")``.

    msgs: ``[n_src, D]``; active: optional ``[n_src]`` activity.
    Returns ``[n_dst, D]``.
    """
    ident = MONOIDS[monoid_name].identity(msgs.dtype)
    msgs_aug = torch.cat([
        msgs, torch.full((1, msgs.shape[1]), ident, dtype=msgs.dtype,
                         device=msgs.device)])
    act_aug = None
    if active is not None:
        act_aug = torch.cat([(active != 0).to(torch.int32),
                             torch.ones(1, dtype=torch.int32,
                                        device=active.device)])
    return deliver_fused_classes(msgs_aug, act_aug, layout, monoid_name,
                                 lowering="plain")


def deliver_leaf_cuda(
    msgs: torch.Tensor,
    active: torch.Tensor | None,
    layout: DeliveryLayout,
    monoid_name: str,
) -> torch.Tensor:
    """One leaf's fused delivery over every class of ``layout``, in one
    launch of the CUDA kernel.

    msgs: ``[n_src, D]`` float32 or int32 (no identity row); active:
    optional ``[n_src]`` activity (bool or int32 read as is, any other
    type as ``!= 0``).  Returns ``[n_dst, D]``: the monoid fold of each
    destination's live senders, the identity where there are none.

    A CPU tensor takes ``deliver_leaf_plain``; a CUDA tensor launches
    the kernel (counted in ``deliver_fused_cuda.launches``) or raises.
    """
    if msgs.device.type == "cpu":
        return deliver_leaf_plain(msgs, active, layout, monoid_name)
    dev = msgs.device
    _check_kernel_args(msgs, monoid_name, dev)
    check_operand("msgs", msgs, None, 2, dev)
    if layout.device != dev:
        raise ValueError(f"layout is on {layout.device}, msgs on {dev}")
    if msgs.shape[0] != layout.n_src:
        raise ValueError(f"msgs has {msgs.shape[0]} rows, the layout "
                         f"{layout.n_src} senders")
    if active is not None:
        if active.dtype not in _ACT_KINDS:
            active = active != 0
        check_operand("active", active, None, 1, dev)
        if active.shape[0] != layout.n_src:
            raise ValueError(f"active has {active.shape[0]} rows, the "
                             f"layout {layout.n_src} senders")
    d = msgs.shape[1]
    if layout.n_dst >= 2**31 or msgs.numel() >= 2**62:
        raise ValueError("leaf too large for the kernel's indexing")
    out = torch.empty((layout.n_dst, d), dtype=msgs.dtype, device=dev)
    if layout.n_dst == 0 or d == 0:
        return out
    plan = leaf_plan(layout)
    _launch(msgs, active, plan.desc, layout.n_classes, layout.block_n,
            plan.slot_dst.data_ptr(), plan.zero_dst.data_ptr(),
            plan.zero_dst.shape[0], out, monoid_name)
    return out


def deliver_fused_classes(
    msgs_aug: torch.Tensor,
    act_aug: torch.Tensor | None,
    layout: DeliveryLayout,
    monoid_name: str,
    *,
    lowering: str = "cuda",
) -> torch.Tensor:
    """One leaf's fused delivery over a degree-classed layout.

    msgs_aug: ``[n_src + 1, D]`` with the identity row appended.
    act_aug: optional ``[n_src + 1]`` int32 activity, or None.
    lowering: ``cuda`` (one launch of the leaf kernel, which reads
      neither appended row) or ``plain`` (one plain class at a time,
      assembled with the ``inv_perm`` gather as in the JAX package).

    Returns ``[n_dst, D]``.
    """
    if lowering == "cuda":
        return deliver_leaf_cuda(
            msgs_aug[:-1], act_aug[:-1] if act_aug is not None else None,
            layout, monoid_name)
    if lowering != "plain":
        raise ValueError(f"lowering must be cuda or plain, got {lowering!r}")
    outs = [
        deliver_fused_plain(
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
