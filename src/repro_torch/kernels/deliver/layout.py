"""Dst-sorted degree-class (sliced-ELL) delivery layouts: the precompute
behind fused delivery.

The reference delivery lowering (``repro_torch.core.engine.deliver``) is
gather -> mask -> segment reduce, which materializes a ``[nnz, D]`` rows
array in device memory and re-reads it.  The fused path removes that
intermediate by reorganizing the incidence ONCE, on the host, into a
destination-sorted layout, degree-classed (SELL-style) so one hub and
the long tail each get a fitting ELL width:

* ``plan_degree_classes`` picks 1–``MAX_CLASSES`` class boundaries from
  the live-degree histogram by dynamic programming over power-of-two
  widths (a pure function of the histogram);
* destinations are permuted class-major (ascending id within a class);
  ``inv_perm`` maps destination id -> its slot in the concatenated
  per-class outputs, and zero-degree destinations point at an appended
  identity row;
* per class, two packings of the same dst-sorted edges: a dense
  ``[rows_c, k_c]`` ELL id table (the stock-op lowering in ``xla``) and
  a CSR edge list with per-tile block bounds (the CUDA kernel in
  ``fused``);
* incidences past a hub's class width land in a small dst-sorted COO
  residual (stock-op lowering only — the CSR form has no width cap).

Statically-dead incidences (``e_mask == 0``) are dropped from every
packing at build time.  Everything here is host numpy, array for array
the JAX package's builder; the products are int32 tensors on the
layout's device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.obs.metrics import default_registry

# Single-ELL planning (the skew baseline of the cost model): grow k
# (powers of two) until the COO remainder holds at most this fraction of
# the incidences, then stop at the cap.
ELL_REMAINDER_FRACTION = 0.25
ELL_K_CAP = 64
# Degree-class planning: at most this many classes, widths capped here.
MAX_CLASSES = 4
CLASS_K_CAP = 65536
# The planner's price of one residual lane in dense ELL slots.  This is
# the JAX package's constant (measured there on CPU XLA), kept so both
# packages plan identical layouts; it is not a measurement of the card.
RESIDUAL_WEIGHT = 12.0
# Remainder / padded-row buckets: pow2 with a small floor.
_PAD_FLOOR = 8
_ROW_FLOOR = 8


def _pow2_at_least(n: int, floor: int = 1) -> int:
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _width_stats(degrees: np.ndarray, k_cap: int):
    """Per-candidate-width overflow stats from ONE cumulative histogram.

    Candidate widths are ``1, 2, 4, ..., min(pow2 >= max_degree, k_cap)``.
    Returns ``(widths, cnt_le, overflow, n_pos)``: ``cnt_le[j]`` counts
    destinations with ``1 <= degree <= widths[j]`` and ``overflow[j] =
    sum(max(degree - widths[j], 0))``.
    """
    degrees = np.asarray(degrees, np.int64)
    pos = degrees[degrees > 0]
    n_pos = int(pos.size)
    if n_pos == 0:
        return (np.array([1], np.int64), np.zeros(1, np.int64),
                np.zeros(1, np.int64), 0)
    max_deg = int(pos.max())
    total = int(pos.sum())
    top = min(_pow2_at_least(max_deg), int(k_cap))
    widths = np.asarray([1 << e for e in range(top.bit_length())], np.int64)
    hist = np.bincount(pos)
    cnt_cum = np.cumsum(hist)
    deg_cum = np.cumsum(hist * np.arange(hist.size, dtype=np.int64))
    idx = np.minimum(widths, max_deg)
    cnt_le = cnt_cum[idx]
    sum_le = deg_cum[idx]
    overflow = (total - sum_le) - widths * (n_pos - cnt_le)
    return widths, cnt_le, overflow, n_pos


def plan_ell_width(degrees: np.ndarray, nnz: int) -> tuple[int, int]:
    """Pick a SINGLE ELL width ``k``: the smallest power of two (capped
    at ``ELL_K_CAP``) whose overflow is at most
    ``ELL_REMAINDER_FRACTION`` of ``nnz``.  Returns ``(k, remainder)``."""
    if nnz <= 0 or np.asarray(degrees).size == 0:
        return 1, 0
    widths, _, overflow, n_pos = _width_stats(degrees, ELL_K_CAP)
    if n_pos == 0:
        return 1, 0
    ok = overflow <= ELL_REMAINDER_FRACTION * nnz
    ok[-1] = True  # the cap (or a width >= max degree) always stops
    j = int(np.argmax(ok))
    return int(widths[j]), int(overflow[j])


@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """A degree-class partition: the data-dependent half of a layout.

    ``widths`` are ascending power-of-two ELL widths, one per class; a
    destination with live degree ``g > 0`` belongs to the first class
    with ``g <= k_c`` (hubs past the last width stay in the last class,
    spilling ``g - k_C`` incidences to the residual).  ``rows`` counts
    the destinations per class; ``residual`` their total spill.
    """

    widths: tuple[int, ...]
    rows: tuple[int, ...]
    residual: int

    @property
    def n_classes(self) -> int:
        return len(self.widths)

    @property
    def padded_rows(self) -> int:
        """Dense ELL slots the plan commits to (pre row-padding)."""
        return int(sum(r * k for r, k in zip(self.rows, self.widths)))

    @property
    def built_rows(self) -> tuple:
        """Per-class row counts as ``build_delivery_layout`` pads them."""
        return tuple(
            _pow2_at_least(max(int(r), 1), _ROW_FLOOR) for r in self.rows
        )

    @property
    def built_work(self) -> int:
        """Dense slots + residual at the builder's row padding."""
        dense = sum(r * k for r, k in zip(self.built_rows, self.widths))
        return int(dense) + int(self.residual)

    @property
    def weighted_work(self) -> float:
        """The DP's objective: dense slots plus residual at
        ``RESIDUAL_WEIGHT``."""
        return self.padded_rows + RESIDUAL_WEIGHT * self.residual


def plan_degree_classes(
    degrees: np.ndarray,
    nnz: int,
    *,
    max_classes: int = MAX_CLASSES,
    k_cap: int = CLASS_K_CAP,
) -> ClassPlan:
    """Partition a live-degree histogram into 1–``max_classes`` degree
    classes with power-of-two ELL widths (dynamic programming over the
    candidate widths of ``_width_stats``)."""
    degrees = np.asarray(degrees)
    if nnz <= 0 or degrees.size == 0 or not (degrees > 0).any():
        return ClassPlan(widths=(1,), rows=(0,), residual=0)
    widths, cnt_le, overflow, n_pos = _width_stats(degrees, k_cap)
    nw = len(widths)
    max_classes = max(int(max_classes), 1)

    INF = float("inf")
    # best[c][j]: min dense slots covering all degrees <= widths[j] with
    # c classes, the last of width widths[j].
    best = np.full((max_classes + 1, nw), INF)
    prev = np.full((max_classes + 1, nw), -1, np.int64)
    best[1, :] = cnt_le * widths
    for c in range(2, max_classes + 1):
        for j in range(c - 1, nw):
            cand = best[c - 1, :j] + (cnt_le[j] - cnt_le[:j]) * widths[j]
            jp = int(np.argmin(cand))
            if cand[jp] < best[c, j]:
                best[c, j] = cand[jp]
                prev[c, j] = jp
    # Close each (c, j) plan: hubs past widths[j] pay widths[j] dense
    # slots each plus weighted residual spill.
    hub_rows = n_pos - cnt_le
    close = hub_rows * widths + RESIDUAL_WEIGHT * overflow
    best_cost, best_c, best_j = INF, 1, nw - 1
    for c in range(1, max_classes + 1):
        for j in range(nw):
            cost = best[c, j] + close[j]
            if cost < best_cost:  # ties: fewer classes, smaller widths
                best_cost, best_c, best_j = cost, c, j
    chain = [best_j]
    for c in range(best_c, 1, -1):
        chain.append(int(prev[c, chain[-1]]))
    chain.reverse()
    plan_widths = [int(widths[j]) for j in chain]

    # Row counts per class; drop classes that own no destinations.
    bounds = [0] + [cnt_le[j] for j in chain]
    rows = [int(bounds[i + 1] - bounds[i]) for i in range(len(chain))]
    rows[-1] += int(hub_rows[chain[-1]])
    keep = [i for i, r in enumerate(rows) if r > 0]
    if not keep:
        keep = [len(rows) - 1]
    return ClassPlan(
        widths=tuple(plan_widths[i] for i in keep),
        rows=tuple(rows[i] for i in keep),
        residual=int(overflow[chain[-1]]),
    )


def classify_degrees(degrees: np.ndarray, widths) -> np.ndarray:
    """Class index per destination under a plan's widths (-1 for
    zero-degree destinations, which own no slot)."""
    degrees = np.asarray(degrees, np.int64)
    w = np.asarray(widths, np.int64)
    cls = np.minimum(np.searchsorted(w, degrees, side="left"), len(w) - 1)
    return np.where(degrees > 0, cls, -1).astype(np.int64)


def class_block_e(k: int, block_e: int) -> int:
    """Class-local edge-block width: at least the caller's ``block_e``,
    grown toward the class's ELL width, capped at 1024.  The CUDA kernel
    reads it only as the granularity of ``class_bounds``."""
    return min(max(int(block_e), _pow2_at_least(int(k))), 1024)


@dataclasses.dataclass
class DeliveryLayout:
    """One direction's precomputed fused-delivery layout (degree-classed).

    Per degree class ``c`` (tuples of length ``n_classes``, int32
    tensors):

      class_ell[c]: ``[rows_c, k_c]`` — the class's destinations' first
        ``k_c`` sender ids, one row per destination slot (identity row
        ``n_src`` in empty slots).  The stock-op lowering's dense table.
      class_src[c] / class_dst[c]: ``[nnz_c_pad]`` — ALL the class's live
        incidences in dst-sorted order: sender id and class-LOCAL
        destination row (padding lanes: identity sender, out-of-range
        row).  The CUDA kernel's CSR form.
      class_bounds[c]: ``[n_tiles_c, 2]`` — per tile of ``block_n`` rows:
        (first edge block, n edge blocks) at ``class_block_e[c]``
        granularity.

    Shared: ``inv_perm`` ``[n_dst]`` (destination id -> slot; zero-degree
    destinations point at the identity slot ``sum(class_rows)``) and the
    residual ``rem_src`` / ``rem_dst`` ``[rem_pad]`` (dst-sorted COO;
    padding lanes: identity sender -> last destination).

    Static: ``n_src``, ``n_dst``, ``nnz``, ``rem_nnz``, ``class_widths``,
    ``class_rows`` (padded row counts), ``block_n``, ``class_block_e``,
    ``class_max_blocks``.
    """

    class_ell: tuple
    class_src: tuple
    class_dst: tuple
    class_bounds: tuple
    inv_perm: torch.Tensor
    rem_src: torch.Tensor
    rem_dst: torch.Tensor
    n_src: int
    n_dst: int
    nnz: int
    rem_nnz: int
    class_widths: tuple
    class_rows: tuple
    block_n: int
    class_block_e: tuple
    class_max_blocks: tuple

    @property
    def n_classes(self) -> int:
        return len(self.class_widths)

    @property
    def ell_slots(self) -> int:
        """Total dense ELL slots across classes (padding-work metric)."""
        return int(
            sum(r * k for r, k in zip(self.class_rows, self.class_widths))
        )

    @property
    def rem_len(self) -> int:
        return int(self.rem_src.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.inv_perm.device

    def shape_signature(self) -> tuple:
        """Hashable shape tuple for the serving executable cache key.

        The JAX package's fields (every class-plan-dependent dim, so a
        degree-regime shift within a shape bucket recompiles), plus what
        the CUDA kernel takes by value and a captured CUDA graph keeps:
        per class in launch order ``(nnz_pad, n_rows, block_e, span,
        entries)`` from the leaf plan, and the number of zero-degree
        destinations.  Two layouts with equal signatures can take turns
        in one graph's buffers.
        """
        from repro_torch.kernels.deliver.fused import leaf_plan

        plan = leaf_plan(self)
        k1 = tuple(
            (int(self.class_src[c].shape[0]), int(self.class_rows[c]),
             int(self.class_block_e[c]), int(plan.spans[c]),
             int(plan.blocks[c]))
            for c in plan.order
        )
        return (
            tuple(tuple(a.shape) for a in self.class_ell),
            tuple(tuple(a.shape) for a in self.class_src),
            tuple(tuple(a.shape) for a in self.class_bounds),
            tuple(self.inv_perm.shape),
            tuple(self.rem_src.shape),
            self.class_widths, self.class_rows, self.class_block_e,
            self.class_max_blocks, self.rem_nnz,
            self.n_src, self.n_dst, self.nnz,
            k1, int(plan.zero_dst.shape[0]),
        )

    def tensors(self) -> list:
        """Every tensor of the layout, in a fixed order (what a compiled
        executable copies from one same-signature layout to another)."""
        return [*self.class_ell, *self.class_src, *self.class_dst,
                *self.class_bounds, self.inv_perm, self.rem_src,
                self.rem_dst]


def tile_block_bounds(
    row_offsets: np.ndarray, n_dst_pad: int, block_n: int, block_e: int
) -> tuple[np.ndarray, int]:
    """Per-output-tile edge-block ranges from CSR row offsets.

    Tile ``i`` covers destinations ``[i*block_n, (i+1)*block_n)``; its
    incident edges are CSR rows ``[row_offsets[lo], row_offsets[hi])``,
    which span edge blocks ``[floor(lo_e/block_e), ceil(hi_e/block_e))``.
    Returns ``([n_tiles, 2] (start, count), max_count)``.
    """
    row_offsets = np.asarray(row_offsets, np.int64)
    n_tiles = n_dst_pad // block_n
    n_real = len(row_offsets) - 1
    first = np.arange(n_tiles, dtype=np.int64) * block_n
    lo = row_offsets[np.minimum(first, n_real)]
    hi = row_offsets[np.minimum(first + block_n, n_real)]
    b_lo = lo // block_e
    b_hi = -(-hi // block_e)
    bounds = np.stack([b_lo, np.maximum(b_hi - b_lo, 0)], axis=1)
    bounds = bounds.astype(np.int32).reshape(n_tiles, 2)
    max_blocks = int(bounds[:, 1].max()) if n_tiles else 0
    return bounds, max(max_blocks, 1)


def class_tile_bounds(member_degrees: np.ndarray, rows_pad: int,
                      block_n: int, block_e: int) -> tuple[np.ndarray, int]:
    """``tile_block_bounds`` of one degree class whose member rows (in
    slot order) have live degrees ``member_degrees``, its rows padded to
    ``rows_pad``."""
    row_counts = np.zeros(rows_pad, np.int64)
    row_counts[: len(member_degrees)] = member_degrees
    offsets = np.zeros(rows_pad + 1, np.int64)
    np.cumsum(row_counts, out=offsets[1:])
    rows_blk = -(-rows_pad // block_n) * block_n
    return tile_block_bounds(offsets, rows_blk, block_n, block_e)


def build_delivery_layout(
    src,
    dst,
    e_mask,
    n_src: int,
    n_dst: int,
    *,
    plan: ClassPlan | None = None,
    block_n: int = 128,
    block_e: int = 256,
    class_rows_pad: tuple | None = None,
    class_nnz_pad: tuple | None = None,
    rem_pad_to: int | None = None,
    device=None,
) -> DeliveryLayout:
    """Build one direction's degree-class layout from a concrete
    incidence list.

    ``src``/``dst``/``e_mask`` are host arrays or tensors (``e_mask`` may
    be None).  ``plan=None`` lets ``plan_degree_classes`` pick the class
    boundaries from the live-degree histogram.  ``class_rows_pad`` /
    ``class_nnz_pad`` / ``rem_pad_to`` force larger per-class row counts,
    edge-array lengths and residual pad.  ``device``: where the products
    live (default: ``src``'s device when it is a tensor, else the CPU).
    Each build adds to the default metrics registry's
    ``delivery.layouts_built``, ``delivery.ell_slots`` and
    ``delivery.residual_lanes`` counters and its ``delivery.build_s``
    histogram.
    """
    t_build0 = time.perf_counter()
    if device is None:
        device = src.device if isinstance(src, torch.Tensor) else "cpu"
    src = _host(src).astype(np.int64)
    dst = _host(dst).astype(np.int64)
    nnz = len(src)
    live = (
        _host(e_mask) != 0
        if e_mask is not None
        else np.ones(nnz, bool)
    )

    live_deg = (
        np.bincount(dst[live], minlength=max(n_dst, 1))[:n_dst]
        if nnz
        else np.zeros(max(n_dst, 1), np.int64)[:n_dst]
    )
    n_live = int(live.sum())
    if plan is None:
        plan = plan_degree_classes(live_deg, n_live)
    widths = np.asarray(plan.widths, np.int64)
    n_classes = len(widths)

    cls = classify_degrees(live_deg, widths)
    rows_real = np.bincount(cls[cls >= 0], minlength=n_classes)[:n_classes]
    if class_rows_pad is None:
        rows_pad = tuple(
            _pow2_at_least(max(int(r), 1), _ROW_FLOOR) for r in rows_real
        )
    else:
        rows_pad = tuple(int(r) for r in class_rows_pad)
        if not all(p >= r for p, r in zip(rows_pad, rows_real)):
            raise ValueError(
                f"class_rows_pad {rows_pad} below the rows {rows_real}"
            )

    # Slot assignment: class-major, ascending destination id within a
    # class; zero-degree destinations share the appended identity slot.
    base = np.concatenate([[0], np.cumsum(rows_pad)]).astype(np.int64)
    n_slots = int(base[-1])
    inv_perm = np.full(n_dst, n_slots, np.int64)
    class_members = []
    for c in range(n_classes):
        members = np.flatnonzero(cls == c)
        class_members.append(members)
        inv_perm[members] = base[c] + np.arange(len(members))

    # One dst-sorted scan feeds every packing.  Stability keeps each
    # segment's rows in original incidence order.
    order = np.argsort(dst, kind="stable")
    s_src = src[order].astype(np.int32)
    s_dst = dst[order]
    s_live = live[order]
    if nnz:
        counts = np.bincount(s_dst, minlength=max(n_dst, 1))
        seg_starts = np.zeros(counts.size + 1, np.int64)
        np.cumsum(counts, out=seg_starts[1:])
        live_cum = np.cumsum(s_live)
        live_before = np.concatenate([[0], live_cum])[seg_starts[s_dst]]
        live_rank = live_cum - 1 - live_before  # valid on live lanes
        lane_cls = cls[s_dst]
        lane_k = widths[np.maximum(lane_cls, 0)]
        in_ell = s_live & (live_rank < lane_k)
        over = s_live & (live_rank >= lane_k)
    else:
        lane_cls = np.zeros(0, np.int64)
        live_rank = np.zeros(0, np.int64)
        in_ell = over = np.zeros(0, bool)

    # Per-class ELL tables (stock-op lowering).
    class_ell = []
    for c in range(n_classes):
        tbl = np.full((rows_pad[c], int(widths[c])), n_src, np.int32)
        sel = in_ell & (lane_cls == c)
        if sel.any():
            r_local = inv_perm[s_dst[sel]] - base[c]
            tbl[r_local, live_rank[sel]] = s_src[sel]
        class_ell.append(tbl)

    # Residual COO (dst-sorted: the scan order preserves it).  Padding
    # lanes point at the last destination with an identity sender.
    rem_s = s_src[over]
    rem_d = s_dst[over]
    rem_nnz = len(rem_s)
    if rem_pad_to is not None:
        if rem_pad_to < rem_nnz:
            raise ValueError(f"rem_pad_to {rem_pad_to} < {rem_nnz}")
        rem_pad = int(rem_pad_to)
    else:
        rem_pad = _pow2_at_least(max(rem_nnz, 1), _PAD_FLOOR)
    rem_src = np.full(rem_pad, n_src, np.int32)
    rem_dst = np.full(rem_pad, max(n_dst - 1, 0), np.int32)
    rem_src[:rem_nnz] = rem_s
    rem_dst[:rem_nnz] = rem_d

    # Per-class dst-sorted CSR edge arrays (CUDA kernel): every live
    # incidence of the class, hub tails included.  Padding lanes:
    # identity sender, out-of-range row.
    class_src_a, class_dst_a, class_bounds, c_block_e, c_max_blocks = (
        [], [], [], [], [],
    )
    for c in range(n_classes):
        be = class_block_e(int(widths[c]), block_e)
        sel = s_live & (lane_cls == c) if nnz else np.zeros(0, bool)
        e_src = s_src[sel]
        e_dst_local = (inv_perm[s_dst[sel]] - base[c]).astype(np.int32)
        nnz_c = len(e_src)
        rows_blk = -(-rows_pad[c] // block_n) * block_n
        want = nnz_c if class_nnz_pad is None else int(class_nnz_pad[c])
        if want < nnz_c:
            raise ValueError(f"class_nnz_pad[{c}] = {want} < {nnz_c}")
        nnz_c_pad = -(-max(want, 1) // be) * be
        a_src = np.full(nnz_c_pad, n_src, np.int32)
        a_dst = np.full(nnz_c_pad, rows_blk, np.int32)
        a_src[:nnz_c] = e_src
        a_dst[:nnz_c] = e_dst_local
        bounds, mb = class_tile_bounds(live_deg[class_members[c]],
                                       rows_pad[c], block_n, be)
        class_src_a.append(a_src)
        class_dst_a.append(a_dst)
        class_bounds.append(bounds)
        c_block_e.append(be)
        c_max_blocks.append(mb)

    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
    layout = DeliveryLayout(
        class_ell=tuple(t(a) for a in class_ell),
        class_src=tuple(t(a) for a in class_src_a),
        class_dst=tuple(t(a) for a in class_dst_a),
        class_bounds=tuple(t(b) for b in class_bounds),
        inv_perm=t(inv_perm),
        rem_src=t(rem_src),
        rem_dst=t(rem_dst),
        n_src=int(n_src),
        n_dst=int(n_dst),
        nnz=int(nnz),
        rem_nnz=int(rem_nnz),
        class_widths=tuple(int(w) for w in widths),
        class_rows=tuple(int(r) for r in rows_pad),
        block_n=int(block_n),
        class_block_e=tuple(c_block_e),
        class_max_blocks=tuple(c_max_blocks),
    )
    reg = default_registry()
    reg.counter("delivery.layouts_built").inc()
    reg.counter("delivery.ell_slots").inc(layout.ell_slots)
    reg.counter("delivery.residual_lanes").inc(layout.rem_len)
    reg.histogram("delivery.build_s").record(
        time.perf_counter() - t_build0
    )
    return layout


def layout_pair(
    hg_src, hg_dst, e_mask, n_vertices: int, n_hyperedges: int, **kw
) -> tuple[DeliveryLayout, DeliveryLayout]:
    """Both half-superstep directions for one incidence list:
    vertex->hyperedge (combine by ``dst``) and hyperedge->vertex
    (combine by ``src``)."""
    fwd = build_delivery_layout(
        hg_src, hg_dst, e_mask, n_vertices, n_hyperedges, **kw
    )
    bwd = build_delivery_layout(
        hg_dst, hg_src, e_mask, n_hyperedges, n_vertices, **kw
    )
    return fwd, bwd
