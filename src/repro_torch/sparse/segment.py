"""Segment reductions — the single primitive under all MESH supersteps.

A MESH superstep is ``gather -> per-edge transform -> combine-by-key``.
The combine step must be a commutative monoid so that pre-aggregation
before a network hop is legal and the reduction may reassociate freely.
This module defines the monoid registry (the analogue of the paper's
Algebird auto-derived ``MessageCombiner``) and the segment reduction,
in PyTorch.

``segment`` is ``scatter_reduce(..., include_self=True)`` into an
identity-filled output: empty segments read the identity, exactly as
``jax.ops.segment_*`` fill them, and ids outside ``[0, num_segments)``
are dropped (the JAX ``FILL_OR_DROP`` rule).

The GNN side's message-passing reductions (``mp_segment_sum`` /
``_max`` / ``_min`` and the segment statistics built on them) follow.
``mp_segment_sum`` of float32 or bfloat16 rows runs on K2a
(``kernels.segsum.SegmentSumFn``: the hand-written kernel on the card,
its plain version on the CPU); max and min take the scatter.

On DTensors (a partitioned GNN cell, ``launch.tasks``: messages and
ids over the edges, node rows over the same mesh dims) each reduction
runs on the rank's own edges under ``local_map`` and hands back the
rank's own node rows: the sum reduce-scatters its partial ``[N, ...]``
over the flattened dims (``_own_rows_sum``), max and min all-reduce it
(``_MergeExtreme``) and keep their rows; ``graph_segment`` folds node
rows into whole graphs, replicated.  Plain tensors take the paths
above, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.kernels.segsum.ops import SegmentSumFn
from repro_torch.sparse.gather import clamped_ids, gather_nodes


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Commutative monoid: identity + combine + a segment reduction.

    ``segment`` satisfies ``segment(x, ids, n)[i] == fold(combine,
    identity, [x[j] for j where ids[j]==i])`` — the law the parity
    tests assert against the JAX registry.
    """

    name: str
    identity: Callable[[torch.dtype], int | float | bool]
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    segment: Callable[..., torch.Tensor]


def _min_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


# scatter_reduce's name for each monoid's reduction.
_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax", "prod": "prod"}


def scatter_fold(out: torch.Tensor, index: torch.Tensor, rows: torch.Tensor,
                 monoid_name: str) -> torch.Tensor:
    """Fold ``rows`` into ``out`` (identity-filled, ``[n, ...]``) along
    dim 0 by ``index`` (``[len(rows)]`` int64, all in range).

    Float min/max propagate NaN, as ``jnp.minimum``/``jnp.maximum`` do:
    the scatter's own NaN handling is not specified across devices, so a
    row that saw a NaN is set to NaN explicitly.
    """
    idx = index.reshape((-1,) + (1,) * (rows.dim() - 1)).expand_as(rows)
    out = out.scatter_reduce(0, idx, rows, _SCATTER_REDUCE[monoid_name],
                             include_self=True)
    if monoid_name in ("min", "max") and rows.dtype.is_floating_point:
        nan = torch.zeros(out.shape, dtype=torch.int32, device=out.device)
        nan = nan.scatter_reduce(0, idx, rows.isnan().to(torch.int32),
                                 "amax", include_self=True)
        out = torch.where(nan > 0, torch.full_like(out, float("nan")), out)
    return out


def _segment(monoid_name: str):
    def segment(x: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
        ident = MONOIDS[monoid_name].identity(x.dtype)
        ids = ids.to(torch.int64)
        # Out-of-range ids land in one spare segment that is sliced off.
        ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                          torch.full_like(ids, num_segments))
        out = torch.full((num_segments + 1,) + tuple(x.shape[1:]), ident,
                         dtype=x.dtype, device=x.device)
        return scatter_fold(out, ids, x, monoid_name)[:num_segments]

    return segment


def _or_segment(x: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    # ``> 0`` (not a bool cast): an int32 segment max fills EMPTY
    # segments with iinfo.min, which a bool cast would read as True — the
    # monoid law requires the identity (False) for empty folds.
    return _segment("max")(x.to(torch.int32), ids, num_segments) > 0


MONOIDS: dict[str, Monoid] = {
    "sum": Monoid("sum", identity=lambda dt: 0, combine=torch.add,
                  segment=_segment("sum")),
    "max": Monoid("max", identity=_max_identity, combine=torch.maximum,
                  segment=_segment("max")),
    "min": Monoid("min", identity=_min_identity, combine=torch.minimum,
                  segment=_segment("min")),
    "prod": Monoid("prod", identity=lambda dt: 1, combine=torch.mul,
                   segment=_segment("prod")),
    "or": Monoid("or", identity=lambda dt: 0, combine=torch.logical_or,
                 segment=_or_segment),
}


def resolve_monoid(combiner: str | Monoid) -> Monoid:
    if isinstance(combiner, Monoid):
        return combiner
    try:
        return MONOIDS[combiner]
    except KeyError as e:
        raise ValueError(
            f"unknown combiner {combiner!r}; known: {sorted(MONOIDS)}"
        ) from e


def derive_monoid_for(x: torch.Tensor) -> Monoid:
    """Auto-derive a MessageCombiner from the message type: floats and
    ints default to ``sum``, bools to ``or``.  Algorithms needing max/min
    (label propagation, SSSP) say so explicitly."""
    if x.dtype == torch.bool:
        return MONOIDS["or"]
    return MONOIDS["sum"]


def segment_reduce(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str | Monoid = "sum",
) -> torch.Tensor:
    """Reduce ``data`` rows by key; empty segments get the identity."""
    return resolve_monoid(combiner).segment(data, segment_ids, num_segments)


# ---------------------------------------------------------------------------
# Edge-sharded execution (the MESH replicated backend, exposed to every
# consumer of the message-passing reductions).  Inside
# ``edge_sharded(group)`` each ``mp_segment_*`` reduction computes this
# rank's partial over its shard of the edges and merges it across the
# ``torch.distributed`` group with the matching ``all_reduce``
# (SUM / MAX / MIN); models stay oblivious, only the executor
# (``launch.gnn_sharded``) cuts the edges and enters the context.
#
# Gradients: every merge's backward all-reduces (SUMs) its cotangent.
# With each rank back-propagating ``loss / world`` and the parameters'
# gradients summed across ranks afterwards, the result is the gradient
# of the unsharded loss: the replicated (node-side) part of every
# gradient is a world-th on each rank, and each edge shard's part sees
# the whole cotangent of the merged value.  The max / min merges send
# that cotangent to the rank(s) whose partial holds the extreme, as the
# JAX package's ``_pmax`` / ``_pmin`` do, but split among the rows that
# reach it across ranks (the reference gives each tied shard the whole
# cotangent, "exact up to fp ties across shards"): duplicate edges tie
# exactly, and the split keeps the sharded gradient the plain one.
# ---------------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def edge_sharded(group):
    """Merge every ``mp_segment_*`` reduction across ``group`` (a
    process group, or ``torch.distributed.group.WORLD``) while inside;
    the counterpart of the JAX package's ``edge_sharded(axes)``."""
    prev = getattr(_CTX, "group", None)
    _CTX.group = group
    try:
        yield
    finally:
        _CTX.group = prev


def _merge_group():
    return getattr(_CTX, "group", None)


def _all_reduced(x: torch.Tensor, op, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


class _MergeSum(torch.autograd.Function):
    """``all_reduce`` SUM; its backward all-reduces the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduced(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduced(grad, dist.ReduceOp.SUM, ctx.group), None


class _MergeExtreme(torch.autograd.Function):
    """``all_reduce`` MAX or MIN of this rank's partial ``x``, whose
    extremes ``ties`` rows of its shard reach.  The all-reduced
    cotangent goes to the rank(s) whose partial equals the merged
    extreme, split among the rows that reach it on every rank, as the
    plain scatter's gradient splits it among tied rows."""

    @staticmethod
    def forward(ctx, x, ties, op, group):
        ctx.group = group
        m = _all_reduced(x, op, group)
        holds = x == m
        total = _all_reduced(torch.where(holds, ties, 0),
                             dist.ReduceOp.SUM, group)
        ctx.save_for_backward(holds, ties, total)
        return m

    @staticmethod
    def backward(ctx, grad):
        holds, ties, total = ctx.saved_tensors
        grad = _all_reduced(grad, dist.ReduceOp.SUM, ctx.group)
        share = ties.to(grad.dtype) / total.clamp(min=1).to(grad.dtype)
        return torch.where(holds, grad * share, 0), None, None, None


def _merge_sum(x: torch.Tensor) -> torch.Tensor:
    group = _merge_group()
    return x if group is None else _MergeSum.apply(x, group)


def _mp_extreme(name: str, op, data, segment_ids, num_segments):
    if _is_dtensor(segment_ids):
        return _extreme_partitioned(name, op, data, segment_ids,
                                    num_segments)
    local = MONOIDS[name].segment(data, segment_ids, num_segments)
    group = _merge_group()
    if group is None:
        return local
    # Rows of this shard that reach their segment's local extreme.
    reach = (data == _take(local, segment_ids)).to(torch.int32)
    ties = MONOIDS["sum"].segment(reach, segment_ids, num_segments)
    return _MergeExtreme.apply(local, ties, op, group)


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """A segment sum, unmerged: float32 / bfloat16 rows of any rank on
    K2a as ``[E, prod(rest)]``, other types (integer counts) on the
    scatter, since K2a sums floats only."""
    if data.dtype not in (torch.float32, torch.bfloat16):
        return MONOIDS["sum"].segment(data, segment_ids, num_segments)
    rest = tuple(data.shape[1:])
    flat = data.reshape(data.shape[0], math.prod(rest))
    return SegmentSumFn.apply(flat, segment_ids, num_segments).reshape(
        (num_segments,) + rest)


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` with the JAX package's indexing rule: negative ids
    count from the end, then every id is clamped into range
    (``sparse.gather.gather_nodes``, which takes DTensors too)."""
    return gather_nodes(x, ids, jax_rule=True)


def mp_segment_sum(data, segment_ids, num_segments):
    """Segment sum that merges across edge shards when inside
    ``edge_sharded`` (this rank's partial + ``all_reduce`` SUM); of
    DTensors, the rank's own node rows (``_segment_sum_partitioned``)."""
    if _is_dtensor(segment_ids):
        return _segment_sum_partitioned(data, segment_ids, num_segments)
    return _merge_sum(_segment_sum(data, segment_ids, num_segments))


def mp_segment_max(data, segment_ids, num_segments):
    return _mp_extreme("max", dist.ReduceOp.MAX, data, segment_ids,
                       num_segments)


def mp_segment_min(data, segment_ids, num_segments):
    return _mp_extreme("min", dist.ReduceOp.MIN, data, segment_ids,
                       num_segments)


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Edges per segment, int32 (merged across edge shards)."""
    return mp_segment_sum(torch.ones_like(segment_ids, dtype=torch.int32),
                          segment_ids, num_segments)


def _per_row(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = mp_segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments)
    count = count.clamp(min=1).to(data.dtype)
    return total / _per_row(count, data.dim())


def segment_std(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-segment standard deviation (PNA's ``std`` aggregator),
    ``sqrt(var + eps)``.  Two passes: the mean, then the mean square of
    the centred values.  The JAX package's one pass, E[x²] − E[x]² in
    float32, cancels on values far from 0 with a small spread (its
    clip at 0 then reads the error as the variance); centring first
    does not."""
    mean = segment_mean(data, segment_ids, num_segments)
    centred = data - _take(mean, segment_ids)
    var = segment_mean(centred * centred, segment_ids, num_segments)
    return torch.sqrt(var + eps)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within each segment (GAT's edge
    softmax); edge-shard-aware: the max and the denominator merge."""
    seg_max = mp_segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(logits - _take(seg_max, segment_ids))
    denom = mp_segment_sum(exp, segment_ids, num_segments)
    return exp / _take(denom, segment_ids).clamp(min=1e-30)


def segment_logsumexp(logits: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    seg_max = mp_segment_max(logits, segment_ids, num_segments)
    safe_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(logits - _take(safe_max, segment_ids))
    s = mp_segment_sum(exp, segment_ids, num_segments)
    return safe_max + torch.log(s.clamp(min=1e-30))


def segment_normalize(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Divide each row by its segment's sum (unmerged, as the JAX
    package's: PageRank's broadcast)."""
    denom = _segment_sum(data, segment_ids, num_segments)
    denom = torch.where(denom.abs() < 1e-30, 1.0, denom)
    return data / _take(denom, segment_ids)


# ---------------------------------------------------------------------------
# Partitioned execution: DTensor messages and ids over the edges, node
# rows over the same mesh dims (``launch.tasks``' GNN ``pjit`` cells,
# the JAX package's placements).  Each reduction's body runs on the
# rank's own edges under ``local_map``; its collectives run over those
# mesh dims flattened (``models.sharding.row_mesh``: one call each).
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from repro_torch.models.sharding import is_dtensor

    return is_dtensor(x)


class _ReduceScatterRows(torch.autograd.Function):
    """This rank's node rows of the ranks' partials summed (one
    reduce-scatter over the 1-D mesh ``rows``); the backward all-gathers
    the cotangent of the rows (the partial's cotangent is the whole
    sum's)."""

    @staticmethod
    def forward(ctx, partial, rows):
        from repro_torch.models.sharding import reduce_scatter_rows

        ctx.rows = rows
        return reduce_scatter_rows(partial, rows)

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.models.sharding import all_gather_rows

        return all_gather_rows(grad, ctx.rows), None


def _own_rows_sum(partial: torch.Tensor, rows) -> torch.Tensor:
    """This rank's rows of the sum of every rank's ``partial [N, ...]``
    over ``rows`` (``partial`` itself where nothing cuts the rows)."""
    return partial if rows is None else _ReduceScatterRows.apply(partial,
                                                                 rows)


def _own_rows(x: torch.Tensor, rows) -> torch.Tensor:
    """This rank's piece of the whole ``x [N, ...]`` (the rows of its
    rank in ``rows``)."""
    if rows is None:
        return x
    k = x.shape[0] // rows.size()
    return x.narrow(0, rows.get_local_rank() * k, k)


def _partitioned_reduction(body, data, ids, num_segments):
    """``body(data_local, ids_local, rows)`` under ``local_map`` over the
    edges' layout, its result laid out as the node rows (the same
    placements, over ``num_segments`` rows)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sparse.gather import _edge_layout

    mesh, pl, rows = _edge_layout(ids, num_segments)
    return local_map(lambda d, i: body(d, i, rows), out_placements=list(pl),
                     in_placements=(pl, pl), device_mesh=mesh)(data, ids)


def _segment_sum_partitioned(data, ids, num_segments):
    """``mp_segment_sum`` of DTensors: the rank's partial over its own
    edges into ``[N, ...]`` (K2a for float rows, the scatter for
    integer counts), reduce-scattered to its node rows; backward one
    all-gather of the cotangent, then ``SegmentSumFn``'s gather."""

    def body(d, i, rows):
        return _own_rows_sum(_segment_sum(d, i, num_segments), rows)

    return _partitioned_reduction(body, data, ids, num_segments)


def _extreme_partitioned(name, op, data, ids, num_segments):
    """``mp_segment_max`` / ``_min`` of DTensors: the rank's partial over
    its own edges merged by ``_MergeExtreme`` over the flattened group
    (its tie-split backward: the plain scatter's gradient), then the
    rank's own rows kept."""

    def body(d, i, rows):
        local = MONOIDS[name].segment(d, i, num_segments)
        if rows is None:
            return local
        reach = (d == local[clamped_ids(i, num_segments)]).to(torch.int32)
        ties = MONOIDS["sum"].segment(reach, i, num_segments)
        return _own_rows(_MergeExtreme.apply(local, ties, op,
                                             rows.get_group()), rows)

    return _partitioned_reduction(body, data, ids, num_segments)


class _AllReducedSum(torch.autograd.Function):
    """Every rank's partial summed, on every rank (one all-reduce over
    the 1-D mesh ``rows``).  The result is replicated and so is what
    consumes it: each rank's partial takes the cotangent as it is."""

    @staticmethod
    def forward(ctx, partial, rows):
        from torch.distributed import _functional_collectives as funcol

        from repro_torch.models.sharding import waited

        return waited(funcol.all_reduce(partial.contiguous(), "sum", rows))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def graph_segment(x: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int,
                  monoid: str = "sum") -> torch.Tensor:
    """Node rows folded into their graphs: ``MONOIDS[monoid].segment(x,
    graph_ids, n_graphs)`` (``sum``, or ``max`` of integer labels).  Of
    DTensors (nodes over some mesh dims), each rank folds its own rows
    and the partials are all-reduced once over those dims flattened:
    the ``[n_graphs, ...]`` result is replicated, the layout of the JAX
    package's per-graph loss."""
    if not _is_dtensor(x):
        return MONOIDS[monoid].segment(x, graph_ids, n_graphs)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.sharding import row_mesh, waited

    mesh, pl = x.device_mesh, tuple(x.placements)
    rows = row_mesh(mesh, pl)

    def body(v, gid):
        part = MONOIDS[monoid].segment(v, gid, n_graphs)
        if rows is None:
            return part
        if monoid == "sum":
            return _AllReducedSum.apply(part, rows)
        if part.is_floating_point() and part.requires_grad:
            raise ValueError(f"graph_segment: no gradient through {monoid}")
        return waited(funcol.all_reduce(part.contiguous(), monoid, rows))

    return local_map(body, out_placements=[Replicate()] * mesh.ndim,
                     in_placements=(pl, pl), device_mesh=mesh)(x, graph_ids)
