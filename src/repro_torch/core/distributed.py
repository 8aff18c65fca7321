"""Distributed MESH executor: superstep pairs over ``torch.distributed``.

The port's counterpart of the JAX package's ``repro.core.distributed``.
There, one program runs under ``shard_map`` over the mesh's ``data``
axis; here one process runs per rank, every rank builds the same
hypergraph and the same ``PartitionPlan`` from the same seed, and rank
``p`` holds the plan's edge shard ``p``.  Two backends, both over the
plan's padded edge shards:

* ``replicated`` — entity state replicated on every rank; each rank
  combines its own edges into a full-size message buffer and one
  ``all_reduce`` (``SUM`` / ``MAX`` / ``MIN``) merges.  One collective
  of O(N·d) per half-superstep.
* ``sharded`` — entity state split by id range over the ranks; per
  half-superstep: ``all_gather_into_tensor`` of the sender side's
  messages (and activity), a local gather + combine over the rank's
  edges into a full-size buffer, then a reduce-scatter that leaves each
  rank its id block (one reduce-scatter with the monoid's op, on NCCL
  and ``gloo`` alike: both take ``SUM``, ``MAX`` and ``MIN``).

The ``or`` monoid travels as ``MAX`` over a ``uint8`` view (a ``SUM``
of bools would overflow the byte).  The pair itself is the local
engine's (``engine.pair_in_place`` with ``dist=``), so both backends run
the local design points unchanged, ``delivery='pallas_fused'`` included:
each rank runs the fused delivery (K1 on the card) over its own shard's
layout (``build_shard_delivery``).  The halting test reads only activity
counts that are the same on every rank: ``all_reduce``d under
``sharded``, computed from replicated state under ``replicated``.  A
rank that leaves the loop while another waits in a collective would
hang; the group's timeout (``launch.mesh.init_local_group``) turns that
into an error on every rank.

Correctness contract (tested on four ``gloo`` ranks): for every plan
and program pair, both backends equal the single-device engine —
bitwise for min, max, or and integer sums, within float reassociation
for float sums.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import Program, constant_initial_msg, tree_map
from repro_torch.core.engine import (
    _pair,
    deliver,
    halting_loop,
    pair_in_place,
    pair_state,
)
from repro_torch.core.hypergraph import HyperGraph, _host

Pytree = Any

_REDUCE_OPS = {
    "sum": dist.ReduceOp.SUM,
    "or": dist.ReduceOp.MAX,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


# torch 2.13 renamed these two (the old names warn); older releases
# have only the old names.
all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _pad_to(n: int, parts: int) -> int:
    return -(-n // parts) * parts


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What a rank's distributed superstep needs: the JAX package's
    static facts (``axis``, ``n_parts``, ``nv_pad``, ``ne_pad``) plus the
    backend, the process group of the mesh's axis and this rank's index
    along it."""

    axis: str
    n_parts: int
    nv_pad: int
    ne_pad: int
    backend: str = "replicated"
    group: Any = None
    rank: int = 0

    @classmethod
    def for_mesh(cls, mesh, axis: str, n_vertices: int, n_hyperedges: int,
                 backend: str) -> "DistContext":
        """The context of this process on ``mesh[axis]`` for entity
        counts padded to a multiple of the axis's size."""
        from repro_torch.launch.mesh import mesh_size

        if backend not in ("replicated", "sharded"):
            raise ValueError(backend)
        n_parts = mesh_size(mesh, axis)
        return cls(
            axis=axis, n_parts=n_parts,
            nv_pad=_pad_to(n_vertices, n_parts),
            ne_pad=_pad_to(n_hyperedges, n_parts),
            backend=backend, group=mesh.get_group(axis),
            rank=int(mesh.get_local_rank(axis)),
        )

    @property
    def sharded(self) -> bool:
        return self.backend == "sharded"

    @property
    def superstep(self):
        """This backend's pair (``engine._pair``'s signature)."""
        fn = _superstep_sharded if self.sharded else _superstep_replicated
        return lambda *args: fn(self, *args)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's id block of a full padded ``[n_pad, ...]`` tensor
        under ``sharded``; the whole tensor under ``replicated``."""
        if not self.sharded:
            return x
        size = x.shape[0] // self.n_parts
        return x[self.rank * size:(self.rank + 1) * size]

    def full(self, tree: Pytree) -> Pytree:
        """The full padded tensors of a tree of this rank's blocks
        (``all_gather`` under ``sharded``; as is under ``replicated``)."""
        if not self.sharded:
            return tree
        return tree_map(lambda leaf: _all_gather(leaf, self), tree)

    def count(self, cnt, active):
        """An activity count over the whole world: ``sharded`` counts
        are summed over the ranks (one ``all_reduce``); counts without
        an activity vector are the real entity counts already."""
        if self.sharded and active is not None:
            dist.all_reduce(cnt, op=dist.ReduceOp.SUM, group=self.group)
        return cnt


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _wire(leaf: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the collectives take: bools as ``uint8``."""
    leaf = leaf.contiguous()
    return leaf.view(torch.uint8) if leaf.dtype == torch.bool else leaf


def _unwire(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return out.view(torch.bool) if dtype == torch.bool else out


def _reduce_op(monoid):
    try:
        return _REDUCE_OPS[monoid.name]
    except KeyError:
        raise NotImplementedError(monoid.name) from None


def _all_gather(leaf: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """Every rank's ``[n/P, ...]`` block, concatenated in rank order."""
    wire = _wire(leaf)
    out = torch.empty((wire.shape[0] * ctx.n_parts,) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    all_gather_single(out, wire, group=ctx.group)
    return _unwire(out, leaf.dtype)


def _cross_combine(program: Program, partials, ctx: DistContext):
    """Merge the ranks' partial aggregates, in place, with the monoid the
    local combine used (``all_reduce``)."""
    def one(leaf):
        op = _reduce_op(program.monoid_for(leaf))
        wire = _wire(leaf)
        dist.all_reduce(wire, op=op, group=ctx.group)
        return _unwire(wire, leaf.dtype)

    return tree_map(one, partials)


def _cross_combine_scatter(program: Program, partials, ctx: DistContext):
    """Merge the ranks' partials and keep only this rank's id block: a
    reduce-scatter with the monoid's op."""
    def one(leaf):
        wire = _wire(leaf)
        out = torch.empty((wire.shape[0] // ctx.n_parts,)
                          + tuple(wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        op = _reduce_op(program.monoid_for(leaf))
        reduce_scatter_single(out, wire, op=op, group=ctx.group)
        return _unwire(out, leaf.dtype)

    return tree_map(one, partials)


def _deliver_local(program, out_msg_full, active_full, src, dst, mask,
                   num_dst, layout=None):
    """gather -> transform -> mask -> local combine, over one rank's
    padded edge shard, into a full-size partial: ``engine.deliver`` with
    the shard mask as the incidence mask (``edge_transform`` gets no
    edge attributes, as in the JAX package).

    ``layout``: the rank's ``DeliveryLayout`` (the shard mask folded in)
    — the fused delivery (K1 on the card), the local engine's
    ``delivery='pallas_fused'`` design point.  A custom (Seq) reducer's
    partials have no cross-rank combine, so it is refused.
    """
    if program.reducer is not None:
        raise NotImplementedError(
            "custom (Seq) reducers are local-engine only; distribute the "
            "sum-decomposed form instead (see pagerank_entropy)."
        )
    return deliver(out_msg_full, active_full, src, dst, num_dst, program,
                   None, mask, layout=layout)


# --------------------------------------------------------------------------
# the two backends' pairs (``engine._pair``'s signature, plus the context)
# --------------------------------------------------------------------------

def _superstep_replicated(ctx: DistContext, hg, step, v_attr, he_attr,
                          msg_to_v, v_program, he_program, v_deg, he_card,
                          delivery, ids, batched):
    """``hg``: this rank's edge shard over the padded entity range; the
    state is full size.  Each half delivers over the shard and
    ``all_reduce``s the full-size partials."""
    def send(out_msg, active, src, dst, num_dst, program, e_attr, e_mask,
             layout=None):
        partial = _deliver_local(program, out_msg, active, src, dst,
                                 e_mask, num_dst, layout)
        return _cross_combine(program, partial, ctx)

    return _pair(hg, step, v_attr, he_attr, msg_to_v, v_program,
                 he_program, v_deg, he_card, delivery, ids, batched,
                 send=send)


def _superstep_sharded(ctx: DistContext, hg, step, v_attr, he_attr,
                       msg_to_v, v_program, he_program, v_deg, he_card,
                       delivery, ids, batched):
    """The state carries only this rank's id block (``[n/P, ...]``; the
    ids are global).  Each half gathers the senders' messages and
    activity, delivers over the shard into a full-size buffer and
    reduce-scatters it."""
    def send(out_msg, active, src, dst, num_dst, program, e_attr, e_mask,
             layout=None):
        msg_full = tree_map(lambda leaf: _all_gather(leaf, ctx), out_msg)
        act_full = _all_gather(active, ctx) if active is not None else None
        partial = _deliver_local(program, msg_full, act_full, src, dst,
                                 e_mask, num_dst, layout)
        return _cross_combine_scatter(program, partial, ctx)

    return _pair(hg, step, v_attr, he_attr, msg_to_v, v_program,
                 he_program, v_deg, he_card, delivery, ids, batched,
                 send=send)


# --------------------------------------------------------------------------
# fused-delivery shard layouts
# --------------------------------------------------------------------------

def build_shard_delivery(shard_src, shard_dst, shard_mask, nv_pad: int,
                         ne_pad: int, parts=None, device=None):
    """Per-shard fused-delivery layouts for both half-superstep
    directions, over a plan's ``[n_parts, shard_len]`` edge shards.

    Returns the ``(fwd, bwd)`` layout pair of each shard in ``parts``
    (default: every shard); a rank builds only its own
    (``parts=(rank,)``).  Each shard's layout covers the *full* padded
    entity range (both backends combine into full-size buffers before
    their collective), with the shard mask folded in: a destination
    with no live edge in the shard comes out as the monoid's identity,
    so the cross-rank combine is exact.  Class boundaries and widths are
    planned once per direction from the merged per-shard live-degree
    histograms, and the data-dependent shapes (per-class rows, edge
    lengths, the residual pad, the residual count and each class's
    block extent) take their maxima over every shard: the JAX package's
    ``build_shard_delivery`` and ``_stack_layouts``, whose stacked
    arrays these layouts equal shard for shard.
    """
    from repro_torch.kernels.deliver import (
        build_delivery_layout,
        classify_degrees,
        plan_degree_classes,
    )
    from repro_torch.kernels.deliver.layout import (
        _PAD_FLOOR,
        _ROW_FLOOR,
        _pow2_at_least,
        class_tile_bounds,
    )

    shard_src = _host(shard_src)
    shard_dst = _host(shard_dst)
    shard_mask = _host(shard_mask)
    n_parts = shard_src.shape[0]
    parts = tuple(range(n_parts)) if parts is None else tuple(parts)

    def direction(srcs, dsts, n_src, n_dst):
        live = shard_mask != 0
        degs = [
            np.bincount(dsts[p][live[p]], minlength=max(n_dst, 1))[:n_dst]
            for p in range(n_parts)
        ]
        plan = plan_degree_classes(np.concatenate(degs), int(live.sum()))
        widths = np.asarray(plan.widths, np.int64)
        n_classes = len(widths)
        rows_max = np.zeros(n_classes, np.int64)
        nnz_max = np.zeros(n_classes, np.int64)
        rem_max = 0
        classes = [classify_degrees(deg, widths) for deg in degs]
        for deg, cls in zip(degs, classes):
            pos = cls >= 0
            rows = np.bincount(cls[pos], minlength=n_classes)
            nnz_c = np.bincount(
                cls[pos], weights=deg[pos].astype(np.float64),
                minlength=n_classes,
            ).astype(np.int64)
            np.maximum(rows_max, rows, out=rows_max)
            np.maximum(nnz_max, nnz_c, out=nnz_max)
            spill = int(np.maximum(deg[pos] - widths[cls[pos]], 0).sum())
            rem_max = max(rem_max, spill)
        kw = dict(
            plan=plan,
            class_rows_pad=tuple(
                _pow2_at_least(max(int(r), 1), _ROW_FLOOR)
                for r in rows_max),
            class_nnz_pad=tuple(int(n) for n in nnz_max),
            rem_pad_to=_pow2_at_least(max(rem_max, 1), _PAD_FLOOR),
            device=device,
        )
        built = {p: build_delivery_layout(srcs[p], dsts[p], shard_mask[p],
                                          n_src, n_dst, **kw)
                 for p in parts}
        # Every shard's class block extents, from the same histograms
        # (the ranks build only their own layouts).
        like = built[parts[0]]
        max_blocks = tuple(
            max(class_tile_bounds(deg[cls == c], kw["class_rows_pad"][c],
                                  like.block_n, like.class_block_e[c])[1]
                for deg, cls in zip(degs, classes))
            for c in range(n_classes))
        return {p: dataclasses.replace(built[p], rem_nnz=rem_max,
                                       class_max_blocks=max_blocks)
                for p in parts}

    fwd = direction(shard_src, shard_dst, nv_pad, ne_pad)
    bwd = direction(shard_dst, shard_src, ne_pad, nv_pad)
    return tuple((fwd[p], bwd[p]) for p in parts)


# --------------------------------------------------------------------------
# a rank's inputs
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RankShard:
    """What one rank's pairs read: its edge shard as a hypergraph over
    the padded entity range, its degrees and entity ids (its block under
    ``sharded``), the real entity counts as device scalars, and its
    layout pair (``None`` on the reference path)."""

    hg: HyperGraph
    v_deg: torch.Tensor
    he_card: torch.Tensor
    ids: tuple
    n_real: tuple
    delivery: tuple | None


def rank_shard(ctx: DistContext, shard_src, shard_dst, shard_mask, v_deg,
               he_card, nv_real, ne_real, delivery, device) -> RankShard:
    """This rank's ``RankShard`` from the plan's ``[n_parts, L]`` edge
    shards and the full padded degrees."""
    dev = torch.device(device)
    row = lambda a, dt: torch.as_tensor(
        np.ascontiguousarray(_host(a)[ctx.rank], dt), device=dev)
    hs = HyperGraph(
        src=row(shard_src, np.int32), dst=row(shard_dst, np.int32),
        n_vertices=ctx.nv_pad, n_hyperedges=ctx.ne_pad,
        e_mask=row(shard_mask, np.float32),
    )
    ids = tuple(ctx.block(torch.arange(n, dtype=torch.int32, device=dev))
                for n in (ctx.nv_pad, ctx.ne_pad))
    real = tuple(n if isinstance(n, torch.Tensor) else
                 torch.full((), int(n), dtype=torch.int32, device=dev)
                 for n in (nv_real, ne_real))
    return RankShard(hg=hs, v_deg=ctx.block(v_deg),
                     he_card=ctx.block(he_card), ids=ids, n_real=real,
                     delivery=delivery)


def plan_rank_shard(hg: HyperGraph, plan, ctx: DistContext,
                    delivery: str = "xla", layouts=None) -> RankShard:
    """This rank's ``RankShard`` of ``plan`` over ``hg``: the rank's
    shard row copied to ``hg``'s device, ``hg``'s padded degrees, and
    under ``delivery='pallas_fused'`` its layout pair (``layouts``: one
    already built).  A run reads it on every chunk; ``Engine`` keeps it
    per plan and backend."""
    if delivery != "pallas_fused":
        layouts = None
    elif layouts is None:
        layouts = _shard_layouts(plan, ctx, hg.device)
    return rank_shard(
        ctx, plan.shard_src, plan.shard_dst, plan.shard_mask,
        _pad_leading(hg.degrees(), ctx.nv_pad),
        _pad_leading(hg.cardinalities(), ctx.ne_pad),
        hg.n_vertices, hg.n_hyperedges, layouts, hg.device)


def _pad_leading(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    pad = n_pad - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                     dtype=x.dtype, device=x.device)])


def _check_plan(plan, mesh, axis: str) -> None:
    from repro_torch.launch.mesh import mesh_size

    n = mesh_size(mesh, axis)
    if plan.n_parts != n:
        raise ValueError(
            f"plan has {plan.n_parts} partitions but mesh[{axis!r}] = {n}"
        )


def _shard_layouts(plan, ctx: DistContext, device):
    """This rank's fused layout pair over the plan's shards."""
    return build_shard_delivery(
        plan.shard_src, plan.shard_dst, plan.shard_mask, ctx.nv_pad,
        ctx.ne_pad, parts=(ctx.rank,), device=device)[0]


def distributed_compute(
    hg: HyperGraph,
    plan,
    mesh,
    max_iters: int,
    initial_msg: Pytree,
    v_program: Program,
    he_program: Program,
    *,
    axis: str = "data",
    backend: str = "replicated",
    feature_axis: str | None = None,
    return_stats: bool = False,
    delivery: str = "xla",
    shard: RankShard | None = None,
    counters: dict | None = None,
) -> HyperGraph:
    """Run ``compute`` distributed over ``mesh[axis]`` per ``plan``; every
    rank calls it with the same hypergraph and plan and gets the whole
    result.

    ``return_stats``: also return the per-superstep ``(v_active,
    he_active)`` activity traces (int32, length ``max_iters``), equal to
    the local engine's.  ``delivery``: ``'xla'`` (reference) or
    ``'pallas_fused'`` — this rank's ``build_shard_delivery`` layouts.
    ``shard``: this rank's ``plan_rank_shard`` for this backend and
    delivery, already built.  ``feature_axis`` (the JAX package's 2-D
    hypergraph parallelism) needs a second mesh axis; the port's mesh
    has one, so it must be ``None``.  ``counters`` accumulates
    ``halting_loop``'s ``pairs_run``, ``host_syncs`` and ``halted``.
    """
    if feature_axis is not None:
        raise ValueError(
            "feature_axis needs a 2-D mesh; the port's host mesh has one "
            "axis"
        )
    _check_plan(plan, mesh, axis)
    state = distributed_initial_state(hg, plan, initial_msg)
    out, trace = distributed_compute_resumable(
        hg, plan, mesh, max_iters, state, v_program, he_program,
        axis=axis, backend=backend, delivery=delivery, shard=shard,
        counters=counters,
    )
    res = hg.with_attrs(
        v_attr=tree_map(lambda x: x[:hg.n_vertices], out["v_attr"]),
        he_attr=tree_map(lambda x: x[:hg.n_hyperedges], out["he_attr"]),
    )
    if return_stats:
        return res, trace
    return res


def distributed_initial_state(hg: HyperGraph, plan,
                              initial_msg: Pytree) -> dict:
    """The explicit (partition-padded) loop state ``distributed_compute``
    starts from, as a checkpoint-serializable tree — the distributed
    twin of ``engine.initial_superstep_state``."""
    nv_pad = _pad_to(hg.n_vertices, plan.n_parts)
    ne_pad = _pad_to(hg.n_hyperedges, plan.n_parts)
    return {
        "step": 0,
        "v_attr": tree_map(lambda x: _pad_leading(x, nv_pad), hg.v_attr),
        "he_attr": tree_map(lambda x: _pad_leading(x, ne_pad), hg.he_attr),
        "msg": constant_initial_msg(initial_msg, nv_pad, hg.device),
        "halted": False,
    }


def distributed_compute_resumable(
    hg: HyperGraph,
    plan,
    mesh,
    n_iters: int,
    state: dict,
    v_program: Program,
    he_program: Program,
    *,
    axis: str = "data",
    backend: str = "replicated",
    delivery: str = "xla",
    shard: RankShard | None = None,
    counters: dict | None = None,
):
    """Run ``n_iters`` superstep pairs from an explicit loop ``state``
    (see ``distributed_initial_state``); returns ``(state', trace)``.

    ``distributed_compute`` with the loop state lifted to an argument —
    the distributed checkpoint/resume seam.  Every chunk runs the same
    pair and loop, so chunked runs compose bitwise into an uninterrupted
    run (the local engine's ``compute_resumable`` contract).
    ``state'`` holds the full padded tensors on every rank; under
    ``sharded`` the rank runs on its block and gathers back.
    ``shard`` and ``counters``: as ``distributed_compute``'s (the
    shard is built here when ``None``).
    """
    _check_plan(plan, mesh, axis)
    ctx = DistContext.for_mesh(mesh, axis, hg.n_vertices, hg.n_hyperedges,
                               backend)
    if shard is None:
        shard = plan_rank_shard(hg, plan, ctx, delivery)
    counters = counters if counters is not None else {}
    step = int(state["step"]) + 2 * n_iters
    if state["halted"]:
        for key in ("pairs_run", "host_syncs"):
            counters.setdefault(key, 0)
        counters["halted"] = True
        zeros = torch.zeros(n_iters, dtype=torch.int32, device=hg.device)
        return {**state, "step": step}, (zeros, zeros.clone())
    block = lambda tree: tree_map(ctx.block, tree)
    ps = pair_state(block(state["v_attr"]), block(state["he_attr"]),
                    block(state["msg"]), n_iters, None,
                    device=shard.v_deg.device)
    ps["step"].fill_(int(state["step"]))
    halting_loop(
        lambda: pair_in_place(
            ps, shard.hg, v_program, he_program, shard.v_deg, shard.he_card,
            ids=shard.ids, n_real=shard.n_real, delivery=shard.delivery,
            dist=ctx),
        ps, n_iters, counters)
    out = {"step": step, "v_attr": ctx.full(ps["v_attr"]),
           "he_attr": ctx.full(ps["he_attr"]), "msg": ctx.full(ps["msg"]),
           "halted": counters["halted"]}
    return out, (ps["v_trace"], ps["he_trace"])
