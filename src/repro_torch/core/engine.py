"""The MESH superstep engine (single-device executor), in PyTorch.

``compute`` is the paper's ``HyperGraph.compute``: alternating vertex /
hyperedge supersteps, message delivery along the bipartite incidence
with combiner-merged messages, and dynamic termination when every
entity goes inactive (SSSP).

The JAX package halts with ``lax.cond`` inside a static ``lax.scan``;
here the scan is a Python loop with the same semantics: at most
``max_iters`` pairs, stop once ``v_active + he_active == 0``, every later
stats row is 0, and the final state is the halted state.  There is one
pair and one loop for every path.  ``pair_in_place`` runs a superstep
pair on a loop state (``pair_state``) in place with no host read (the
step is a device tensor it advances), so the compiled path
(``repro_torch.core.serving``) can capture it once in a CUDA graph and
replay it.  ``halting_loop`` is the host loop around it (the JAX
package's scan and its ``batch_halting_scan``): deciding to stop reads
the state's halt flag on the host, one sync per pair, skipped when both
procedures return ``active=None`` (the counts are the entity counts,
known without the device).  ``compute`` runs the same pair and loop
eagerly.  A batch of queries keeps its query axis inner (``[n, B,
...]``): procedures run under ``torch.func.vmap`` over dim 1, delivery
stays outside it and serves every query in one launch, and a halted
query is frozen by selection.

Procedures get the superstep as a 0-d int32 tensor on the entities'
device, as the JAX package's traced step: they select on it with
``torch.where``.  A procedure that reads it on the host still runs in
``Engine.run``, but fails the compiled path's capture on the card.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.api import Program, ProcedureOut, constant_initial_msg
from repro_torch.core.api import tree_map
from repro_torch.core.hypergraph import HyperGraph

Pytree = Any


def deliver(
    out_msg: Pytree,
    active: torch.Tensor | None,
    src_ids: torch.Tensor,
    dst_ids: torch.Tensor,
    num_dst: int,
    program: Program,
    e_attr: Pytree = None,
    e_mask: torch.Tensor | None = None,
    layout=None,
) -> Pytree:
    """Deliver broadcast messages along incidences and combine by
    destination with the *sender* program's MessageCombiner.

    The reference (``delivery='xla'``) data path is gather -> optional
    per-incidence transform -> mask dead rows to the monoid identity ->
    segment-reduce by destination.

    ``layout``: optional ``DeliveryLayout`` (the ``delivery='pallas_fused'``
    design point) — routes the monoid path through
    ``repro_torch.kernels.deliver`` (gather, mask and combine fused, no
    ``[nnz, D]`` intermediate).  Custom ``reducer``s and per-incidence
    ``edge_transform``s always take the reference path.
    """
    if (layout is not None and program.reducer is None
            and program.edge_transform is None):
        from repro_torch.kernels.deliver import fused_deliver

        return fused_deliver(out_msg, active, layout, program)

    rows = tree_map(lambda leaf: leaf.index_select(0, src_ids), out_msg)
    if program.edge_transform is not None:
        rows = program.edge_transform(rows, e_attr)

    live = None
    if active is not None:
        # [nnz], or [nnz, B] for a batch of queries.
        live = active.index_select(0, src_ids)
    if e_mask is not None:
        em = e_mask.to(torch.bool)
        if live is not None:
            em = em.reshape((-1,) + (1,) * (live.dim() - 1))
        live = em if live is None else (live & em)

    if program.reducer is not None:
        return program.reducer(rows, dst_ids, num_dst, live)

    def combine_leaf(leaf: torch.Tensor) -> torch.Tensor:
        monoid = program.monoid_for(leaf)
        if live is not None:
            ident = torch.full((), monoid.identity(leaf.dtype),
                               dtype=leaf.dtype, device=leaf.device)
            shape = tuple(live.shape) + (1,) * (leaf.dim() - live.dim())
            leaf = torch.where(live.reshape(shape), leaf, ident)
        return monoid.segment(leaf, dst_ids, num_dst)

    return tree_map(combine_leaf, rows)


def _as_out(res) -> ProcedureOut:
    """Normalize procedure output (allow returning (attr, msg) tuples)."""
    if isinstance(res, ProcedureOut):
        return res
    if isinstance(res, tuple) and len(res) == 2:
        return ProcedureOut(res[0], res[1], None)
    raise TypeError(
        "Procedure must return ProcedureOut or (attr, msg); got "
        f"{type(res)}"
    )


def _over_queries(procedure):
    """``procedure`` over a batch whose query axis is dim 1 of every
    attribute and message leaf (``[n, B, ...]``): ``torch.func.vmap``
    over that axis, with the step, ids and degrees shared.

    vmap returns tensors only, so ``active=None`` is left out of what
    it maps.  Outputs leave vmap with the query axis first and are
    moved to dim 1: a view, contiguous for outputs computed from the
    query's state; an output that does not depend on the query (a
    constant, a function of the ids) comes out expanded over the batch.
    (``out_dims=1`` would do it in one step, but torch 2.11 and 2.13
    fail to expand such an output along dim 1.)
    """
    def call(step, ids, attr, msg, deg):
        has_active = []

        def one_query(step, ids, attr, msg, deg):
            out = _as_out(procedure(step, ids, attr, msg, deg))
            has_active.append(out.active is not None)
            return (out.attr, out.msg) + (
                (out.active,) if out.active is not None else ())

        parts = torch.func.vmap(
            one_query, in_dims=(None, None, 1, 1, None), out_dims=0,
        )(step, ids, attr, msg, deg)
        parts = tree_map(lambda x: x.movedim(0, 1), parts)
        return ProcedureOut(parts[0], parts[1],
                            parts[2] if has_active[0] else None)

    return call


def entity_ids(hg: HyperGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """``(v_ids, he_ids)``: the int32 ids the procedures get, made once
    per run rather than per pair."""
    dev = hg.device
    return (torch.arange(hg.n_vertices, dtype=torch.int32, device=dev),
            torch.arange(hg.n_hyperedges, dtype=torch.int32, device=dev))


def _pair(hg, step, v_attr, he_attr, msg_to_v, v_program, he_program,
          v_deg, he_card, delivery, ids, batched, send=deliver):
    """Both half-supersteps: ``(v_out, he_out, msg_to_v_next)``.

    ``send`` delivers one side's messages (``deliver``'s arguments); the
    distributed backends pass one that wraps it in their collectives
    (``repro_torch.core.distributed``)."""
    fwd_layout, bwd_layout = delivery if delivery is not None else (None, None)
    v_proc, he_proc = v_program.procedure, he_program.procedure
    if batched:
        v_proc, he_proc = _over_queries(v_proc), _over_queries(he_proc)
    v_ids, he_ids = ids
    v_out = _as_out(v_proc(step, v_ids, v_attr, msg_to_v, v_deg))
    msg_to_he = send(
        v_out.msg, v_out.active, hg.src, hg.dst, hg.n_hyperedges,
        v_program, hg.e_attr, hg.e_mask, layout=fwd_layout,
    )
    he_out = _as_out(
        he_proc(step + 1, he_ids, he_attr, msg_to_he, he_card)
    )
    msg_to_v_next = send(
        he_out.msg, he_out.active, hg.dst, hg.src, hg.n_vertices,
        he_program, hg.e_attr, hg.e_mask, layout=bwd_layout,
    )
    return v_out, he_out, msg_to_v_next


def _count(active, n, real, ids):
    """Active entities (per query for ``[n, B]`` activity) among the
    first ``real`` (all ``n`` when ``real`` is None).  Without an
    activity vector the count is ``real`` itself (or ``n``)."""
    if active is None:
        return n if real is None else real
    if real is not None:
        live = ids < real
        active = active & (live if active.dim() == 1 else live[:, None])
    return active.sum(0, dtype=torch.int32)


def initial_superstep_state(hg: HyperGraph, initial_msg: Pytree) -> dict:
    """The explicit loop state ``compute`` starts from: superstep
    counter, both attribute trees, the in-flight vertex-bound message
    buffer, and the halt flag."""
    return {
        "step": 0,
        "v_attr": hg.v_attr,
        "he_attr": hg.he_attr,
        "msg": constant_initial_msg(initial_msg, hg.n_vertices, hg.device),
        "halted": False,
    }


def compute_resumable(
    hg: HyperGraph,
    n_iters: int,
    state: dict,
    v_program: Program,
    he_program: Program,
    *,
    n_real: tuple | None = None,
    delivery: tuple | None = None,
    counters: dict | None = None,
):
    """Run ``n_iters`` superstep pairs from an explicit ``state`` (see
    ``initial_superstep_state``); returns ``(state', trace)`` where
    ``trace`` is ``(v_active, he_active)``, two ``[n_iters]`` int32
    tensors.

    The pairs are ``pair_in_place`` on a ``pair_state``, run eagerly
    by ``halting_loop``: the compiled path's pair and loop.  A halted
    state runs nothing: its rows of the trace stay 0 and the state is
    carried unchanged (``step`` still advances by 2 per pair, as the
    scan in the JAX package does).  ``counters`` (optional dict)
    accumulates ``pairs_run`` (pairs executed, the halting pair
    included), ``host_syncs`` (activity reads on the host) and
    ``halted``.
    """
    step0 = int(state["step"])
    counters = counters if counters is not None else {}
    out = {**state, "step": step0 + 2 * n_iters}
    if state["halted"]:
        for key in ("pairs_run", "host_syncs"):
            counters.setdefault(key, 0)
        counters["halted"] = True
        zeros = torch.zeros(n_iters, dtype=torch.int32, device=hg.device)
        return out, (zeros, zeros.clone())
    ps = pair_state(state["v_attr"], state["he_attr"], state["msg"],
                    n_iters, device=hg.device)
    ps["step"].fill_(step0)
    v_deg, he_card, ids = hg.degrees(), hg.cardinalities(), entity_ids(hg)
    halting_loop(
        lambda: pair_in_place(ps, hg, v_program, he_program, v_deg,
                              he_card, ids=ids, n_real=n_real,
                              delivery=delivery),
        ps, n_iters, counters,
    )
    out.update(v_attr=ps["v_attr"], he_attr=ps["he_attr"], msg=ps["msg"],
               halted=counters["halted"])
    return out, (ps["v_trace"], ps["he_trace"])


def compute(
    hg: HyperGraph,
    max_iters: int,
    initial_msg: Pytree,
    v_program: Program,
    he_program: Program,
    *,
    return_stats: bool = False,
    n_real: tuple | None = None,
    delivery: tuple | None = None,
    counters: dict | None = None,
):
    """Run the alternating-superstep computation; returns the updated
    HyperGraph (and the per-iteration activity trace when requested).

    ``max_iters`` counts (vertex, hyperedge) superstep pairs — the
    paper's "iterations".  See ``compute_resumable`` for the halting
    rule, ``n_real``, ``delivery`` and ``counters``.
    """
    state, trace = compute_resumable(
        hg, max_iters, initial_superstep_state(hg, initial_msg),
        v_program, he_program, n_real=n_real, delivery=delivery,
        counters=counters,
    )
    out = hg.with_attrs(v_attr=state["v_attr"], he_attr=state["he_attr"])
    if return_stats:
        return out, trace
    return out


# --------------------------------------------------------------------------
# the in-place pair and its loop: what every path runs (and the
# compiled path captures and replays)
# --------------------------------------------------------------------------

def _store(bufs: Pytree, values: Pytree) -> None:
    """Copy a tree into same-typed buffers (a loop state's carry)."""
    def one(buf, value):
        if buf.shape != value.shape or buf.dtype != value.dtype:
            raise TypeError(
                "a procedure changed the type of the loop state: "
                f"{tuple(buf.shape)} {buf.dtype} -> {tuple(value.shape)} "
                f"{value.dtype} (attributes and messages keep their "
                "shape and dtype from one superstep to the next)"
            )
        buf.copy_(value)

    tree_map(one, bufs, values)


def pair_state(v_attr: Pytree, he_attr: Pytree, msg: Pytree,
               max_iters: int, batch: int | None = None, *,
               device: torch.device) -> dict:
    """Buffers for ``pair_in_place``, filled with a starting state.

    ``step`` (0-d int32), ``row`` (``[1]`` int64: the pairs run, the
    next trace row), ``v_attr`` / ``he_attr`` / ``msg`` (trees of
    contiguous buffers), ``v_trace`` / ``he_trace`` (``[max_iters]``
    int32, ``[max_iters, batch]`` for a batch), ``done`` (0-d bool: the
    last pair halted the run, every query of a batch), for a batch
    ``halted`` (``[batch]`` bool), and ``counts``: the entity counts as
    device scalars, made at their first use and kept.
    """
    dev = device
    trace_shape = (max_iters,) + ((batch,) if batch is not None else ())
    buf = lambda x: torch.empty_like(x, memory_format=torch.contiguous_format)
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "row": torch.zeros(1, dtype=torch.int64, device=dev),
        "v_attr": tree_map(buf, v_attr),
        "he_attr": tree_map(buf, he_attr),
        "msg": tree_map(buf, msg),
        "v_trace": torch.zeros(trace_shape, dtype=torch.int32, device=dev),
        "he_trace": torch.zeros(trace_shape, dtype=torch.int32, device=dev),
        "done": torch.zeros((), dtype=torch.bool, device=dev),
        "counts": {},
    }
    if batch is not None:
        state["halted"] = torch.zeros(batch, dtype=torch.bool, device=dev)
    reset_pair_state(state, v_attr, he_attr, msg)
    return state


def reset_pair_state(state: dict, v_attr: Pytree, he_attr: Pytree,
                     msg: Pytree) -> None:
    """Start ``state`` over from the given attributes and message."""
    _store(state["v_attr"], v_attr)
    _store(state["he_attr"], he_attr)
    _store(state["msg"], msg)
    for key in ("step", "row", "v_trace", "he_trace", "done", "halted"):
        if key in state:
            state[key].zero_()


def _as_count(count, state: dict) -> torch.Tensor:
    """A count as a device scalar; a host int (an entity count) is made
    once per state, not per pair."""
    if isinstance(count, torch.Tensor):
        return count
    made = state["counts"].get(count)
    if made is None:
        made = state["counts"][count] = torch.full(
            (), count, dtype=torch.int32, device=state["step"].device)
    return made


def pair_in_place(
    state: dict,
    hg: HyperGraph,
    v_program: Program,
    he_program: Program,
    v_deg: torch.Tensor,
    he_card: torch.Tensor,
    *,
    ids: tuple,
    n_real: tuple | None = None,
    delivery: tuple | None = None,
    dist=None,
) -> bool:
    """One superstep pair on ``state`` (``pair_state``), in place.

    Reads nothing on the host, so a CUDA graph can capture it: the step
    is ``state["step"]``, advanced by 2 here; this pair's activity
    counts go to trace row ``state["row"]``, advanced by 1;
    ``state["done"]`` says whether the pair halted the run (set only
    when the host will read it).  A batch (``"halted"`` in ``state``)
    follows the JAX package's batch-aware halting: a halted query's
    state is frozen by selection and its counts are 0, and ``done`` is
    set once every query has halted.

    Returns whether the host must read ``done``: a procedure returned
    an activity vector, or the counts are host ints that sum to 0 (an
    empty structure).  Otherwise ``done`` is False and goes unread.

    ``dist``: a ``repro_torch.core.distributed.DistContext`` — the pair
    is then this rank's part of a distributed superstep pair
    (``dist.superstep``: ``hg`` is the rank's edge shard over the padded
    entity range, the state its entities), and each activity count is
    the whole world's (``dist.count``), so every rank decides to halt
    from the same numbers.
    """
    step = state["step"]
    halted = state.get("halted")
    superstep = _pair if dist is None else dist.superstep
    v_out, he_out, msg = superstep(
        hg, step, state["v_attr"], state["he_attr"], state["msg"],
        v_program, he_program, v_deg, he_card, delivery, ids,
        halted is not None,
    )
    nv_real, ne_real = n_real if n_real is not None else (None, None)
    v_cnt = _count(v_out.active, hg.n_vertices, nv_real, ids[0])
    he_cnt = _count(he_out.active, hg.n_hyperedges, ne_real, ids[1])
    if dist is not None:
        v_cnt = dist.count(v_cnt, v_out.active)
        he_cnt = dist.count(he_cnt, he_out.active)
    v_act, he_act = _as_count(v_cnt, state), _as_count(he_cnt, state)
    total = v_cnt + he_cnt
    # The host reads ``done`` only after a data-dependent pair, or at
    # once when the counts are host ints that sum to 0 (an empty
    # structure).
    read = (v_out.active is not None or he_out.active is not None
            or (not isinstance(total, torch.Tensor) and total == 0))
    if halted is None:
        _store(state["v_attr"], v_out.attr)
        _store(state["he_attr"], he_out.attr)
        _store(state["msg"], msg)
        if read:
            torch.eq(v_act + he_act, 0, out=state["done"])
    else:
        v_act = torch.where(halted, 0, v_act)
        he_act = torch.where(halted, 0, he_act)

        def keep(old, new):
            frozen = halted.reshape((1, -1) + (1,) * (old.dim() - 2))
            return torch.where(frozen, old, new)

        new_v = tree_map(keep, state["v_attr"], v_out.attr)
        new_he = tree_map(keep, state["he_attr"], he_out.attr)
        new_msg = tree_map(keep, state["msg"], msg)
        now_halted = halted | ((v_act + he_act) == 0)
        _store(state["v_attr"], new_v)
        _store(state["he_attr"], new_he)
        _store(state["msg"], new_msg)
        halted.copy_(now_halted)
        state["done"].copy_(now_halted.all())
    row = state["row"]
    state["v_trace"].index_copy_(0, row, v_act.reshape((1,) + v_act.shape))
    state["he_trace"].index_copy_(0, row,
                                  he_act.reshape((1,) + he_act.shape))
    row.add_(1)
    step.add_(2)
    return read


def halting_loop(pair, state: dict, max_iters: int,
                 counters: dict | None = None) -> int:
    """Run ``pair`` (``pair_in_place`` over ``state``, or the replay of
    a graph that captured it) until the run halts or ``max_iters`` pairs
    ran; returns the pairs run, the halting pair included.

    ``pair()`` returns whether the host must read ``state["done"]``
    (halting depends on the device's data); only then is it read, once
    per pair.
    ``counters`` (optional dict) accumulates ``pairs_run``,
    ``host_syncs`` and ``halted``, as ``compute_resumable`` does.
    """
    counters = counters if counters is not None else {}
    for key in ("pairs_run", "host_syncs"):
        counters.setdefault(key, 0)
    pairs, halted = 0, False
    while pairs < max_iters and not halted:
        data_dependent = pair()
        pairs += 1
        if data_dependent:
            counters["host_syncs"] += 1
            halted = bool(state["done"])
    counters["pairs_run"] += pairs
    counters["halted"] = halted
    return pairs
