"""The MESH superstep engine (single-device executor), in PyTorch.

``compute`` is the paper's ``HyperGraph.compute``: alternating vertex /
hyperedge supersteps, message delivery along the bipartite incidence
with combiner-merged messages, and dynamic termination when every
entity goes inactive (SSSP).

The JAX package halts with ``lax.cond`` inside a static ``lax.scan``;
here the scan is a Python loop with the same semantics: at most
``max_iters`` pairs, stop once ``v_active + he_active == 0``, every later
stats row is 0, and the final state is the halted state.  Deciding to
stop reads the activity counts on the host: one host sync per pair,
skipped when both procedures return ``active=None`` (the counts are the
entity counts, known without the device).
"""
from __future__ import annotations

from typing import Any, NamedTuple

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
        live = active.index_select(0, src_ids)
    if e_mask is not None:
        em = e_mask.to(torch.bool)
        live = em if live is None else (live & em)

    if program.reducer is not None:
        return program.reducer(rows, dst_ids, num_dst, live)

    def combine_leaf(leaf: torch.Tensor) -> torch.Tensor:
        monoid = program.monoid_for(leaf)
        if live is not None:
            ident = torch.full((), monoid.identity(leaf.dtype),
                               dtype=leaf.dtype, device=leaf.device)
            shape = (live.shape[0],) + (1,) * (leaf.dim() - 1)
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


class SuperstepStats(NamedTuple):
    """Per-iteration activity counters: an ``int`` when known on the
    host (no ``active`` vector), else a 0-d int32 tensor."""

    v_active: Any
    he_active: Any


def superstep_pair(
    hg: HyperGraph,
    step: int,
    v_attr: Pytree,
    he_attr: Pytree,
    msg_to_v: Pytree,
    v_program: Program,
    he_program: Program,
    v_deg: torch.Tensor,
    he_card: torch.Tensor,
    n_real: tuple | None = None,
    delivery: tuple | None = None,
):
    """One (vertex, hyperedge) pair of supersteps.

    ``n_real``: optional ``(nv_real, ne_real)``; activity counts mask to
    the first ``n_real`` slots so bucket padding never leaks into the
    stats or the halting decision.

    ``delivery``: optional ``(fwd_layout, bwd_layout)`` routing both
    half-supersteps through the fused delivery kernel.
    """
    fwd_layout, bwd_layout = delivery if delivery is not None else (None, None)
    dev = hg.device
    v_ids = torch.arange(hg.n_vertices, dtype=torch.int32, device=dev)
    he_ids = torch.arange(hg.n_hyperedges, dtype=torch.int32, device=dev)

    v_out = _as_out(v_program.procedure(step, v_ids, v_attr, msg_to_v, v_deg))
    msg_to_he = deliver(
        v_out.msg, v_out.active, hg.src, hg.dst, hg.n_hyperedges,
        v_program, hg.e_attr, hg.e_mask, layout=fwd_layout,
    )
    he_out = _as_out(
        he_program.procedure(step + 1, he_ids, he_attr, msg_to_he, he_card)
    )
    msg_to_v_next = deliver(
        he_out.msg, he_out.active, hg.dst, hg.src, hg.n_vertices,
        he_program, hg.e_attr, hg.e_mask, layout=bwd_layout,
    )

    def count(active, n, real):
        if real is None:
            if active is None:
                return int(n)
            return active.sum(dtype=torch.int32)
        live = torch.arange(n, dtype=torch.int32, device=dev) < real
        if active is not None:
            live = live & active
        return live.sum(dtype=torch.int32)

    nv_real, ne_real = n_real if n_real is not None else (None, None)
    stats = SuperstepStats(
        v_active=count(v_out.active, hg.n_vertices, nv_real),
        he_active=count(he_out.active, hg.n_hyperedges, ne_real),
    )
    return v_out.attr, he_out.attr, msg_to_v_next, stats


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

    A halted state runs nothing: its rows of the trace stay 0 and the
    state is carried unchanged (``step`` still advances by 2 per pair,
    as the scan in the JAX package does).  ``counters`` (optional dict)
    accumulates ``pairs_run`` (pairs executed, the halting pair
    included), ``host_syncs`` (activity reads on the host) and
    ``halted``.
    """
    dev = hg.device
    v_deg = hg.degrees()
    he_card = hg.cardinalities()
    v_trace = torch.zeros(n_iters, dtype=torch.int32, device=dev)
    he_trace = torch.zeros(n_iters, dtype=torch.int32, device=dev)
    step, v_attr, he_attr, msg, halted = (
        state["step"], state["v_attr"], state["he_attr"], state["msg"],
        state["halted"],
    )
    counters = counters if counters is not None else {}
    for key in ("pairs_run", "host_syncs"):
        counters.setdefault(key, 0)
    for i in range(n_iters):
        if halted:
            break
        v_attr, he_attr, msg, stats = superstep_pair(
            hg, step + 2 * i, v_attr, he_attr, msg,
            v_program, he_program, v_deg, he_card, n_real, delivery,
        )
        v_trace[i] = stats.v_active
        he_trace[i] = stats.he_active
        counters["pairs_run"] += 1
        total = stats.v_active + stats.he_active
        if isinstance(total, torch.Tensor):
            counters["host_syncs"] += 1
            total = int(total)
        halted = total == 0
    counters["halted"] = bool(halted)
    out = {
        "step": step + 2 * n_iters, "v_attr": v_attr, "he_attr": he_attr,
        "msg": msg, "halted": bool(halted),
    }
    return out, (v_trace, he_trace)


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
