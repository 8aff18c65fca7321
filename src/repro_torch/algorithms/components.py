"""Connected components over the hypergraph (min-label flood fill).

Two vertices are connected iff some hyperedge path joins them.
Min-combined label propagation with sparse activation; terminates via
the engine's halting rule well before ``max_iters`` on small-diameter
hypergraphs.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms.spec import AlgorithmSpec, resolve_engine
from repro_torch.core.api import Program, ProcedureOut
from repro_torch.core.hypergraph import HyperGraph


def connected_components_spec(
    hg: HyperGraph, max_iters: int = 128
) -> AlgorithmSpec:
    def vertex(step, ids, attr, msg, deg):
        boot = step == 0
        candidate = torch.where(boot, ids, torch.minimum(attr, msg))
        updated = boot | (candidate < attr)
        return ProcedureOut(attr=candidate, msg=candidate, active=updated)

    def hyperedge(step, ids, attr, msg, card):
        candidate = torch.minimum(attr, msg)
        updated = candidate < attr
        return ProcedureOut(attr=candidate, msg=candidate, active=updated)

    imax = torch.iinfo(torch.int32).max
    nv, ne = hg.n_vertices, hg.n_hyperedges
    hg0 = hg.with_attrs(
        v_attr=torch.full((nv,), imax, dtype=torch.int32, device=hg.device),
        he_attr=torch.full((ne,), imax, dtype=torch.int32, device=hg.device),
    )
    return AlgorithmSpec(
        hg0=hg0,
        initial_msg=torch.tensor(imax, dtype=torch.int32),
        v_program=Program(procedure=vertex, combiner="min"),
        he_program=Program(procedure=hyperedge, combiner="min"),
        max_iters=max_iters,
        extract=lambda out: (out.v_attr, out.he_attr),
        name="connected_components",
        touches_hyperedge_state=True,  # per-hyperedge labels persist
    )


def connected_components(hg, max_iters=128, *, engine=None):
    """Returns (vertex_component, hyperedge_component) int32 labels.
    The component id is the minimum member vertex id."""
    return resolve_engine(engine).run(
        connected_components_spec(hg, max_iters)
    ).value
