"""Label Propagation (paper Listing 4): community detection where both
vertices and hyperedges carry a community label; max-combined messages."""
from __future__ import annotations

import torch

from repro_torch.algorithms.spec import AlgorithmSpec, resolve_engine
from repro_torch.core.api import Program, ProcedureOut
from repro_torch.core.hypergraph import HyperGraph


def label_propagation_spec(hg: HyperGraph, iters: int = 30) -> AlgorithmSpec:
    def vertex(step, ids, attr, msg, deg):
        new_label = torch.where(step == 0, ids, torch.maximum(msg, attr))
        return ProcedureOut(attr=new_label, msg=new_label)

    def hyperedge(step, ids, attr, msg, card):
        new_label = torch.maximum(msg, attr)
        return ProcedureOut(attr=new_label, msg=new_label)

    def init(hg: HyperGraph) -> HyperGraph:
        return hg.with_attrs(
            v_attr=torch.zeros(hg.n_vertices, dtype=torch.int32,
                               device=hg.device),
            he_attr=torch.zeros(hg.n_hyperedges, dtype=torch.int32,
                                device=hg.device),
        )

    return AlgorithmSpec(
        hg0=init(hg),
        initial_msg=torch.tensor(0, dtype=torch.int32),
        v_program=Program(procedure=vertex, combiner="max"),
        he_program=Program(procedure=hyperedge, combiner="max"),
        max_iters=iters,
        extract=lambda out: (out.v_attr, out.he_attr),
        name="label_propagation",
        touches_hyperedge_state=True,  # labels persist on hyperedges
        init=init,
    )


def label_propagation(hg, iters=30, *, engine=None):
    """Returns (vertex_labels, hyperedge_labels) as int32."""
    return resolve_engine(engine).run(label_propagation_spec(hg, iters)).value
