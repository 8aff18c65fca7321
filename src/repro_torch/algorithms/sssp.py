"""Single-Source Shortest Paths (paper Listing 5).

Distance unit = number of hyperedges traversed (vertex->he hop costs 1).
Only updated entities broadcast (sparse activation); the engine halts
when every entity is inactive — the paper's termination condition.

The *source* is the per-request axis: ``bind_query`` seeds distance 0 at
the query vertex on an all-infinite initial state, and the step-0
bootstrap activates every finite-distance vertex.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.spec import AlgorithmSpec, resolve_engine
from repro_torch.core.api import Program, ProcedureOut
from repro_torch.core.hypergraph import HyperGraph

INF = float("inf")


def shortest_paths_spec(
    hg: HyperGraph, source: int, max_iters: int = 64
) -> AlgorithmSpec:
    def vertex(step, ids, attr, msg, deg):
        new_hop = msg
        updated = attr > new_hop
        attr2 = torch.where(updated, new_hop, attr)
        # Superstep 0: every vertex with a finite seeded distance (the
        # bound source) activates and broadcasts.
        boot = (step == 0) & torch.isfinite(attr2)
        return ProcedureOut(attr=attr2, msg=attr2 + 1.0, active=updated | boot)

    def hyperedge(step, ids, attr, msg, card):
        new_hop = msg
        updated = attr > new_hop
        attr2 = torch.where(updated, new_hop, attr)
        return ProcedureOut(attr=attr2, msg=attr2, active=updated)

    def init(hg: HyperGraph) -> HyperGraph:
        return hg.with_attrs(
            v_attr=torch.full((hg.n_vertices,), INF, device=hg.device),
            he_attr=torch.full((hg.n_hyperedges,), INF, device=hg.device),
        )

    def bind_query(hg0: HyperGraph, source) -> HyperGraph:
        v_attr = hg0.v_attr.clone()
        v_attr[int(source)] = 0.0
        return hg0.with_attrs(v_attr=v_attr)

    return AlgorithmSpec(
        hg0=bind_query(init(hg), source),
        initial_msg=torch.tensor(INF, dtype=torch.float32),
        v_program=Program(procedure=vertex, combiner="min"),
        he_program=Program(procedure=hyperedge, combiner="min"),
        max_iters=max_iters,
        extract=lambda out: (out.v_attr, out.he_attr),
        name="sssp",
        touches_hyperedge_state=True,  # per-hyperedge distances persist
        init=init,
        bind_query=bind_query,
        query0=int(source),
    )


def shortest_paths(hg, source=0, max_iters=64, *, sources=None,
                   engine=None):
    """Returns (vertex_hops, hyperedge_hops); unreachable = +inf.

    ``sources``: optional batch of source vertices — compiles the
    algorithm once and serves every source through
    ``CompiledAlgorithm.run_batch`` (results gain a leading batch axis).
    """
    eng = resolve_engine(engine)
    if sources is not None:
        if source != 0:
            raise ValueError(
                "pass either source (single query) or sources (batched "
                "serve), not both"
            )
        spec = shortest_paths_spec(hg, 0, max_iters)
        return eng.compile(spec).run_batch(
            np.asarray(sources, np.int32)
        ).value
    return eng.run(shortest_paths_spec(hg, source, max_iters)).value
