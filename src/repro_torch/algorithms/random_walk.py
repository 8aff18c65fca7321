"""Hypergraph random walk with restart (the paper's RW application).

One walk step: vertex -> uniformly-random incident hyperedge ->
uniformly-random member vertex.  Power iteration on that Markov chain
with restart mass ``alpha`` at the seed distribution.

The restart distribution rides in the vertex state (``v_attr = (p,
restart)``), which makes it the per-request axis: ``bind_query`` rebinds
a one-hot restart at a seed vertex (personalized PageRank).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.spec import AlgorithmSpec, resolve_engine
from repro_torch.core.api import Program, ProcedureOut
from repro_torch.core.hypergraph import HyperGraph


def random_walk_spec(
    hg: HyperGraph,
    seeds=None,
    iters: int = 30,
    alpha: float = 0.15,
) -> AlgorithmSpec:
    def vertex(step, ids, attr, msg, deg):
        p, restart = attr
        d = torch.clamp(deg.to(torch.float32), min=1.0)
        dangling = (deg == 0).to(torch.float32)
        # dangling vertices (no incident hyperedge) keep their mass in
        # place instead of leaking it — the walk stays a distribution.
        p_next = torch.where(
            step == 0,
            restart,
            (1.0 - alpha) * (msg + p * dangling) + alpha * restart,
        )
        return ProcedureOut(
            attr=(p_next, restart), msg=p_next / d * (1.0 - dangling)
        )

    def hyperedge(step, ids, attr, msg, card):
        c = torch.clamp(card.to(torch.float32), min=1.0)
        return ProcedureOut(attr=msg, msg=msg / c)

    def init(hg: HyperGraph) -> HyperGraph:
        nv = hg.n_vertices
        if seeds is None:
            restart = torch.full((nv,), 1.0 / max(nv, 1),
                                 dtype=torch.float32, device=hg.device)
        else:
            idx = torch.as_tensor(seeds, device=hg.device).to(torch.int64)
            restart = torch.zeros(nv, dtype=torch.float32, device=hg.device)
            restart[idx] = 1.0 / idx.shape[0]
        return hg.with_attrs(
            v_attr=(restart, restart),
            he_attr=torch.zeros(hg.n_hyperedges, dtype=torch.float32,
                                device=hg.device),
        )

    def bind_query(hg0: HyperGraph, seed) -> HyperGraph:
        """Personalize: all restart mass on one seed vertex."""
        p, _ = hg0.v_attr
        ids = torch.arange(p.shape[0], dtype=torch.int32, device=p.device)
        restart = (ids == int(seed)).to(torch.float32)
        return hg0.with_attrs(v_attr=(restart, restart))

    return AlgorithmSpec(
        hg0=init(hg),
        initial_msg=torch.tensor(0.0),
        v_program=Program(procedure=vertex, combiner="sum"),
        he_program=Program(procedure=hyperedge, combiner="sum"),
        max_iters=iters,
        extract=lambda out: out.v_attr[0],
        name="random_walk",
        touches_hyperedge_state=True,
        init=init,
        bind_query=bind_query,
    )


def random_walk(hg, seeds=None, iters=30, alpha=0.15, *, seed_batch=None,
                engine=None):
    """Returns the stationary visit distribution over vertices.

    ``seed_batch``: optional batch of seed vertices — compiles once and
    serves a personalized walk per seed via ``run_batch`` (the result
    gains a leading batch axis; row b restarts at ``seed_batch[b]``).
    """
    eng = resolve_engine(engine)
    if seed_batch is not None:
        if seeds is not None:
            raise ValueError(
                "pass either seeds (one walk, arbitrary restart set) or "
                "seed_batch (one personalized walk per seed), not both"
            )
        spec = random_walk_spec(hg, None, iters, alpha)
        return eng.compile(spec).run_batch(
            np.asarray(seed_batch, np.int32)
        ).value
    return eng.run(random_walk_spec(hg, seeds, iters, alpha)).value
