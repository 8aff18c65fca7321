"""Hypergraph PageRank and PageRank-Entropy (paper Listings 2 & 3).

Messages:
  v -> he : rank_v / totalWeight_v                       (sum combiner)
  he -> v : (weight_e, rank_e / cardinality_e)           (sum combiner)

``totalWeight_v`` is the sum of incident hyperedge weights — delivered
as the first component of the he->v message, exactly as in Listing 2.
Aux lookups inside procedures go through ``ids`` so the same procedure
runs on any id range.

``vertex_pagerank_spec`` (the clique-eligible variant) waits for the
clique representation (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import math

import torch

from repro_torch.algorithms.spec import AlgorithmSpec, resolve_engine
from repro_torch.core.api import Program, ProcedureOut
from repro_torch.core.hypergraph import HyperGraph


def _weights(hg: HyperGraph, he_weight) -> torch.Tensor:
    if he_weight is None:
        return torch.ones(hg.n_hyperedges, dtype=torch.float32,
                          device=hg.device)
    return torch.as_tensor(he_weight, device=hg.device).to(torch.float32)


def _one() -> tuple:
    return (torch.tensor(1.0), torch.tensor(1.0))


def pagerank_spec(
    hg: HyperGraph,
    iters: int = 30,
    alpha: float = 0.15,
    he_weight: torch.Tensor | None = None,
) -> AlgorithmSpec:
    ne = hg.n_hyperedges
    weight_full = _weights(hg, he_weight)

    def vertex(step, ids, attr, msg, deg):
        total_weight, rank = msg
        new_rank = alpha + (1.0 - alpha) * rank
        tw = torch.clamp(total_weight, min=1e-12)
        return ProcedureOut(attr=new_rank, msg=new_rank / tw)

    def hyperedge(step, ids, attr, msg, cards):
        w = weight_full.index_select(0, torch.clamp(ids, max=ne - 1))
        card = torch.clamp(cards.to(torch.float32), min=1.0)
        new_rank = msg * w
        return ProcedureOut(attr=new_rank, msg=(w, new_rank / card))

    def init(hg: HyperGraph) -> HyperGraph:
        return hg.with_attrs(
            v_attr=torch.ones(hg.n_vertices, dtype=torch.float32,
                              device=hg.device),
            he_attr=torch.ones(hg.n_hyperedges, dtype=torch.float32,
                               device=hg.device),
        )

    return AlgorithmSpec(
        hg0=init(hg),
        initial_msg=_one(),
        v_program=Program(procedure=vertex, combiner="sum"),
        he_program=Program(procedure=hyperedge, combiner="sum"),
        max_iters=iters,
        extract=lambda out: (out.v_attr, out.he_attr),
        name="pagerank",
        touches_hyperedge_state=True,  # extracts hyperedge ranks
        init=init,
    )


def pagerank(hg, iters=30, alpha=0.15, he_weight=None, *, engine=None):
    """Returns (vertex_ranks, hyperedge_ranks)."""
    return resolve_engine(engine).run(
        pagerank_spec(hg, iters, alpha, he_weight)
    ).value


def pagerank_entropy_spec(
    hg: HyperGraph,
    iters: int = 30,
    alpha: float = 0.15,
    he_weight: torch.Tensor | None = None,
) -> AlgorithmSpec:
    """PageRank + per-hyperedge entropy of member rank shares (Listing 3),
    sum-decomposed: with S = sum_v r_v and Q = sum_v r_v*log2(r_v) over
    members, H = log2(S) - Q/S — three sum-monoid message components
    (``pagerank_entropy_seq`` is the literal Seq-typed form)."""
    nv, ne = hg.n_vertices, hg.n_hyperedges
    weight_full = _weights(hg, he_weight)

    def vertex(step, ids, attr, msg, deg):
        total_weight, rank = msg
        new_rank = alpha + (1.0 - alpha) * rank
        tw = torch.clamp(total_weight, min=1e-12)
        r = torch.clamp(new_rank, min=1e-12)
        return ProcedureOut(
            attr=new_rank,
            msg=(new_rank / tw, r, r * torch.log2(r)),
        )

    def hyperedge(step, ids, attr, msg, cards):
        share_sum, s, q = msg
        w = weight_full.index_select(0, torch.clamp(ids, max=ne - 1))
        s = torch.clamp(s, min=1e-12)
        ent = torch.log2(s) - q / s
        new_rank = share_sum * w
        card = torch.clamp(cards.to(torch.float32), min=1.0)
        return ProcedureOut(
            attr=(new_rank, w, ent),
            msg=(w, new_rank / card),
        )

    dev = hg.device
    hg0 = hg.with_attrs(
        v_attr=torch.ones(nv, dtype=torch.float32, device=dev),
        he_attr=(
            torch.ones(ne, dtype=torch.float32, device=dev),
            weight_full,
            torch.zeros(ne, dtype=torch.float32, device=dev),
        ),
    )
    return AlgorithmSpec(
        hg0=hg0,
        initial_msg=_one(),
        v_program=Program(procedure=vertex, combiner="sum"),
        he_program=Program(procedure=hyperedge, combiner="sum"),
        max_iters=iters,
        extract=lambda out: (out.v_attr, out.he_attr[0], out.he_attr[2]),
        name="pagerank_entropy",
        touches_hyperedge_state=True,
    )


def pagerank_entropy(hg, iters=30, alpha=0.15, he_weight=None, *,
                     engine=None):
    """Returns (vertex_ranks, hyperedge_ranks, hyperedge_entropy)."""
    return resolve_engine(engine).run(
        pagerank_entropy_spec(hg, iters, alpha, he_weight)
    ).value


def pagerank_entropy_seq(
    hg: HyperGraph,
    iters: int = 30,
    alpha: float = 0.15,
    he_weight: torch.Tensor | None = None,
    *,
    engine=None,
):
    """Seq-combiner formulation — the literal port of Listing 3 where the
    hyperedge sees the member rank multiset, via a custom ``reducer``.
    The reducer keeps it on the reference delivery path; oracle for the
    decomposed form above.  Runs on ``engine`` (default: a local Engine
    on the hypergraph's device)."""
    from repro_torch.core.executor import Engine
    from repro_torch.sparse.segment import segment_reduce

    nv, ne = hg.n_vertices, hg.n_hyperedges
    dev = hg.device
    card = torch.clamp(hg.cardinalities().to(torch.float32), min=1.0)
    weight = _weights(hg, he_weight)

    def vertex(step, ids, attr, msg, deg):
        total_weight, rank = msg
        new_rank = alpha + (1.0 - alpha) * rank
        tw = torch.clamp(total_weight, min=1e-12)
        # broadcast (rank -> totalWeight) pairs, Listing 3.
        return ProcedureOut(attr=new_rank, msg=(new_rank, tw))

    def entropy_reducer(rows, dst_ids, num_dst, live):
        rank, tw = rows
        if live is not None:
            rank = torch.where(live, rank, torch.zeros_like(rank))
        share_sum = segment_reduce(rank / tw, dst_ids, num_dst)
        total = torch.clamp(segment_reduce(rank, dst_ids, num_dst),
                            min=1e-12)
        p = torch.clamp(rank / total.index_select(0, dst_ids), min=1e-12)
        ent = segment_reduce(-p * torch.log(p), dst_ids, num_dst)
        return (share_sum, ent / math.log(2.0))

    def hyperedge(step, ids, attr, msg, cards):
        share_sum, ent = msg
        new_rank = share_sum * weight
        return ProcedureOut(
            attr=(new_rank, weight, ent),
            msg=(weight, new_rank / card),
        )

    hg0 = hg.with_attrs(
        v_attr=torch.ones(nv, dtype=torch.float32, device=dev),
        he_attr=(
            torch.ones(ne, dtype=torch.float32, device=dev),
            weight,
            torch.zeros(ne, dtype=torch.float32, device=dev),
        ),
    )
    spec = AlgorithmSpec(
        hg0=hg0,
        initial_msg=_one(),
        v_program=Program(
            procedure=vertex, combiner="sum", reducer=entropy_reducer
        ),
        he_program=Program(procedure=hyperedge, combiner="sum"),
        max_iters=iters,
        extract=lambda out: (out.v_attr, out.he_attr[0], out.he_attr[2]),
        name="pagerank_entropy[seq]",
        touches_hyperedge_state=True,
    )
    # Seq reducers have no distributed decomposition: pin the backend.
    eng = engine if engine is not None else Engine(device=dev,
                                                  backend="local")
    return eng.run(spec).value
