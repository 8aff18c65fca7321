"""Parity of the port's clique representation with the JAX package's, on
the CPU.

The same hypergraphs (the paper's Fig. 1, and the generator's DBLP and
power-law regimes, carried over as numpy arrays) go through
``repro.core.clique`` / ``repro.algorithms`` / ``repro.core.Engine`` and
their ``repro_torch`` counterparts:

* ``to_graph``: ``src``, ``dst`` and ``e_attr`` bitwise (same dtype, same
  order), ``v_attr`` the hypergraph's; ``clique_expansion_size`` equal,
  also on one hyperedge of 20,001 members, past the approximate branch's
  budget;
* ``graph_pagerank`` within 1e-5 relative (the port sums in destination
  order, the reference in edge order: reassociation only);
* ``select_representation``: winner and ``why`` equal;
* ``Engine.run(vertex_pagerank_spec)`` under ``auto``, ``clique`` and
  ``bipartite`` within 1e-5 of the reference, on the same design point;
* the illegal clique requests raise the reference's error types and
  messages (hyperedge state, no clique program, ``max_iters``,
  ``compile``); ``auto`` with a ``max_iters`` override pins bipartite.
"""
import numpy as np
import pytest
import torch

import repro.algorithms as jalg
from repro.algorithms.graph_pagerank import graph_pagerank as j_graph_pagerank
from repro.core import Engine as JEngine
from repro.core import HyperGraph as JHyperGraph
from repro.core.clique import _unique_pairs as j_unique_pairs
from repro.core.clique import clique_expansion_size as j_clique_size
from repro.core.clique import to_graph as j_to_graph
from repro.core.executor import select_representation as j_select_rep
from repro.data import make_dataset as j_make_dataset
from repro.data import powerlaw_hypergraph as j_powerlaw
import repro_torch.algorithms as talg
from repro_torch.algorithms import graph_pagerank
from repro_torch.core import (
    Engine,
    HyperGraph,
    clique_expansion_size,
    select_representation,
    to_graph,
)
from repro_torch.core.clique import APPROX_PAIR_BUDGET, _unique_pairs

FIG1 = [[0, 1], [0, 1, 2, 3], [0, 3, 4], [2, 3]]
RTOL = 1e-5  # float32 sums in another order


def _carry(jhg):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu")


def _hypergraphs():
    return {
        "fig1": JHyperGraph.from_hyperedge_lists(FIG1, n_vertices=5),
        "dblp": j_make_dataset("dblp", 0.002, seed=0),
        "powerlaw": j_powerlaw(200, 40, mean_cardinality=8,
                               max_cardinality=150, seed=2),
    }


@pytest.fixture(scope="module")
def hgs():
    return _hypergraphs()


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(
        got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("name", ["fig1", "dblp", "powerlaw"])
def test_to_graph_bitwise(hgs, name):
    jhg = hgs[name]
    thg = _carry(jhg)
    want = j_to_graph(jhg)
    got = to_graph(thg)
    assert got.n_vertices == want.n_vertices
    for field in ("src", "dst", "e_attr"):
        assert _same_bits(getattr(got, field), getattr(want, field)), field
    assert got.v_attr is thg.v_attr
    assert np.array_equal(_unique_pairs(thg), j_unique_pairs(jhg))


def test_to_graph_edge_attr_fn_and_empty():
    jhg = JHyperGraph.from_hyperedge_lists(FIG1, n_vertices=5)
    fn = lambda counts: (counts * 2 + 1).astype(np.float32)
    got = to_graph(_carry(jhg), edge_attr_fn=fn)
    assert _same_bits(got.e_attr, j_to_graph(jhg, edge_attr_fn=fn).e_attr)
    # singleton hyperedges only: no pair, empty typed edge lists
    jone = JHyperGraph.from_hyperedge_lists([[0], [1], [2]], n_vertices=3)
    got, want = to_graph(_carry(jone)), j_to_graph(jone)
    for field in ("src", "dst", "e_attr"):
        assert _same_bits(getattr(got, field), getattr(want, field)), field
    assert clique_expansion_size(_carry(jone)) == j_clique_size(jone) == 0


@pytest.mark.parametrize("name", ["fig1", "dblp", "powerlaw"])
def test_clique_expansion_size_equal(hgs, name):
    jhg = hgs[name]
    assert clique_expansion_size(_carry(jhg)) == j_clique_size(jhg)


def test_clique_expansion_size_approximate_branch():
    """One hyperedge of 20,001 members: 200,010,000 pairs, past the
    budget, so both report the upper bound without building a pair."""
    k = 20_001
    assert k * (k - 1) // 2 > APPROX_PAIR_BUDGET
    src = np.arange(k, dtype=np.int32)
    dst = np.zeros(k, np.int32)
    jhg = JHyperGraph.from_coo(src, dst, k, 1)
    thg = HyperGraph.from_numpy(src, dst, k, 1, device="cpu")
    assert clique_expansion_size(thg) == j_clique_size(jhg) == k * (k - 1) // 2


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got.numpy() - want) / np.abs(want)))


@pytest.mark.parametrize("name", ["fig1", "dblp", "powerlaw"])
@pytest.mark.parametrize("iters", [1, 8, 30])
def test_graph_pagerank_matches_jax(hgs, name, iters):
    jhg = hgs[name]
    got = graph_pagerank(to_graph(_carry(jhg)), iters=iters)
    want = j_graph_pagerank(j_to_graph(jhg), iters=iters)
    assert got.dtype == torch.float32 and got.shape == (jhg.n_vertices,)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("name", ["fig1", "dblp", "powerlaw"])
@pytest.mark.parametrize("budget", [1.0, 4.0, 1e9])
@pytest.mark.parametrize("spec", ["vertex_pagerank", "pagerank",
                                  "no_program"])
def test_select_representation_matches_jax(hgs, name, budget, spec):
    jhg = hgs[name]
    thg = _carry(jhg)
    make = {
        "vertex_pagerank": lambda m, h: m.vertex_pagerank_spec(h, iters=4),
        "pagerank": lambda m, h: m.pagerank_spec(h, iters=4),
        "no_program": lambda m, h: m.vertex_pagerank_spec(
            h, iters=4)._replace(clique_program=None),
    }[spec]
    got = select_representation(make(talg, thg), thg, edge_budget=budget)
    want = j_select_rep(make(jalg, jhg), jhg, edge_budget=budget)
    assert got == want


@pytest.mark.parametrize("name", ["fig1", "dblp", "powerlaw"])
@pytest.mark.parametrize("representation", ["auto", "clique", "bipartite"])
def test_engine_run_vertex_pagerank_matches_jax(hgs, name, representation):
    jhg = hgs[name]
    thg = _carry(jhg)
    got = Engine(device="cpu", representation=representation).run(
        talg.vertex_pagerank_spec(thg, iters=8))
    want = JEngine(representation=representation).run(
        jalg.vertex_pagerank_spec(jhg, iters=8))
    assert got.representation == want.representation
    assert got.config.representation == want.config.representation
    assert got.config.delivery == want.config.delivery
    assert got.decision["representation"] == want.decision["representation"]
    assert got.decision["backend"] == want.decision["backend"]
    if got.representation == "clique":
        assert got.decision["delivery"] == want.decision["delivery"]
        assert set(got.decision["measured"]) == {
            "wall_s", "dispatch_s", "device_wait_s"}
    assert _rel(got.value, want.value) <= RTOL


def test_auto_picks_clique_on_fig1_and_bipartite_on_dblp(hgs):
    """Fig. 1's 16 directed edges are within 4 x its 11 incidences; the
    DBLP regime's expansion is past the budget."""
    eng = Engine(device="cpu")
    fig1 = _carry(hgs["fig1"])
    rep, why = select_representation(talg.vertex_pagerank_spec(fig1), fig1)
    assert (rep, why["clique_edges"], why["bipartite_edges"]) == (
        "clique", 16, 11)
    res = eng.run(talg.vertex_pagerank_spec(fig1, iters=8))
    assert res.representation == "clique"
    assert _rel(res.value, j_graph_pagerank(
        j_to_graph(hgs["fig1"]), iters=8)) <= RTOL
    dblp = talg.vertex_pagerank_spec(_carry(hgs["dblp"]))
    assert eng.resolve(dblp)[0].representation == "bipartite"
    assert eng.resolve(dblp)[2]["representation"]["reason"] == (
        "expansion exceeds edge budget")


def _raises_like_jax(run_port, run_jax):
    with pytest.raises(Exception) as want:
        run_jax()
    with pytest.raises(type(want.value)) as got:
        run_port()
    assert str(got.value) == str(want.value)


def test_illegal_clique_requests_raise_like_jax(hgs):
    jhg = hgs["fig1"]
    thg = _carry(jhg)
    # hyperedge state
    _raises_like_jax(
        lambda: Engine(device="cpu", representation="clique").run(
            talg.pagerank_spec(thg, iters=4)),
        lambda: JEngine(representation="clique").run(
            jalg.pagerank_spec(jhg, iters=4)))
    # no clique program
    _raises_like_jax(
        lambda: Engine(device="cpu", representation="clique").run(
            talg.vertex_pagerank_spec(thg)._replace(clique_program=None)),
        lambda: JEngine(representation="clique").run(
            jalg.vertex_pagerank_spec(jhg)._replace(clique_program=None)))
    # max_iters cannot override a clique program
    _raises_like_jax(
        lambda: Engine(device="cpu", representation="clique").run(
            talg.vertex_pagerank_spec(thg, iters=6), max_iters=3),
        lambda: JEngine(representation="clique").run(
            jalg.vertex_pagerank_spec(jhg, iters=6), max_iters=3))
    # compile serves the bipartite representation only
    _raises_like_jax(
        lambda: Engine(device="cpu", representation="clique").compile(
            talg.vertex_pagerank_spec(thg)),
        lambda: JEngine(representation="clique").compile(
            jalg.vertex_pagerank_spec(jhg)))


def test_auto_with_max_iters_or_compile_pins_bipartite(hgs):
    """``auto`` would pick clique on Fig. 1: a ``max_iters`` override
    pins bipartite (with the reference's reason), and ``compile``
    compiles the bipartite representation, as the reference does."""
    jhg = hgs["fig1"]
    thg = _carry(jhg)
    got = Engine(device="cpu").run(talg.vertex_pagerank_spec(thg, iters=6),
                                   max_iters=3)
    want = JEngine().run(jalg.vertex_pagerank_spec(jhg, iters=6),
                         max_iters=3)
    assert got.representation == want.representation == "bipartite"
    assert got.config.max_iters == 3
    assert got.decision["representation"] == want.decision["representation"]
    assert _rel(got.value, want.value) <= RTOL
    compiled = Engine(device="cpu").compile(talg.vertex_pagerank_spec(thg))
    j_compiled = JEngine().compile(jalg.vertex_pagerank_spec(jhg))
    assert compiled.config.representation == (
        j_compiled.config.representation) == "bipartite"
    assert _rel(compiled.run().value, j_compiled.run().value) <= RTOL
