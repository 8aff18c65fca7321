"""Parity of the port's batch analytics (``repro_torch.motifs`` and
``Engine.analyze``) with the JAX package, on the CPU.

The same hypergraphs (generated by the JAX package, carried over with
``HyperGraph.from_numpy``) go through both packages:

* ``build_index``: equal arrays for both kinds (the port's int32 bitset
  is the reference's uint32 bits), equal cardinalities;
* ``batch_intersections``: equal sizes for both kinds, pairs and
  triples, with a tile that does not divide the batch;
* ``overlap_pairs_with_counts``, ``build_overlap_graph`` and
  ``connected_triples``: equal arrays;
* ``exact_census``: equal ``Census`` fields for both kernels and with
  the materialized pair sizes;
* ``sampled_census``: bitwise equal ``counts``, ``ci_low`` and
  ``ci_high`` at the same seed (same draws, same float64 arithmetic);
* ``Engine(device="cpu").analyze`` for every task, mode, representation
  and kernel, pinned and ``auto``: equal design point, decision and
  value;
* the configurations the port refuses, ``submit``'s dispatch and the
  launcher's ``--algorithm motifs``.
"""
import dataclasses

import numpy as np
import pytest

from repro import motifs as jm
from repro.core import AnalyticsSpec as JSpec
from repro.core import Engine as JEngine
from repro.data import make_dataset as j_make
from repro.data import powerlaw_hypergraph as j_powerlaw
import repro_torch.algorithms as talg
from repro_torch import motifs as tm
from repro_torch.core import AnalyticsResult, AnalyticsSpec, Engine, HyperGraph
from repro_torch.core.executor import ExecutionConfig
from repro_torch.launch import hypergraph as launcher

CASES = {
    "apache": lambda: j_make("apache", 0.001, seed=0),         # W = 1
    "dblp": lambda: j_make("dblp", 0.0015, seed=0),             # W = 43
    "powerlaw": lambda: j_powerlaw(150, 100, mean_cardinality=4, seed=3),
    "wide": lambda: j_powerlaw(3316, 120, mean_cardinality=5, seed=1),
}


def _carry(jhg):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu")


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jhg = CASES[request.param]()
    return jhg, _carry(jhg)


def _same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f.name
            assert np.array_equal(x, np.asarray(y)), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind", ["bitset", "merge"])
def test_build_index_matches_jax(pair, kind):
    jhg, thg = pair
    want = jm.build_index(jhg, kind)
    got = tm.build_index(thg, kind)
    data = np.asarray(want.data)
    assert got.kind == kind and got.data.dtype.itemsize == 4
    assert np.array_equal(got.data.numpy().view(data.dtype), data)
    assert (got.width, got.nbytes) == (want.width, want.nbytes)
    assert np.array_equal(got.cardinalities(), want.cardinalities())
    assert tm.select_intersect_kernel(thg) == jm.select_intersect_kernel(jhg)


@pytest.mark.parametrize("kind", ["bitset", "merge"])
def test_batch_intersections_match_jax(pair, kind):
    jhg, thg = pair
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, jhg.n_hyperedges, 1000) for _ in range(3))
    jidx = jm.build_index(jhg, kind)
    tidx = tm.build_index(thg, kind)
    for ids in ((a, b), (a, b, c), (a[:0], b[:0])):
        got = tm.batch_intersections(tidx, *ids, tile=384)
        want = jm.batch_intersections(jidx, *ids, tile=256)
        assert got.dtype == np.int32 and np.array_equal(got, want)


def test_overlap_structures_match_jax(pair):
    jhg, thg = pair
    jp, jn = jm.overlap_pairs_with_counts(jhg)
    tp, tn = tm.overlap_pairs_with_counts(thg)
    assert np.array_equal(tp, jp) and np.array_equal(tn, jn)
    assert np.array_equal(tm.overlap_pairs(thg), jp)
    jog = jm.build_overlap_graph(jhg, jp)
    tog = tm.build_overlap_graph(thg, tp)
    for f in ("pairs", "indptr", "nbrs"):
        assert np.array_equal(getattr(tog, f), getattr(jog, f)), f
    assert np.array_equal(tm.connected_triples(tog, thg.n_hyperedges),
                          jm.connected_triples(jog, jhg.n_hyperedges))
    want = jm.materialize_pair_sizes(jhg)
    for got in (tm.materialize_pair_sizes(thg),
                tm.materialize_pair_sizes(thg, tp, tn)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["apache", "powerlaw", "wide"])
@pytest.mark.parametrize("kind", ["bitset", "merge"])
def test_exact_census_matches_jax(case, kind):
    jhg = CASES[case]()
    thg = _carry(jhg)
    want = jm.exact_census(jhg, kernel=kind, tile=512)
    _same_fields(tm.exact_census(thg, kernel=kind, tile=500), want)
    clique = tm.exact_census(thg, kernel=kind,
                             pair_sizes=tm.materialize_pair_sizes(thg))
    _same_fields(clique, want)


@pytest.mark.parametrize("kind", ["bitset", "merge"])
def test_sampled_census_is_bitwise_the_reference(pair, kind):
    jhg, thg = pair
    want = jm.sampled_census(jhg, 150, seed=3, kernel=kind)
    got = tm.sampled_census(thg, 150, seed=3, kernel=kind, tile=700)
    _same_fields(got, want)
    assert got.counts.dtype == np.float64 and got.n_triples_seen > 0
    rows, triples = tm.sample_triples(tm.build_overlap_graph(thg), 150,
                                      thg.n_hyperedges, seed=3)
    assert triples.shape == (len(rows), 3) and rows.max() < 150
    assert len(triples) >= got.n_triples_seen


ENGINE_GRAPH = lambda: j_powerlaw(150, 100, mean_cardinality=4, seed=3)
WORK = [("hmotif_census", "auto"), ("hmotif_census", "exact"),
        ("hmotif_census", "sample"), ("pair_intersections", None),
        ("pair_intersections", "explicit")]


def _spec(cls, hg, task, mode):
    if task == "hmotif_census":
        return cls(hg, mode=mode, n_samples=200, seed=1)
    if mode == "explicit":
        ea = np.array([0, 1, 2, 4, 7, 7, 99])
        eb = np.array([1, 2, 3, 4, 7, 50, 0])
        return cls(hg, task=task, pairs=(ea, eb))
    return cls(hg, task=task)


@pytest.mark.parametrize("representation", ["auto", "bipartite", "clique"])
@pytest.mark.parametrize("kernel", ["auto", "bitset", "merge"])
def test_engine_analyze_matches_jax(representation, kernel):
    jhg = ENGINE_GRAPH()
    thg = _carry(jhg)
    kw = dict(representation=representation, intersect_kernel=kernel)
    jeng, teng = JEngine(**kw), Engine(device="cpu", **kw)
    for task, mode in WORK:
        want = jeng.analyze(_spec(JSpec, jhg, task, mode))
        got = teng.analyze(_spec(AnalyticsSpec, thg, task, mode))
        tag = (task, mode)
        assert isinstance(got, AnalyticsResult)
        assert (got.representation, got.kernel, got.backend, got.mode) == (
            want.representation, want.kernel, want.backend, want.mode), tag
        measured = got.decision["measured"]
        assert {k: v for k, v in got.decision.items()
                if k != "measured"} == dict(want.decision), tag
        assert measured["wall_s"] >= measured["intersect_s"] >= 0.0
        if task == "pair_intersections":
            for x, y in zip(got.value, want.value):
                assert np.array_equal(x, y), tag
        else:
            _same_fields(got.value, want.value)
        assert got.config.representation == want.config.representation
        assert got.config.intersect_kernel == want.config.intersect_kernel
        assert got.config.backend == "local"


def test_engine_resolve_analytics_and_submit_match_jax():
    jhg = j_make("apache", 0.01, seed=0)
    thg = _carry(jhg)
    for over in ({}, {"clique_edge_budget": 1e-6},
                 {"clique_edge_budget": 1e6}):
        jcfg, jmode, jwhy = JEngine().resolve_analytics(
            JSpec(jhg, exact_pair_budget=1000), **over)
        tcfg, tmode, twhy = Engine(device="cpu").resolve_analytics(
            AnalyticsSpec(thg, exact_pair_budget=1000), **over)
        assert (tcfg.representation, tcfg.intersect_kernel, tmode) == (
            jcfg.representation, jcfg.intersect_kernel, jmode)
        assert twhy == jwhy
    spec = AnalyticsSpec(_carry(ENGINE_GRAPH()), mode="sample",
                         n_samples=50)
    res = Engine(device="cpu").submit(spec, intersect_kernel="merge")
    assert isinstance(res, AnalyticsResult) and res.kernel == "merge"
    assert res.mode == "sample" and res.value.n_samples == 50


def test_invalid_configs_rejected():
    hg = _carry(j_powerlaw(20, 10, seed=0))
    with pytest.raises(ValueError, match="task"):
        AnalyticsSpec(hg, task="clustering")
    with pytest.raises(ValueError, match="mode"):
        AnalyticsSpec(hg, mode="guess")
    with pytest.raises(ValueError, match="intersect_kernel"):
        ExecutionConfig(intersect_kernel="gpu_hash")
    # the distributed backends are ported: analytics refuses
    # "replicated", and "sharded" without a mesh, with the reference's
    # messages; a mesh must name the axis the pair blocks tile over
    jhg = j_powerlaw(20, 10, seed=0)
    for backend, match in (("replicated", "does not apply"),
                           ("sharded", "needs a mesh")):
        msgs = []
        for run in (lambda: JEngine(backend=backend).analyze(JSpec(jhg)),
                    lambda: Engine(device="cpu", backend=backend).analyze(
                        AnalyticsSpec(hg))):
            with pytest.raises(ValueError, match=match) as err:
                run()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="no axis 'data'"):
        tm.batch_intersections(tm.build_index(hg, "bitset"), [0], [1],
                               mesh=object())
    with pytest.raises(ValueError, match="unknown intersection kernel"):
        tm.build_index(hg, "gpu_hash")
    for bad in ([0, 10], [-1, 0]):
        with pytest.raises(ValueError, match="must lie in"):
            Engine(device="cpu").analyze(AnalyticsSpec(
                hg, task="pair_intersections", pairs=(bad, [0, 1])),
                representation="bipartite")
    with pytest.raises(ValueError, match="exact"):
        Engine(device="cpu").analyze(AnalyticsSpec(
            dataclasses.replace(hg, n_hyperedges=1 << 21), mode="exact"))
    with pytest.raises(ValueError, match="spec lives on"):
        Engine(device="meta").analyze(AnalyticsSpec(hg))


def test_run_with_clique_still_raises():
    """``clique`` is the dual's pair-size table to ``analyze``; for an
    iterative spec that touches hyperedge state it is refused, given or
    configured, with the reference's error."""
    hg = _carry(j_powerlaw(60, 40, mean_cardinality=4, seed=1))
    spec = talg.pagerank_spec(hg, iters=2)
    assert ExecutionConfig(representation="clique").representation == (
        "clique")
    with pytest.raises(ValueError, match="hyperedge state"):
        Engine(device="cpu", representation="clique").run(spec)
    with pytest.raises(ValueError, match="hyperedge state"):
        Engine(device="cpu").resolve(spec, representation="clique")
    res = Engine(device="cpu", representation="clique").analyze(
        AnalyticsSpec(hg, mode="exact"))
    assert res.representation == "clique" and res.value.n_triples > 0


def test_launcher_runs_motifs_on_cpu(capsys):
    rc = launcher.main(["--algorithm", "motifs", "--regime", "apache",
                        "--scale", "0.003", "--device", "cpu",
                        "--samples", "100", "--kernel", "bitset"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "kernel=bitset" in out and "measured: wall=" in out
    assert "h-motif" in out
    rc = launcher.main(["--algorithm", "motifs", "--regime", "apache",
                        "--scale", "0.001", "--device", "cpu", "--mode",
                        "exact", "--representation", "clique"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "representation=clique" in out and "mode=exact" in out
