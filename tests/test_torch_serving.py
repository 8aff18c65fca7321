"""Compile-once serving in the port, held against the JAX package.

The same hypergraphs (``repro.data.powerlaw_hypergraph`` from one
numpy seed, carried over with ``HyperGraph.from_numpy``) go through
``repro.core.Engine.compile`` and the port's, on the CPU:

* ``bucket_dim`` equals the reference's;
* ``compile().run()`` equals the reference's ``compile().run()`` —
  bitwise for SSSP, label propagation and components, within 1e-5 for
  PageRank and the random walk — with equal activity stats, on both
  delivery paths;
* ``run_batch`` of 8 SSSP sources equals the reference's bitwise, with
  equal stats and ``supersteps_executed`` (batch-aware halting: the
  slowest query's pairs, not ``max_iters``);
* personalized random walks from ``run_batch`` equal sequential runs
  within 1e-5 (the reference's own bitwise version of this test is
  red: float sums reassociate);
* the executable cache's semantics (``tests/test_compile.py``): no new
  trace for a same-bucket hypergraph, a second compile or a new query;
  dtype, design point and ``initial_msg`` changes miss; the LRU is
  bounded; clique and analytics specs are refused; ``run_batch``
  without ``bind_query`` raises; a batch of 5 shares the bucket of 8;
* the degrade twin, ``warmup``, the wrappers' ``sources=`` /
  ``seed_batch=`` and the launcher's ``--sources --cache-stats``.

The CUDA-graph replay itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.algorithms as jalg
from repro.core import Engine as JEngine
from repro.core import bucket_dim as j_bucket_dim
from repro.data import powerlaw_hypergraph as j_powerlaw
import repro_torch.algorithms as talg
from repro_torch.core import AnalyticsSpec, Engine, HyperGraph, bucket_dim
from repro_torch.core.api import constant_initial_msg, tree_leaves
from repro_torch.core.engine import (
    compute,
    entity_ids,
    halting_loop,
    pair_in_place,
    pair_state,
)
from repro_torch.core.serving import BATCH_FLOOR, BUCKET_FLOOR
from repro_torch.launch import hypergraph as launcher


def _carry(jhg, **attrs):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu", **attrs)


def _small(seed=0, nv=47, ne=33):
    return j_powerlaw(nv, ne, mean_cardinality=4, seed=seed)


def _same_bucket_pair():
    """Two structurally different hypergraphs in one shape bucket."""
    jhg = _small()
    want = (bucket_dim(47), bucket_dim(33), bucket_dim(jhg.nnz))
    for seed in range(1, 60):
        jhg2 = j_powerlaw(52, 36, mean_cardinality=4, seed=seed)
        if (bucket_dim(52), bucket_dim(36), bucket_dim(jhg2.nnz)) == want:
            return _carry(jhg), _carry(jhg2)
    raise AssertionError("no same-bucket draw found")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, want, bitwise):
    """Leaf by leaf (either package's values, or lists of leaves)."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if bitwise:
            assert np.array_equal(a, b, equal_nan=True)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# (name, spec factory over either package, bitwise)
SPECS = [
    ("sssp", lambda m, h: m.shortest_paths_spec(h, 0, 12), True),
    ("label_propagation", lambda m, h: m.label_propagation_spec(h, 6), True),
    ("connected_components",
     lambda m, h: m.connected_components_spec(h, 16), True),
    ("pagerank", lambda m, h: m.pagerank_spec(h, iters=6), False),
    ("random_walk", lambda m, h: m.random_walk_spec(h, iters=8), False),
]


def test_bucket_dim_matches_jax():
    assert BUCKET_FLOOR == 64 and BATCH_FLOOR == 8
    for n in range(0, 5001):
        assert bucket_dim(n) == j_bucket_dim(n)
        assert (bucket_dim(n, floor=BATCH_FLOOR)
                == j_bucket_dim(n, floor=BATCH_FLOOR))


@pytest.mark.parametrize("delivery", ["xla", "pallas_fused"])
@pytest.mark.parametrize("name,make,bitwise", SPECS,
                         ids=[s[0] for s in SPECS])
def test_compiled_run_matches_jax(name, make, bitwise, delivery):
    jhg = _small()
    want = JEngine(collect_stats=True).compile(
        make(jalg, jhg), delivery=delivery).run()
    eng = Engine(device="cpu", collect_stats=True)
    spec = make(talg, _carry(jhg))
    got = eng.compile(spec, delivery=delivery).run()
    assert got.config.delivery == delivery
    _check(got.value, want.value, bitwise)
    for a, b in zip(got.superstep_stats, want.superstep_stats):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    # ... and equals the port's one-shot run on the unpadded structure
    ref = eng.run(spec, delivery=delivery)
    _check(got.value, ref.value, bitwise)
    assert got.supersteps_executed is None
    m = got.decision["measured"]
    assert m["pairs_run"] == ref.decision["measured"]["pairs_run"]
    assert m["host_syncs"] == ref.decision["measured"]["host_syncs"]
    assert not m["graph"]


def test_compiled_stats_mask_bucket_padding():
    jhg = _small()
    assert bucket_dim(jhg.n_vertices) > jhg.n_vertices  # padding exists
    got = Engine(device="cpu", collect_stats=True).compile(
        talg.pagerank_spec(_carry(jhg), iters=4)).run()
    assert got.superstep_stats[0].tolist() == [jhg.n_vertices] * 4
    assert got.superstep_stats[1].tolist() == [jhg.n_hyperedges] * 4


@pytest.mark.parametrize("delivery", ["xla", "pallas_fused"])
def test_run_batch_sssp_matches_jax_with_batch_aware_halting(delivery):
    jhg = _small()
    max_iters = 24
    sources = np.arange(8, dtype=np.int32)
    want = JEngine(collect_stats=True).compile(
        jalg.shortest_paths_spec(jhg, 0, max_iters),
        delivery=delivery).run_batch(sources)
    eng = Engine(device="cpu", collect_stats=True)
    thg = _carry(jhg)
    got = eng.compile(talg.shortest_paths_spec(thg, 0, max_iters),
                      delivery=delivery).run_batch(sources)
    assert got.value[0].shape == (8, jhg.n_vertices)
    assert got.value[1].shape == (8, jhg.n_hyperedges)
    _check(got.value, want.value, True)
    for a, b in zip(got.superstep_stats, want.superstep_stats):
        assert a.shape == (8, max_iters)
        assert np.array_equal(a.numpy(), np.asarray(b))
    executed = got.supersteps_executed
    assert executed == int(np.asarray(want.supersteps_executed))

    # the slowest sequential query's pairs (halting pair included)
    def halt_iter(stats):
        zeros = np.flatnonzero((stats[0] + stats[1]).numpy() == 0)
        return zeros[0] + 1 if len(zeros) else max_iters

    seq = [eng.run(talg.shortest_paths_spec(thg, int(s), max_iters),
                   delivery=delivery) for s in sources]
    assert executed == max(halt_iter(r.superstep_stats) for r in seq)
    assert executed < max_iters
    for i, r in enumerate(seq):
        _check([got.value[0][i], got.value[1][i]], r.value, True)
        for k in (0, 1):
            assert torch.equal(got.superstep_stats[k][i],
                               r.superstep_stats[k])


@pytest.mark.parametrize("delivery", ["xla", "pallas_fused"])
def test_run_batch_personalized_random_walk_matches_sequential(delivery):
    jhg = _small(seed=2, nv=40, ne=28)
    thg = _carry(jhg)
    seeds = np.asarray([3, 17, 29], np.int32)
    eng = Engine(device="cpu")
    got = eng.compile(talg.random_walk_spec(thg, iters=12),
                      delivery=delivery).run_batch(seeds).value
    assert got.shape == (3, jhg.n_vertices)
    want_j = JEngine().compile(jalg.random_walk_spec(jhg, iters=12),
                               delivery=delivery).run_batch(seeds).value
    for i, s in enumerate(seeds):
        ref = eng.run(talg.random_walk_spec(thg, seeds=[int(s)], iters=12),
                      delivery=delivery).value
        np.testing.assert_allclose(got[i].numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want_j[i]),
                                   rtol=1e-5, atol=1e-7)


def test_compute_batch_keeps_the_query_axis_inner():
    """The batched pair and loop outside serving (the JAX package's
    ``compute_batch``): the query axis stays at dim 1 of the state and
    each query's result equals its own ``compute``."""
    thg = _carry(_small())
    eng_spec = talg.shortest_paths_spec(thg, 0, 16)
    sources = [0, 5, 9]
    bound = [eng_spec.bind_query(eng_spec.init(thg), s) for s in sources]
    v_b = torch.stack([g.v_attr for g in bound], dim=1)
    he_b = torch.stack([g.he_attr for g in bound], dim=1)
    msg = constant_initial_msg(eng_spec.initial_msg, thg.n_vertices,
                               thg.device)
    state = pair_state(v_b, he_b, msg[:, None].expand(-1, 3), 16, 3,
                       device=thg.device)
    counters = {}
    v_deg, he_card, ids = thg.degrees(), thg.cardinalities(), entity_ids(thg)
    executed = halting_loop(
        lambda: pair_in_place(state, thg, eng_spec.v_program,
                              eng_spec.he_program, v_deg, he_card, ids=ids),
        state, 16, counters)
    v_out, he_out = state["v_attr"], state["he_attr"]
    v_tr = state["v_trace"].T
    assert v_out.shape == (thg.n_vertices, 3) and v_tr.shape == (3, 16)
    assert counters["pairs_run"] == executed == counters["host_syncs"]
    for i, g in enumerate(bound):
        out, (tr, _) = compute(g, 16, eng_spec.initial_msg,
                               eng_spec.v_program, eng_spec.he_program,
                               return_stats=True)
        assert torch.equal(v_out[:, i], out.v_attr)
        assert torch.equal(he_out[:, i], out.he_attr)
        assert torch.equal(v_tr[i], tr)


# --------------------------------------------------------------------------
# the executable cache (tests/test_compile.py's semantics)
# --------------------------------------------------------------------------

def test_same_bucket_second_hypergraph_no_new_trace():
    hg, hg2 = _same_bucket_pair()
    eng = Engine(device="cpu")
    compiled = eng.compile(talg.shortest_paths_spec(hg, 0, 12))
    compiled.run()
    stats = eng.cache_stats()
    assert stats["misses"] == 1 and stats["traces"] == 1
    got = compiled.run(hg2).value
    stats = eng.cache_stats()
    assert stats["traces"] == 1 and stats["hits"] >= 1
    _check(got, eng.run(talg.shortest_paths_spec(hg2, 0, 12)).value, True)


def test_same_signature_layouts_take_turns_in_one_executable():
    """Two hypergraph objects with one structure share the fused
    executable's signature: each request copies its layouts into the
    executable's buffers, and the results stay each one's own."""
    hg = _carry(_small())
    hg2 = dataclasses.replace(hg, src=hg.src.clone(), dst=hg.dst.clone())
    eng = Engine(device="cpu", delivery="pallas_fused")
    spec = talg.shortest_paths_spec(hg, 0, 12)
    compiled = eng.compile(spec)
    first = compiled.run(query=3).value
    assert compiled.run(hg2, query=3).value[0].shape == first[0].shape
    again = compiled.run(query=3).value
    _check(again, first, True)
    stats = eng.cache_stats()
    assert stats["misses"] == 1 and stats["traces"] == 1


def test_second_compile_of_same_spec_hits_cache():
    eng = Engine(device="cpu")
    spec = talg.shortest_paths_spec(_carry(_small()), 0, 12)
    eng.compile(spec).run()
    eng.compile(spec).run()
    stats = eng.cache_stats()
    assert stats["misses"] == 1 and stats["hits"] == 1
    assert stats["traces"] == 1


def test_query_change_never_rebuilds():
    eng = Engine(device="cpu")
    thg = _carry(_small())
    compiled = eng.compile(talg.shortest_paths_spec(thg, 0, 12))
    for s in (0, 3, 11, 46, np.int64(7), np.int32(8)):
        got = compiled.run(query=s).value
        _check(got, eng.run(talg.shortest_paths_spec(thg, int(s),
                                                     12)).value, True)
    assert eng.cache_stats()["traces"] == 1


def test_dtype_change_misses():
    hg, hg2 = _same_bucket_pair()
    hg = dataclasses.replace(hg, e_attr=torch.ones(hg.nnz))
    hg2 = dataclasses.replace(hg2,
                              e_attr=torch.ones(hg2.nnz, dtype=torch.int32))
    eng = Engine(device="cpu")
    compiled = eng.compile(talg.shortest_paths_spec(hg, 0, 8))
    compiled.run()
    compiled.run(hg2)
    stats = eng.cache_stats()
    assert stats["misses"] == 2 and stats["traces"] == 2


def test_initial_msg_change_misses():
    eng = Engine(device="cpu")
    spec = talg.shortest_paths_spec(_carry(_small()), 0, 8)
    ref = eng.compile(spec).run().value
    spec2 = spec._replace(initial_msg=torch.tensor(0.0))
    got = eng.compile(spec2).run().value
    assert eng.cache_stats()["misses"] == 2
    assert not torch.equal(ref[0], got[0])
    assert float(got[0].max()) == 0.0


def test_design_point_change_misses():
    eng = Engine(device="cpu")
    spec = talg.shortest_paths_spec(_carry(_small()), 0, 12)
    eng.compile(spec).run()
    eng.compile(spec, max_iters=6).run()
    eng.compile(spec, collect_stats=True).run()
    eng.compile(spec, delivery="pallas_fused").run()
    stats = eng.cache_stats()
    assert stats["misses"] == 4 and stats["entries"] == 4


def test_cache_is_lru_bounded():
    eng = Engine(device="cpu", exec_cache_size=2)
    thg = _carry(_small())
    for iters in (2, 3, 4):
        eng.compile(talg.shortest_paths_spec(thg, 0, iters)).run()
    stats = eng.cache_stats()
    assert stats["entries"] == 2 and stats["misses"] == 3
    assert stats["evictions"] == 1 and stats["capacity"] == 2
    assert set(stats) == {"entries", "capacity", "capacity_bytes", "bytes",
                          "hits", "misses", "evictions", "traces",
                          "entry_shapes", "disk"}
    assert stats["disk"] is None and stats["capacity_bytes"] is None
    assert [m["algorithm"] for m in stats["entry_shapes"]] == ["sssp"] * 2
    assert stats["bytes"] == sum(m["bytes"] for m in stats["entry_shapes"])
    assert all(m["bytes"] > 0 for m in stats["entry_shapes"])


def test_cache_is_bounded_in_bytes_and_releases_evicted_entries():
    """An entry holds its buffers and loop state: the LRU also keeps
    their bytes under ``exec_cache_bytes`` (the newest entry always
    stays), and an evicted entry drops them."""
    thg = _carry(_small())
    probe = Engine(device="cpu")
    probe.compile(talg.shortest_paths_spec(thg, 0, 4)).run()
    one = probe.cache_stats()["bytes"]
    eng = Engine(device="cpu", exec_cache_bytes=2 * one + one // 2)
    held = []
    for iters in (4, 4, 4):
        compiled = eng.compile(talg.shortest_paths_spec(thg, 0, iters))
        compiled.run()
        held.append(next(reversed(eng._exec_cache.values())))
    stats = eng.cache_stats()
    assert stats["entries"] == 2 and stats["evictions"] == 1
    assert stats["bytes"] <= stats["capacity_bytes"]
    assert held[0].state is None and held[0].nbytes == 0
    assert held[2].state is not None
    single = Engine(device="cpu", exec_cache_bytes=1)
    got = single.compile(talg.shortest_paths_spec(thg, 0, 4)).run()
    assert single.cache_stats()["entries"] == 1
    _check(got.value, probe.run(talg.shortest_paths_spec(thg, 0, 4)).value,
           True)


def test_compile_rejects_clique_and_analytics():
    thg = _carry(_small())
    with pytest.raises(ValueError, match="bipartite"):
        Engine(device="cpu", representation="clique").compile(
            talg.pagerank_spec(thg, iters=2))
    with pytest.raises(TypeError, match="AlgorithmSpec"):
        Engine(device="cpu").compile(AnalyticsSpec(thg))


def test_run_batch_requires_query_axis():
    compiled = Engine(device="cpu").compile(
        talg.pagerank_spec(_carry(_small()), iters=2))
    with pytest.raises(ValueError, match="bind_query"):
        compiled.run_batch(np.arange(4))


def test_padded_batch_of_5_shares_the_bucket_of_8():
    eng = Engine(device="cpu")
    thg = _carry(_small())
    compiled = eng.compile(talg.shortest_paths_spec(thg, 0, 8))
    full = compiled.run_batch(np.arange(8, dtype=np.int32)).value
    part = compiled.run_batch(np.arange(5, dtype=np.int32)).value
    stats = eng.cache_stats()
    assert stats["traces"] == 1 and stats["hits"] == 1
    assert part[0].shape == (5, thg.n_vertices)
    assert torch.equal(part[0], full[0][:5])
    assert stats["entry_shapes"][0]["batch_pad"] == 8


def test_batched_results_do_not_alias_the_loop_state():
    """A full batch bucket (b == b_pad) at one pair, where slicing and
    transposing the state are views: the Result is a copy, and the next
    request on the same executable leaves it as it was."""
    eng = Engine(device="cpu", collect_stats=True)
    thg = _carry(_small())
    compiled = eng.compile(talg.shortest_paths_spec(thg, 0, 1))
    first = compiled.run_batch(np.arange(8, dtype=np.int32))
    kept = [t.clone() for t in tree_leaves((first.value,
                                             first.superstep_stats))]
    compiled.run_batch(np.arange(8, 16, dtype=np.int32))
    assert eng.cache_stats()["hits"] == 1
    for a, b in zip(tree_leaves((first.value, first.superstep_stats)), kept):
        assert torch.equal(a, b)


def test_seeded_random_walk_serves_new_hypergraph():
    hg, hg2 = _same_bucket_pair()
    eng = Engine(device="cpu")
    compiled = eng.compile(talg.random_walk_spec(hg, seeds=[3, 7], iters=8))
    got = compiled.run(hg2).value
    ref = eng.run(talg.random_walk_spec(hg2, seeds=[3, 7], iters=8)).value
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)


def test_warmup_builds_without_serving():
    eng = Engine(device="cpu")
    compiled = eng.compile(talg.shortest_paths_spec(_carry(_small()), 0, 8))
    report = compiled.warmup(batch_sizes=(3, 8))
    assert report == {"single": {"source": "jit", "executable": "eager"},
                      "batch8": {"source": "jit", "executable": "eager"}}
    stats = eng.cache_stats()
    assert stats["misses"] == 2 and stats["traces"] == 2
    compiled.run()
    compiled.run_batch(np.arange(6))
    stats = eng.cache_stats()
    assert stats["traces"] == 2 and stats["hits"] >= 2
    with pytest.raises(ValueError, match="bind_query"):
        eng.compile(talg.pagerank_spec(_carry(_small()), iters=2)).warmup(
            batch_sizes=(4,))


def test_fused_failure_degrades_to_the_marked_xla_twin(monkeypatch):
    """On the CPU a permanent fused-path failure is served by the xla
    twin, whose Result says so; a transient one raises (on the card
    every failure raises: ``tests/test_torch_cuda.py``)."""
    import repro_torch.kernels.deliver as deliver_pkg

    thg = _carry(_small())
    eng = Engine(device="cpu")
    spec = talg.shortest_paths_spec(thg, 0, 12)
    compiled = eng.compile(spec, delivery="pallas_fused")
    healthy = compiled.run()
    assert "degraded_from" not in healthy.decision

    def broken(*a, **k):
        raise RuntimeError("kernel lost")

    monkeypatch.setattr(deliver_pkg, "fused_deliver", broken)
    res = compiled.run(query=4)
    assert res.decision["degraded_from"] == "pallas_fused"
    assert res.config.delivery == "xla"
    _check(res.value, eng.run(talg.shortest_paths_spec(thg, 4, 12),
                              delivery="xla").value, True)
    from repro_torch.faults import TransientExecuteError

    def transient(*a, **k):
        raise TransientExecuteError("retry me")

    monkeypatch.setattr(deliver_pkg, "fused_deliver", transient)
    with pytest.raises(TransientExecuteError):
        compiled.run(query=5)


def test_wrappers_serve_batches():
    jhg = _small()
    thg = _carry(jhg)
    eng = Engine(device="cpu")
    v, he = talg.shortest_paths(thg, max_iters=16, sources=[0, 4, 9],
                                engine=eng)
    assert v.shape == (3, thg.n_vertices) and he.shape[0] == 3
    for i, s in enumerate((0, 4, 9)):
        ref = talg.shortest_paths(thg, s, 16, engine=eng)
        _check([v[i], he[i]], ref, True)
    with pytest.raises(ValueError, match="not both"):
        talg.shortest_paths(thg, 2, sources=[1], engine=eng)
    p = talg.random_walk(thg, iters=6, seed_batch=[1, 5], engine=eng)
    assert p.shape == (2, thg.n_vertices)
    want = JEngine().compile(jalg.random_walk_spec(jhg, iters=6)).run_batch(
        np.asarray([1, 5], np.int32)).value
    np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="not both"):
        talg.random_walk(thg, seeds=[1], seed_batch=[1], engine=eng)


def test_procedures_select_on_a_step_tensor():
    """Every built-in procedure takes the step as a 0-d tensor and
    selects on it, as a captured pair needs."""
    thg = _carry(_small())
    ids = torch.arange(thg.n_vertices, dtype=torch.int32)
    for make in (lambda h: talg.shortest_paths_spec(h, 0),
                 talg.connected_components_spec,
                 talg.label_propagation_spec,
                 lambda h: talg.random_walk_spec(h, iters=3),
                 talg.pagerank_spec):
        spec = make(thg)
        msg = spec.initial_msg
        from repro_torch.core.api import constant_initial_msg

        msg0 = constant_initial_msg(msg, thg.n_vertices)
        for step in (0, 2):
            out = spec.v_program.procedure(
                torch.tensor(step, dtype=torch.int32), ids,
                spec.hg0.v_attr, msg0, thg.degrees())
            assert all(isinstance(x, torch.Tensor)
                       for x in tree_leaves(out.attr))


def test_launcher_serves_sources_with_cache_stats(capsys):
    rc = launcher.main(["--device", "cpu", "--algorithm", "sssp",
                        "--scale", "0.001", "--sources", "0,3",
                        "--cache-stats"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 2 queries" in out
    assert "cache: entries=1/32 hits=1 misses=1 evictions=0 traces=1" in out
    assert "'batch_pad': 8" in out
    rc = launcher.main(["--device", "cpu", "--algorithm", "pagerank",
                        "--scale", "0.001", "--batch", "2"])
    assert rc == 2
