"""Parity of the port's ``Engine`` with the JAX package, end to end.

* ``repro_torch`` ``Engine(device="cpu").run`` against the JAX
  ``Engine(backend="local").run`` on the same hypergraph (carried over
  with ``HyperGraph.from_numpy``), with ``delivery`` both ``xla`` and
  ``pallas_fused``, for all six specs: SSSP, label propagation and
  connected components bitwise with equal activity traces; PageRank,
  PageRank-Entropy and the random walk within 1e-5.
* The ``auto`` delivery decision equals the reference's on the CPU.
* The halting loop keeps the scan's semantics (at most ``max_iters``
  pairs, zero stats after the halt, resumable bitwise) and counts its
  host syncs.
* Isolation: the port imports no ``jax`` and nothing of ``repro``;
  entry points without a card raise unless asked for the CPU; axes not
  ported raise ``NotImplementedError``.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.algorithms as jalg
from repro.core import Engine as JEngine
from repro.core.executor import select_delivery as j_select_delivery
from repro.data import powerlaw_hypergraph as j_powerlaw
import repro_torch.algorithms as talg
from repro_torch.core import Engine, HyperGraph
from repro_torch.core.engine import (
    compute,
    compute_resumable,
    initial_superstep_state,
)
from repro_torch.core.executor import ExecutionConfig, select_delivery
from repro_torch.data import make_dataset
from repro_torch.launch import hypergraph as launcher

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _carry(jhg):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu")


def medium():
    # large enough to clear FUSED_MIN_NNZ, so auto picks the fused path
    return j_powerlaw(1400, 1000, mean_cardinality=7, seed=3)


# (name, reference spec builder, port spec builder, bitwise)
SPECS = [
    ("sssp", lambda m, h: m.shortest_paths_spec(h, 0, 12), True),
    ("label_propagation", lambda m, h: m.label_propagation_spec(h, 6), True),
    ("connected_components", lambda m, h: m.connected_components_spec(h),
     True),
    ("pagerank", lambda m, h: m.pagerank_spec(h, iters=8), False),
    ("pagerank_entropy", lambda m, h: m.pagerank_entropy_spec(h, iters=6),
     False),
    ("random_walk", lambda m, h: m.random_walk_spec(h, iters=8), False),
]


def _leaves(x):
    return [np.asarray(a) for a in jax.tree.leaves(x)]


def _tleaves(x):
    from repro_torch.core.api import tree_leaves

    return [a.numpy() for a in tree_leaves(x)]


@pytest.mark.parametrize("delivery", ["xla", "pallas_fused"])
@pytest.mark.parametrize("name,make,bitwise", SPECS,
                         ids=[s[0] for s in SPECS])
def test_engine_run_matches_jax(name, make, bitwise, delivery):
    jhg = medium()
    want = JEngine(backend="local", collect_stats=True).run(
        make(jalg, jhg), delivery=delivery)
    got = Engine(device="cpu", collect_stats=True).run(
        make(talg, _carry(jhg)), delivery=delivery)
    assert got.config.delivery == want.config.delivery == delivery
    for a, b in zip(_tleaves(got.value), _leaves(want.value)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if bitwise:
            assert np.array_equal(a, b, equal_nan=True), name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(got.superstep_stats, want.superstep_stats):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    m = got.decision["measured"]
    assert m["supersteps"] == want.decision["measured"]["supersteps"]
    assert m["wall_s"] >= m["dispatch_s"] >= 0 and m["device_wait_s"] >= 0


def test_pagerank_entropy_seq_matches_jax():
    jhg = j_powerlaw(300, 200, mean_cardinality=5, seed=1)
    want = jalg.pagerank_entropy_seq(jhg, iters=5)
    got = talg.pagerank_entropy_seq(_carry(jhg), iters=5)
    for a, b in zip(_tleaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["medium", "tiny", "wide", "seq",
                                     "masked"])
def test_auto_delivery_decision_matches_jax(variant):
    if variant == "tiny":
        jhg = j_powerlaw(30, 20, mean_cardinality=3, seed=0)
    elif variant == "masked":
        base = medium()
        rng = np.random.default_rng(0)
        jhg = dataclasses.replace(base, e_mask=jax.numpy.asarray(
            (rng.random(base.nnz) > 0.5).astype(np.float32)))
    else:
        jhg = medium()
    jspec = jalg.pagerank_spec(jhg, iters=4)
    thg = HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                jhg.n_hyperedges, e_mask=jhg.e_mask,
                                device="cpu")
    tspec = talg.pagerank_spec(thg, iters=4)
    if variant == "wide":
        jspec = jspec._replace(initial_msg=jax.numpy.zeros((64,)))
        tspec = tspec._replace(initial_msg=torch.zeros(64))
    if variant == "seq":
        red = lambda rows, dst, n, live: rows
        jspec = jspec._replace(v_program=dataclasses.replace(
            jspec.v_program, reducer=red))
        tspec = tspec._replace(v_program=dataclasses.replace(
            tspec.v_program, reducer=red))
    got, got_why = select_delivery(tspec, thg)
    want, want_why = j_select_delivery(jspec, jhg)
    assert got == want
    assert got_why == want_why
    cfg, _, decision = Engine(device="cpu").resolve(tspec)
    assert cfg.delivery == got and decision["delivery"] == got_why


def test_halting_semantics_and_host_syncs():
    thg = _carry(medium())
    spec = talg.shortest_paths_spec(thg, 0, 40)
    counters = {}
    out, (v_tr, he_tr) = compute(
        spec.hg0, 40, spec.initial_msg, spec.v_program, spec.he_program,
        return_stats=True, counters=counters)
    pairs = counters["pairs_run"]
    assert counters["halted"] and pairs < 40
    assert counters["host_syncs"] == pairs
    assert int(v_tr[pairs - 1] + he_tr[pairs - 1]) == 0
    assert (v_tr[pairs:] == 0).all() and (he_tr[pairs:] == 0).all()
    assert ((v_tr[:pairs - 1] + he_tr[:pairs - 1]) > 0).all()
    # a longer budget changes nothing once halted
    out2 = compute(spec.hg0, 60, spec.initial_msg, spec.v_program,
                   spec.he_program)
    assert torch.equal(out.v_attr, out2.v_attr)
    # resuming in chunks runs the same pairs in the same order: bitwise
    state = initial_superstep_state(spec.hg0, spec.initial_msg)
    traces = []
    for n in (3, 4, 33):
        state, tr = compute_resumable(spec.hg0, n, state, spec.v_program,
                                      spec.he_program)
        traces.append(tr)
    assert state["halted"] and state["step"] == 80
    assert torch.equal(state["v_attr"], out.v_attr)
    assert torch.equal(torch.cat([t[0] for t in traces]), v_tr)
    # no activity vectors (PageRank): the counts need no host sync
    pr = talg.pagerank_spec(thg, iters=5)
    m = Engine(device="cpu").run(pr).decision["measured"]
    assert m["host_syncs"] == 0 and m["pairs_run"] == m["supersteps"] == 5


@pytest.mark.parametrize("overrides,exc", [
    ({"representation": "clique"}, ValueError),
    ({"backend": "replicated"}, NotImplementedError),
    ({"backend": "sharded"}, NotImplementedError),
    ({"checkpoint_every": 2, "checkpoint_dir": "ckpt"}, NotImplementedError),
    ({"delivery": "fast"}, ValueError),
    ({"backend": "mesh"}, ValueError),
])
def test_unported_axes_raise(overrides, exc):
    # "clique" constructs and is refused for a spec that touches
    # hyperedge state, with the reference's message, once resolved; the
    # others raise in ExecutionConfig.
    spec = talg.pagerank_spec(
        _carry(j_powerlaw(30, 20, mean_cardinality=3, seed=2)), iters=1)
    with pytest.raises(exc, match="ROADMAP|must be one of|hyperedge state"):
        Engine(device="cpu", config=ExecutionConfig(**overrides)).resolve(
            spec)


@pytest.mark.parametrize("kw", ["mesh", "plan", "disk_cache",
                                "fault_injector"])
def test_unported_engine_arguments_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(device="cpu", **{kw: object()})
    if kw == "fault_injector":
        with pytest.raises(NotImplementedError, match="item 8's fault half"):
            Engine(device="cpu", fault_injector=object())


def test_unported_methods_and_wrong_inputs_raise():
    thg = _carry(j_powerlaw(60, 40, mean_cardinality=4, seed=1))
    eng = Engine(device="cpu")
    spec = talg.pagerank_spec(thg, iters=2)
    # explain is ported (item 8's observability half)
    assert eng.explain(spec)["config"] == eng.resolve(spec)[0]
    # compile is ported (item 6): it resolves and returns a handle
    assert eng.compile(spec).config.representation == "bipartite"
    with pytest.raises(TypeError, match="AnalyticsSpec"):
        eng.analyze(spec)
    # the clique representation is ported (item 5): auto resolves it
    # for a clique-eligible spec whose expansion fits the budget
    eligible = spec._replace(touches_hyperedge_state=False,
                             clique_program=lambda g: g)
    assert eng.resolve(eligible, clique_edge_budget=1e9)[0].representation \
        == "clique"
    with pytest.raises(TypeError, match="AlgorithmSpec"):
        eng.submit(object())
    assert eng.submit(spec).backend == "local"
    seq = spec._replace(v_program=dataclasses.replace(
        spec.v_program, reducer=lambda rows, dst, n, live: rows))
    with pytest.raises(ValueError, match="monoid"):
        eng.resolve(seq, delivery="pallas_fused")
    assert eng._delivery_layouts(thg) is eng._delivery_layouts(thg)


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dataset("dblp", 0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HyperGraph.from_coo(np.zeros(1), np.zeros(1), 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--scale", "0.001"])
    hg = make_dataset("dblp", 0.001, device="cpu")
    with pytest.raises(ValueError, match="spec lives on"):
        Engine(device="meta").run(talg.pagerank_spec(hg, iters=1))


@pytest.mark.parametrize("algorithm", launcher.ALGORITHMS)
def test_launcher_runs_on_cpu(algorithm, capsys):
    rc = launcher.main(["--algorithm", algorithm, "--scale", "0.001",
                        "--iters", "4", "--device", "cpu", "--stats",
                        "--delivery", "pallas_fused"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "delivery=pallas_fused" in out and "host_syncs=" in out


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


ISOLATION = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not bad, bad
assert len(names) >= 20, names
print('ISOLATED', len(names))
"""


def test_port_imports_no_jax_or_reference_at_runtime():
    proc = subprocess.run(
        [sys.executable, "-c", ISOLATION], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout
