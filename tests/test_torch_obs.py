"""Parity of the port's observability layer (``repro_torch.obs``,
``Engine.explain``, ``Engine(tracer=, metrics=)``) with the JAX package's
``repro.obs``, on the CPU.

The ports of ``tests/test_obs.py``'s cases that need neither the serve
tier nor faults, each run on the port (and, where the reference has the
same function, on both with the same inputs):

* ``Tracer``: span nesting on a fake clock, ring eviction, the
  Chrome-trace schema, ``maybe_span`` as a no-op, ``block`` on CPU
  values;
* ``MetricsRegistry``: instruments, provider collisions and errors, dead
  weak providers pruned; the port's default registry is not the
  reference's;
* the layout builder's counters, equal to the reference's counts;
* ``Engine.explain``: axes equal to the reference's key for key
  (winners, reasons, inputs, candidates' predicted costs) for
  ``pagerank_spec``, ``vertex_pagerank_spec``, SSSP and an
  ``AnalyticsSpec``; its winners equal ``resolve``'s under every pinning
  of the axes; no execution;
* ``Result.decision["measured"]["delivery"]`` on the fused path equal to
  the reference's bytes;
* ``reference_traffic``, ``fused_traffic``, ``executed_supersteps``,
  ``residual_log2``, ``delivery_calibration`` and ``decision_residuals``
  equal to the reference's on the same inputs;
* traced runs and compiles record their spans; the launcher's
  ``--explain``, ``--trace`` and ``--metrics-json``.
"""
import dataclasses
import gc
import json

import numpy as np
import pytest
import torch

import repro.algorithms as jalg
import repro.obs as jobs
from repro.core import AnalyticsSpec as JAnalyticsSpec
from repro.core import Engine as JEngine
from repro.data import powerlaw_hypergraph as j_powerlaw
from repro.kernels.deliver import build_delivery_layout as j_build_layout
import repro_torch.algorithms as talg
import repro_torch.obs as tobs
from repro_torch.core import AnalyticsSpec, Engine, HyperGraph
from repro_torch.kernels.deliver import build_delivery_layout
from repro_torch.launch import hypergraph as launcher
from repro_torch.obs import (
    MetricsRegistry,
    Tracer,
    maybe_span,
    weak_provider,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _carry(jhg):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu")


@pytest.fixture(scope="module")
def jhg():
    return j_powerlaw(400, 180, mean_cardinality=5, seed=3)


@pytest.fixture
def registries():
    """Fresh default registries on both sides (each package has its
    own), reset again afterwards."""
    yield jobs.reset_default_registry(), tobs.reset_default_registry()
    jobs.reset_default_registry()
    tobs.reset_default_registry()


# --------------------------------------------------------------------------
# Tracer
# --------------------------------------------------------------------------

def test_span_nesting_and_durations_fake_clock():
    clock = FakeClock()
    tr = Tracer(clock=clock)
    with tr.span("outer", cat="execute", k=1) as outer:
        clock.t = 1.0
        with tr.span("inner", cat="compile") as inner:
            clock.t = 3.0
        clock.t = 10.0
    assert [s.name for s in tr.spans()] == ["inner", "outer"]
    assert inner.depth == 1 and outer.depth == 0
    assert inner.dur_s == pytest.approx(2.0)
    assert outer.dur_s == pytest.approx(10.0)
    assert outer.args["k"] == 1
    with tr.span("next") as nxt:
        pass
    assert nxt.depth == 0


def test_ring_eviction_keeps_newest_and_counts_dropped():
    tr = Tracer(capacity=4, clock=FakeClock())
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    assert (tr.dropped, tr.total) == (6, 10)
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_chrome_trace_schema_and_export(tmp_path):
    clock = FakeClock()
    tr = Tracer(clock=clock)
    with tr.span("compile", cat="compile", key="k"):
        clock.t = 0.5
        with tr.span("execute", cat="execute"):
            clock.t = 0.75
    doc = tr.chrome_trace()
    assert doc["otherData"]["dropped_spans"] == 0
    events = doc["traceEvents"]
    assert len(events) == 2
    for ev in events:
        for field in ("name", "cat", "ph", "ts", "dur", "pid", "tid"):
            assert field in ev
        assert ev["ph"] == "X" and ev["dur"] >= 0.0
        assert "depth" in ev["args"]
    assert [ev["dur"] for ev in events] == [250000.0, 750000.0]
    with open(tr.export(str(tmp_path / "trace.json"))) as f:
        assert json.load(f)["traceEvents"] == json.loads(json.dumps(events))


def test_maybe_span_is_noop_without_tracer():
    with maybe_span(None, "anything", cat="execute", k=2) as sp:
        assert sp is None


@pytest.mark.parametrize("value", [
    np.zeros(3), torch.zeros(3), (torch.ones(2), [torch.zeros(1)]), None])
def test_tracer_block_waits_for_nothing_on_the_cpu(value):
    clock = FakeClock()
    tr = Tracer(clock=clock)
    with tr.span("x") as sp:
        clock.t = 1.0
        assert tr.block(sp, value) is value
    assert sp.args["device_wait_s"] == pytest.approx(0.0)


# --------------------------------------------------------------------------
# MetricsRegistry
# --------------------------------------------------------------------------

def test_registry_instruments_and_kind_mismatch():
    reg = MetricsRegistry()
    c = reg.counter("n")
    c.inc()
    c.inc(3)
    reg.gauge("g").set(2.5)
    reg.histogram("h").record(0.01)
    assert reg.counter("n") is c
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("n")
    snap = reg.snapshot()
    assert (snap["n"], snap["g"], snap["h"]["count"]) == (4, 2.5, 1)


def test_registry_provider_collision_suffix_and_errors():
    reg = MetricsRegistry()
    n1 = reg.register_provider("cache", lambda: {"a": 1})
    n2 = reg.register_provider("cache", lambda: {"b": 2})
    assert (n1, n2) == ("cache", "cache#2")

    def boom():
        raise RuntimeError("nope")

    reg.register_provider("bad", boom)
    snap = reg.snapshot()
    assert snap["cache"] == {"a": 1} and snap["cache#2"] == {"b": 2}
    assert "error" in snap["bad"]


def test_registry_prunes_dead_weak_providers():
    class Owner:
        def stats(self):
            return {"alive": True}

    reg = MetricsRegistry()
    o = Owner()
    reg.register_provider("owner", weak_provider(o.stats))
    assert reg.snapshot()["owner"] == {"alive": True}
    del o
    gc.collect()
    assert "owner" not in reg.snapshot()
    assert "owner" not in reg._providers


def test_histogram_quantiles_match_jax():
    got, want = tobs.LatencyHistogram(), jobs.LatencyHistogram()
    for x in np.random.default_rng(0).exponential(0.01, 500):
        got.record(x)
        want.record(x)
    assert got.snapshot() == want.snapshot()


def test_engine_registers_its_cache_and_default_registries_are_apart(
        registries):
    j_reg, t_reg = registries
    assert t_reg is not j_reg
    eng = Engine(device="cpu")
    assert "engine.exec_cache" in t_reg.snapshot()
    assert t_reg.snapshot()["engine.exec_cache"]["entries"] == 0
    assert "engine.exec_cache" not in j_reg.snapshot()
    own = MetricsRegistry()
    mine = Engine(device="cpu", metrics=own)
    assert mine.metrics is own and "engine.exec_cache" in own.snapshot()
    del eng
    gc.collect()
    assert "engine.exec_cache" not in t_reg.snapshot()


def test_delivery_layout_builder_counts_like_jax(registries):
    j_reg, t_reg = registries
    rng = np.random.default_rng(0)
    for n, e in ((64, 512), (300, 4000), (32, 256)):
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        layout = build_delivery_layout(src, dst, None, n, n)
        j_layout = j_build_layout(src, dst, None, n, n)
        assert layout.ell_slots == j_layout.ell_slots
    got, want = t_reg.snapshot(), j_reg.snapshot()
    for key in ("delivery.layouts_built", "delivery.ell_slots",
                "delivery.residual_lanes"):
        assert got[key] == want[key], key
    assert got["delivery.layouts_built"] == 3
    assert got["delivery.build_s"]["count"] == 3


# --------------------------------------------------------------------------
# Engine.explain against the reference
# --------------------------------------------------------------------------

def _plain(x):
    """Tuples as lists, numpy scalars as Python numbers: the form the
    two packages' decision dicts compare in."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


SPECS = {
    "pagerank": lambda m, h: m.pagerank_spec(h, iters=4),
    "vertex_pagerank": lambda m, h: m.vertex_pagerank_spec(h, iters=4),
    "sssp": lambda m, h: m.shortest_paths_spec(h, 0, 5),
}


@pytest.mark.parametrize("budget", [4.0, 1e9])
@pytest.mark.parametrize("name", list(SPECS))
def test_explain_axes_match_jax(jhg, name, budget):
    eng = Engine(device="cpu", clique_edge_budget=budget)
    ex = eng.explain(SPECS[name](talg, _carry(jhg)))
    want = JEngine(clique_edge_budget=budget).explain(
        SPECS[name](jalg, jhg))
    assert _plain(ex["axes"]) == _plain(want["axes"])
    assert _plain(ex["decision"]) == _plain(want["decision"])
    assert dataclasses.asdict(ex["config"]) == dataclasses.asdict(
        want["config"])
    assert eng.cache_stats()["traces"] == eng.cache_stats()["entries"] == 0
    assert eng._delivery_cache == []  # no layout built


@pytest.mark.parametrize("mode", ["auto", "exact", "sample"])
def test_explain_analytics_axes_match_jax(jhg, mode):
    ex = Engine(device="cpu").explain(AnalyticsSpec(_carry(jhg), mode=mode))
    want = JEngine().explain(JAnalyticsSpec(jhg, mode=mode))
    assert ex["mode"] == want["mode"]
    assert _plain(ex["axes"]) == _plain(want["axes"])
    res = Engine(device="cpu").analyze(AnalyticsSpec(_carry(jhg), mode=mode))
    assert ex["axes"]["kernel"]["winner"] == res.kernel
    assert ex["axes"]["representation"]["winner"] == res.representation
    assert ex["mode"] == res.mode


def test_explain_against_another_hypergraph(jhg):
    other = j_powerlaw(120, 60, mean_cardinality=4, seed=7)
    ex = Engine(device="cpu").explain(
        talg.vertex_pagerank_spec(_carry(jhg)), hg=_carry(other))
    want = JEngine().explain(jalg.vertex_pagerank_spec(jhg), hg=other)
    assert _plain(ex["axes"]) == _plain(want["axes"])


@pytest.mark.parametrize("representation", ["auto", "bipartite"])
@pytest.mark.parametrize("delivery", ["auto", "xla", "pallas_fused"])
@pytest.mark.parametrize("backend", ["auto", "local"])
def test_explain_matches_resolve_under_overrides(representation, delivery,
                                                 backend):
    thg = _carry(j_powerlaw(120, 60, mean_cardinality=4, seed=7))
    eng = Engine(device="cpu")
    overrides = dict(representation=representation, delivery=delivery,
                     backend=backend)
    for spec in (talg.shortest_paths_spec(thg, 0, 3),
                 talg.vertex_pagerank_spec(thg, iters=3)):
        ex = eng.explain(spec, **overrides)
        resolved, _, decision = eng.resolve(spec, **overrides)
        assert ex["config"] == resolved
        assert ex["decision"].keys() == decision.keys()
        for axis in ("representation", "backend", "delivery"):
            assert ex["axes"][axis]["winner"] == getattr(resolved, axis)
        res = eng.run(spec, **overrides)
        assert res.config == resolved
    assert eng.cache_stats()["traces"] == 0


def test_run_measured_delivery_bytes_match_jax(jhg):
    # collect_stats: the reference measures supersteps only then (the
    # port always does)
    got = Engine(device="cpu", delivery="pallas_fused",
                 collect_stats=True).run(
        talg.pagerank_spec(_carry(jhg), iters=3))
    want = JEngine(delivery="pallas_fused", collect_stats=True).run(
        jalg.pagerank_spec(jhg, iters=3))
    md = got.decision["measured"]["delivery"]
    assert _plain(md) == _plain(want.decision["measured"]["delivery"])
    assert md["fwd"]["nnz"] == jhg.nnz
    assert md["total_bytes"] == pytest.approx(
        md["fwd"]["total_bytes"] + md["bwd"]["total_bytes"])
    # the residual record built from the same enriched decision
    assert _plain(tobs.decision_residuals(got.decision)) == _plain(
        jobs.decision_residuals(want.decision))
    # the xla path measures no delivery bytes
    m = Engine(device="cpu", delivery="xla").run(
        talg.pagerank_spec(_carry(jhg), iters=3)).decision["measured"]
    assert "delivery" not in m


# --------------------------------------------------------------------------
# obs.calibrate against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nnz,n_dst,width", [
    (100, 10, 4.0), (0, 5, 8.0), (2_838_951, 782_659, 256.0)])
def test_reference_traffic_matches_jax(nnz, n_dst, width):
    assert tobs.reference_traffic(nnz, n_dst, width) == (
        jobs.reference_traffic(nnz, n_dst, width))
    assert tobs.reference_traffic(100, 10, 4.0) == 100 * (12 + 8) + 40


@pytest.mark.parametrize("n,e,width", [(32, 256, 4.0), (300, 4000, 12.0),
                                       (64, 1, 256.0)])
def test_fused_traffic_matches_jax(n, e, width):
    rng = np.random.default_rng(e)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (rng.zipf(1.6, e) % n).astype(np.int32)
    mask = (rng.random(e) < 0.9).astype(np.int32)
    got_l = build_delivery_layout(src, dst, mask, n, n)
    want_l = j_build_layout(src, dst, mask, n, n)
    got = tobs.fused_traffic(got_l, width)
    assert _plain(got) == _plain(jobs.fused_traffic(want_l, width))
    assert got["total_bytes"] == pytest.approx(
        sum(got["per_class_bytes"]) + got["residual_bytes"]
        + got["output_bytes"])
    pair = tobs.delivery_traffic_pair((got_l, got_l), width)
    assert _plain(pair) == _plain(
        jobs.delivery_traffic_pair((want_l, want_l), width))


@pytest.mark.parametrize("stats,max_iters", [
    (([3, 2, 0, 0], [1, 0, 0, 0]), None),
    (([1, 0, 0, 0], [0, 0, 0, 0]), None),
    ((np.array([[3, 2, 0], [1, 0, 0]]), np.zeros((2, 3), int)), None),
    ((np.array([[3, 2, 0], [1, 0, 0]]), np.zeros((2, 3), int)), 1),
    (None, 4),
])
def test_executed_supersteps_matches_jax(stats, max_iters):
    want = jobs.executed_supersteps(stats, max_iters)
    assert tobs.executed_supersteps(stats, max_iters) == want
    if stats is not None:  # the port's own stats are tensors
        as_t = tuple(torch.as_tensor(np.asarray(x), dtype=torch.int32)
                     for x in stats)
        assert tobs.executed_supersteps(as_t, max_iters) == want


@pytest.mark.parametrize("pred,meas", [(2.0, 1.0), (1.0, 1.0), (0.0, 3.0),
                                       (5.0, 0.0), (0.3, 0.9)])
def test_residual_log2_matches_jax(pred, meas):
    assert tobs.residual_log2(pred, meas) == jobs.residual_log2(pred, meas)


def test_delivery_calibration_matches_jax():
    regimes = {
        "perfect": {"model_traffic_ratio": 2.0, "fused_speedup": 2.0,
                    "auto_picks": "pallas_fused"},
        "off": {"model_traffic_ratio": 0.5, "fused_speedup": 0.8,
                "auto_picks": "xla"},
        "timed": {"model_traffic_ratio": 1.5, "xla_s": 0.3,
                  "fused_s": 0.6, "auto_picks": "pallas_fused"},
    }
    got = tobs.delivery_calibration(regimes)
    assert _plain(got) == _plain(jobs.delivery_calibration(regimes))
    assert got["regimes"]["timed"]["decision_agrees"] is False
    assert got["summary"]["decision_accuracy"] == pytest.approx(2 / 3)


# --------------------------------------------------------------------------
# traced execution and the launcher
# --------------------------------------------------------------------------

def test_traced_run_and_compile_record_spans(jhg):
    tr = Tracer()
    eng = Engine(device="cpu", tracer=tr, delivery="pallas_fused")
    thg = _carry(jhg)
    eng.run(talg.pagerank_spec(thg, iters=3))
    eng.run(talg.vertex_pagerank_spec(thg, iters=3),
            representation="clique")
    runs = [s for s in tr.spans() if s.name == "engine.run"]
    assert [s.args.get("representation", "bipartite") for s in runs] == [
        "bipartite", "clique"]
    assert all("device_wait_s" in s.args for s in runs)
    assert runs[0].args["delivery"] == "pallas_fused"
    names = [s.name for s in tr.spans()]
    assert names.count("engine.layout_build") == 1
    compiled = eng.compile(talg.shortest_paths_spec(thg, 0, 4))
    compiled.run_batch(np.asarray([0, 1, 2], np.int32))
    names = {s.name for s in tr.spans()}
    assert {"engine.build_executable", "serve.layout_build"} <= names
    # measured delivery bytes ride the traced serve path
    res = compiled.run(query=3)
    assert res.decision["measured"]["delivery"]["total_bytes"] > 0
    untraced = Engine(device="cpu", delivery="pallas_fused").compile(
        talg.shortest_paths_spec(thg, 0, 4)).run(query=3)
    assert "delivery" not in untraced.decision["measured"]


@pytest.mark.parametrize("algorithm,rep", [
    ("vertex_pagerank", "auto"), ("vertex_pagerank", "clique"),
    ("pagerank_entropy", "bipartite"), ("sssp", "auto")])
def test_launcher_explain_trace_metrics(tmp_path, capsys, algorithm, rep):
    trace = tmp_path / "trace.json"
    metrics = tmp_path / "metrics.json"
    rc = launcher.main(["--algorithm", algorithm, "--device", "cpu",
                        "--scale", "0.001", "--iters", "4",
                        "--representation", rep, "--explain",
                        "--trace", str(trace), "--metrics-json",
                        str(metrics)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "explain:" in out and "representation: winner=" in out
    assert "delivery: winner=" in out
    if rep == "clique":
        assert "representation=clique" in out
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert "engine.run" in {ev["name"] for ev in events}
    with open(metrics) as f:
        snap = json.load(f)
    # "#n"-suffixed when earlier Engines' providers are not pruned yet
    assert any(k.startswith("engine.exec_cache") for k in snap)
