"""Fault tolerance in the port, held against the JAX package's
``repro.faults`` and ``repro.core`` on the same inputs, on the CPU:

* plans: the JSON of either package's ``FaultPlan`` loads in the other
  with equal rules; rule checks and ``validate`` warnings are equal;
* the injector: ``always`` / ``nth`` / ``every`` / ``times`` /
  ``prob(seed)`` fire on the same calls as the reference's injector,
  with the same error classes, transience and messages;
* checkpoint/resume: ``Engine.run`` with ``checkpoint_every`` is
  bitwise equal to the run without it (PageRank, SSSP, components, both
  delivery paths); a run killed at ``checkpoint.chunk`` and resumed by
  a fresh Engine is bitwise equal to the uninterrupted run, its
  activity trace included; a corrupt or foreign snapshot restarts from
  superstep 0; the results equal the JAX package's checkpointed runs
  (SSSP and components bitwise, PageRank within 1e-5);
* the serving front-end's resilience (deadline, retry, give-up,
  bisect, breaker, supervisor, close): each case runs through both
  packages' ``Frontend`` on the same fakes and ``FakeClock`` and must
  resolve every future the same way; a chaos property does the same
  for random plans and traffic;
* the instrumented points of the compiled path fire on the same calls
  as the reference's, and on the CPU a permanent fused fault degrades
  to the ``xla`` twin as the reference's does.

The card's side (no degrade, typed errors, bitwise resume through the
kernel) is in ``tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.algorithms as jalg
import repro.faults as jfaults
from repro.core import Engine as JEngine
from repro.data import powerlaw_hypergraph as j_powerlaw
from repro.serve import Frontend as JFrontend
import repro_torch.algorithms as talg
import repro_torch.faults as tfaults
from repro_torch.core import Engine, HyperGraph, tree_leaves
from repro_torch.faults.checkpoint import (
    checkpointed_compute,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.serve import Frontend

PACKAGES = {
    "jax": (JFrontend, JEngine, jfaults),
    "torch": (Frontend, lambda: Engine(device="cpu"), tfaults),
}


def _carry(jhg):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu")


def _small(seed=0, nv=47, ne=33):
    return j_powerlaw(nv, ne, mean_cardinality=4, seed=seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _manifest(path):
    with open(f"{path}/manifest.json") as f:
        return json.load(f)


def _same(got, want, bitwise=True):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if bitwise:
            assert np.array_equal(a, b, equal_nan=True)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the taxonomy, plans and the injector
# --------------------------------------------------------------------------

def test_exports_and_taxonomy_match_the_reference():
    assert tfaults.__all__ == jfaults.__all__
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    for name in jfaults.__all__:
        ref, port = getattr(jfaults, name), getattr(tfaults, name)
        if isinstance(ref, type) and issubclass(ref, BaseException):
            assert [b.__name__ for b in port.__mro__] == [
                b.__name__ for b in ref.__mro__]
            assert port.__doc__ == ref.__doc__
    for kwargs in ({}, {"transient": False}, {"point": "execute"}):
        a = jfaults.InjectedFault("x", **kwargs)
        b = tfaults.InjectedFault("x", **kwargs)
        assert (b.point, b.transient, str(b)) == (a.point, a.transient, str(a))
        assert tfaults.is_transient(b) == jfaults.is_transient(a)
    for name in ("TransientExecuteError", "DeadlineExceeded", "PoisonQuery",
                 "CircuitOpen", "CheckpointError", "ReplicaLost",
                 "Overloaded", "FrontendClosed", "CorruptCacheEntry"):
        assert tfaults.is_transient(getattr(tfaults, name)("x")) == \
            jfaults.is_transient(getattr(jfaults, name)("x"))


def _plan(m):
    return m.FaultPlan((
        m.FaultRule(point="execute", trigger="nth", n=3, error="fatal"),
        m.FaultRule(point="serve.flush", trigger="prob", p=0.25, seed=7,
                    times=2),
        m.FaultRule(point="disk.read", trigger="every", n=2,
                    error="corrupt"),
        m.FaultRule(point="replica.crash", trigger="always", times=1),
    ))


def _fields(plan):
    return [(r.point, r.trigger, r.n, r.p, r.seed, r.times, r.error)
            for r in plan.rules]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_plan_json_round_trip_across_packages(direction):
    src, dst = ((jfaults, tfaults) if direction == "jax_to_torch"
                else (tfaults, jfaults))
    plan = _plan(src)
    text = plan.to_json()
    loaded = dst.FaultPlan.from_json(text)
    assert _fields(loaded) == _fields(plan)
    assert loaded.to_json() == text
    # dict and list forms too
    assert _fields(dst.FaultPlan.from_json(json.loads(text))) == _fields(plan)
    assert _fields(dst.FaultPlan.from_json(json.loads(text)["rules"])) == \
        _fields(plan)
    assert dst.FaultPlan.from_json(text) == dst.FaultPlan.from_json(text)


@pytest.mark.parametrize("kwargs", [
    {"point": "execute", "trigger": "sometimes"},
    {"point": "execute", "trigger": "nth"},
    {"point": "execute", "trigger": "every", "n": 0},
    {"point": "execute", "trigger": "prob"},
    {"point": "execute", "trigger": "prob", "p": 1.5},
    {"point": "execute", "error": "explosive"},
])
def test_rule_checks_match_the_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jfaults.FaultRule(**kwargs)
    with pytest.raises(ValueError) as got:
        tfaults.FaultRule(**kwargs)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown FaultRule fields"):
        tfaults.FaultRule.from_dict({"point": "execute", "when": "later"})


def test_validate_warnings_equal():
    rules = [{"point": p} for p in ("execute", "warp.core", "disk.read",
                                    "serve.flsh", "router.route")]
    want = jfaults.FaultPlan.from_json(rules).validate()
    got = tfaults.FaultPlan.from_json(rules).validate()
    assert got == want and len(got) == 2


def _fire_pattern(inj, point, n):
    out = []
    for _ in range(n):
        try:
            inj.maybe_raise(point, k=1)
            out.append(None)
        except RuntimeError as err:
            out.append((type(err).__name__, str(err),
                        getattr(err, "transient", None)))
    return out


@pytest.mark.parametrize("rule", [
    {"point": "a", "trigger": "always", "times": 2},
    {"point": "a", "trigger": "always", "error": "fatal"},
    {"point": "a", "trigger": "nth", "n": 3},
    {"point": "a", "trigger": "every", "n": 2, "times": 3},
    {"point": "a", "trigger": "prob", "p": 0.4, "seed": 11},
    {"point": "a", "trigger": "prob", "p": 0.4, "seed": 12, "times": 4},
    {"point": "a", "trigger": "prob", "p": 0.9, "error": "corrupt"},
])
def test_fire_patterns_equal_the_reference(rule):
    rules = [rule, {"point": "b", "trigger": "nth", "n": 100}]
    j = jfaults.FaultInjector.from_json({"rules": rules})
    t = tfaults.FaultInjector.from_json({"rules": rules})
    for point, n in (("a", 40), ("b", 3), ("z", 2)):
        assert _fire_pattern(t, point, n) == _fire_pattern(j, point, n)
    assert t.snapshot() == j.snapshot()
    assert t.fired() == j.fired() and t.calls("a") == j.calls("a")


@pytest.mark.parametrize("kind,cls,transient", [
    ("transient", "TransientExecuteError", True),
    ("fatal", "InjectedFault", False),
    ("corrupt", "CorruptCacheEntry", False),
])
def test_error_kinds_map_onto_the_taxonomy(kind, cls, transient):
    plan = {"rules": [{"point": "p", "error": kind}]}
    for m in (jfaults, tfaults):
        with pytest.raises(getattr(m, cls)) as err:
            m.FaultInjector.from_json(plan).maybe_raise("p", step=3)
        assert m.is_transient(err.value) is transient
        assert str(err.value) == ("injected " + kind + " fault at 'p' "
                                  "(call #1) ({'step': 3})")


# --------------------------------------------------------------------------
# checkpoint/resume
# --------------------------------------------------------------------------

# (name, spec factory over either package, bitwise vs the reference)
SPECS = [
    ("pagerank", lambda m, h: m.pagerank_spec(h, iters=8), False),
    ("sssp", lambda m, h: m.shortest_paths_spec(h, 0, 8), True),
    ("connected_components",
     lambda m, h: m.connected_components_spec(h, 8), True),
]


@pytest.mark.parametrize("delivery", ["xla", "pallas_fused"])
@pytest.mark.parametrize("name,make,bitwise", SPECS,
                         ids=[s[0] for s in SPECS])
def test_checkpointed_run_bitwise_equals_plain(tmp_path, name, make,
                                               bitwise, delivery):
    spec = make(talg, _carry(_small()))
    eng = Engine(device="cpu", collect_stats=True, delivery=delivery)
    plain = eng.run(spec)
    saved0 = eng.metrics.counter("faults.checkpoint.saved").value
    ck = eng.run(spec, checkpoint_every=3,
                 checkpoint_dir=str(tmp_path / "ck"))
    _same(ck.value, plain.value)
    _same(ck.superstep_stats, plain.superstep_stats)
    steps = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert steps[0] == "step_00000003"
    assert eng.metrics.counter("faults.checkpoint.saved").value - saved0 \
        == len(steps)
    assert ck.decision["measured"]["resumed_from"] == 0


@pytest.mark.parametrize("name,make,bitwise", SPECS,
                         ids=[s[0] for s in SPECS])
def test_kill_and_resume_bitwise_equals_uninterrupted(tmp_path, name, make,
                                                      bitwise):
    spec = make(talg, _carry(_small(seed=3, nv=90, ne=40)))
    baseline = Engine(device="cpu", collect_stats=True).run(spec)
    ckdir = str(tmp_path / "ck")
    inj = tfaults.FaultInjector(tfaults.FaultPlan((
        tfaults.FaultRule(point="checkpoint.chunk", trigger="nth", n=1,
                          error="fatal"),
    )))
    dead = Engine(device="cpu", collect_stats=True, fault_injector=inj)
    assert dead.fault_injector is inj
    with pytest.raises(tfaults.InjectedFault, match="checkpoint.chunk"):
        dead.run(spec, checkpoint_every=3, checkpoint_dir=ckdir)
    assert (tmp_path / "ck" / "step_00000003").exists()

    fresh = Engine(device="cpu", collect_stats=True)
    restored0 = fresh.metrics.counter("faults.checkpoint.restored").value
    resumed = fresh.run(spec, checkpoint_every=3, checkpoint_dir=ckdir)
    assert fresh.metrics.counter(
        "faults.checkpoint.restored").value - restored0 == 1
    _same(resumed.value, baseline.value)
    # the snapshot carries the trace so far: the whole trace is equal
    _same(resumed.superstep_stats, baseline.superstep_stats)
    m = resumed.decision["measured"]
    assert m["resumed_from"] == 3
    assert m["pairs_run"] == baseline.decision["measured"]["pairs_run"] - 3


def test_corrupt_checkpoint_restarts_from_zero(tmp_path):
    spec = talg.shortest_paths_spec(_carry(_small()), 0, 8)
    baseline = Engine(device="cpu").run(spec)
    junk = tmp_path / "ck" / "step_00000003"
    junk.mkdir(parents=True)
    (junk / "manifest.json").write_text("{ not json")
    eng = Engine(device="cpu")
    failed0 = eng.metrics.counter("faults.checkpoint.restore_failed").value
    res = eng.run(spec, checkpoint_every=3,
                  checkpoint_dir=str(tmp_path / "ck"))
    assert eng.metrics.counter(
        "faults.checkpoint.restore_failed").value - failed0 == 1
    _same(res.value, baseline.value)
    assert res.decision["measured"]["resumed_from"] == 0


@pytest.mark.parametrize("damage", ["bitrot", "foreign_shape", "dtype",
                                    "leaf_count"])
def test_snapshot_that_does_not_fit_restarts(tmp_path, damage):
    hg = _carry(_small())
    spec = talg.pagerank_spec(hg, iters=6)
    baseline = Engine(device="cpu", collect_stats=True).run(spec)
    ckdir = tmp_path / "ck"
    if damage == "foreign_shape":
        other = talg.pagerank_spec(_carry(_small(seed=1, nv=50, ne=30)), 6)
        Engine(device="cpu").run(other, checkpoint_every=3,
                                 checkpoint_dir=str(ckdir))
    else:
        Engine(device="cpu").run(spec, max_iters=6, checkpoint_every=3,
                                 checkpoint_dir=str(ckdir))
        path = latest_checkpoint(str(ckdir))
        manifest = _manifest(path)
        if damage == "bitrot":
            leaf = f"{path}/{manifest['leaves'][1]['file']}"
            arr = np.load(leaf)
            arr.reshape(-1)[0] += 1
            np.save(leaf, arr)
        elif damage == "dtype":
            manifest["leaves"][1]["dtype"] = "float16"
        else:
            manifest["leaves"].pop()
        with open(f"{path}/manifest.json", "w") as f:
            json.dump(manifest, f)
    eng = Engine(device="cpu", collect_stats=True)
    failed0 = eng.metrics.counter("faults.checkpoint.restore_failed").value
    res = eng.run(spec, checkpoint_every=3, checkpoint_dir=str(ckdir))
    assert eng.metrics.counter(
        "faults.checkpoint.restore_failed").value - failed0 == 1
    _same(res.value, baseline.value)
    _same(res.superstep_stats, baseline.superstep_stats)


def test_restore_raises_typed_on_a_mismatch(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32), "b": (3, True)}
    path = save_checkpoint(str(tmp_path), 7, tree)
    got, step = restore_checkpoint(path, tree)
    assert step == 7 and got["b"] == (3, True)
    assert torch.equal(got["a"], tree["a"])
    with pytest.raises(tfaults.CheckpointError, match="expected"):
        restore_checkpoint(path, {"a": torch.zeros(5), "b": (3, True)})


def test_bfloat16_leaf_is_saved_by_its_bits(tmp_path):
    x = torch.randn(17, 3).to(torch.bfloat16)
    tree = {"x": x, "step": 4, "halted": False}
    path = save_checkpoint(str(tmp_path), 2, tree)
    manifest = _manifest(path)
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "bool", "int32", "bfloat16"]
    assert [m["name"] for m in manifest["leaves"]] == [
        "['halted']", "['step']", "['x']"]
    got, step = restore_checkpoint(path, tree)
    assert step == 2 and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


@pytest.mark.parametrize("name,make,bitwise", SPECS,
                         ids=[s[0] for s in SPECS])
def test_checkpointed_runs_match_the_reference(tmp_path, name, make,
                                               bitwise):
    jhg = _small(seed=2, nv=60, ne=40)
    want = JEngine(collect_stats=True).run(
        make(jalg, jhg), checkpoint_every=3,
        checkpoint_dir=str(tmp_path / "j"))
    got = Engine(device="cpu", collect_stats=True).run(
        make(talg, _carry(jhg)), checkpoint_every=3,
        checkpoint_dir=str(tmp_path / "t"))
    _same(got.value, want.value, bitwise)
    _same(got.superstep_stats, want.superstep_stats)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_checkpointed_compute_matches_the_reference_function(tmp_path):
    from repro.faults.checkpoint import checkpointed_compute as j_ckpt

    jhg = _small(seed=4, nv=70, ne=30)
    jspec = jalg.shortest_paths_spec(jhg, 5, 10)
    tspec = talg.shortest_paths_spec(_carry(jhg), 5, 10)
    j_out, j_tr = j_ckpt(jspec.hg0, 10, jspec.initial_msg, jspec.v_program,
                         jspec.he_program, every=4,
                         ckpt_dir=str(tmp_path / "j"), return_stats=True)
    counters = {}
    t_out, t_tr = checkpointed_compute(
        tspec.hg0, 10, tspec.initial_msg, tspec.v_program, tspec.he_program,
        every=4, ckpt_dir=str(tmp_path / "t"), return_stats=True,
        counters=counters)
    _same((t_out.v_attr, t_out.he_attr), (j_out.v_attr, j_out.he_attr))
    _same(t_tr, j_tr)
    assert counters["halted"] and counters["resumed_from"] == 0


@pytest.mark.parametrize("name,make,bitwise", SPECS,
                         ids=[s[0] for s in SPECS])
def test_compiled_checkpointed_route_equals_the_executable(tmp_path, name,
                                                           make, bitwise):
    spec = make(talg, _carry(_small()))
    eng = Engine(device="cpu", collect_stats=True, delivery="pallas_fused")
    want = eng.compile(spec).run()
    ck = eng.compile(spec, checkpoint_every=3,
                     checkpoint_dir=str(tmp_path / "ck"))
    got = ck.run()
    _same(got.value, want.value)
    _same(got.superstep_stats, want.superstep_stats)
    assert got.decision["checkpointed"] == {
        "every": 3, "dir": str(tmp_path / "ck")}
    again = ck.run()  # resumes from the last snapshot: nothing left
    _same(again.value, want.value)


def test_clique_ignores_checkpoint_every_as_the_reference_does(tmp_path):
    jhg = _small()
    want = JEngine().run(jalg.vertex_pagerank_spec(jhg, iters=5),
                         representation="clique", checkpoint_every=2,
                         checkpoint_dir=str(tmp_path / "j"))
    got = Engine(device="cpu").run(
        talg.vertex_pagerank_spec(_carry(jhg), iters=5),
        representation="clique", checkpoint_every=2,
        checkpoint_dir=str(tmp_path / "t"))
    assert got.representation == want.representation == "clique"
    _same(got.value, want.value, bitwise=False)
    assert not (tmp_path / "t").exists() and not (tmp_path / "j").exists()


def test_config_checks_and_the_disk_cache_slot():
    from repro_torch.core import ExecutionConfig

    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        ExecutionConfig(checkpoint_every=0, checkpoint_dir="x")
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        ExecutionConfig(checkpoint_every=2)
    assert ExecutionConfig(checkpoint_every=2,
                           checkpoint_dir="x").checkpoint_every == 2
    # the store's slot: kept, and handed the Engine's injector
    from repro_torch.faults import FaultInjector
    from repro_torch.serve import DiskExecutableCache

    store, inj = DiskExecutableCache("unused", device="cpu"), FaultInjector()
    eng = Engine(device="cpu", disk_cache=store, fault_injector=inj)
    assert eng.disk_cache is store and store.fault_injector is inj
    assert eng.cache_stats()["disk"]["entries"] == 0


# --------------------------------------------------------------------------
# the compiled path's points, and the CPU's degrade to the xla twin
# --------------------------------------------------------------------------

def _point_calls(m, eng_factory, alg, hg, tmp_path):
    """Drive one call sequence through an Engine with an injector that
    only counts; returns its snapshot."""
    inj = m.FaultInjector(m.FaultPlan((
        m.FaultRule(point="unused", trigger="always"),)))
    eng = eng_factory(inj)
    comp = eng.compile(alg.shortest_paths_spec(hg, 0, 8),
                       delivery="pallas_fused")
    comp.warmup(batch_sizes=(8,))
    comp.run(query=3)
    comp.run_batch(np.arange(5, dtype=np.int32))
    eng.compile(alg.random_walk_spec(hg, iters=4),
                delivery="pallas_fused").run(query=1)
    eng.run(alg.pagerank_spec(hg, iters=7), checkpoint_every=3,
            checkpoint_dir=str(tmp_path))
    return inj.snapshot()


def test_instrumented_points_fire_on_the_reference_calls(tmp_path):
    jhg = _small()
    want = _point_calls(jfaults, lambda i: JEngine(fault_injector=i), jalg,
                        jhg, tmp_path / "j")
    got = _point_calls(
        tfaults, lambda i: Engine(device="cpu", fault_injector=i), talg,
        _carry(jhg), tmp_path / "t")
    assert got == want
    assert got["calls"]["execute"] == 3 and got["calls"]["layout.build"] == 2


def test_warmup_never_fires_execute():
    inj = tfaults.FaultInjector.from_json(
        {"rules": [{"point": "execute", "error": "fatal"}]})
    eng = Engine(device="cpu", fault_injector=inj)
    comp = eng.compile(talg.shortest_paths_spec(_carry(_small()), 0, 8),
                       delivery="xla")
    comp.warmup(batch_sizes=(8,))
    assert inj.calls("execute") == 0
    with pytest.raises(tfaults.InjectedFault, match="execute"):
        comp.run(query=2)  # already on xla: nothing to degrade to


def test_execute_fault_degrades_fused_to_xla_as_the_reference():
    jhg = _small()
    plan = {"rules": [{"point": "execute", "trigger": "nth", "n": 1,
                       "error": "fatal"}]}
    jeng = JEngine(fault_injector=jfaults.FaultInjector.from_json(plan))
    jgot = jeng.compile(jalg.shortest_paths_spec(jhg, 0, 12),
                        delivery="pallas_fused").run(query=3)
    eng = Engine(device="cpu",
                 fault_injector=tfaults.FaultInjector.from_json(plan))
    comp = eng.compile(talg.shortest_paths_spec(_carry(jhg), 0, 12),
                       delivery="pallas_fused")
    ref = Engine(device="cpu").compile(
        talg.shortest_paths_spec(_carry(jhg), 0, 12),
        delivery="xla").run(query=3)
    degraded0 = eng.metrics.counter("faults.delivery_degraded").value
    got = comp.run(query=3)
    _same(got.value, ref.value)
    _same(got.value, jgot.value)
    assert got.decision.get("degraded_from") == "pallas_fused" == \
        jgot.decision.get("degraded_from")
    assert eng.metrics.counter(
        "faults.delivery_degraded").value - degraded0 == 1
    again = comp.run(query=3)  # the nth=1 rule is spent: fused again
    _same(again.value, ref.value)
    assert "degraded_from" not in again.decision


def test_layout_fault_degrades_fused_to_xla_as_the_reference():
    jhg = _small()
    plan = {"rules": [{"point": "layout.build", "error": "fatal"}]}
    jgot = JEngine(fault_injector=jfaults.FaultInjector.from_json(plan)
                   ).compile(jalg.shortest_paths_spec(jhg, 0, 12),
                             delivery="pallas_fused").run(query=5)
    got = Engine(device="cpu",
                 fault_injector=tfaults.FaultInjector.from_json(plan)
                 ).compile(talg.shortest_paths_spec(_carry(jhg), 0, 12),
                           delivery="pallas_fused").run(query=5)
    _same(got.value, jgot.value)
    assert got.decision.get("degraded_from") == "pallas_fused"


def test_transient_execute_fault_is_not_degraded():
    inj = tfaults.FaultInjector.from_json(
        {"rules": [{"point": "execute", "trigger": "nth", "n": 1}]})
    eng = Engine(device="cpu", fault_injector=inj)
    comp = eng.compile(talg.shortest_paths_spec(_carry(_small()), 0, 8),
                       delivery="pallas_fused")
    with pytest.raises(tfaults.TransientExecuteError):
        comp.run(query=1)
    assert "degraded_from" not in comp.run(query=1).decision


# --------------------------------------------------------------------------
# the front-end's resilience, both packages on the same fakes
# --------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeResult:
    def __init__(self, value):
        self.value = value
        self.supersteps_executed = None


class FakeCompiled:
    """``run_batch`` double: rows are a pure function of the query."""

    def __init__(self, salt):
        self.salt = salt

    def _one(self, q):
        return {"out": np.asarray([q * 2 + self.salt, q], np.int64)}

    def run(self, query=None, hg=None):
        return FakeResult(self._one(int(query)))

    def run_batch(self, queries, hg=None):
        qs = np.asarray(queries)
        rows = [self._one(int(q)) for q in qs]
        return FakeResult({"out": np.stack([r["out"] for r in rows])})


class FlakyCompiled(FakeCompiled):
    """Fails transiently the first ``fail_first`` run_batch calls."""

    def __init__(self, salt, fail_first, errors):
        super().__init__(salt)
        self.fail_first = fail_first
        self.calls = 0
        self.errors = errors

    def run_batch(self, queries, hg=None):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise self.errors.TransientExecuteError(
                f"flaky call #{self.calls}")
        return super().run_batch(queries, hg=hg)


class PoisonCompiled(FakeCompiled):
    """Deterministically fails any batch containing ``poison``."""

    def __init__(self, salt, poison):
        super().__init__(salt)
        self.poison = poison

    def run_batch(self, queries, hg=None):
        if self.poison in set(np.asarray(queries).tolist()):
            raise RuntimeError(f"poisoned by {self.poison}")
        return super().run_batch(queries, hg=hg)


class Togglable(FakeCompiled):
    broken = True

    def run_batch(self, queries, hg=None):
        if self.broken:
            raise RuntimeError("hard down")
        return super().run_batch(queries, hg=hg)


def _outcome(fut):
    """How a future resolved, comparable across packages."""
    assert fut.done()
    err = fut.exception(timeout=0)
    if err is None:
        v = fut.result(timeout=0)
        return ("ok", v.value["out"].tolist(), v.flush_reason, v.batch_size,
                v.batch_bucket)
    cause = err.__cause__
    return ("err", type(err).__name__, str(err),
            None if cause is None else str(cause))


def _frontend(pkg, compiled, **kw):
    front, engine, _ = PACKAGES[pkg]
    kw.setdefault("clock", FakeClock())
    kw.setdefault("max_batch", 4)
    kw.setdefault("retry_backoff_ms", 0.0)
    fe = front(engine(), **kw)
    fe._sleep = lambda s: None   # retries without wall-clock waits
    fe.register("k", compiled)
    return fe


def _counter(fe, name):
    return fe.metrics.registry.counter(name).value


def _case_closed(pkg):
    fe = _frontend(pkg, FakeCompiled(10))
    f1, f2 = fe.submit("k", query=1), fe.submit("k", query=2)
    fe.close()
    out = [_outcome(f1), _outcome(f2)]
    errors = PACKAGES[pkg][2]
    with pytest.raises(errors.FrontendClosed):
        fe.submit("k", query=3)
    with pytest.raises(errors.FrontendClosed):
        fe.register("k2", FakeCompiled(11))
    snap = fe.stats()
    return out, (snap["errors"], snap["in_flight"])


def _case_deadline(pkg):
    fe = _frontend(pkg, FakeCompiled(10))
    late = fe.submit("k", query=1, timeout_ms=5.0)
    ok = fe.submit("k", query=2)
    fe.clock.t += 1.0              # blow way past the 5ms hard deadline
    fe.pump(drain=True)
    return [_outcome(late), _outcome(ok)], fe.stats()["in_flight"]


def _case_retry(pkg):
    flaky = FlakyCompiled(10, 2, PACKAGES[pkg][2])
    fe = _frontend(pkg, flaky, max_retries=2)
    before = _counter(fe, "faults.serve.retries")
    fut = fe.submit("k", query=5)
    fe.pump(drain=True)
    return [_outcome(fut)], (flaky.calls,
                             _counter(fe, "faults.serve.retries") - before)


def _case_give_up(pkg):
    flaky = FlakyCompiled(10, 10, PACKAGES[pkg][2])
    fe = _frontend(pkg, flaky, max_retries=2)
    fut = fe.submit("k", query=5)
    fe.pump(drain=True)
    return [_outcome(fut)], flaky.calls


def _case_bisect(pkg):
    fe = _frontend(pkg, PoisonCompiled(10, poison=2))
    before = _counter(fe, "faults.serve.bisects")
    futs = [fe.submit("k", query=q) for q in (0, 1, 2, 3)]
    fe.pump(drain=True)
    snap = fe.stats()
    return [_outcome(f) for f in futs], (
        _counter(fe, "faults.serve.bisects") - before, snap["completed"],
        snap["errors"], snap["in_flight"])


def _case_breaker(pkg):
    dbl = Togglable(10)
    fe = _frontend(pkg, dbl, breaker_threshold=2, breaker_cooldown_ms=1000.0)
    trips0 = _counter(fe, "faults.serve.breaker_trips")
    out = []
    for _ in range(2):             # two consecutive failures: trip
        fut = fe.submit("k", query=1)
        fe.pump(drain=True)
        out.append(_outcome(fut))
    fast = fe.submit("k", query=1)   # open: fail fast
    fe.pump(drain=True)
    out.append(_outcome(fast))
    dbl.broken = False               # cooldown elapses; the probe passes
    fe.clock.t += 2.0
    probe = fe.submit("k", query=7)
    fe.pump(drain=True)
    out.append(_outcome(probe))
    return out, (_counter(fe, "faults.serve.breaker_trips") - trips0,
                 fe.stats()["in_flight"])


def _case_error_fans_out(pkg):
    class Broken:
        def run_batch(self, queries, hg=None):
            raise RuntimeError("boom")

    fe = _frontend(pkg, Broken(), resilience=False)
    futs = [fe.submit("k", query=q) for q in (1, 2)]
    fe.pump(drain=True)
    return [_outcome(f) for f in futs], fe.stats()["errors"]


CASES = {
    "closed": _case_closed,
    "deadline": _case_deadline,
    "retry": _case_retry,
    "give_up": _case_give_up,
    "bisect": _case_bisect,
    "breaker": _case_breaker,
    "error_fans_out": _case_error_fans_out,
}


@pytest.mark.parametrize("case", list(CASES))
def test_frontend_resilience_resolves_as_the_reference(case):
    got = CASES[case]("torch")
    assert got == CASES[case]("jax")
    outcomes, _ = got
    assert outcomes  # every case resolves every future it submitted


def test_frontend_resilience_expected_outcomes():
    """The cases' own contracts, on the port alone."""
    o, _ = _case_deadline("torch")
    assert o[0][:2] == ("err", "DeadlineExceeded") and o[1][0] == "ok"
    o, (calls, retries) = _case_retry("torch")
    assert o[0][1] == [20, 5] and (calls, retries) == (3, 2)
    o, calls = _case_give_up("torch")
    assert o[0][1] == "TransientExecuteError" and calls == 3
    o, (bisects, done, errs, inflight) = _case_bisect("torch")
    assert o[2][:2] == ("err", "PoisonQuery") and "poisoned by 2" in o[2][3]
    assert [x[0] for x in o] == ["ok", "ok", "err", "ok"]
    assert bisects >= 1 and (done, errs, inflight) == (3, 1, 0)
    o, (trips, inflight) = _case_breaker("torch")
    assert [x[1] for x in o[:3]] == ["RuntimeError", "RuntimeError",
                                     "CircuitOpen"]
    assert o[3][0] == "ok" and (trips, inflight) == (1, 0)


@pytest.mark.parametrize("rule,expect", [
    ({"point": "serve.worker", "trigger": "nth", "n": 1}, "served"),
    ({"point": "serve.worker", "trigger": "always", "error": "fatal"},
     "InjectedFault"),
])
def test_worker_supervisor_restarts_and_bounds_requeues(rule, expect):
    inj = tfaults.FaultInjector.from_json({"rules": [rule]})
    fe = Frontend(Engine(device="cpu"), max_batch=4, max_delay_ms=1.0,
                  fault_injector=inj)
    fake = FakeCompiled(100)
    fe.register("k", fake)
    restarts0 = _counter(fe, "faults.serve.worker_restarts")
    try:
        fe.start()
        futs = [fe.submit("k", query=q) for q in (3, 4, 5)]
        for f in futs:
            f.exception(timeout=120)   # resolves; never hangs
    finally:
        fe.close()
    if expect == "served":
        for q, f in zip((3, 4, 5), futs):
            np.testing.assert_array_equal(f.result(timeout=0).value["out"],
                                          fake.run(query=q).value["out"])
        assert inj.fired("serve.worker") == 1
    else:
        for f in futs:
            with pytest.raises(tfaults.InjectedFault, match="serve.worker"):
                f.result(timeout=0)
    assert _counter(fe, "faults.serve.worker_restarts") - restarts0 >= 1
    assert fe.stats()["in_flight"] == 0


_CHAOS_RULE = st.tuples(
    st.sampled_from(["serve.flush", "serve.flush", "execute"]),
    st.sampled_from(["always", "nth", "every", "prob"]),
    st.integers(1, 3),                    # n (nth / every)
    st.floats(0.0, 0.6),                  # p (prob)
    st.integers(0, 99),                   # seed
    st.sampled_from([1, 2, 3, None]),     # times
    st.sampled_from(["transient", "transient", "fatal"]),
)

_CHAOS_TRAFFIC = st.lists(
    st.tuples(
        st.sampled_from(["sssp", "ppr"]),   # signature
        st.integers(0, 30),                 # query
        st.floats(0.0, 0.01),               # inter-arrival
        st.booleans(),                      # pump mid-stream?
    ),
    min_size=1, max_size=40,
)


def _chaos(pkg, raw_rules, events):
    front, engine, m = PACKAGES[pkg]
    rules = tuple(
        m.FaultRule(point=point, trigger=trigger, n=n, p=p, seed=seed,
                    times=times, error=error)
        for point, trigger, n, p, seed, times, error in raw_rules
    )
    inj = m.FaultInjector(m.FaultPlan(rules))
    clock = FakeClock()
    fe = front(engine(), max_batch=4, max_delay_ms=5.0, clock=clock,
               retry_backoff_ms=0.0, fault_injector=inj)
    fe._sleep = lambda s: None
    fakes = {"sssp": FakeCompiled(1000), "ppr": FakeCompiled(7000)}
    for key, fake in fakes.items():
        fe.register(key, fake)
    futs = []
    for key, query, dt, do_pump in events:
        clock.t += dt
        futs.append((key, query, fe.submit(key, query=query)))
        if do_pump:
            fe.pump()
    clock.t += 10.0
    fe.pump(drain=True)
    outcomes = []
    for key, query, fut in futs:
        out = _outcome(fut)          # NOTHING hangs, whatever the plan
        if out[0] == "ok":
            assert out[1] == fakes[key].run(query=query).value["out"].tolist()
        outcomes.append(out)
    snap = fe.stats()
    assert snap["in_flight"] == 0 and snap["submitted"] == len(futs)
    if not rules:
        assert all(o[0] == "ok" for o in outcomes)
    return outcomes, inj.snapshot()


@given(st.lists(_CHAOS_RULE, min_size=0, max_size=3), _CHAOS_TRAFFIC)
@settings(max_examples=25, deadline=None)
def test_chaos_every_request_resolves_as_the_reference(raw_rules, events):
    assert _chaos("torch", raw_rules, events) == \
        _chaos("jax", raw_rules, events)
