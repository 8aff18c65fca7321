"""The distributed backends of the port, held against the JAX package on
the CPU.

Four ranks, one spawn: a module fixture spawns ONE group of four
``gloo`` ranks (``launch.mesh.spawn_ranks``: one thread each, a 180 s
deadline, the group's 60 s timeout), which runs every case of
``tests/torch_dist_ranks.py`` at once while this process computes the
JAX package's answers; rank 0 writes the results under
``tmp_path_factory``.  The parametrised tests then hold:

* ``Engine(plan=, mesh=).run`` of the reference test's 4 strategies x 6
  algorithms (``tests/test_distributed.py``, greedy with ``chunk=32``)
  x both backends x both deliveries (``xla``, and ``pallas_fused``: the
  sliced-ELL lowering over each rank's shard layout on the CPU) against
  the JAX package's local engine on Apache 0.04, with the reference's
  contract: ``allclose(rtol=1e-5, atol=1e-5)`` for PageRank, entropy and
  the random walk, bitwise for SSSP, label propagation and components,
  and equal activity traces;
* the reduce-scatter of ``_cross_combine_scatter`` against
  ``all_reduce`` + slice, for every monoid;
* the sharded census (``Engine.analyze`` with a mesh) against the
  reference's census, field for field;
* a checkpointed sharded PageRank cut by the injector and resumed,
  bitwise against the uninterrupted distributed run;
* compiled ``run`` / ``run_batch`` on both backends against
  ``Engine.run`` and sequential queries;
* one delivery pick on every rank where the card's pick is measured
  and each rank's timer reports other times (the lowering forced to
  ``cuda``, the timer injected).

World size 1, in this process: a fixture forms a group with a
``FileStore`` in ``tmp_path`` and destroys it; under it the reference's
error messages and ``explain``'s backend and partition axes, key for
key.  The launcher's ``--devices 4 --device cpu`` runs in one
subprocess beside the reference launcher's ``--devices 4``.

Nothing here writes ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE`` into this process's environment, and the module's
teardown asserts no process group is left behind.
"""
import os
import pickle
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.algorithms as jalg
from repro.core import AnalyticsSpec as JAnalyticsSpec
from repro.core import Engine as JEngine
from repro.data import make_dataset as j_make
from repro.partition import partition as j_partition
import repro_torch.algorithms as talg
from repro_torch.core import Engine, HyperGraph
from repro_torch.core.executor import measured_pick
from repro_torch.launch.mesh import (
    init_local_group,
    make_host_mesh,
    spawn_ranks,
)

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

WORLD = 4
FLOAT_SUMS = ("pagerank", "pr_entropy", "randwalk")
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_leaves(value):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(value)]


def _jax_answers():
    """The JAX package's local answers to every case the ranks run."""
    regime, scale, seed = ranks.RUNS
    jhg = j_make(regime, scale=scale, seed=seed)
    eng = JEngine(representation="bipartite", backend="local",
                  delivery="xla", collect_stats=True)
    runs = {}
    for name, spec in ranks.specs(jalg, jhg).items():
        res = eng.run(spec)
        runs[name] = {"value": _np_leaves(res.value),
                      "stats": _np_leaves(res.superstep_stats)}
    pr8 = eng.run(jalg.pagerank_spec(jhg, iters=8))
    runs["pagerank8"] = {"value": _np_leaves(pr8.value),
                         "stats": _np_leaves(pr8.superstep_stats)}
    plans = {}
    for strat in ranks.STRATEGIES:
        kw = {"chunk": 32} if "greedy" in strat else {}
        plans[strat] = j_partition(strat, jhg, WORLD, **kw).edge_part
    c_regime, c_scale, c_seed = ranks.CENSUS
    chg = j_make(c_regime, scale=c_scale, seed=c_seed)
    census = JEngine().analyze(JAnalyticsSpec(chg, mode="exact")).value
    pairs = JEngine().analyze(
        JAnalyticsSpec(chg, task="pair_intersections"),
        representation="bipartite").value
    return {"runs": runs, "plans": plans, "census": census, "pairs": pairs}


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """``(rank results, JAX answers)``: the one spawn of four ranks runs
    in a thread while the JAX package computes its answers."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    env0 = {k: os.environ.get(k) for k in ENV_KEYS}
    errors = []

    def spawn():
        try:
            spawn_ranks(ranks.run_cases, WORLD,
                        (os.path.join(out_dir, "store"), out_dir),
                        deadline_s=180.0)
        except Exception as err:  # re-raised below, in this thread
            errors.append(err)

    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        jax_side = _jax_answers()
    finally:
        worker.join()
    if errors:
        raise errors[0]
    with open(os.path.join(out_dir, "results.pkl"), "rb") as f:
        got = pickle.load(f)
    assert {k: os.environ.get(k) for k in ENV_KEYS} == env0
    yield got, jax_side
    assert not dist.is_initialized()


def test_ranks_ran_clean(answers):
    got, _ = answers
    assert got["threads"] == 1
    assert got["env"] == {k: None for k in ENV_KEYS}
    assert got["jax_imported"] is False


@pytest.mark.parametrize("strategy", ranks.STRATEGIES)
def test_rank_plans_are_the_reference_plans(answers, strategy):
    got, want = answers
    assert np.array_equal(got["plans"][strategy], want["plans"][strategy])


CASES = [(s, a, b, d) for s in ranks.STRATEGIES for a in ranks.ALGORITHMS
         for b in ranks.BACKENDS for d in ranks.DELIVERIES]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_distributed_run_matches_jax_local(answers, case):
    got, want = answers
    res = got["runs"][case]
    ref = want["runs"][case[1]]
    assert len(res["value"]) == len(ref["value"])
    for a, b in zip(res["value"], ref["value"]):
        assert a.shape == b.shape
        if case[1] in FLOAT_SUMS:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(res["stats"], ref["stats"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("monoid", ranks.MONOIDS)
def test_scatter_equals_all_reduce_and_slice(answers, monoid):
    got, _ = answers
    for per_rank in got["scatter"][monoid]:
        have, want = per_rank["reduce_scatter"], per_rank["all_reduce"]
        if monoid == "sum":
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6)
        else:
            assert have.dtype == want.dtype
            assert np.array_equal(have, want)


def test_ranks_agree_on_a_measured_delivery_pick(answers):
    """Alone, even ranks would pick the fused lowering and odd ranks
    ``xla``; with a mesh every rank takes each lowering's largest time
    and so one pick, on both backends, from one measurement a rank."""
    got, _ = answers
    per_rank = got["delivery_pick"]
    assert len(per_rank) == WORLD
    own = [ranks.pick_times(r) for r in range(WORLD)]
    assert {measured_pick(x, f) for x, f in own} == {"xla", "pallas_fused"}
    want_ms = {"xla": max(x for x, _ in own),
               "pallas_fused": max(f for _, f in own)}
    want = measured_pick(want_ms["xla"], want_ms["pallas_fused"])
    assert want == "xla"
    for mine in per_rank:
        assert mine["calls"] == 1
        for backend in ranks.BACKENDS:
            assert mine[backend] == (want, want_ms)


def test_sharded_census_matches_jax(answers):
    got, want = answers
    census = got["census"]
    assert census["backend"] == "sharded"
    ref = want["census"]
    for name, value in census["fields"].items():
        r = getattr(ref, name)
        if isinstance(value, np.ndarray):
            assert value.dtype == np.asarray(r).dtype
            assert np.array_equal(value, np.asarray(r)), name
        else:
            assert value == r, name
    assert census["calls"] > 0
    for a, b in zip(census["pairs"], want["pairs"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_checkpointed_run_resumes_bitwise(answers):
    got, want = answers
    ck = got["checkpoint"]
    assert "checkpoint.chunk" in ck["cut"]
    assert ck["snapshots"] == ["step_00000003", "step_00000006"]
    assert ck["resumed_from"] == 6
    for a, b in zip(ck["resumed"]["value"] + ck["resumed"]["stats"],
                    ck["whole"]["value"] + ck["whole"]["stats"]):
        assert np.array_equal(a, b)
    for a, b in zip(ck["whole"]["value"], want["runs"]["pagerank8"]["value"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


COMPILED = [(b, a) for b in ranks.BACKENDS for a in ("sssp", "randwalk")]


@pytest.mark.parametrize("case", COMPILED, ids=["-".join(c) for c in COMPILED])
def test_compiled_run_and_batch_match_engine_run(answers, case):
    got, want = answers
    res = got["compiled"][case]
    exact = case[1] == "sssp"

    def same(a, b):
        if exact:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    assert res["partition"] == "random_vertex_cut"
    for a, b in zip(res["run"]["value"], res["engine_run"]["value"]):
        same(a, b)
    for a, b in zip(res["run"]["value"], want["runs"][case[1]]["value"]):
        same(a, b)
    for i, single in enumerate(res["queries"]):
        for a, b in zip(res["batch"]["value"], single["value"]):
            same(a[i], b)
        for a, b in zip(res["batch"]["stats"], single["stats"]):
            assert np.array_equal(a[i], b)
    # one executable per path on the CPU: the query-bound single, the
    # batch of 8, and for the random walk (no default query) the unbound
    # single of run()
    assert res["traces"] == {"sssp": 2, "randwalk": 3}[case[1]]


# --------------------------------------------------------------------------
# world size 1, in this process
# --------------------------------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    env0 = {k: os.environ.get(k) for k in ENV_KEYS}
    init_local_group(0, 1, str(tmp_path / "store"), "cpu", timeout_s=30.0)
    try:
        yield make_host_mesh(1)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    assert {k: os.environ.get(k) for k in ENV_KEYS} == env0


def _pair_of_specs():
    jhg = j_make("dblp", scale=0.002, seed=0)
    thg = HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                jhg.n_hyperedges, device="cpu")
    return (jalg.pagerank_spec(jhg, iters=4), talg.pagerank_spec(thg,
                                                                 iters=4))


def _jax_mesh():
    from repro.launch.mesh import make_host_mesh as j_mesh

    return j_mesh(1)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_errors_match_jax(world1):
    jspec, tspec = _pair_of_specs()
    jmesh = _jax_mesh()
    for backend in ("replicated", "sharded"):
        msgs = [_message(lambda: JEngine(backend=backend).resolve(jspec)),
                _message(lambda: Engine(device="cpu", backend=backend)
                         .resolve(tspec))]
        assert msgs[0] == msgs[1] and "needs a mesh" in msgs[0]
    jplan = j_partition("random_vertex_cut", jspec.hg0, 2)
    from repro_torch.partition import partition

    tplan = partition("random_vertex_cut", tspec.hg0, 2)
    msgs = [_message(lambda: JEngine(plan=jplan, mesh=jmesh,
                                     backend="replicated").resolve(jspec)),
            _message(lambda: Engine(plan=tplan, mesh=world1, device="cpu",
                                    backend="replicated").resolve(tspec))]
    assert msgs[0] == msgs[1] == "plan has 2 partitions but mesh['data'] = 1"
    vj = jalg.vertex_pagerank_spec(jspec.hg0, iters=3)
    vt = talg.vertex_pagerank_spec(tspec.hg0, iters=3)
    msgs = [_message(lambda: JEngine(mesh=jmesh, representation="clique")
                     .run(vj)),
            _message(lambda: Engine(mesh=world1, device="cpu",
                                    representation="clique").run(vt))]
    assert msgs[0] == msgs[1] and "cannot use the supplied mesh" in msgs[0]
    # auto pins bipartite with a mesh, with the reference's reason
    jres = JEngine(mesh=jmesh).resolve(vj)[2]["representation"]
    tres = Engine(mesh=world1, device="cpu").resolve(vt)[2]["representation"]
    assert jres == tres
    chg = j_make("dblp", scale=0.0015, seed=0)
    thg = HyperGraph.from_numpy(chg.src, chg.dst, chg.n_vertices,
                                chg.n_hyperedges, device="cpu")
    from repro_torch.core import AnalyticsSpec

    msgs = [_message(lambda: JEngine(mesh=jmesh, backend="replicated")
                     .resolve_analytics(JAnalyticsSpec(chg))),
            _message(lambda: Engine(mesh=world1, device="cpu",
                                    backend="replicated")
                     .resolve_analytics(AnalyticsSpec(thg)))]
    assert msgs[0] == msgs[1] and "does not apply" in msgs[0]
    msgs = [_message(lambda: JEngine(backend="sharded")
                     .resolve_analytics(JAnalyticsSpec(chg))),
            _message(lambda: Engine(device="cpu", backend="sharded")
                     .resolve_analytics(AnalyticsSpec(thg)))]
    assert msgs[0] == msgs[1] and "needs a mesh" in msgs[0]


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-6), path
    else:
        assert a == b, path


@pytest.mark.parametrize("overrides", [
    {}, {"backend": "replicated"}, {"partition_strategy": "random_both_cut"},
    {"backend": "local"},
], ids=["auto", "replicated", "pinned_strategy", "local"])
def test_explain_partitioning_axes_match_jax(world1, overrides):
    jspec, tspec = _pair_of_specs()
    jex = JEngine(mesh=_jax_mesh(), delivery="xla").explain(jspec,
                                                            **overrides)
    tex = Engine(mesh=world1, device="cpu", delivery="xla").explain(
        tspec, **overrides)
    for axis in ("backend", "partition"):
        _close(tex["axes"][axis], jex["axes"][axis], axis)
    assert tex["config"].backend == jex["config"].backend
    assert tex["config"].partition_strategy == \
        jex["config"].partition_strategy
    assert tex["config"].n_parts == jex["config"].n_parts


def test_world1_run_and_compiled_equal_local(world1):
    _, tspec = _pair_of_specs()
    local = Engine(device="cpu", delivery="pallas_fused").run(tspec)
    for backend in ("replicated", "sharded"):
        eng = Engine(mesh=world1, device="cpu", backend=backend,
                     delivery="pallas_fused")
        res = eng.run(tspec)
        assert res.backend == backend and res.partition is not None
        for a, b in zip(res.value, local.value):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        comp = eng.compile(tspec).run()
        for a, b in zip(comp.value, res.value):
            assert torch.equal(a, b)


def test_world1_rank_shard_is_built_once(world1):
    _, tspec = _pair_of_specs()
    eng = Engine(mesh=world1, device="cpu", backend="sharded",
                 delivery="pallas_fused")
    first = eng.run(tspec)
    shard = eng._rank_shard_cache[-1][-1]
    second = eng.run(tspec)
    assert len(eng._rank_shard_cache) == 1
    assert eng._rank_shard_cache[-1][-1] is shard
    for a, b in zip(first.value, second.value):
        assert torch.equal(a, b)


def test_spawn_ranks_without_deadline_kills_the_rest_when_one_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        spawn_ranks(ranks.fail_or_hang, 2)
    assert time.monotonic() - t0 < 60.0


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", line)]


def test_launcher_devices_matches_jax():
    args = ["--algorithm", "pagerank", "--regime", "dblp", "--scale",
            "0.002", "--devices", "4", "--backend", "auto", "--partition",
            "auto"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    # One after the other, the reference's XLA on one thread: the suite's
    # other workers keep their cores (the launcher's ranks run on one
    # thread each).
    commands = {
        "torch": ([sys.executable, "-m", "repro_torch.launch.hypergraph",
                   *args, "--device", "cpu"], env),
        "jax": ([sys.executable, "-m", "repro.launch.hypergraph", *args],
                {**env, "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1"}),
    }
    outs = {}
    for name, (cmd, cmd_env) in commands.items():
        proc = subprocess.run(cmd, cwd=ROOT, env=cmd_env, text=True,
                              capture_output=True, timeout=180)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[name] = proc.stdout
    lines = {name: {ln.split(":")[0].strip(): ln for ln in out.splitlines()}
             for name, out in outs.items()}
    for key in ("dblp", "plan"):
        assert lines["torch"][key].split(" device=")[0] == lines["jax"][key]
    design = re.search(r"backend=(\w+) partition=(\w+)",
                       lines["torch"]["design point"]).groups()
    assert design == re.search(r"backend=(\w+) partition=(\w+)",
                               lines["jax"]["design point"]).groups()
    for axis in ("representation", "backend", "partition"):
        assert lines["torch"][axis] == lines["jax"][axis]
    np.testing.assert_allclose(_numbers(lines["torch"]["result"]),
                               _numbers(lines["jax"]["result"]), rtol=1e-5)
    # only rank 0 prints
    assert outs["torch"].count("design point") == 1
