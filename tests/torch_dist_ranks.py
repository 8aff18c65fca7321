"""The rank side of ``tests/test_torch_distributed.py``.

``run_cases`` is what each of the four spawned ``gloo`` ranks runs: every
case of the distributed tests at once, through the port alone (this
module imports ``repro_torch`` and never JAX, so a rank does not start
it).  Every rank builds the same hypergraphs and plans from the same
seeds; rank 0 pickles the results for the parametrised tests, which hold
them against the JAX package in the pytest process.
"""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

# The reference test's strategies and algorithms
# (tests/test_distributed.py).
STRATEGIES = ("random_vertex_cut", "random_both_cut", "hybrid_hyperedge_cut",
              "greedy_vertex_cut")
ALGORITHMS = ("pagerank", "pr_entropy", "labelprop", "sssp", "randwalk",
              "cc")
BACKENDS = ("replicated", "sharded")
DELIVERIES = ("xla", "pallas_fused")
MONOIDS = ("sum", "max", "min", "or")
QUERIES = (0, 1, 5, 9)
CENSUS = ("dblp", 0.0015, 0)      # regime, scale, seed
RUNS = ("apache", 0.04, 3)


def specs(alg, hg):
    """The reference test's specs, by name, for either package's
    ``algorithms`` module."""
    return {
        "pagerank": alg.pagerank_spec(hg, iters=6),
        "pr_entropy": alg.pagerank_entropy_spec(hg, iters=6),
        "labelprop": alg.label_propagation_spec(hg, iters=8),
        "sssp": alg.shortest_paths_spec(hg, source=1, max_iters=16),
        "randwalk": alg.random_walk_spec(hg, iters=6),
        "cc": alg.connected_components_spec(hg, max_iters=32),
    }


def leaves_np(value):
    from repro_torch.core import tree_leaves

    return [leaf.cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in tree_leaves(value)]


def _result(res):
    out = {"value": leaves_np(res.value),
           "supersteps": res.decision["measured"].get("supersteps")}
    if res.superstep_stats is not None:
        out["stats"] = leaves_np(res.superstep_stats)
    return out


def _engine_runs(mesh, hg, out):
    import repro_torch.algorithms as talg
    from repro_torch.core import Engine
    from repro_torch.partition import partition

    by_alg = specs(talg, hg)
    for strat in STRATEGIES:
        plan = partition(strat, hg, mesh.size(), **(
            {"chunk": 32} if "greedy" in strat else {}))
        out["plans"][strat] = plan.edge_part
        for backend in BACKENDS:
            for delivery in DELIVERIES:
                eng = Engine(plan=plan, mesh=mesh, device="cpu",
                             representation="bipartite", backend=backend,
                             delivery=delivery, collect_stats=True)
                for name, spec in by_alg.items():
                    res = eng.run(spec)
                    assert res.backend == backend
                    assert res.config.delivery == delivery
                    out["runs"][(strat, name, backend, delivery)] = \
                        _result(res)


def _scatter(mesh, out):
    """Each monoid through the reduce-scatter and through ``all_reduce``
    + slice, on per-rank random partials."""
    from repro_torch.core import Program
    from repro_torch.core.distributed import (
        DistContext,
        _cross_combine,
        _cross_combine_scatter,
    )

    ctx = DistContext.for_mesh(mesh, "data", 1, 1, "sharded")
    rng = np.random.default_rng(100 + ctx.rank)
    for name in MONOIDS:
        shape = (8 * ctx.n_parts, 3)
        if name == "or":
            partial = torch.as_tensor(rng.random(shape) < 0.2)
        else:
            partial = torch.as_tensor(
                rng.standard_normal(shape).astype(np.float32))
        prog = Program(procedure=None, combiner=name)
        got = {
            "reduce_scatter": _cross_combine_scatter(
                prog, partial.clone(), ctx).numpy(),
            "all_reduce": ctx.block(
                _cross_combine(prog, partial.clone(), ctx)).numpy(),
        }
        gathered = [None] * ctx.n_parts
        dist.all_gather_object(gathered, got)
        out["scatter"][name] = gathered


def _census(mesh, out):
    from repro_torch.core import AnalyticsSpec, Engine
    from repro_torch.data import make_dataset
    from repro_torch.kernels.isect import isect_cuda, isect_fused_cuda

    regime, scale, seed = CENSUS
    hg = make_dataset(regime, scale, seed=seed, device="cpu")
    eng = Engine(mesh=mesh, device="cpu")
    res = eng.analyze(AnalyticsSpec(hg, mode="exact"))
    out["census"] = {
        "backend": res.backend, "kernel": res.kernel,
        "fields": {f.name: getattr(res.value, f.name)
                   for f in dataclasses.fields(res.value)},
        "calls": res.decision["measured"]["intersect_calls"],
        "launches": (isect_cuda.launches, isect_fused_cuda.launches),
    }
    pairs = eng.analyze(AnalyticsSpec(hg, task="pair_intersections"),
                        representation="bipartite")
    out["census"]["pairs"] = pairs.value


def _checkpoint(mesh, hg, plan, ck_dir, out):
    import repro_torch.algorithms as talg
    import repro_torch.faults as tfaults
    from repro_torch.core import Engine

    spec = talg.pagerank_spec(hg, iters=8)
    kw = dict(plan=plan, mesh=mesh, device="cpu", backend="sharded",
              delivery="pallas_fused", collect_stats=True)
    whole = Engine(**kw).run(spec)
    inj = tfaults.FaultInjector(tfaults.FaultPlan((
        tfaults.FaultRule(point="checkpoint.chunk", trigger="nth", n=2,
                          error="fatal"),
    )))
    try:
        Engine(fault_injector=inj, **kw).run(
            spec, checkpoint_every=3, checkpoint_dir=ck_dir)
        cut = None
    except tfaults.InjectedFault as err:
        cut = str(err)
    snapshots = sorted(os.listdir(ck_dir))
    resumed = Engine(**kw).run(spec, checkpoint_every=3,
                               checkpoint_dir=ck_dir)
    out["checkpoint"] = {
        "whole": _result(whole), "resumed": _result(resumed), "cut": cut,
        "snapshots": snapshots,
        "resumed_from": resumed.decision["measured"]["resumed_from"],
    }


def _compiled(mesh, hg, plan, out):
    import repro_torch.algorithms as talg
    from repro_torch.core import Engine

    for backend in BACKENDS:
        for name in ("sssp", "randwalk"):
            spec = specs(talg, hg)[name]
            eng = Engine(plan=plan, mesh=mesh, device="cpu",
                         backend=backend, delivery="pallas_fused",
                         collect_stats=True)
            compiled = eng.compile(spec)
            out["compiled"][(backend, name)] = {
                "engine_run": _result(eng.run(spec)),
                "run": _result(compiled.run()),
                "queries": [_result(compiled.run(query=q))
                            for q in QUERIES],
                "batch": _result(compiled.run_batch(np.asarray(QUERIES))),
                "traces": eng.cache_stats()["traces"],
                "partition": compiled.run().partition,
            }


def pick_times(rank):
    """The delivery pair's times rank ``rank``'s timer reports: alone,
    even ranks would pick the fused lowering and odd ranks ``xla`` (its
    lead over 10%)."""
    return 1.0 + 0.01 * rank, 0.9 if rank % 2 == 0 else 1.2


def _delivery_pick(mesh, hg, out):
    """``Engine.resolve`` of a 256-byte-row spec with the card's
    lowering forced and each rank's timer reporting ``pick_times``:
    every rank's pick, measured times and timer calls, gathered."""
    from repro_torch.algorithms import AlgorithmSpec
    from repro_torch.core import Engine, Program, executor
    from repro_torch.partition import partition

    rank = dist.get_rank()
    calls = []

    def timer(xla_pair, fused_pair, device):
        calls.append(device)
        return pick_times(rank)

    prog = Program(procedure=None, combiner="sum")
    spec = AlgorithmSpec(hg0=hg, initial_msg=torch.zeros(64),
                         v_program=prog, he_program=prog, max_iters=1,
                         extract=lambda o: o)
    saved = executor.select_lowering, executor.time_in_turns
    executor.select_lowering = lambda device: "cuda"
    executor.time_in_turns = timer
    try:
        plan = partition("random_vertex_cut", hg, mesh.size())
        eng = Engine(plan=plan, mesh=mesh, device="cpu")
        mine = {}
        for backend in BACKENDS:
            resolved, _, decision = eng.resolve(spec, backend=backend)
            mine[backend] = (resolved.delivery,
                             decision["delivery"]["measured_ms"])
        mine["calls"] = len(calls)
    finally:
        executor.select_lowering, executor.time_in_turns = saved
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out["delivery_pick"] = every


def fail_or_hang(rank, world):
    """Rank 1 fails at once; every other rank would run for ten minutes."""
    import sys
    import time

    if rank == 1:
        sys.exit(3)
    time.sleep(600)


def run_cases(rank, world, store_dir, out_dir):
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import init_local_group, make_host_mesh
    from repro_torch.partition import partition

    init_local_group(rank, world, store_dir, "cpu", timeout_s=60.0)
    try:
        mesh = make_host_mesh(world)
        regime, scale, seed = RUNS
        hg = make_dataset(regime, scale, seed=seed, device="cpu")
        out = {"plans": {}, "runs": {}, "scatter": {}, "compiled": {},
               "threads": torch.get_num_threads(),
               "env": {k: os.environ.get(k) for k in
                       ("MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE")}}
        _engine_runs(mesh, hg, out)
        _scatter(mesh, out)
        _census(mesh, out)
        plan = partition("random_vertex_cut", hg, world)
        _checkpoint(mesh, hg, plan, os.path.join(out_dir, "ck"), out)
        _compiled(mesh, hg, plan, out)
        _delivery_pick(mesh, hg, out)
        import sys

        out["jax_imported"] = "jax" in sys.modules
        dist.barrier()
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
