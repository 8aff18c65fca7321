"""Hypergraph query serving: replay a mixed trace through the serve tier
(the port's counterpart of the JAX package's
``repro.launch.serve_hypergraph``).

Replays a mixed SSSP / PPR (random-walk) request trace against one
generated dataset, through ``repro_torch.serve.Frontend`` over
``Engine.compile``, on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve_hypergraph \
      --regime dblp --scale 1.0 --requests 200 \
      --max-batch 16 --max-delay-ms 5 --verify 8

Flags of note: ``--mix`` sets the SSSP fraction of the trace;
``--warm`` (the default) makes every batch bucket up to ``--max-batch``
before the front-end starts (the JAX package's launcher warms
``--max-batch`` alone), and ``--no-warm`` skips it (first requests then
pay the build and, on the card, the CUDA-graph capture on the worker);
``--verify`` cross-checks a sample of served results against sequential
``CompiledAlgorithm.run`` under the port's parity rule (SSSP bitwise,
PPR within 1e-5 relative: its batched float sums may associate
differently); ``--fault-plan`` (inline JSON or a file path) arms a
``FaultPlan`` of scheduled failures — the chaos replay: every request
still resolves (result or typed error), successes still agree, and the
per-point calls/fired report prints after the run, e.g.::

  --fault-plan '{"rules": [{"point": "execute", "trigger": "every",
                            "n": 7, "error": "transient"}]}'

``--replicas N`` serves the trace through N replica processes behind
the heartbeat-failover ``Router`` (``repro_torch.serve.router``), all on
the same device: the parent warms the shared store (``--cache-dir``,
default ``$REPRO_CACHE_DIR`` or ``.repro_cache/``), each replica boots
from its records with ``require_no_retrace`` and takes a quarter of the
card divided by N for its executable cache, and the parent stays the
fault-free ``--verify`` oracle; a ``--fault-plan`` is armed on the
router (``router.route``) and inside every replica, and its report
sums the router's and every replica instance's calls and fires::

  python -m repro_torch.launch.serve_hypergraph --replicas 2 \
      --cache-dir /tmp/store --warm --verify 8 \
      --fault-plan '{"rules": [{"point": "replica.crash",
                                "trigger": "nth", "n": 20}]}'

The store holds warmup records, not executables: a CUDA graph cannot be
saved, so every replica captures its graphs at boot, and a record says
that doing so is expected.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

def build_paths(regime: str = "dblp", scale: float = 0.003,
                seed: int = 0, iters: int = 12, device=None) -> dict:
    """The served paths: SSSP from a bound source and the personalized
    walk over one seeded dataset, plus each path's warm-up query."""
    from repro_torch import algorithms as alg
    from repro_torch.data import make_dataset

    hg = make_dataset(regime, scale=scale, seed=seed, device=device)
    return {
        "hg": hg,
        "specs": {
            "sssp": alg.shortest_paths_spec(hg, source=0, max_iters=iters),
            "ppr": alg.random_walk_spec(hg, iters=iters),
        },
        "warm_queries": [0, 0],  # ppr has no query0; seed vertex 0
    }


def batch_buckets(max_batch: int) -> tuple[int, ...]:
    """Every batch bucket a flush of 1 to ``max_batch`` requests pads
    to (``serving.bucket_dim`` over ``BATCH_FLOOR``)."""
    from repro_torch.core.serving import BATCH_FLOOR, bucket_dim

    return tuple(sorted({bucket_dim(b, floor=BATCH_FLOOR)
                         for b in range(1, max_batch + 1)}))


def agrees(key: str, a, b) -> bool:
    """The port's parity rule for a served value against a sequential
    run: SSSP bitwise (NaN positions included), PPR within 1e-5
    relative."""
    import torch

    from repro_torch.core import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if key == "sssp":
            if not torch.equal(x.isnan(), y.isnan()):
                return False
            keep = ~x.isnan()
            if not torch.equal(x[keep], y[keep]):
                return False
        else:
            rel = (x - y).abs() / y.abs().clamp_min(1e-30)
            if not bool((rel <= 1e-5).all()):
                return False
    return True


def make_trace(n_vertices: int, requests: int, mix: float, seed: int):
    """``requests`` (key, query vertex) pairs: SSSP with probability
    ``mix``, else PPR; vertices uniform (``numpy`` generator ``seed``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng, [
        ("sssp" if rng.random() < mix else "ppr",
         int(rng.integers(0, n_vertices)))
        for _ in range(requests)
    ]


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--regime", default="dblp",
                    help="dataset regime (apache/dblp/friendster/orkut)")
    ap.add_argument("--scale", type=float, default=0.003)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=12,
                    help="superstep budget per query")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    ap.add_argument("--requests", type=int, default=200,
                    help="trace length (mixed across algorithms)")
    ap.add_argument("--mix", type=float, default=0.6,
                    help="fraction of the trace that is SSSP "
                         "(the rest is PPR / random-walk)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="coalescing batch bucket per registered path")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="max queue wait before a partial flush")
    ap.add_argument("--adaptive-delay", action="store_true",
                    help="let the front-end adapt the flush deadline "
                         "from the observed wait/execute split "
                         "(bounded EWMA controller; --max-delay-ms "
                         "becomes the upper clamp)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record engine + serve trace spans; export "
                         "Chrome-trace JSON here (loadable in Perfetto)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the unified metrics-registry snapshot "
                         "as JSON ('-' for stdout)")
    ap.add_argument("--cache-dir", default=None,
                    help="the shared store of warmup records (default "
                         "$REPRO_CACHE_DIR or .repro_cache/ with "
                         "--replicas; none without either)")
    ap.add_argument("--no-warm", dest="warm", action="store_false",
                    help="skip the boot-time warmup pass")
    ap.add_argument("--warm", dest="warm", action="store_true",
                    default=True)
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a pool of N replica processes "
                         "behind the heartbeat-failover Router (0 = "
                         "single-process front-end); replicas boot from "
                         "the shared --cache-dir store")
    ap.add_argument("--heartbeat-timeout-ms", type=float, default=2000.0,
                    help="router declares a replica dead after this "
                         "long without a heartbeat")
    ap.add_argument("--fault-plan", default=None, metavar="JSON",
                    help="chaos mode: a FaultPlan as inline JSON or a "
                         "file path; scheduled failures are injected at "
                         "the engine/serve failure points and a per-point "
                         "calls/fired report is printed after the replay")
    ap.add_argument("--verify", type=int, default=8,
                    help="cross-check N served results against "
                         "sequential run (0 = skip)")
    ap.add_argument("--log-every-s", type=float, default=5.0)
    ap.add_argument("--json", action="store_true",
                    help="dump the full stats snapshot as JSON")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)

    from repro_torch.core import Engine
    from repro_torch.serve import DiskExecutableCache, Frontend, warm

    paths = build_paths(args.regime, args.scale, args.seed, args.iters,
                        device=args.device)
    hg, specs = paths["hg"], paths["specs"]
    print(f"{args.regime}: |V|={hg.n_vertices} |E|={hg.n_hyperedges} "
          f"nnz={hg.nnz}")

    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer

        tracer = Tracer()
    injector, plan_json = None, None
    if args.fault_plan:
        from repro_torch.faults import FaultInjector, FaultPlan

        raw = args.fault_plan
        if os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        plan = FaultPlan.from_json(raw)
        for warning in plan.validate():
            print(f"fault-plan: {warning}", file=sys.stderr)
        injector = FaultInjector(plan)
        plan_json = plan.to_json()
        print(f"fault-plan: {len(plan.rules)} rule(s) armed")
    store = None
    if args.cache_dir is not None or args.replicas > 0:
        store = DiskExecutableCache(args.cache_dir, device=args.device)
    engine = Engine(
        device=args.device, tracer=tracer, disk_cache=store,
        # In pool mode the parent engine is the prewarmer + verify
        # oracle, never the system under test: the plan is armed inside
        # each replica (and on the router for ``router.route``) instead.
        fault_injector=None if args.replicas > 0 else injector,
    )
    if args.replicas > 0:
        if args.warm:
            report = warm(
                engine, list(specs.values()),
                batch_sizes=batch_buckets(args.max_batch),
                queries=paths["warm_queries"],
            )
            print(f"warm boot: {report['boot_s']:.3f}s, "
                  f"{report['traces']} traces, "
                  f"{report['from_disk']} from disk, "
                  f"{report['compiled']} compiled")
        return _serve_pool(args, engine, specs, hg, injector, plan_json)

    fe = Frontend(
        engine, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, log_every_s=args.log_every_s,
        adaptive_delay=args.adaptive_delay,
    )
    for key, spec in specs.items():
        fe.register(key, spec)
    if args.warm:
        # Every batch bucket a flush can take (a partial flush pads to a
        # smaller one) is made before the worker starts — on the card,
        # its CUDA graph captured — so the worker only replays.
        report = warm(
            engine, [fe.compiled(key) for key in specs],
            batch_sizes=batch_buckets(args.max_batch),
            queries=paths["warm_queries"],
        )
        print(f"warm boot: {report['boot_s']:.3f}s, "
              f"{report['traces']} traces, "
              f"{report['from_disk']} from disk, "
              f"{report['compiled']} compiled")

    rng, trace = make_trace(hg.n_vertices, args.requests, args.mix,
                            args.seed)

    t0 = time.perf_counter()
    results, failures = [], []
    with fe:
        futs = [(key, q, fe.submit(key, query=q)) for key, q in trace]
        for key, q, f in futs:
            try:
                results.append((key, q, f.result(timeout=600)))
            except RuntimeError as err:
                # Under an injected fault plan, requests may resolve
                # with a typed FaultError instead of a value — counted
                # and reported, never a hang or a crashed replay.
                failures.append((key, q, err))
    wall_s = time.perf_counter() - t0
    if failures and injector is None:
        print(f"{len(failures)} requests failed without a fault plan: "
              f"{failures[0][2]!r}", file=sys.stderr)
        return 1

    st = fe.stats()
    print(f"served {len(results)} requests in {wall_s:.3f}s "
          f"({len(results) / wall_s:.1f} q/s sustained)")
    print(f"  wait    p50={st['queue_wait']['p50_s'] * 1e3:.2f}ms "
          f"p99={st['queue_wait']['p99_s'] * 1e3:.2f}ms")
    print(f"  execute p50={st['execute']['p50_s'] * 1e3:.2f}ms "
          f"p99={st['execute']['p99_s'] * 1e3:.2f}ms")
    print(f"  flushes {st['flush_reasons']}")
    for bucket, occ in st["buckets"].items():
        print(f"  bucket {bucket}: {occ['flushes']} flushes, "
              f"occupancy {occ['mean_occupancy']:.2f}")
    print(f"  engine cache: entries={st['engine_cache']['entries']} "
          f"hits={st['engine_cache']['hits']} "
          f"traces={st['engine_cache']['traces']}")
    if st["disk_cache"] is not None:
        d = st["disk_cache"]
        print(f"  disk cache:   entries={d['entries']} "
              f"records={d['warm_records']} stores={d['disk_stores']} "
              f"({d['dir']})")
    if st.get("adaptive_delay") is not None:
        a = st["adaptive_delay"]
        print(f"  adaptive delay: {a['delay_s'] * 1e3:.2f}ms "
              f"(exec ewma {a['exec_ewma_s'] * 1e3:.2f}ms, "
              f"{a['observations']} obs)")
    if injector is not None:
        snap = injector.snapshot()
        print(f"  fault injection: {sum(snap['fired'].values())} fired "
              f"across {sum(snap['calls'].values())} instrumented calls; "
              f"{len(failures)} requests resolved with typed errors")
        for point in sorted(snap["calls"]):
            print(f"    {point}: calls={snap['calls'][point]} "
                  f"fired={snap['fired'].get(point, 0)}")

    if args.verify:
        # The sequential re-runs are the ORACLE, not the system under
        # test: disarm injection so the reference path runs fault-free.
        engine.fault_injector = None
        idx = rng.choice(len(results), size=min(args.verify, len(results)),
                         replace=False)
        for i in idx:
            key, q, served = results[i]
            seq = fe.compiled(key).run(query=q)
            if not agrees(key, served.value, seq.value):
                print(f"VERIFY FAILED: {key} query={q}", file=sys.stderr)
                return 1
        print(f"verified {len(idx)} served results vs sequential run "
              f"(sssp bitwise, ppr within 1e-5 relative)")

    if args.json:
        print(json.dumps(st, indent=2, sort_keys=True, default=str))
    if args.trace and tracer is not None:
        tracer.export(args.trace)
        print(f"trace: {len(tracer.spans())} spans "
              f"({tracer.dropped} dropped) -> {args.trace}")
    if args.metrics_json:
        payload = json.dumps(engine.metrics.snapshot(), indent=2,
                             sort_keys=True, default=str)
        if args.metrics_json == "-":
            print(payload)
        else:
            with open(args.metrics_json, "w") as f:
                f.write(payload + "\n")
            print(f"metrics -> {args.metrics_json}")
    return 0


def pool_faults(snapshots: list[dict], planned) -> dict:
    """One chaos report over several injectors' ``snapshot()``s (the
    router's and every replica instance's): calls and fires summed per
    point, and ``never_fired``, the planned points that fired nowhere."""
    calls: dict = {}
    fired: dict = {}
    for snap in snapshots:
        for point, n in snap["calls"].items():
            calls[point] = calls.get(point, 0) + n
        for point, n in snap["fired"].items():
            fired[point] = fired.get(point, 0) + n
    return {"calls": calls, "fired": fired,
            "never_fired": sorted(p for p in set(planned)
                                  if not fired.get(p))}


def _serve_pool(args, engine, specs, hg, injector, plan_json) -> int:
    """Replay the trace through a ``Router`` over N replica processes.

    The parent already warmed the shared store (under ``--warm``), so
    every replica boots ``require_no_retrace=True``; the parent engine
    stays fault-free and is the ``--verify`` oracle (SSSP bitwise, PPR
    within 1e-5 relative).  The chaos invariant being demonstrated:
    every request resolves even when ``replica.crash`` kills workers
    mid-replay, and the survivors' successes match the sequential run.
    """
    import dataclasses
    import itertools

    import torch

    from repro_torch.serve import ProcessReplica, ReplicaConfig, Router

    exec_cache_bytes = None
    if engine.device.type == "cuda":
        # One card for the pool and the parent: each replica's LRU
        # takes a quarter of it divided by N.
        exec_cache_bytes = torch.cuda.get_device_properties(
            engine.device).total_memory // 4 // args.replicas
    cfg = ReplicaConfig(
        builder="repro_torch.launch.serve_hypergraph:build_paths",
        kwargs={"regime": args.regime, "scale": args.scale,
                "seed": args.seed, "iters": args.iters},
        cache_dir=args.cache_dir,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        fault_plan=plan_json,
        require_no_retrace=args.warm,
        heartbeat_interval_s=min(0.1, args.heartbeat_timeout_ms / 4e3),
        device=args.device,
        exec_cache_bytes=exec_cache_bytes,
    )
    # Every spawned instance (initial or respawn) gets a distinct prob
    # seed offset, so a respawned replica doesn't replay the exact fault
    # draws that killed its predecessor (see ReplicaConfig.seed_offset).
    spawns = itertools.count()
    spawned: list = []

    def factory(index: int) -> ProcessReplica:
        handle = ProcessReplica(index, dataclasses.replace(
            cfg, seed_offset=1009 * next(spawns)))
        spawned.append(handle)
        return handle

    router = Router(
        factory, args.replicas,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        max_in_flight=2 * args.max_batch,
        fault_injector=injector,
    ).start()
    try:
        t0 = time.perf_counter()
        router.wait_ready()
        boot_s = time.perf_counter() - t0
        boots = [s["boot"] for s in router.stats()["per_replica"]]
        print(f"pool: {args.replicas} replicas ready in {boot_s:.3f}s; "
              f"boots: " + ", ".join(
                  f"#{b['index']} {b['boot_s']:.2f}s "
                  f"(disk={b['from_disk']} aot={b['compiled']} "
                  f"traces={b['traces']} records={b['warm_records']})"
                  for b in boots if b))

        rng, trace = make_trace(hg.n_vertices, args.requests, args.mix,
                                args.seed)
        t0 = time.perf_counter()
        futs = [(key, q, router.submit(key, query=q)) for key, q in trace]
        results, failures = [], []
        for key, q, f in futs:
            try:
                results.append((key, q, f.result(timeout=600)))
            except RuntimeError as err:  # typed FaultError taxonomy
                failures.append((key, q, err))
        wall_s = time.perf_counter() - t0
    finally:
        router.close()
        for handle in spawned:
            handle.stop(force=True)

    st = router.stats()
    if st["in_flight"] != 0 or st["pending"] != 0:
        print(f"ROUTER LEAK: in_flight={st['in_flight']} "
              f"pending={st['pending']} after drain", file=sys.stderr)
        return 1
    if failures and injector is None:
        print(f"{len(failures)} requests failed without a fault plan: "
              f"{failures[0][2]!r}", file=sys.stderr)
        return 1
    print(f"served {len(results)}/{len(trace)} requests in {wall_s:.3f}s "
          f"({len(results) / wall_s:.1f} q/s aggregate)")
    print(f"  pool: deaths={st['deaths']} respawns={st['respawns']} "
          f"failovers={st['failovers']} lost={st['lost']} "
          f"shed={st['shed']}")
    for p in st["per_replica"]:
        counts = p["replica_counts"] or {}
        print(f"  replica {p['index']}: {p['state']} served={p['served']} "
              f"errors={p['errors']} deaths={p['deaths']} "
              f"respawns={p['respawns']} traces={counts.get('traces')}")
    if injector is not None:
        snaps = [injector.snapshot()] + [
            h.faults for h in spawned if h.faults is not None]
        report = pool_faults(snaps,
                             [r.point for r in injector.plan.rules])
        print(f"  pool fault injection (router + {len(snaps) - 1} "
              f"replica instances): {sum(report['fired'].values())} "
              f"fired across {sum(report['calls'].values())} calls; "
              f"{len(failures)} requests resolved with typed errors")
        for point in sorted(report["calls"]):
            print(f"    {point}: calls={report['calls'][point]} "
                  f"fired={report['fired'].get(point, 0)}")
        print(f"  never fired: {report['never_fired'] or 'none'}")

    if args.verify and results:
        idx = rng.choice(len(results),
                         size=min(args.verify, len(results)),
                         replace=False)
        for i in idx:
            key, q, served = results[i]
            seq = engine.compile(specs[key]).run(query=q)
            if not agrees(key, served.value, seq.value):
                print(f"VERIFY FAILED: {key} query={q}", file=sys.stderr)
                return 1
        print(f"verified {len(idx)} pool-served results vs sequential run "
              f"(sssp bitwise, ppr within 1e-5 relative)")

    if args.metrics_json:
        payload = json.dumps(engine.metrics.snapshot(), indent=2,
                             sort_keys=True, default=str)
        if args.metrics_json == "-":
            print(payload)
        else:
            with open(args.metrics_json, "w") as f:
                f.write(payload + "\n")
            print(f"metrics -> {args.metrics_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
