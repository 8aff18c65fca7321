"""Launch hypergraph analytics through the port's ``Engine`` facade.

Run a built-in algorithm on a generated dataset regime, on the card
unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.hypergraph \
      --algorithm pagerank --regime dblp --scale 1.0 --iters 30 \
      --delivery auto --device cuda --stats

  # batch analytics (Engine.analyze): the h-motif census
  PYTHONPATH=src python -m repro_torch.launch.hypergraph \
      --algorithm motifs --regime apache --scale 1.0 \
      --mode auto --kernel auto --representation auto

  # compile-once serve-many (Engine.compile -> run_batch): 64 SSSP
  # sources through one compiled executable
  PYTHONPATH=src python -m repro_torch.launch.hypergraph \
      --algorithm sssp --regime dblp --scale 1.0 --batch 64 --cache-stats

  # the clique representation, its decision tree, a trace and the
  # metrics registry
  PYTHONPATH=src python -m repro_torch.launch.hypergraph \
      --algorithm vertex_pagerank --representation auto --explain \
      --trace trace.json --metrics-json -
"""
from __future__ import annotations

import argparse
import sys
import time

ALGORITHMS = ("pagerank", "vertex_pagerank", "pagerank_entropy", "sssp",
              "random_walk", "label_propagation", "connected_components")


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--algorithm", default="pagerank",
                    choices=ALGORITHMS + ("motifs",),
                    help="an iterative algorithm, or motifs (the h-motif "
                    "census through Engine.analyze)")
    ap.add_argument("--regime", default="dblp",
                    help="dataset regime (apache/dblp/friendster/orkut)")
    ap.add_argument("--scale", type=float, default=0.003)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--delivery", default="auto",
                    choices=["auto", "xla", "pallas_fused"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-superstep activity")
    ap.add_argument("--representation", default="auto",
                    choices=["auto", "bipartite", "clique"],
                    help="clique: constant folding onto the clique "
                    "expansion (vertex_pagerank); for motifs, the dual's "
                    "pair-size table")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "exact", "sample"],
                    help="motifs only: census mode")
    ap.add_argument("--samples", type=int, default=4000,
                    help="motifs only: sample count for --mode sample")
    ap.add_argument("--kernel", default="auto",
                    choices=["auto", "bitset", "merge"],
                    help="motifs only: intersection kernel path")
    ap.add_argument("--sources", default=None,
                    help="comma-separated query vertices (sssp sources / "
                         "random_walk seeds): compile once, serve the "
                         "batch via CompiledAlgorithm.run_batch")
    ap.add_argument("--batch", type=int, default=None,
                    help="serve N random query vertices through one "
                         "compiled executable (see --sources)")
    ap.add_argument("--cache-stats", action="store_true",
                    help="print the executable-cache statistics "
                         "(entries, hits/misses, evictions, per-entry "
                         "bucket shapes) after the run")
    ap.add_argument("--explain", action="store_true",
                    help="print the full auto-axis decision tree "
                         "(per-candidate predicted costs) before running")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record engine trace spans; export Chrome-trace "
                         "JSON here (loadable in Perfetto)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the unified metrics-registry snapshot "
                         "as JSON ('-' for stdout)")
    return ap.parse_args(argv)


def build_spec(name: str, hg, iters: int):
    from repro_torch import algorithms as alg

    if name == "pagerank":
        return alg.pagerank_spec(hg, iters=iters)
    if name == "vertex_pagerank":
        # vertex ranks only — the clique-eligible variant, so
        # --representation clique/auto can actually constant-fold.
        return alg.vertex_pagerank_spec(hg, iters=iters)
    if name == "pagerank_entropy":
        return alg.pagerank_entropy_spec(hg, iters=iters)
    if name == "label_propagation":
        return alg.label_propagation_spec(hg, iters=iters)
    if name == "sssp":
        return alg.shortest_paths_spec(hg, source=0, max_iters=iters)
    if name == "random_walk":
        return alg.random_walk_spec(hg, iters=iters)
    if name == "connected_components":
        return alg.connected_components_spec(hg, max_iters=iters)
    raise ValueError(name)


def _print_cache_stats(engine) -> None:
    s = engine.cache_stats()
    print(f"cache: entries={s['entries']}/{s['capacity']} "
          f"hits={s['hits']} misses={s['misses']} "
          f"evictions={s['evictions']} traces={s['traces']} "
          f"bytes={s['bytes']}/{s['capacity_bytes']}")
    for meta in s["entry_shapes"]:
        print(f"  entry: {meta}")
    if s.get("disk") is not None:
        print(f"  disk: {s['disk']}")


def _print_explain(ex: dict) -> None:
    print("explain:")
    for axis, info in ex["axes"].items():
        print(f"  {axis}: winner={info.get('winner')} "
              f"({info.get('reason')})")
        for cand, costs in info.get("candidates", {}).items():
            mark = "*" if cand == info.get("winner") else " "
            kv = " ".join(
                f"{k}={v}" for k, v in costs.items()
                if k not in ("class_plans",) and not isinstance(v, dict)
            )
            print(f"   {mark} {cand}: {kv}")


def _emit_obs(engine, args) -> None:
    if args.trace and engine.tracer is not None:
        engine.tracer.export(args.trace)
        print(f"trace: {len(engine.tracer.spans())} spans "
              f"({engine.tracer.dropped} dropped) -> {args.trace}")
    if args.metrics_json:
        import json

        payload = json.dumps(engine.metrics.snapshot(), indent=2,
                             sort_keys=True, default=str)
        if args.metrics_json == "-":
            print(payload)
        else:
            with open(args.metrics_json, "w") as f:
                f.write(payload + "\n")
            print(f"metrics -> {args.metrics_json}")


def _serve(args, engine, spec, hg) -> int:
    """``--sources`` / ``--batch``: one compiled executable, B queries,
    served twice (cold: with the build and, on the card, the capture;
    warm: from the cache)."""
    import numpy as np
    import torch

    from repro_torch.core import tree_leaves

    if spec.bind_query is None:
        print(f"--sources/--batch need a query-capable algorithm "
              f"(sssp, random_walk); {args.algorithm} has no query axis",
              file=sys.stderr)
        return 2
    if args.sources is not None:
        queries = np.asarray([int(s) for s in args.sources.split(",")],
                             np.int32)
    else:
        rng = np.random.default_rng(args.seed)
        queries = rng.integers(0, hg.n_vertices,
                               size=args.batch).astype(np.int32)
    compiled = engine.compile(spec)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = compiled.run_batch(queries)
        if hg.device.type == "cuda":
            torch.cuda.synchronize(hg.device)
        secs.append(time.perf_counter() - t0)
    n = len(queries)
    print(f"design point: representation={res.representation} "
          f"backend={res.backend} delivery={res.config.delivery}")
    print(f"served {n} queries: cold {secs[0]:.3f}s ({n / secs[0]:.1f} q/s "
          f"incl. build), warm {secs[1]:.3f}s ({n / secs[1]:.1f} q/s), "
          f"{res.supersteps_executed} superstep pairs, "
          f"graph={res.decision['measured']['graph']}")
    first = tree_leaves(res.value)[0]
    for i, q in enumerate(queries[:4]):
        print(f"  query {int(q):4d}: {first[i].reshape(-1)[:5].tolist()}")
    return 0


def main(argv=None) -> int:
    args = _parse(argv)

    from repro_torch.core import Engine, tree_leaves
    from repro_torch.core.device import resolve_device
    from repro_torch.data import make_dataset

    device = resolve_device(args.device)
    hg = make_dataset(args.regime, scale=args.scale, seed=args.seed,
                      device=device)
    print(f"{args.regime}: |V|={hg.n_vertices} |E|={hg.n_hyperedges} "
          f"nnz={hg.nnz} device={device}")
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer

        tracer = Tracer()
    if args.algorithm == "motifs":
        return _motifs(args, hg, device, tracer)
    engine = Engine(device=device, tracer=tracer, delivery=args.delivery,
                    representation=args.representation,
                    collect_stats=args.stats)
    spec = build_spec(args.algorithm, hg, args.iters)
    if args.explain:
        _print_explain(engine.explain(spec))
    if args.sources is not None or args.batch is not None:
        rc = _serve(args, engine, spec, hg)
        if rc == 0 and args.cache_stats:
            _print_cache_stats(engine)
        if rc == 0:
            _emit_obs(engine, args)
        return rc
    res = engine.run(spec)

    print(f"design point: representation={res.representation} "
          f"backend={res.backend} delivery={res.config.delivery}")
    for axis, why in res.decision.items():
        if axis != "measured":
            print(f"  {axis}: {why.get('reason')}")
    m = res.decision["measured"]
    line = (f"  measured: wall={m['wall_s'] * 1e3:.1f}ms "
            f"device_wait={m['device_wait_s'] * 1e3:.2f}ms")
    if "supersteps" in m:  # the clique path runs no supersteps
        line += (f" supersteps={m['supersteps']}/{m['max_iters']} "
                 f"host_syncs={m['host_syncs']}")
    print(line)
    if res.superstep_stats is not None:
        v_act, he_act = res.superstep_stats
        print(f"  activity: v={v_act.tolist()}")
        print(f"            he={he_act.tolist()}")
    leaves = tree_leaves(res.value)
    print(f"result: {len(leaves)} output array(s); "
          f"first = {leaves[0].reshape(-1)[:6].tolist()}")
    if args.cache_stats:
        _print_cache_stats(engine)
    _emit_obs(engine, args)
    return 0


def _motifs(args, hg, device, tracer) -> int:
    import numpy as np

    from repro_torch.core import AnalyticsSpec, Engine

    engine = Engine(device=device, tracer=tracer,
                    representation=args.representation,
                    intersect_kernel=args.kernel)
    aspec = AnalyticsSpec(
        hg, mode=args.mode, n_samples=args.samples, seed=args.seed,
    )
    if args.explain:
        _print_explain(engine.explain(aspec))
    res = engine.analyze(aspec)
    print(f"design point: representation={res.representation} "
          f"kernel={res.kernel} backend={res.backend} "
          f"mode={res.mode}")
    for ax, why in res.decision.items():
        if ax != "measured":
            print(f"  {ax}: {why.get('reason')}")
    m = res.decision["measured"]
    print(f"  measured: wall={m['wall_s'] * 1e3:.1f}ms "
          f"preprocess={m['preprocess_s'] * 1e3:.1f}ms "
          f"intersect={m['intersect_s'] * 1e3:.1f}ms "
          f"({m['intersect_calls']} calls) "
          f"classify={m['classify_s'] * 1e3:.1f}ms")
    c = res.value
    if res.mode == "exact":
        print(f"census: {c.total} connected triples over "
              f"{c.n_pairs} overlapping pairs "
              f"({c.n_duplicate_triples} duplicate-hyperedge "
              f"triples dropped)")
    else:
        print(f"census (estimated from {c.n_samples} sampled "
              f"linked pairs of {c.n_pairs}): total ~{c.total:.0f}")
    counts = c.counts
    for k in np.argsort(counts)[::-1][:6]:
        if counts[k] > 0:
            line = f"  h-motif {k:2d}: {counts[k]:.0f}"
            if res.mode == "sample":
                line += (f"  [{c.ci_low[k]:.0f}, {c.ci_high[k]:.0f}] "
                         f"@{c.confidence:.0%}")
            print(line)
    _emit_obs(engine, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
