#!/usr/bin/env python3
"""Where a distributed run's time goes at world size 1, on one card.

    python3 tools/dist_profile.py [--out FILE]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Forms an NCCL group of world size 1 (``init_local_group``,
``make_host_mesh(1)``), builds DBLP at full scale as ``chip_smoke.py``
phase 14 does and runs PageRank-30, SSSP from 0 and components with
``delivery='pallas_fused'`` and ``collect_stats=True``:

* ``local``: ``Engine.run`` on the local backend;
* ``<backend>``: ``Engine.run`` under ``replicated`` and ``sharded``
  (the Engine keeps the layouts and the rank's shard after its first
  run);
* ``<backend> kept`` / ``rebuilt``: ``distributed_compute_resumable``
  from the initial state with one shard built before the timing, or
  built inside each call (``plan_rank_shard``: the rank's shard row
  copied to the card, its degrees computed; the layouts cached), as
  ``Engine.run`` did before it kept the shard;
* ``plan_rank_shard`` (PageRank-30): that per-run work alone.

Each path is warmed twice, then timed without the profiler: the median
of 7 calls, the paths in turns, each call through a synchronize.  Then,
for PageRank-30, 5 calls of each are recorded under ``torch.profiler``:
the card's busy time per call (every kernel, copy and collective on the
card), the idle share (one less busy over the unprofiled wall), the
device's events by time and the host's operators by self CPU time (the
profiler's own wall is longer, and is printed beside it).  Last, the collectives one
run of each backend issues, counted by op, and what one such op costs
the host at this run's width (``[nv_pad]`` float32, 100 calls, then a
synchronize).  Prints the card's name and power limit first; ``--out``
keeps the JSON.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CALLS = 5
N_TURNS = 7
N_OPS = 100
TOP = 10


def profiled(call, n):
    """(host ms per call, busy device ms per call, [(device event, ms
    per call)], [(host operator, self CPU ms per call)]) over ``n``
    calls of ``call``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    dev = [(ev.key, ev.self_device_time_total / 1e3 / n) for ev in events
           if ev.device_type == DeviceType.CUDA
           and ev.self_device_time_total > 0]
    host = [(ev.key, ev.self_cpu_time_total / 1e3 / n) for ev in events
            if ev.device_type == DeviceType.CPU
            and ev.self_cpu_time_total > 0]
    dev.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return wall, sum(ms for _, ms in dev), dev, host


def report(label, wall, prof_wall, busy, dev, host):
    idle = 1.0 - busy / wall if wall > 0 else float("nan")
    print(f"{label}: wall {wall:.3f} ms a call ({prof_wall:.3f} profiled), "
          f"card busy {busy:.3f} ms, idle share {idle:.1%}", flush=True)
    for title, rows, whole in (("device", dev, busy),
                               ("host", host, prof_wall)):
        print(f"  {title}:")
        for key, ms in rows[:TOP]:
            name = key if len(key) <= 90 else key[:87] + "..."
            print(f"    {ms:9.4f} ms  {ms / whole if whole else 0:6.1%}  "
                  f"{name}")
    return {"wall_ms": wall, "profiled_wall_ms": prof_wall, "busy_ms": busy,
            "idle_share": idle, "device": dev[:TOP], "host": host[:TOP]}


def timed(call):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def counted_collectives(run):
    """The collectives ``run()`` issues, by op: the module functions
    ``repro_torch.core.distributed`` calls, wrapped for one run."""
    import torch.distributed as dist

    import repro_torch.core.distributed as rd

    counts = {}
    saved = {}

    def wrap(owner, name):
        fn = getattr(owner, name)
        saved[(owner, name)] = fn

        def counting(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)

        setattr(owner, name, counting)

    for owner, name in ((dist, "all_reduce"), (rd, "all_gather_single"),
                        (rd, "reduce_scatter_single")):
        wrap(owner, name)
    try:
        run()
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
    return counts


def collective_cost(n, device):
    """Host ms a call of each collective on ``[n]`` float32, ``N_OPS``
    back to back, then a synchronize; and the wall a call with it."""
    import torch
    import torch.distributed as dist

    import repro_torch.core.distributed as rd

    x = torch.ones(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x, op=dist.ReduceOp.MIN),
        "all_gather_single": lambda: rd.all_gather_single(y, x),
        "reduce_scatter_single": lambda: rd.reduce_scatter_single(
            y, x, op=dist.ReduceOp.MIN),
    }
    out = {}
    for name, op in ops.items():
        for _ in range(3):
            op()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_OPS):
            op()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[name] = {"host_ms": (t1 - t0) * 1e3 / N_OPS,
                     "wall_ms": (t2 - t0) * 1e3 / N_OPS}
        print(f"{name} on [{n}] float32: host {out[name]['host_ms']:.4f} "
              f"ms a call, wall {out[name]['wall_ms']:.4f}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("dist_profile: no CUDA device available", file=sys.stderr)
        return 1

    from repro_torch.algorithms import (
        connected_components_spec,
        pagerank_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine
    from repro_torch.core.distributed import (
        DistContext,
        distributed_compute_resumable,
        distributed_initial_state,
        plan_rank_shard,
    )
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import init_local_group, make_host_mesh
    from repro_torch.partition import partition

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    spec = pagerank_spec(hg, iters=30)
    init_local_group(0, 1, tempfile.mkdtemp(prefix="dist-profile-"), "cuda")
    out = {}
    try:
        mesh = make_host_mesh(1)
        plan = partition("random_vertex_cut", hg, 1)
        kw = dict(device=dev, delivery="pallas_fused", collect_stats=True)
        local = Engine(**kw)
        eng = Engine(plan=plan, mesh=mesh, **kw)

        ctxs = {b: DistContext.for_mesh(mesh, "data", hg.n_vertices,
                                        hg.n_hyperedges, b)
                for b in ("replicated", "sharded")}
        lays = {b: eng._shard_layouts(plan, ctx) for b, ctx in ctxs.items()}
        kept = {b: plan_rank_shard(hg, plan, ctx, "pallas_fused", lays[b])
                for b, ctx in ctxs.items()}

        def resumable(spec, b, shard):
            state = distributed_initial_state(spec.hg0, plan,
                                              spec.initial_msg)
            return distributed_compute_resumable(
                spec.hg0, plan, mesh, spec.max_iters, state, spec.v_program,
                spec.he_program, backend=b, shard=shard)

        def paths_of(spec):
            paths = [("local", lambda: local.run(spec))]
            for b in ("replicated", "sharded"):
                paths += [
                    (b, lambda b=b: eng.run(spec, backend=b)),
                    (f"{b} kept", lambda b=b: resumable(spec, b, kept[b])),
                    (f"{b} rebuilt", lambda b=b: resumable(
                        spec, b, plan_rank_shard(hg, plan, ctxs[b],
                                                 "pallas_fused", lays[b]))),
                ]
            return paths

        specs = {"pagerank-30": spec,
                 "sssp": shortest_paths_spec(hg, 0),
                 "components": connected_components_spec(hg)}
        for name, one in specs.items():
            paths = paths_of(one)
            for label, call in paths:
                for _ in range(2):
                    call()
            walls = {label: [] for label, _ in paths}
            for _ in range(N_TURNS):
                for label, call in paths:
                    walls[label].append(timed(call))
            out[f"{name} walls"] = walls
            print(f"{name}: wall ms, median of {N_TURNS} in turns [min, "
                  "max]: " + "; ".join(
                      f"{label} {statistics.median(w):.3f} [{min(w):.3f}, "
                      f"{max(w):.3f}]" for label, w in walls.items()),
                  flush=True)
            if name != "pagerank-30":
                continue
            for b in ("replicated", "sharded"):
                paths.append((f"{b} plan_rank_shard",
                              lambda b=b: plan_rank_shard(
                                  hg, plan, ctxs[b], "pallas_fused",
                                  lays[b])))
            for label, call in paths:
                w = walls.get(label) or [timed(call) for _ in range(N_TURNS)]
                out[label] = report(label, statistics.median(w),
                                    *profiled(call, N_CALLS))
        for b in ("replicated", "sharded"):
            counts = counted_collectives(lambda b=b: eng.run(spec, backend=b))
            print(f"{b}: collectives a run {counts}", flush=True)
            out[f"{b} collectives"] = counts
        out["collective cost"] = collective_cost(
            hg.n_vertices + (-hg.n_vertices) % plan.n_parts, dev)
    finally:
        dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
