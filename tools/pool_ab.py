#!/usr/bin/env python3
"""Where a replica pool's time goes, on one card.

    python3 tools/pool_ab.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Builds DBLP at full scale, warms ``chip_smoke.py`` phase 13's
two paths (SSSP and PPR, 12 iterations, unbatched and buckets 8/16)
into a fresh store, and replays phase 12's trace (256 requests, 60%
SSSP, seed 0) four ways, in turns (A B C D D C B A), each with its
requests/s:

* A: one in-process ``Frontend`` on the parent's Engine (results stay
  on the card, as in phase 12);
* B: the same, each result then copied to the host as numpy, as a
  replica does before it sends it (``serve.replica._to_host``);
* C: a ``Router`` over 2 replica processes, its thread woken by the
  replicas' pipes (the port's loop);
* D: the same pool, its thread sleeping ``poll_interval_s`` between
  pumps (the JAX package's loop).

Also prints the bytes of the trace's answers as the pool served them
(numpy: what crossed the pipes) and the seconds to pickle and unpickle
them once.  Prints the card's
name and power limit first.
"""
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import tempfile

    import torch

    import chip_smoke as cs
    from repro_torch.algorithms import random_walk_spec, shortest_paths_spec
    from repro_torch.core import Engine, tree_map
    from repro_torch.data import make_dataset
    from repro_torch.launch.serve_hypergraph import batch_buckets, make_trace
    from repro_torch.serve import DiskExecutableCache, Frontend, warm
    from repro_torch.serve.replica import _to_host
    from repro_torch.serve.router import Router

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    specs = {"sssp": shortest_paths_spec(hg, source=0,
                                         max_iters=cs.SERVE_ITERS),
             "ppr": random_walk_spec(hg, iters=cs.SERVE_ITERS)}
    _, trace = make_trace(hg.n_vertices, cs.SERVE_REQUESTS, cs.SERVE_MIX, 0)
    store = tempfile.TemporaryDirectory(prefix="pool_ab_")
    eng = Engine(device=dev,
                 disk_cache=DiskExecutableCache(store.name, device=dev))
    warm(eng, list(specs.values()),
         batch_sizes=batch_buckets(cs.SERVE_MAX_BATCH), queries=[0, 0])

    def in_process(to_host):
        fe = Frontend(eng, max_batch=cs.SERVE_MAX_BATCH, max_delay_ms=5.0)
        for key, spec in specs.items():
            fe.register(key, spec)
        t0 = time.perf_counter()
        out, _ = cs.replay(fe, trace)
        if to_host:
            out = [tree_map(_to_host, r.value) for r in out]
        return time.perf_counter() - t0, out

    router, spawned, _ = cs.start_pool(store.name)
    woken = Router._wait_for_messages

    def pool(sleeping):
        Router._wait_for_messages = (
            (lambda self: time.sleep(self._poll_interval_s))
            if sleeping else woken)
        try:
            out, wall = cs.pool_replay(router, trace)
        finally:
            Router._wait_for_messages = woken
        return wall, out

    ways = {"A in-process, results on the card": lambda: in_process(False),
            "B in-process, results to the host": lambda: in_process(True),
            "C pool, woken by the pipes": lambda: pool(False),
            "D pool, sleeping between pumps": lambda: pool(True)}
    walls = {name: [] for name in ways}
    outs = {}
    try:
        cs.wait_ready(router, [0, 1], time.perf_counter())
        names = list(ways)
        for name in names + names[::-1]:
            wall, outs[name] = ways[name]()
            walls[name].append(wall)
            print(f"{name}: {len(trace) / wall:.1f} requests/s "
                  f"({wall:.3f} s)", flush=True)
    finally:
        cs.close_pool(router, spawned)
    # What crossed the pipes: the pool's answers, numpy.
    answers = [r.value for r in outs["C pool, woken by the pipes"]]
    t0 = time.perf_counter()
    blob = pickle.dumps(answers, protocol=pickle.HIGHEST_PROTOCOL)
    t1 = time.perf_counter()
    pickle.loads(blob)
    t2 = time.perf_counter()
    print(f"the trace's answers: {len(blob) / 2**20:.1f} MiB "
          f"({len(blob) / len(trace) / 2**20:.2f} MiB a request); pickled "
          f"in {t1 - t0:.3f} s, unpickled in {t2 - t1:.3f} s")
    for name, w in walls.items():
        print(f"best of 2, {name}: {len(trace) / min(w):.1f} requests/s")
    store.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
