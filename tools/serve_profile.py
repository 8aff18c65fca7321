#!/usr/bin/env python3
"""Where the compiled path's time goes, on one card.

    python3 tools/serve_profile.py [--out FILE]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Builds DBLP at full scale as ``chip_smoke.py`` phase 9 does
and serves its three compiled paths through
``Engine(delivery="pallas_fused").compile``: PageRank-30 ``run()``,
SSSP ``run(query=0)`` and ``run_batch`` of 64 SSSP sources (phase 9's
sources).  Each path is warmed (its CUDA graph captured), then 5 calls
are recorded under ``torch.profiler`` (CPU and CUDA activity; the
profiler sees the kernels a graph replays).  Per path it prints the
host wall per call (through a synchronize, profiler on), the card's
busy time per call (the sum of the device time of every kernel, copy
and fill on the card), the idle share (one less busy over wall), and
the kernels by device time per call with their share of the busy time.
Prints the card's name and power limit first; ``--out`` keeps the JSON.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CALLS = 5
TOP = 14


def profiled(call, n):
    """(host ms per call, busy device ms per call, [(kernel, device ms
    per call)] by device time) over ``n`` calls of ``call``."""
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
    # Device-side events only: a host op's row repeats its kernels' time.
    rows = [(ev.key, ev.self_device_time_total / 1e3 / n)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(ms for _, ms in rows), rows


def report(label, wall, busy, rows):
    idle = 1.0 - busy / wall if wall > 0 else float("nan")
    print(f"{label}: wall {wall:.3f} ms a call, card busy {busy:.3f} ms, "
          f"idle share {idle:.1%}", flush=True)
    for key, ms in rows[:TOP]:
        name = key if len(key) <= 96 else key[:93] + "..."
        print(f"    {ms:9.4f} ms  {ms / busy if busy else 0:6.1%}  {name}")
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": idle,
            "kernels": rows[:TOP]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from repro_torch.algorithms import pagerank_spec, shortest_paths_spec
    from repro_torch.core import Engine
    from repro_torch.data import make_dataset

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    eng = Engine(device=dev, delivery="pallas_fused", collect_stats=True)
    c_pr = eng.compile(pagerank_spec(hg, iters=30))
    c_sp = eng.compile(shortest_paths_spec(hg, 0))
    rng = np.random.default_rng(9)
    sources = rng.integers(0, hg.n_vertices, cs.SERVE_BATCH).astype(np.int32)
    sources[0] = 0
    paths = (
        ("pagerank-30 run()", c_pr.run),
        ("sssp run(query=0)", lambda: c_sp.run(query=0)),
        (f"sssp run_batch x{cs.SERVE_BATCH}",
         lambda: c_sp.run_batch(sources)),
    )
    out = {}
    for label, call in paths:
        for _ in range(3):
            call()
        out[label] = report(label, *profiled(call, N_CALLS))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
