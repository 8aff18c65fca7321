#!/usr/bin/env python3
"""Time the fused delivery (K1) and bitset intersection (K3a, K3b)
kernels of two checkouts side by side, in one call on one card.

    python3 tools/leaf_isect_ab.py --parent DIR [--only k1|k3] [--out FILE]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit; ``DIR`` is another checkout of the repository (for example the
parent commit, unpacked with ``git archive``).  Each tree runs in its
own process, in the order parent, this, this, parent, so that drift of
the card shows.  Each process builds its tree's kernels and times, on
the DBLP regime at full scale, one fwd and one bwd leaf of PageRank's
float32 sum through ``deliver_fused_classes(..., lowering="cuda")``
(CUDA events, L2 flushed, median of 20; and ``chip_smoke.time_device``,
the device time without the host's share) and end-to-end PageRank-30 and
SSSP through ``Engine.run`` with both ``delivery`` values (wall time,
median of 5 after a warm-up); and, on the Apache regime at full scale,
K3b on the census's four batches (the same sampled triples in every
process) and K3a on the whole index.  This tree's processes also time
variants: K1 with every class at the whole tile and with no span
above the tile; and ``isect.cu`` built with source substitutions (each
must match exactly once, as in ``tools/flash_variants.py``): K3b with a
register ring of 4, K3a with a shared-memory ring of 2 or 8, and K3a
through the uncached loop or through K3b's register-ring kernel instead
of its shared-memory ring.  Prints the
card's name and power limit, one line per process and a table;
``--out`` keeps the JSON.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts this tree's src on sys.path)

ISECT = os.path.join(ROOT, "src", "repro_torch", "csrc", "isect.cu")
VARIANTS = os.path.join(ROOT, "build", "variants")
# isect.cu variants: (label, kernel it times, substitutions).
ISECT_VARIANTS = [
    ("register ring 4", "K3b", [(
        "constexpr int R = 2;  //", "constexpr int R = 4;  //")]),
    ("shared ring 2", "K3a", [(
        "constexpr int kStreamRing = 4;", "constexpr int kStreamRing = 2;")]),
    ("shared ring 8", "K3a", [(
        "constexpr int kStreamRing = 4;", "constexpr int kStreamRing = 8;")]),
    ("isect_loop", "K3a", [(
        "return {isect_stream<V, U>, ring_bytes<V, U>()};",
        "return {isect_loop<0, V>, 0};")]),
    ("K3b's kernel", "K3a", [
        ("return {isect_stream<V, U>, ring_bytes<V, U>()};",
         "return {isect_cached<0, V, U>, 0};"),
        ("static_assert(MODE != 0", "static_assert(MODE >= 0")]),
]


def variant_path(label):
    return os.path.join(VARIANTS, "isect_" + "".join(
        c if c.isalnum() else "_" for c in label))


def build_variant(item):
    """Builds ``isect.cu`` with one variant's substitutions."""
    from repro_torch.kernels import _nvcc

    label, _, subs = item
    src = open(ISECT).read()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{label}: {old!r} matches {src.count(old)} "
                             "times in isect.cu")
        src = src.replace(old, new)
    stem = variant_path(label)
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.run(
        [_nvcc.find_nvcc(), *_nvcc.NVCC_FLAGS, "-o", stem + ".so",
         stem + ".cu"], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{label}: nvcc failed\n{proc.stderr[-4000:]}")


def prepare(path):
    """The Apache census's sampled triples, saved for every process."""
    import numpy as np

    from repro_torch.core import AnalyticsSpec
    from repro_torch.data import make_dataset
    from repro_torch.motifs import (
        build_overlap_graph,
        overlap_pairs_with_counts,
        sample_triples,
    )

    hg = make_dataset("apache", 1.0, seed=0, device="cpu")
    pairs, _ = overlap_pairs_with_counts(hg)
    og = build_overlap_graph(hg, pairs)
    _, triples = sample_triples(og, AnalyticsSpec(hg).n_samples,
                                hg.n_hyperedges, seed=0)
    np.save(path, np.ascontiguousarray(triples, dtype=np.int32))


def time_tree(tree, triples_path, variants, only=None):
    """One tree's timings (ms), in this process; ``only``: "k1" or "k3"."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    # Older checkouts' deliver package cannot be imported before the core.
    import repro_torch.core  # noqa: F401
    from repro_torch.kernels.deliver import fused

    if not fused.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {fused.__file__}, not from {tree}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    res = {}

    if only != "k3":
        time_delivery(res, dev, flush, fused, variants)
    if only != "k1":
        time_isect(res, dev, flush, triples_path, variants)
    return res


def time_delivery(res, dev, flush, fused, variants):
    import torch

    from repro_torch.algorithms import pagerank_spec, shortest_paths_spec
    from repro_torch.core import Engine
    from repro_torch.data import make_dataset

    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    eng = Engine(device=dev)
    fwd, bwd = eng._delivery_layouts(hg)

    def leaves(tag):
        for name, lay in (("fwd", fwd), ("bwd", bwd)):
            msgs_aug = torch.cat([torch.rand(lay.n_src, 1, device=dev),
                                  torch.zeros(1, 1, device=dev)])
            leaf = lambda: fused.deliver_fused_classes(msgs_aug, None, lay,
                                                       "sum")
            res[f"K1 {name} leaf{tag}"] = cs.time_cuda(leaf, flush)
            res[f"K1 {name} leaf{tag}, device"] = cs.time_device(leaf, flush)

    leaves("")
    for label, spec in (("pagerank-30", pagerank_spec(hg, iters=30)),
                        ("sssp", shortest_paths_spec(hg, 0))):
        for delivery in ("pallas_fused", "xla"):
            eng.run(spec, delivery=delivery)
            walls = [eng.run(spec, delivery=delivery).decision["measured"][
                "wall_s"] for _ in range(5)]
            res[f"e2e {label} {delivery}"] = statistics.median(walls) * 1e3
    if variants:
        span = fused.class_span
        for tag, rule in (
                (" (whole tiles)", lambda nnz_pad, n_rows, block_n: block_n),
                (" (no span above the tile)",
                 lambda *a: min(span(*a), a[2]))):
            fused.class_span = rule
            fused._PLANS.clear()
            leaves(tag)
        fused.class_span = span
        fused._PLANS.clear()


def time_isect(res, dev, flush, triples_path, variants):
    import numpy as np
    import torch

    from repro_torch.data import make_dataset
    from repro_torch.kernels.isect import isect, isect_cuda, isect_fused_cuda
    from repro_torch.motifs import build_index

    hg_a = make_dataset("apache", 1.0, seed=0, device=dev)
    bits = build_index(hg_a, "bitset").data
    tri = torch.as_tensor(np.load(triples_path), device=dev)
    a, b, c = (tri[:, i].contiguous() for i in range(3))
    batches = {"a&b": (a, b), "b&c": (b, c), "c&a": (c, a),
               "a&b&c": (a, b, c)}

    def k3b(tag):
        for name, abc in batches.items():
            res[f"K3b {name}{tag}"] = cs.time_cuda(
                lambda: isect_fused_cuda(bits, *abc), flush)

    def k3a(tag):
        res[f"K3a whole index{tag}"] = cs.time_cuda(
            lambda: isect_cuda(bits, bits), flush)
        res[f"K3a whole index{tag}, device"] = cs.time_device(
            lambda: isect_cuda(bits, bits), flush)

    k3b("")
    k3a("")
    if variants:
        from repro_torch.kernels import _nvcc

        shipped = isect._kernel_lib()
        for label, kernel, _ in ISECT_VARIANTS:
            # The wrappers load the library through _nvcc's cache.
            _nvcc._LOADED["isect"] = ctypes.CDLL(variant_path(label) + ".so")
            isect._kernel_lib()
            (k3b if kernel == "K3b" else k3a)(f" ({label})")
        _nvcc._LOADED["isect"] = shipped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out")
    ap.add_argument("--only", choices=("k1", "k3"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--triples", help=argparse.SUPPRESS)
    ap.add_argument("--variants", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("leaf_isect_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(time_tree(args.worker, args.triples,
                                   args.variants, args.only)))
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    triples = os.path.join(ROOT, "build", "ab_triples.npy")
    if args.only != "k1":
        t0 = time.perf_counter()
        os.makedirs(VARIANTS, exist_ok=True)
        with ThreadPoolExecutor(len(ISECT_VARIANTS)) as pool:
            built = pool.map(build_variant, ISECT_VARIANTS)
            prepare(triples)
            list(built)
        print(f"census triples and isect variants in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    parent = os.path.abspath(args.parent)
    runs = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        cmd = [sys.executable, os.path.abspath(__file__), "--parent",
               parent, "--worker", tree, "--triples", triples]
        if label == "this":
            cmd.append("--variants")
        if args.only:
            cmd += ["--only", args.only]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        runs.append((label, json.loads(out.stdout.strip().splitlines()[-1])))
        print(f"{label}: {time.perf_counter() - t0:.1f} s "
              f"{json.dumps(runs[-1][1])}", flush=True)
    keys = list(runs[1][1])
    print(f"{'ms':40s}" + "".join(f"{lab:>12s}" for lab, _ in runs))
    for k in keys:
        print(f"{k:40s}" + "".join(
            f"{r[k]:12.4f}" if k in r else f"{'-':>12s}" for _, r in runs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
