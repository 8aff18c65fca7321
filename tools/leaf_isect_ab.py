#!/usr/bin/env python3
"""Time the fused delivery (K1), bitset intersection (K3a, K3b) and
segment-sum (K2a, K2b) kernels of two checkouts side by side, in one
call on one card.

    python3 tools/leaf_isect_ab.py --parent DIR [--only k1|k3|k2a|k2b]
        [--out FILE]

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
of its shared-memory ring.  ``--only k2a`` times instead
``segsum_cuda`` (K2a) on the DBLP incidences at full scale, as
``chip_smoke.py`` phase 7 makes them: float32 D = 1 and 64 and bfloat16
D = 64, in the generator's order and on shuffled ids (CUDA events, L2
flushed, median of 20; and the device time), the one-segment case, and
``index_add_`` beside each; this tree's processes also time
``segsum.cu`` built with substitutions (more or fewer edges in flight,
longer sorted chunks, register caps; and ablations, each without one
phase: message loads, folds, combines, tile stores, tile zeroing), and
the device time of each of its kernels (``torch.profiler``).  ``--only
k2b`` times ``segsum_sorted_cuda`` (K2b) on five cases: DBLP's
incidences sorted by hyperedge (float32 D = 1 and 64, bfloat16 D = 64),
every edge into one row (float32 D = 64) and Apache's incidences sorted
by vertex (3,316 rows, the longest 6,465 edges; float32 D = 64), each
beside ``index_add_`` and its byte bound; this tree's processes also
time ``segsum.cu`` built with substitutions (ablations, each without
one step: all but the setup, message loads, row stores, the carries'
combine; and variants: more edges in flight, register caps) and other
``block_e``, and each kernel's device time (``torch.profiler``).  Prints
the card's name and power limit, one line per process and a table;
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

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
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

# segsum.cu variants of K2a's accumulate pass: (label, "K2a", substitutions).
K2A_VARIANTS = [
    ("twice the edges in flight", "K2a", [(
        "constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    ("chunks of 1024", "K2a", [(
        "constexpr int kChunk = 512;", "constexpr int kChunk = 1024;")]),
    ("5 blocks per SM", "K2a", [(
        "__launch_bounds__(kMaxThreads)\nk2a_accumulate",
        "__launch_bounds__(kMaxThreads, 5)\nk2a_accumulate")]),
    ("3 blocks per SM", "K2a", [(
        "__launch_bounds__(kMaxThreads)\nk2a_accumulate",
        "__launch_bounds__(kMaxThreads, 3)\nk2a_accumulate")]),
    ("half the edges in flight", "K2a", [(
        "constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")]),
    # Ablations: each times the kernel without one of its phases, so
    # its sums are wrong.
    ("no message loads", "K2a", [(
        "if (e + u < b) x[u].load(base + (long long)sorted_edge[e + u] * d);",
        "x[u] = Cols<T, VEC>{};")]),
    ("no folds", "K2a", [(
        "for (int v = lane; v < nv && a < b; v += lanes) {",
        "for (int v = lane; v < 0; v += lanes) {")]),
    ("no combine", "K2a", [(
        "  if (k > 1) {\n    int node = j",
        "  if (false) {\n    int node = j")]),
    ("no tile store", "K2a", [(
        "for (int x = tid; x < rows * nv; x += blockDim.x) {",
        "for (int x = tid; x < 0; x += blockDim.x) {")]),
    ("no tile zeroing", "K2a", [(
        "for (int x = tid; x < rows * d_slice / W; x += blockDim.x) {",
        "for (int x = tid; x < 0; x += blockDim.x) {")]),
]


# segsum.cu variants of K2b: (label, "K2b", substitutions).
K2B_VARIANTS = [
    # Ablations: each times the kernel without one of its steps, so its
    # sums are wrong.
    ("setup only", "K2b", [(
        "  const int nv = STAGED ? 1 : d / VEC;  // vectors a lane group "
        "covers\n",
        "  if (ma + mb + split_head + block_head + block_tail != INT_MIN) "
        "return;\n  const int nv = STAGED ? 1 : d / VEC;\n")]),
    ("search only", "K2b", [(
        "  // 2. Offsets (and staged rows) into shared memory.\n",
        "  if (i0 + i1 + j0 + j1 + js != INT_MIN) return;\n")]),
    ("no message loads", "K2b", [
        ("        else x[u].load(base + (long long)(e + u) * d);",
         "        else x[u] = {};"),
        ("    stage(s_val, msgs + (long long)js * VEC, (j1 - js) * VEC);",
         "    (void)0;")]),
    ("no walk", "K2b", [(
        "    for (int e = ea; e < eb; e += kK2bIn) {",
        "    for (int e = eb; e < eb; e += kK2bIn) {")]),
    ("no scan", "K2b", [(
        "    for (int o = G; o < 32; o <<= 1) {\n      const int ku",
        "    for (int o = 32; o < 32; o <<= 1) {\n      const int ku")]),
    ("no row stores", "K2b", [
        ("        else store_vec<VEC>(out_c + (long long)r * d, acc);",
         "        else if (acc[0] == 1234.5f)\n"
         "          store_vec<VEC>(out_c + (long long)r * d, acc);"),
        ("        out[(long long)(i0 + m) * VEC + q] = slot[q];",
         "        if (to_f32(slot[q]) == 1234.5f)\n"
         "          out[(long long)(i0 + m) * VEC + q] = slot[q];")]),
    ("no carry combine", "K2b", [(
        "  if (!block_head && !block_tail) return;", "  if (n > 0) return;")]),
    ("rows stored by their lanes", "K2b", [
        ("        if constexpr (STAGED) put_slot<T, VEC>(s_off + r + 1, acc);",
         "        if constexpr (false) put_slot<T, VEC>(s_off + r + 1, acc);"),
        ("      } else if constexpr (STAGED) {",
         "      } else if constexpr (false) {"),
        ("  if constexpr (STAGED) {\n    for (int m = tid + block_head;",
         "  if constexpr (false) {\n    for (int m = tid + block_head;")]),
    ("tickets zeroed by a memset", "K2b", [(
        "  int rc;\n  if (narrow) {",
        "  {\n    int levels = 0;\n"
        "    for (long long c = 1; c < n_blocks; c *= 1 << kLgFan) ++levels;\n"
        "    const cudaError_t err = cudaMemsetAsync(\n"
        "        tk, 0, (size_t)levels * n_blocks * sizeof(int), st);\n"
        "    if (err != cudaSuccess) return (int)err;\n  }\n"
        "  int rc;\n  if (narrow) {")]),
    ("twice the edges in flight", "K2b", [(
        "constexpr int kK2bIn = 4;", "constexpr int kK2bIn = 8;")]),
    ("3 blocks per SM", "K2b", [(
        "__launch_bounds__(kK2bThreads, 4)\nk2b_kernel",
        "__launch_bounds__(kK2bThreads, 3)\nk2b_kernel")]),
    ("5 blocks per SM", "K2b", [(
        "__launch_bounds__(kK2bThreads, 4)\nk2b_kernel",
        "__launch_bounds__(kK2bThreads, 5)\nk2b_kernel")]),
]
K2B_BLOCK_E = (256, 1024, 2048)


def variant_path(label, source="isect"):
    return os.path.join(VARIANTS, f"{source}_" + "".join(
        c if c.isalnum() else "_" for c in label))


def build_variant(item, source="isect"):
    """Builds ``<source>.cu`` with one variant's substitutions."""
    from repro_torch.kernels import _nvcc

    label, _, subs = item
    src = open(os.path.join(CSRC, f"{source}.cu")).read()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{label}: {old!r} matches {src.count(old)} "
                             f"times in {source}.cu")
        src = src.replace(old, new)
    stem = variant_path(label, source)
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
    """One tree's timings (ms), in this process; ``only``: "k1", "k3" or
    "k2a"."""
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

    if only == "k2a":
        time_k2a(res, dev, flush, variants)
        return res
    if only == "k2b":
        time_k2b(res, dev, flush, variants)
        return res
    if only != "k3":
        time_delivery(res, dev, flush, fused, variants)
    if only != "k1":
        time_isect(res, dev, flush, triples_path, variants)
    return res


def time_k2a(res, dev, flush, variants):
    import torch

    from repro_torch.data import make_dataset
    from repro_torch.kernels.segsum import segsum

    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    n, e = hg.n_hyperedges, hg.nnz
    gen = torch.Generator(device=dev).manual_seed(7)
    dst = hg.dst.contiguous()
    perm = torch.randperm(e, generator=gen, device=dev)
    dst_p = dst[perm].contiguous()
    cases = []
    for dtype, d in ((torch.float32, 1), (torch.float32, 64),
                     (torch.bfloat16, 64)):
        m = torch.randn(e, d, generator=gen, device=dev).to(dtype)
        tag = f"{str(dtype)[6:]} D={d}"
        cases += [(tag, m, dst), (f"{tag} shuffled", m[perm].contiguous(),
                                  dst_p)]
    one = torch.randint(-8, 9, (e, 64), generator=gen, device=dev).float()
    cases.append(("one segment", one, torch.zeros_like(dst)))

    def k2a(suffix):
        for tag, m, ids in cases:
            rows = 3 if tag == "one segment" else n
            call = lambda: segsum.segsum_cuda(m, ids, rows)
            res[f"K2a {tag}{suffix}"] = cs.time_cuda(call, flush)
            res[f"K2a {tag}{suffix}, device"] = cs.time_device(call, flush)

    k2a("")
    if variants:
        # Device time of each of the call's kernels (torch.profiler,
        # 5 flushed calls).
        from torch.profiler import ProfilerActivity, profile

        for tag, m, ids in cases:
            rows = 3 if tag == "one segment" else n
            for _ in range(3):
                segsum.segsum_cuda(m, ids, rows)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    flush.zero_()
                    segsum.segsum_cuda(m, ids, rows)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if "k2a_" in ev.key:
                    name = ev.key.split("k2a_")[1].split("(")[0].split("<")[0]
                    res[f"K2a {tag} [{name}]"] = ev.device_time / 1e3
    for tag, m, ids in cases:
        rows = 3 if tag == "one segment" else n
        res[f"index_add_ {tag}"] = cs.time_cuda(
            lambda: torch.zeros(rows, m.shape[1], device=dev).index_add_(
                0, ids, m.float()).to(m.dtype), flush)
    if variants:
        from repro_torch.kernels import _nvcc

        shipped = segsum._kernel_lib()
        for label, _, _ in K2A_VARIANTS:
            _nvcc._LOADED["segsum"] = ctypes.CDLL(
                variant_path(label, "segsum") + ".so")
            segsum._kernel_lib()
            k2a(f" ({label})")
        _nvcc._LOADED["segsum"] = shipped


def time_k2b(res, dev, flush, variants):
    import torch

    from repro_torch.data import make_dataset
    from repro_torch.kernels.segsum import csr_row_offsets, segsum

    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    n, e = hg.n_hyperedges, hg.nnz
    gen = torch.Generator(device=dev).manual_seed(7)
    dst = torch.sort(hg.dst, stable=True).values.contiguous()
    cases = []   # (tag, msgs, sorted ids, offsets, rows)
    for dtype, d in ((torch.float32, 1), (torch.float32, 64),
                     (torch.bfloat16, 64)):
        m = torch.randn(e, d, generator=gen, device=dev).to(dtype)
        cases.append((f"{str(dtype)[6:]} D={d}", m, dst,
                      csr_row_offsets(dst, n), n))
    zeros = torch.zeros_like(dst)
    cases.append(("one segment", torch.randint(
        -8, 9, (e, 64), generator=gen, device=dev).float(), zeros,
        csr_row_offsets(zeros, 3), 3))
    hg_a = make_dataset("apache", 1.0, seed=0, device=dev)
    v = torch.sort(hg_a.src, stable=True).values.contiguous()
    cases.append(("Apache vertex side", torch.randn(
        v.numel(), 64, generator=gen, device=dev), v,
        csr_row_offsets(v, hg_a.n_vertices), hg_a.n_vertices))

    def k2b(suffix, **kw):
        for tag, m, _, off, rows in cases:
            call = lambda: segsum.segsum_sorted_cuda(m, off, rows, **kw)
            res[f"K2b {tag}{suffix}"] = cs.time_cuda(call, flush)
            res[f"K2b {tag}{suffix}, device"] = cs.time_device(call, flush)

    k2b("")
    for tag, m, ids, off, rows in cases:
        size = m.element_size()
        e_c, d = m.shape
        # K2b reads the messages and the offsets and writes the rows; it
        # never reads the ids.
        res[f"bound {tag}"] = (e_c * d * size + rows * d * size
                               + 4 * (rows + 1)) / cs.HBM_BYTES_PER_S * 1e3
        res[f"index_add_ {tag}"] = cs.time_cuda(
            lambda: torch.zeros(rows, d, device=dev).index_add_(
                0, ids, m.float()).to(m.dtype), flush)
    if variants:
        # Device time of each of the call's kernels (torch.profiler,
        # 5 flushed calls).
        from torch.profiler import ProfilerActivity, profile

        for tag, m, _, off, rows in cases:
            for _ in range(3):
                segsum.segsum_sorted_cuda(m, off, rows)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    flush.zero_()
                    segsum.segsum_sorted_cuda(m, off, rows)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                name = ("kernel" if "k2b_kernel" in ev.key else
                        "memset" if "emset" in ev.key and ev.count == 5
                        else None)
                if name:
                    res[f"K2b {tag} [{name}]"] = ev.device_time / 1e3
        for block_e in K2B_BLOCK_E:
            k2b(f" (block_e {block_e})", block_e=block_e)
        from repro_torch.kernels import _nvcc

        shipped = segsum._kernel_lib()
        for label, _, _ in K2B_VARIANTS:
            _nvcc._LOADED["segsum"] = ctypes.CDLL(
                variant_path(label, "segsum") + ".so")
            segsum._kernel_lib()
            k2b(f" ({label})")
        _nvcc._LOADED["segsum"] = shipped


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
    ap.add_argument("--only", choices=("k1", "k3", "k2a", "k2b"))
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
    os.makedirs(VARIANTS, exist_ok=True)
    if args.only in ("k2a", "k2b"):
        t0 = time.perf_counter()
        built = K2A_VARIANTS if args.only == "k2a" else K2B_VARIANTS
        with ThreadPoolExecutor(len(built)) as pool:
            list(pool.map(lambda v: build_variant(v, "segsum"), built))
        print(f"segsum variants in {time.perf_counter() - t0:.1f} s",
              flush=True)
    elif args.only != "k1":
        t0 = time.perf_counter()
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
