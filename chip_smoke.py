#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  It imports nothing of JAX
and nothing of the JAX package.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), the torch / CUDA
   versions, and the builds of the kernels from
   ``src/repro_torch/csrc/`` (``deliver_fused.cu`` and ``isect.cu``, one
   ``nvcc`` each, started together, timed);
2. kernel vs plain: on both delivery layouts of the DBLP regime at full
   scale, every degree class, ``deliver_fused_cuda`` against
   ``deliver_fused_plain`` for sum/min/max/prod/or, float32 and int32,
   D = 1 and 4, with and without sender activity.  Bitwise for
   min/max/or/prod and integer-valued payloads; ``rtol = atol = 1e-5``
   for random float sums;
3. the main path: ``Engine(device="cuda").run`` with
   ``delivery="pallas_fused"`` against ``delivery="xla"`` — PageRank-30
   (1e-5 relative), SSSP from vertex 0 (bitwise, equal activity stats)
   and connected components (bitwise) — and the kernel's launch count
   over each fused run against the count the layouts imply;
4. timings (CUDA events, L2 flushed before each run, warm-up, median of
   20): per class and direction the kernel, its plain version and the
   port's ``xla`` delivery of the same leaf, beside the memory bound;
   end-to-end PageRank-30 and SSSP wall time, fused vs ``xla``;
5. intersection kernels vs plain, bitwise, on the Apache regime at full
   scale (the bitset index built by the port's ``build_index`` on the
   card): ``isect_fused_cuda`` (K3b) on 4,194,304 uniform pairs, as many
   Zipf-skewed pairs, self pairs and the census's own sampled triples
   (its three pair batches and its triple batch); ``isect_cuda`` (K3a)
   on the gathered uniform pairs and on the whole index; both on a
   random ``[78,080, 101]`` bitset with bit 31 set in many words;
6. the analytics path: ``Engine(device="cuda").analyze(AnalyticsSpec(hg))``
   on Apache at full scale must resolve to bitset / bipartite / local /
   sample with the reference's reasons, launch K3a once and K3b four
   times, and give the census (counts, CI, triples seen) bit for bit as
   the ``merge`` path does; ``pair_intersections`` on the uniform pairs,
   bitset vs merge; an exact census on DBLP at scale 0.003 (where
   ``auto`` resolves to exact + bitset) against the ``clique``
   representation; a tiny exact census against a python-set oracle.
   Timings: per census batch the kernel, its plain version and the
   bound (CUDA events, L2 flushed, median of 20), and ``analyze``'s wall
   time split into host preprocessing, intersection calls and
   classification.

Prints the kernel line (JSON) and, last, the device line (JSON).  Exits
non-zero, printing no result, when there is no card.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
# __popc results per clock per SM for compute capability 9.0: 16 (CUDA
# C++ Programming Guide, "Arithmetic Instructions", throughput table,
# row "population count").  Times the SMs and the max SM clock.
POPC_PER_CLOCK_PER_SM = 16
N_TIMED = 20
N_WARM = 3
N_PAIRS = 4_194_304
PLAIN_TILE = 1 << 18             # pairs per step of the plain version
# Reasons the reference's cost models give on Apache at full scale.
APACHE_DESIGN = {
    "kernel": ("bitset", "vocabulary small: word lanes beat sort-merge"),
    "representation": ("bipartite", "dual expansion exceeds edge budget: "
                       "derive intersections from the incidence"),
    "backend": ("local", "no mesh available"),
    "mode": ("sample", "overlap graph too large: sample linked pairs"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def same_bits(a, b):
    """Bitwise equality, NaN positions included."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        na, nb = a.isnan(), b.isnan()
        if not torch.equal(na, nb):
            return False
        a = torch.where(na, torch.zeros_like(a), a).view(torch.int32)
        b = torch.where(nb, torch.zeros_like(b), b).view(torch.int32)
    return torch.equal(a, b)


def time_cuda(fn, flush):
    """Median ms of ``fn()`` over ``N_TIMED`` runs, each after an L2
    flush, timed with CUDA events around the call alone."""
    import torch

    for _ in range(N_WARM):
        fn()
    times = []
    for _ in range(N_TIMED):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def payloads(rng, n_src, d, dtype_name, monoid):
    """(payload, exact) pairs for one kernel check: host numpy, seeded."""
    import numpy as np

    shape = (n_src, d)
    if dtype_name == "int32":
        full = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
        if monoid == "or":
            return [(rng.integers(0, 2, shape).astype(np.int32), True)]
        return [(full.astype(np.int32), True)]
    if monoid == "sum":
        return [
            (rng.integers(-8, 9, shape).astype(np.float32), True),
            (rng.standard_normal(shape).astype(np.float32), False),
        ]
    if monoid == "prod":
        return [(rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape,
                            p=[0.45, 0.1, 0.45]), True)]
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 1e-3] = np.nan
    return [(x, True)]


def check_kernel(layouts, rng):
    """Phase 2: every class of both layouts, kernel vs plain."""
    import torch

    from repro_torch.kernels.deliver.fused import (
        deliver_fused_cuda,
        deliver_fused_plain,
    )
    from repro_torch.sparse.segment import MONOIDS

    dev = torch.device("cuda")
    n_checks, max_err = 0, 0.0
    cases = [("float32", m) for m in ("sum", "min", "max", "prod")]
    cases += [("int32", m) for m in ("sum", "min", "max", "prod", "or")]
    for direction, lay in layouts:
        n_src = lay.n_src
        for d in (1, 4):
            for dtype_name, monoid in cases:
                kernel_monoid = "max" if monoid == "or" else monoid
                for payload, exact in payloads(rng, n_src, d, dtype_name,
                                               monoid):
                    msgs = torch.as_tensor(payload, device=dev)
                    ident = MONOIDS[kernel_monoid].identity(msgs.dtype)
                    msgs_aug = torch.cat([
                        msgs, torch.full((1, d), ident, dtype=msgs.dtype,
                                         device=dev)]).contiguous()
                    act = torch.as_tensor(
                        (rng.random(n_src + 1) < 0.7).astype("int32"),
                        device=dev)
                    act[-1] = 1
                    for act_aug in (None, act):
                        for c in range(lay.n_classes):
                            args = (msgs_aug, act_aug, lay.class_src[c],
                                    lay.class_dst[c], lay.class_bounds[c],
                                    lay.class_rows[c], kernel_monoid)
                            kw = dict(block_n=lay.block_n,
                                      block_e=lay.class_block_e[c])
                            got = deliver_fused_cuda(*args, **kw)
                            want = deliver_fused_plain(*args, **kw)
                            torch.cuda.synchronize()
                            tag = (direction, c, monoid, dtype_name, d,
                                   act_aug is not None)
                            if monoid == "or":
                                got, want = got > 0, want > 0
                            if exact:
                                if not same_bits(got, want):
                                    fail(f"kernel != plain (bitwise) {tag}")
                            else:
                                err = (got - want).abs().max().item()
                                max_err = max(max_err, err)
                                if not torch.allclose(got, want, rtol=1e-5,
                                                      atol=1e-5):
                                    fail(f"kernel !~ plain {tag}: max abs "
                                         f"err {err}")
                            n_checks += 1
    return n_checks, max_err


def leaf_counts(spec):
    """Message leaves per direction: the vertex program's message on the
    initial state (fwd) and the hyperedge-bound message shape, which is
    ``initial_msg``'s (bwd)."""
    import torch

    from repro_torch.core.api import constant_initial_msg, tree_leaves

    hg = spec.hg0
    ids = torch.arange(hg.n_vertices, dtype=torch.int32, device=hg.device)
    msg0 = constant_initial_msg(spec.initial_msg, hg.n_vertices, hg.device)
    out = spec.v_program.procedure(0, ids, hg.v_attr, msg0, hg.degrees())
    return len(tree_leaves(out.msg)), len(tree_leaves(spec.initial_msg))


def run_fused_counted(eng, spec):
    """One fused run with the launch counter zeroed just before and read
    just after; checks it against the count the layouts imply."""
    from repro_torch.kernels.deliver.fused import deliver_fused_cuda

    fwd, bwd = eng._delivery_layouts(spec.hg0)  # built before counting
    n_fwd, n_bwd = leaf_counts(spec)
    per_pair = fwd.n_classes * n_fwd + bwd.n_classes * n_bwd
    deliver_fused_cuda.launches = 0
    res = eng.run(spec, delivery="pallas_fused")
    launches = deliver_fused_cuda.launches
    pairs = res.decision["measured"]["pairs_run"]
    log(f"  {spec.name}: fused launches {launches} = {pairs} pairs x "
        f"({fwd.n_classes} fwd classes x {n_fwd} leaves + "
        f"{bwd.n_classes} bwd classes x {n_bwd} leaves)")
    if launches != pairs * per_pair or launches == 0:
        fail(f"{spec.name}: {launches} launches, layouts imply "
             f"{pairs * per_pair}")
    return res, launches


def build_kernels():
    """Phase 1: one ``nvcc`` per kernel source, all started together;
    returns each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.deliver import fused
    from repro_torch.kernels.isect import isect

    sources = {"deliver_fused": ("deliver_fused.cu",),
               "isect": ("isect.cu",)}

    def one(item):
        t0 = time.perf_counter()
        _nvcc.build(*item)
        return item[0], time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(pool.map(one, sources.items()))
    fused._kernel_lib()
    isect._kernel_lib()
    return seconds


def card_ids(x, dev):
    import numpy as np
    import torch

    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                           device=dev)


def census_batches(triples, dev):
    """The four intersection batches of one census over ``[T, 3]``
    triples (as ``triple_profiles`` sends them)."""
    a, b, c = (card_ids(triples[:, i], dev) for i in range(3))
    return {"census a&b": (a, b), "census b&c": (b, c),
            "census c&a": (c, a), "census a&b&c": (a, b, c)}


def check_isect(bits, rng, dev, batches):
    """Phase 5: every batch through K3b and the pre-gathered pairs
    through K3a, against the plain versions, bitwise.  Returns (checks,
    max abs err, the uniform pairs as host arrays)."""
    import numpy as np
    import torch

    from repro_torch.kernels.isect import (
        isect_cuda,
        isect_fused_cuda,
        isect_fused_plain,
        isect_plain,
    )

    n_checks, max_err = 0, 0

    def same(tag, got, want):
        nonlocal n_checks, max_err
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.int32:
            fail(f"isect {tag}: shape/dtype {tuple(got.shape)} {got.dtype}")
        err = int((got.to(torch.int64) - want).abs().max()) if len(got) else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"isect kernel != plain (bitwise) on {tag}: max abs err "
                 f"{err}")
        n_checks += 1

    e, w = bits.shape
    host_uni = [rng.integers(0, e, N_PAIRS) for _ in range(2)]
    perm = rng.permutation(e)
    cases = dict(batches)
    cases["uniform"] = tuple(card_ids(x, dev) for x in host_uni)
    cases["zipf"] = tuple(
        card_ids(perm[(rng.zipf(1.2, N_PAIRS) - 1) % e], dev)
        for _ in range(2))
    ids = card_ids(np.arange(e), dev)
    cases["self"] = (ids, ids)
    wide = rng.integers(-2**31, 2**31, (e, 101), dtype=np.int64)
    wide[rng.random(wide.shape) < 0.05] = -1
    wide = card_ids(wide, dev)
    for name, table in ((f"W={w}", bits), ("random W=101", wide)):
        for case, abc in cases.items():
            if table is wide and case not in ("uniform", "self"):
                continue
            got = isect_fused_cuda(table, *abc)
            want = isect_fused_plain(table, *abc, tile=PLAIN_TILE)
            same(f"K3b {name} {case} ({len(abc[0])})", got, want)
        ua, ub = (table.index_select(0, x) for x in cases["uniform"])
        same(f"K3a {name} uniform", isect_cuda(ua, ub),
             isect_plain(ua, ub, tile=PLAIN_TILE))
        same(f"K3a {name} whole table", isect_cuda(table, table),
             isect_plain(table, table, tile=PLAIN_TILE))
        del ua, ub
    card = isect_cuda(bits, bits)
    if not torch.equal(isect_fused_cuda(bits, ids, ids), card):
        fail("self pairs do not give |e|")
    return n_checks, max_err, host_uni


def isect_bound(p, n_ids, w, unique_rows, popc_rate):
    """(bytes s, popcount s): the id streams, the output and the
    distinct rows read once, over the memory rate; P x W popcounts over
    the card's popcount rate."""
    n_bytes = 4 * p * n_ids + 4 * p + 4 * w * unique_rows
    return n_bytes / HBM_BYTES_PER_S, p * w / popc_rate


def time_isect(bits, batches, flush, popc_rate):
    """Per census batch: K3b, its plain version and the bound; then K3a
    on the whole index (the cardinalities the census reads).  Returns
    the two kernels' entries of the kernel line (launches filled in by
    the caller)."""
    import torch

    from repro_torch.kernels.isect import (
        isect_cuda,
        isect_fused_cuda,
        isect_fused_plain,
        isect_plain,
    )

    e, w = bits.shape
    fused = {"ms": 0.0, "plain_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
    for name, abc in batches.items():
        k_ms = time_cuda(lambda: isect_fused_cuda(bits, *abc), flush)
        p_ms = time_cuda(
            lambda: isect_fused_plain(bits, *abc, tile=PLAIN_TILE), flush)
        p = len(abc[0])
        rows = int(torch.unique(torch.cat(abc)).numel())
        b_s, o_s = isect_bound(p, len(abc), w, rows, popc_rate)
        fused["ms"] += k_ms
        fused["plain_ms"] += p_ms
        fused["bytes_s"] += b_s
        fused["ops_s"] += o_s
        log(f"  K3b {name}: P={p} W={w} rows={rows}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{max(b_s, o_s) * 1e3:.4f} ms (bytes {b_s * 1e3:.4f} ms, "
            f"popcounts {o_s * 1e3:.4f} ms); {p * w / (k_ms * 1e-3):.4g} "
            f"popcounts/s")
    k_ms = time_cuda(lambda: isect_cuda(bits, bits), flush)
    p_ms = time_cuda(lambda: isect_plain(bits, bits, tile=PLAIN_TILE),
                     flush)
    # a and b are the same [E, W] table: one input, read once.
    b_s = (4 * e * w + 4 * e) / HBM_BYTES_PER_S
    o_s = e * w / popc_rate
    log(f"  K3a whole index (cardinalities): E={e} W={w}: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{max(b_s, o_s) * 1e3:.4f} ms (bytes {b_s * 1e3:.4f} ms, "
        f"popcounts {o_s * 1e3:.4f} ms)")
    entries = {
        "isect": {"ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": max(b_s, o_s) * 1e3,
                  "bound_by": "bytes" if b_s >= o_s else "operations"},
        "isect_fused": {
            "ms": fused["ms"], "plain_ms": fused["plain_ms"],
            "bound_ms": max(fused["bytes_s"], fused["ops_s"]) * 1e3,
            "bound_by": ("bytes" if fused["bytes_s"] >= fused["ops_s"]
                         else "operations"),
        },
    }
    return entries


def log_measured(label, res):
    m = res.decision["measured"]
    other = (m["wall_s"] - m["preprocess_s"] - m["intersect_s"]
             - m["classify_s"])
    log(f"  {label}: wall {m['wall_s']:.3f} s = preprocess "
        f"{m['preprocess_s']:.3f} s + intersect {m['intersect_s']:.3f} s "
        f"({m['intersect_calls']} calls) + classify {m['classify_s']:.3f} "
        f"s + other {other:.3f} s")


def same_census(a, b, fields):
    import numpy as np

    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))) for f in fields)


def brute_force_census(hg):
    """The O(E^3) python-set oracle of ``tests/test_motifs.py``."""
    import itertools

    import numpy as np

    from repro_torch.motifs import CLASS_OF_PATTERN, N_HMOTIF_CLASSES

    src, dst = hg.src.cpu().numpy(), hg.dst.cpu().numpy()
    sets = [set(src[dst == e].tolist()) for e in range(hg.n_hyperedges)]
    counts = np.zeros(N_HMOTIF_CLASSES, np.int64)
    for a, b, c in itertools.combinations(range(hg.n_hyperedges), 3):
        sa, sb, sc = sets[a], sets[b], sets[c]
        if bool(sa & sb) + bool(sb & sc) + bool(sc & sa) < 2:
            continue
        regions = [sa - sb - sc, sb - sa - sc, (sa & sb) - sc,
                   sc - sa - sb, (sa & sc) - sb, (sb & sc) - sa,
                   sa & sb & sc]
        cls = CLASS_OF_PATTERN[sum((len(r) > 0) << i
                                   for i, r in enumerate(regions))]
        if cls >= 0:
            counts[cls] += 1
    return counts


def intersections_vs_plain(dev, rng, scale=1.0):
    """Phase 5 on the Apache regime at ``scale``: the bitset index, the
    census's own sampled triples, and every kernel-vs-plain check."""
    from repro_torch.core import AnalyticsSpec
    from repro_torch.data import make_dataset
    from repro_torch.motifs import (
        build_index,
        build_overlap_graph,
        overlap_pairs_with_counts,
        sample_triples,
    )

    t0 = time.perf_counter()
    hg_a = make_dataset("apache", scale, seed=0, device=dev)
    index = build_index(hg_a, "bitset")
    bits = index.data
    t_idx = time.perf_counter() - t0
    pairs, n_shared = overlap_pairs_with_counts(hg_a)
    og = build_overlap_graph(hg_a, pairs)
    t_og = time.perf_counter() - t0 - t_idx
    _, triples = sample_triples(og, AnalyticsSpec(hg_a).n_samples,
                                hg_a.n_hyperedges, seed=0)
    t_tri = time.perf_counter() - t0 - t_idx - t_og
    log(f"apache: |V|={hg_a.n_vertices} |E|={hg_a.n_hyperedges} "
        f"nnz={hg_a.nnz}; bitset index {tuple(bits.shape)} "
        f"({index.nbytes} bytes, {t_idx:.1f} s); {len(pairs)} overlap "
        f"pairs, overlap graph in {t_og:.1f} s; {len(triples)} sampled "
        f"triples in {t_tri:.1f} s")
    del pairs, n_shared, og
    batches = census_batches(triples, dev)
    n_isect, isect_err, host_uni = check_isect(bits, rng, dev, batches)
    log(f"phase 5: {n_isect} intersection kernel-vs-plain checks bitwise "
        f"equal in {time.perf_counter() - t0:.1f} s")

    return hg_a, bits, triples, batches, isect_err, host_uni


def analytics_path(dev, hg_a, triples, batches, host_uni):
    """Phase 6: ``Engine.analyze`` on the Apache hypergraph (the main
    path, launches counted), against the merge path, plus the exact
    census checks.  Returns the K3a and K3b launches of the main run."""
    import numpy as np

    from repro_torch.core import AnalyticsSpec, Engine
    from repro_torch.data import make_dataset, powerlaw_hypergraph
    from repro_torch.kernels.isect import isect_cuda, isect_fused_cuda
    from repro_torch.motifs import N_HMOTIF_CLASSES

    t0 = time.perf_counter()
    aeng = Engine(device=dev)
    spec = AnalyticsSpec(hg_a)
    isect_cuda.launches = 0
    isect_fused_cuda.launches = 0
    res = aeng.analyze(spec)
    k3a_launches = isect_cuda.launches
    k3b_launches = isect_fused_cuda.launches
    got = {"kernel": res.kernel, "representation": res.representation,
           "backend": res.backend, "mode": res.mode}
    for axis, (value, reason) in APACHE_DESIGN.items():
        if got[axis] != value or res.decision[axis]["reason"] != reason:
            fail(f"apache analyze {axis}: {got[axis]} "
                 f"({res.decision[axis]['reason']!r}), expected {value}")
    log(f"  design point {got}")
    for axis in APACHE_DESIGN:
        log(f"    {axis}: " + ", ".join(
            f"{k}={v}" for k, v in res.decision[axis].items()))
    log(f"  launches in analyze: K3a {k3a_launches} (cardinalities), K3b "
        f"{k3b_launches} (3 pair batches + 1 triple batch)")
    if (k3a_launches, k3b_launches) != (1, 4):
        fail(f"analyze launched K3a {k3a_launches} and K3b {k3b_launches} "
             "times, expected 1 and 4")
    est = res.value
    if len(triples) != len(batches["census a&b"][0]) or (
            est.n_triples_seen > len(triples)):
        fail("the census's triples are not the ones phase 5 checked")
    if est.counts.shape != (N_HMOTIF_CLASSES,) or not (
            np.isfinite(est.counts).all() and (est.ci_low <= est.counts).all()
            and (est.counts <= est.ci_high).all() and est.total > 0):
        fail("census estimate is not finite, positive and inside its CI")
    log_measured("analyze (bitset)", res)
    res_m = aeng.analyze(spec, intersect_kernel="merge")
    log_measured("analyze (merge)", res_m)
    fields = ("counts", "ci_low", "ci_high", "n_triples_seen", "n_pairs")
    if res_m.kernel != "merge" or not same_census(est, res_m.value, fields):
        fail("apache census: bitset != merge")
    log(f"  census bitset == merge, bitwise: {est.n_triples_seen} triples "
        f"of {est.n_samples} samples over {est.n_pairs} linked pairs, "
        f"total ~{est.total:.6g}")

    ptask = AnalyticsSpec(hg_a, task="pair_intersections",
                          pairs=tuple(host_uni))
    pk = aeng.analyze(ptask, representation="bipartite")
    pm = aeng.analyze(ptask, representation="bipartite",
                      intersect_kernel="merge")
    if pk.kernel != "bitset" or not np.array_equal(pk.value[1],
                                                   pm.value[1]):
        fail("pair_intersections: bitset != merge")
    log(f"  pair_intersections on {N_PAIRS} uniform pairs: bitset == "
        f"merge (intersect {pk.decision['measured']['intersect_s']:.3f} s "
        f"vs {pm.decision['measured']['intersect_s']:.3f} s)")

    hg_x = make_dataset("dblp", 0.003, seed=0, device=dev)
    ex = aeng.analyze(AnalyticsSpec(hg_x))
    if (ex.mode, ex.kernel) != ("exact", "bitset"):
        fail(f"dblp 0.003 resolved to {ex.mode}/{ex.kernel}")
    ex_c = aeng.analyze(AnalyticsSpec(hg_x), representation="clique")
    ex_m = aeng.analyze(AnalyticsSpec(hg_x), intersect_kernel="merge")
    cf = ("counts", "n_triples", "n_duplicate_triples", "n_pairs")
    if not (same_census(ex.value, ex_c.value, cf)
            and same_census(ex.value, ex_m.value, cf)):
        fail("exact census: bipartite/clique/merge disagree")
    log(f"  exact census, dblp 0.003 (|V|={hg_x.n_vertices} "
        f"|E|={hg_x.n_hyperedges}, W={(hg_x.n_vertices + 31) // 32}): "
        f"{ex.mode}/{ex.kernel}/{ex.representation}; "
        f"{ex.value.n_triples} triples over {ex.value.n_pairs} pairs, "
        f"equal under clique and merge")
    tiny = powerlaw_hypergraph(40, 36, mean_cardinality=4, seed=7,
                               device=dev)
    tc = aeng.analyze(AnalyticsSpec(tiny, mode="exact"),
                      intersect_kernel="bitset", representation="bipartite")
    if not np.array_equal(tc.value.counts, brute_force_census(tiny)):
        fail("tiny exact census != python-set oracle")
    log(f"  tiny exact census == python-set oracle ({tc.value.n_triples} "
        f"triples)")
    log(f"phase 6: analytics path agrees in {time.perf_counter() - t0:.1f} "
        "s")

    return k3a_launches, k3b_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.algorithms import (
        connected_components_spec,
        pagerank_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine, Program, deliver
    from repro_torch.data import make_dataset
    from repro_torch.kernels.deliver import fused

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build_kernels()
    log(f"phase 1: built " + ", ".join(
        f"{k} in {v:.1f} s" for k, v in built.items())
        + f" (together {time.perf_counter() - t0:.1f} s)")

    # -- phase 2: kernel vs plain at DBLP scale --------------------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    t_gen = time.perf_counter() - t0
    eng = Engine(device=dev, collect_stats=True)
    t0 = time.perf_counter()
    fwd, bwd = eng._delivery_layouts(hg)
    t_lay = time.perf_counter() - t0
    log(f"dblp: |V|={hg.n_vertices} |E|={hg.n_hyperedges} nnz={hg.nnz} "
        f"(generated {t_gen:.1f} s, layouts {t_lay:.1f} s)")
    for name, lay in (("fwd", fwd), ("bwd", bwd)):
        log(f"  {name}: widths {lay.class_widths} rows {lay.class_rows} "
            f"lanes {tuple(int(a.shape[0]) for a in lay.class_src)} "
            f"max_blocks {lay.class_max_blocks} block_e {lay.class_block_e}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    n_checks, max_err = check_kernel((("fwd", fwd), ("bwd", bwd)), rng)
    log(f"phase 2: {n_checks} kernel-vs-plain checks passed "
        f"(max abs err on random float sums {max_err:.3g}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path ------------------------------------------------
    t0 = time.perf_counter()
    pr = pagerank_spec(hg, iters=30)
    pr_f, pr_launches = run_fused_counted(eng, pr)
    pr_x = eng.run(pr, delivery="xla")
    rel = 0.0
    for a, b in zip(pr_f.value, pr_x.value):
        rel = max(rel, ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item())
    log(f"  pagerank-30: fused vs xla max relative error {rel:.3g}")
    if not rel <= 1e-5:
        fail(f"pagerank fused vs xla relative error {rel}")

    sp = shortest_paths_spec(hg, 0)
    sp_f, _ = run_fused_counted(eng, sp)
    sp_x = eng.run(sp, delivery="xla")
    for a, b in zip(sp_f.value, sp_x.value):
        if not same_bits(a, b):
            fail("sssp fused != xla")
    for a, b in zip(sp_f.superstep_stats, sp_x.superstep_stats):
        if not torch.equal(a, b):
            fail("sssp activity stats differ")
    reached = int(torch.isfinite(sp_f.value[0]).sum())
    log(f"  sssp: bitwise, {sp_f.decision['measured']['supersteps']} "
        f"supersteps, {reached} vertices reached")

    cc = connected_components_spec(hg)
    cc_f, _ = run_fused_counted(eng, cc)
    cc_x = eng.run(cc, delivery="xla")
    for a, b in zip(cc_f.value, cc_x.value):
        if not same_bits(a, b):
            fail("connected components fused != xla")
    n_comp = int(torch.unique(cc_f.value[0]).numel())
    log(f"  components: bitwise, {n_comp} components, "
        f"{cc_f.decision['measured']['supersteps']} supersteps, "
        f"{cc_f.decision['measured']['host_syncs']} host syncs")
    for v, n in zip(pr_f.value, (hg.n_vertices, hg.n_hyperedges)):
        if v.shape != (n,) or not torch.isfinite(v).all() or (v <= 0).any():
            fail("pagerank ranks are not finite, positive, of shape [n]")
    if any(v.isnan().any() for v in sp_f.value):
        fail("NaN in sssp distances")
    log(f"phase 3: main path agrees in {time.perf_counter() - t0:.1f} s")

    # -- phase 4: timings ------------------------------------------------------
    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    sum_prog = Program(procedure=None, combiner="sum")
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0}
    log("phase 4: float32 sum, D=1, no activity (PageRank's v->he leaf); "
        "L2 flushed before each run; median of 20")
    for name, lay, src, dst, n_dst in (
            ("fwd", fwd, hg.src, hg.dst, hg.n_hyperedges),
            ("bwd", bwd, hg.dst, hg.src, hg.n_vertices)):
        msgs = torch.rand(lay.n_src, 1, device=dev)
        msgs_aug = torch.cat([msgs, torch.zeros(1, 1, device=dev)])
        for c in range(lay.n_classes):
            args = (msgs_aug, None, lay.class_src[c], lay.class_dst[c],
                    lay.class_bounds[c], lay.class_rows[c], "sum")
            kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[c])
            k_ms = time_cuda(lambda: fused.deliver_fused_cuda(*args, **kw),
                             flush)
            p_ms = time_cuda(lambda: fused.deliver_fused_plain(*args, **kw),
                             flush)
            lanes = int(lay.class_src[c].shape[0])
            rows = lay.class_rows[c]
            real = lay.class_dst[c] < rows
            nnz_c = int(real.sum())
            msg_rows = int(torch.unique(lay.class_src[c][real]).numel())
            # Each input read once, each output written once: the src and
            # dst index streams, the tile table, the message rows the
            # class references, the output rows (all 4-byte words).
            n_bytes = 4 * (2 * lanes + lay.class_bounds[c].numel()
                           + msg_rows + rows)
            bound = max(n_bytes / HBM_BYTES_PER_S, nnz_c / FP32_OPS_PER_S)
            totals["ms"] += k_ms
            totals["plain_ms"] += p_ms
            totals["bound_ms"] += bound * 1e3
            log(f"  {name} class {c} (width {lay.class_widths[c]}, rows "
                f"{rows}, lanes {lanes}, blocks {lay.class_max_blocks[c]}): "
                f"kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, "
                f"bound {bound * 1e6:.1f} us ({n_bytes / 1e6:.2f} MB, "
                f"{nnz_c} real lanes, {msg_rows} message rows)")
        msgs_1d = msgs[:, 0].contiguous()
        x_ms = time_cuda(
            lambda: deliver(msgs_1d, None, src, dst, n_dst, sum_prog), flush)
        f_ms = time_cuda(
            lambda: fused.deliver_fused_classes(msgs_aug, None, lay, "sum"),
            flush)
        totals["library_ms"] += x_ms
        log(f"  {name} leaf: fused delivery (all classes + inv_perm "
            f"assembly) {f_ms * 1e3:.1f} us; xla lowering (index_select "
            f"gather + where + scatter_reduce: stock calls, not one) "
            f"{x_ms * 1e3:.1f} us")

    walls = {}
    for label, spec in (("pagerank-30", pr), ("sssp", sp)):
        for delivery in ("pallas_fused", "xla"):
            eng.run(spec, delivery=delivery)  # warm-up
            m = eng.run(spec, delivery=delivery).decision["measured"]
            walls[(label, delivery)] = m
            log(f"  e2e {label} {delivery}: wall {m['wall_s'] * 1e3:.1f} "
                f"ms (dispatch {m['dispatch_s'] * 1e3:.1f} ms, device wait "
                f"{m['device_wait_s'] * 1e3:.1f} ms), {m['pairs_run']} "
                f"pairs, {m['host_syncs']} host syncs")
    log(f"phase 4: timed in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    del fwd, bwd, hg, eng, pr, sp, cc, pr_f, pr_x, sp_f, sp_x, cc_f, cc_x

    # -- phase 5: intersection kernels vs plain at Apache scale ---------------
    hg_a, bits, triples, batches, isect_err, host_uni = (
        intersections_vs_plain(dev, rng))

    # -- phase 6: the analytics path -------------------------------------------
    k3a_launches, k3b_launches = analytics_path(dev, hg_a, triples, batches,
                                                host_uni)

    # -- timings of the intersection kernels -----------------------------------
    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]) * 1e6
    popc_rate = sms * POPC_PER_CLOCK_PER_SM * clock
    log(f"timings: {sms} SMs x {POPC_PER_CLOCK_PER_SM} popc/clock x "
        f"{clock / 1e6:.0f} MHz = {popc_rate:.4g} popcounts/s; L2 flushed "
        "before each run; median of 20")
    isect_entries = time_isect(bits, batches, flush, popc_rate)
    log(f"timings: done in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "deliver_fused",
        "route": "cuda",
        "source": "src/repro_torch/csrc/deliver_fused.cu",
        "replaces": "src/repro/kernels/deliver/fused.py:126",
        "launches": pr_launches,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
    }]
    for name, replaces, launches in (
            ("isect", "src/repro/kernels/isect/isect.py:63", k3a_launches),
            ("isect_fused", "src/repro/kernels/isect/isect.py:115",
             k3b_launches)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/isect.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": float(isect_err),
            **isect_entries[name],
            "library_ms": None,  # torch has no popcount op
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
