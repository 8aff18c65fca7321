#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  It imports nothing of JAX
and nothing of the JAX package.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), the torch / CUDA
   versions, and the builds of the kernels from
   ``src/repro_torch/csrc/`` (``deliver_fused.cu``, ``isect.cu``,
   ``segsum.cu`` and ``flash.cu``, one ``nvcc`` each, started together,
   timed), with ``ptxas``'s registers, spills and shared memory for
   each ``flash`` template and each ``segsum`` kernel;
2. kernel vs plain: on both delivery layouts of the DBLP regime at full
   scale, and on a bucket-padded v->he layout (a tenth of the
   incidences dead, so some hyperedges have live degree 0; every class
   padded to twice its rows, so half the slots are dead), the leaf
   kernel (``deliver_leaf_cuda``, one launch over every class) against
   ``deliver_fused_classes(..., lowering="plain")``, and every class
   through a one-class plan (``deliver_fused_cuda``) against
   ``deliver_fused_plain``, for sum/min/max/prod/or, float32 and int32,
   D = 1 and 4, with no activity, int32 activity and (the leaf) bool
   activity.  Bitwise for min/max/or/prod and integer-valued payloads;
   ``rtol = atol = 1e-5`` for random float sums (the plain version run
   in float64);
3. the main path: ``Engine(device="cuda").run`` with
   ``delivery="pallas_fused"`` against ``delivery="xla"`` — PageRank-30
   (1e-5 relative), SSSP from vertex 0 (bitwise, equal activity stats)
   and connected components (bitwise) — and the kernel's launch count
   over each fused run: exactly one per leaf and direction, pairs x
   (fwd leaves + bwd leaves);
4. timings (CUDA events, L2 flushed before each run, warm-up, median of
   20; beside them the device time of 20 flushed calls queued back to
   back, less the flushes, which leaves out the host's share of a
   call): per class and direction the kernel through a one-class plan and
   its plain version beside the memory bound; per leaf the one launch
   against the sum of its class bounds, its plain version and the
   port's ``xla`` delivery of the same leaf; end-to-end PageRank-30 and
   SSSP wall time, fused vs ``xla``;
5. intersection kernels vs plain, bitwise, on the Apache regime at full
   scale (the bitset index built by the port's ``build_index`` on the
   card): ``isect_fused_cuda`` (K3b) on 4,194,304 uniform pairs, as many
   Zipf-skewed pairs, self pairs and the census's own sampled triples
   (its three pair batches and its triple batch); ``isect_cuda`` (K3a)
   on the gathered uniform pairs and on the whole index; both on a
   random ``[78,080, 101]`` bitset with bit 31 set in many words; and
   the run cache's cases (alternating ids, runs across the 32-pair
   chunks, runs of one, P = 33 and 1, triples) at W = 1, 3, 101, 104,
   200 and on an unaligned base;
6. the analytics path: ``Engine(device="cuda").analyze(AnalyticsSpec(hg))``
   on Apache at full scale must resolve to bitset / bipartite / local /
   sample with the reference's reasons, launch K3a once and K3b four
   times, and give the census (counts, CI, triples seen) bit for bit as
   the ``merge`` path does; ``pair_intersections`` on the uniform pairs,
   bitset vs merge; an exact census on DBLP at scale 0.003 (where
   ``auto`` resolves to exact + bitset) against the ``clique``
   representation; a tiny exact census against a python-set oracle.
   Timings: per census batch the kernel, its plain version and the
   bound (CUDA events, L2 flushed, median of 20), the L2 row traffic a
   kernel without the run cache would read beside the L2 read rate
   measured on the table, and ``analyze``'s wall time split into host
   preprocessing, intersection calls and classification;
7. segment sum on the DBLP incidences at full scale (2,838,951 into
   782,659 hyperedges): ``segment_sum_mxu`` unsorted (K2a, the
   generator's order) and ``sorted_dst=True`` (K2b, ``sorted_by_dst``'s
   order) on float32 D = 1 and 64 and bfloat16 D = 64, launches counted,
   each against its plain version (float32 with
   ``tests/test_kernels.py``'s tolerance, bfloat16 within two bf16
   steps); K2b bitwise equal over two runs; K2a on shuffled ids; one
   segment taking every edge, an E that is no multiple of ``block_e``,
   ids outside ``[0, N)`` dropped, E = 0 giving zeros without a launch;
   K2b on Apache's vertex side (``make_dataset("apache", 1.0)``'s
   432,872 incidences sorted by vertex into 3,316 rows, the longest
   6,465 edges; float32 D = 64), repeatable.  Timings: kernel, plain
   version and ``index_add_`` into float32 beside the byte bound (CUDA
   events, L2 flushed, median of 20); K2a on shuffled ids (its sum over
   the three configs is the kernel line's ``shuffled_ms``); K2a and K2b
   on the one segment and K2b on Apache's vertex side, beside
   ``index_add_`` and the bound (the K2b line's ``phase7_one_segment_*``
   and ``phase7_skew_*`` keys);
8. attention through ``flash_attention`` (K4: bfloat16 on the tensor
   cores, float32 on the FMA units) at llama3.2-1b's width (32 heads of
   64): bfloat16 causal S = 32,768 (``prefill_32k``'s length, one
   sequence of its batch), float32 causal S = 4,096, bfloat16
   bidirectional S = 4,096, causal S = 32,040 (no multiple of the key
   tiles: partial last key and query tiles); at gemma3-12b's (16 heads
   of 256), bfloat16 causal S = 8,192; and at command-r-plus-104b's (96
   heads of 128), bfloat16 causal S = 8,192.  Launches counted; each
   against its plain version, elementwise (float32 2e-5, bfloat16 rtol
   1e-2 atol 5e-3) and per row relative to the row's largest value
   (float32 1e-4, bfloat16 2e-2), a limit that two planted faults (a
   dropped key tile, late denominators 5% high) must exceed; the first
   case bitwise equal over two runs.  Timings: kernel, plain version and
   ``scaled_dot_product_attention`` beside the larger of the byte bound
   and the operation bound (flops over the tensor-core or float32 FMA
   rate, exps over the MUFU rate; median of 3), the kernel's share of
   its bound and its TFLOP/s;
9. compile-once serving on DBLP at full scale through
   ``Engine(delivery="pallas_fused").compile``, each path's K1 launches
   counted from 0 and read after it (one per leaf and pair, every one
   replayed from the path's CUDA graph; PageRank-30: 90): compiled
   PageRank-30 against ``Engine.run`` (1e-5 relative), compiled SSSP
   from three sources (bitwise, equal stats) and components (bitwise),
   ``run_batch`` of 64 SSSP sources against 64 ``run(query=)`` calls
   (bitwise, equal stats, ``supersteps_executed`` the slowest query's)
   and of 8 personalized-walk seeds (1e-5 relative); second calls are
   cache hits with no new capture; no Result carries ``degraded_from``;
   a failing K1 launch raises from ``run`` (no plain twin on the card)
   and leaves no cache entry; the 64-query entry's bytes (its tensors
   and graph pool) against what the card allocated around its build,
   and the cache within its byte bound.
   Timings: compiled against ``Engine.run`` wall for PageRank-30 and
   SSSP (medians of 5, with dispatch, device wait and host syncs), the
   batch's queries/s against 64 sequential ``run(query=)`` calls and
   ``Engine.run``, and K1 at D = 1, 8 and 64 on the bucket-padded
   layout (call and device time) against ``deliver_leaf_plain``
   (bitwise), the port's ``xla`` lowering of the same leaf (bitwise;
   the K1 line's ``d8_library_ms`` / ``d64_library_ms``) and its byte
   bound, beside the per-query activity pass the batched path runs
   before it;
10. the card's delivery term: one delivery pair (v->he, then he->v),
   float32 sum, through ``deliver``'s ``xla`` lowering and the fused K1
   leaf, on DBLP at scales 0.002, 0.01, 0.05, 0.25 and 1.0 (5,660 to
   2,838,951 incidences) and D = 1, 2, 8, 16 and 64, each pair checked
   (1e-5) and timed (L2 flushed, median of 20); the grid is printed
   with ``select_delivery``'s pick, which must be the faster path at
   every point unless the two are within 10% (logged), and the traffic
   model's calibration record (``obs.delivery_calibration``);
11. the clique representation on DBLP at full scale: ``to_graph``
   (33,490,568 symmetric edges, timed), ``Engine(representation=
   "clique").run(vertex_pagerank_spec(hg))`` with K2's launches counted
   from 0 and read after it (K2b once an iteration: 30; K2a none: the
   out-weights take ``index_add_``, which measured faster there),
   ``graph_pagerank`` against its plain version (1e-5 relative), K2b
   bitwise equal over 31 calls with one set of offsets, ``auto``
   resolving bipartite on DBLP and clique on Fig. 1 (agreeing with the
   plain version there), and a traced ``explain`` + ``run`` whose
   winners are the run's and whose ``engine.run`` spans carry
   ``device_wait_s``.  Timings: the clique run (``to_graph`` included)
   beside the bipartite fused run of the same spec and
   ``graph_pagerank`` alone (host wall through a synchronize, median of
   3); K2b per iteration and K2a on the out-weights against their plain
   versions, ``index_add_`` and the byte bound;
12. fault-tolerant serving on DBLP at full scale through
   ``Engine(delivery="pallas_fused")``: (a) PageRank-30 with
   ``checkpoint_every=7`` bitwise equal to the run without; killed by
   ``checkpoint.chunk`` (``nth=2``, fatal) after pair 14; a fresh Engine
   resuming from pair 14, bitwise equal (values and activity trace),
   with K1's launches counted from 0 (the 16 resumed pairs: 48) and the
   snapshots' save and restore seconds; the same for SSSP from 0, which
   halts early (the trace padded), and once through ``Engine.compile``
   (``_run_checkpointed``); (b) ``Frontend`` over compiled SSSP and PPR
   (12 iterations, buckets 8 and 16 captured by ``warm`` before
   ``start``), 256 requests of a seeded trace (60% SSSP, sources
   uniform): every request resolves, no capture after ``warm``, 16
   sampled results against sequential ``run(query=)`` (SSSP bitwise,
   PPR 1e-5 relative); requests/s, queue-wait and execute p50/p99, flush
   reasons, bucket occupancy, the cache, K1's launches a flush, and the
   resilient front-end against ``resilience=False`` on the same trace;
   (c) the same trace under ``execute`` every 7 (transient),
   ``serve.flush`` nth 3 (transient) and ``serve.worker`` nth 2: every
   request resolves (futures waited with a timeout) with its fault-free
   value or a typed ``FaultError``, every rule fires; (d) ``execute``
   always, fatal: 4 requests resolve typed, none degrades to ``xla``;
   (e) ``python -m repro_torch.launch.serve_hypergraph --regime dblp
   --scale 1.0 --requests 200 --verify 8`` in a subprocess exits 0 and
   verifies 8;
13. the replica pool on one card, DBLP at full scale, phase 12's trace:
   (a) the parent warms SSSP and PPR (unbatched, buckets 8 and 16) into
   a fresh ``DiskExecutableCache`` (6 records written) and
   ``retrace_smoke`` on the card finds nothing; the parent's sequential
   compiled runs of every request are the oracle; (b) a ``Router`` over
   2 ``ProcessReplica``s booting ``require_no_retrace=True`` from the
   records (each: seconds to ready, records read, captures at boot,
   ``torch.cuda.memory_reserved`` and ``nvidia-smi``'s memory per
   process), the trace replayed: requests/s beside phase 12(b)'s
   single-process ``Frontend``, every value agreeing with the oracle
   (SSSP bitwise, PPR 1e-5 relative) and reaching the router as numpy,
   no capture in a replica after its warm, K1's launches a flush in
   each replica; (c) the trace again with ``kill -9`` of replica 0
   mid-replay: every request resolves (a value equal to the oracle's,
   or ``ReplicaLost`` / ``FrontendClosed``, at most ``MAX_FAILOVERS``),
   in_flight = pending = 0, a death and a respawn, which boots from the
   records with the sentinel armed (seconds from the kill to ready);
   (d) a pool under a seeded ``replica.hang``: the missed-heartbeat
   detector declares the hung replica dead and every request resolves;
   (e) ``python -m repro_torch.launch.serve_hypergraph --replicas 2
   --cache-dir <tmp> --warm --verify 8`` under a seeded
   ``replica.crash`` exits 0, verifies 8 and fires the plan.

14. the distributed backends on one card: an NCCL group of world size
   1 (``launch.mesh.init_local_group``; one card gives one rank, since
   NCCL refuses two ranks on one device) and ``make_host_mesh(1)``;
   (a) ``Engine(plan=random_vertex_cut, mesh=).run`` of phase 3's
   PageRank-30, SSSP and components under ``replicated`` and
   ``sharded`` with ``pallas_fused``, against phase 3's local runs
   (PageRank 1e-5 relative, the others bitwise with equal activity),
   K1's launches counted (one per leaf and pair), walls beside the
   local run's (median of 3, in turns); (b) K1 on the four shard layouts
   of a P = 4 ``random_vertex_cut`` plan (``build_shard_delivery``, one
   process): each against its plain version (min bitwise, float32 sum
   within 1e-5 of float64), the four partials combined equal to the
   whole-graph delivery, each shard's leaf time beside the whole
   graph's; (c) ``Engine(mesh=).analyze`` on phase 6's Apache census,
   resolved ``sharded``, field for field phase 6's, K3a / K3b launches
   counted; (d) ``Engine(mesh=, plan=).compile`` on both backends:
   PageRank-30 ``run`` against ``Engine.run`` (1e-5 relative) and
   ``run_batch`` of 8 SSSP sources against ``Engine.run`` (bitwise),
   each replayed from a CUDA graph captured with its collectives,
   queries/s; the group is destroyed at the end;
15. the static analysis on the card (``repro_torch.analysis``): (a) the
   card's shared memory per block without and with the opt-in equals
   ``shapes``' 49,152 and 232,448; (b) every entry function's static
   shared memory in phase 1's ``ptxas -v`` output of all four sources
   equals the model's (read from the sources' ``__shared__`` arrays per
   template instantiation), and each kernel's largest static and worst
   dynamic bytes are logged beside its limit; (c) each kernel once at
   the worst geometry its budget admits (K1 with span ``_MAX_SPAN``,
   K2a at ``block_n`` 4,096 and at the widest tile, K2b at the largest
   ``block_e`` for bfloat16 D = 8, K3a at its widest rings, K4 at head
   dim 256 in both types) against its plain version, bitwise on integer
   payloads, phase 8's tolerance for K4; (d) ``python -m
   repro_torch.analysis --device cuda --passes
   lint,digest,shapes,retrace`` exits 0.

Prints the kernel line (JSON; every entry carries phase 15's
``smem_static`` / ``smem_dynamic_worst``; K1's carries phase 9's compiled
launches and times, phase 12's ``phase12_*`` serving keys, phase
13's ``phase13_*`` pool keys and phase 14's ``dist_*`` keys; the isect
entries carry phase 14's ``dist_census_launches``; K2b's, phase 11's launches and numbers at the
clique's shapes, with phase 7's as ``phase7_*``; K2a's, phase 7's, with
the clique out-weights' as ``out_w_*``) and, last, the device line
(JSON).  Exits non-zero, printing no result, when there is no card.
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


def time_cuda(fn, flush, n_timed=N_TIMED, n_warm=N_WARM):
    """Median ms of ``fn()`` over ``n_timed`` runs, each after an L2
    flush, timed with CUDA events around the call alone."""
    import torch

    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_timed):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_two(fn_a, fn_b, flush, n_timed=N_TIMED, n_warm=N_WARM):
    """Median ms of ``fn_a()`` and of ``fn_b()``, timed in turns (a, b,
    a, b, ...) so that both meet the same state of the host, each after
    an L2 flush and from an idle card: the timer starts once the flush
    is done, so the host's dispatch counts in full.  (``time_cuda``
    starts it behind the flush, which hides up to the flush's ~80 us of
    a call's dispatch: a call of many small launches looks faster than
    it runs in a loop.)"""
    import torch

    for _ in range(n_warm):
        fn_a()
        fn_b()
    times = ([], [])
    for _ in range(n_timed):
        for fn, out in ((fn_a, times[0]), (fn_b, times[1])):
            flush.zero_()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def time_device(fn, flush, n=N_TIMED):
    """Mean device ms of ``fn()`` after an L2 flush, without the host's
    share: ``n`` flushes and calls queued back to back (the flush gives
    the host a head start, so the card never waits on it), less the same
    ``n`` flushes alone, over ``n``."""
    import torch

    def queued(call):
        for _ in range(N_WARM):
            flush.zero_()
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            flush.zero_()
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return (queued(fn) - queued(lambda: None)) / n


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
    """Phase 2: every layout, the leaf kernel (one launch over every
    class, ``deliver_leaf_cuda``) against ``deliver_fused_classes(...,
    lowering="plain")``, and every class through a one-class plan
    (``deliver_fused_cuda``) against ``deliver_fused_plain`` (for random
    float sums run in float64 and rounded to float32)."""
    import torch

    from repro_torch.kernels.deliver.fused import (
        deliver_fused_classes,
        deliver_fused_cuda,
        deliver_fused_plain,
        deliver_leaf_cuda,
    )
    from repro_torch.sparse.segment import MONOIDS

    dev = layouts[0][1].device
    n_checks, max_err = 0, 0.0
    cases = [("float32", m) for m in ("sum", "min", "max", "prod")]
    cases += [("int32", m) for m in ("sum", "min", "max", "prod", "or")]

    def same(tag, got, want, exact):
        nonlocal n_checks, max_err
        torch.cuda.synchronize()
        if exact:
            if not same_bits(got, want):
                fail(f"kernel != plain (bitwise) {tag}")
        else:
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                fail(f"kernel !~ plain {tag}: max abs err {err}")
        n_checks += 1

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
                    # Random float sums: the plain version runs in float64
                    # and is rounded once, so that its own float32 atomics
                    # (an order that changes from run to run) do not move
                    # the reference by as much as the tolerance.
                    ref_aug = msgs_aug if exact else msgs_aug.double()
                    live = torch.as_tensor(rng.random(n_src) < 0.7,
                                           device=dev)
                    act = torch.cat([live.to(torch.int32),
                                     torch.ones(1, dtype=torch.int32,
                                                device=dev)])
                    # The leaf: no activity, int32 activity, bool activity.
                    for act_aug, active in ((None, None), (act, act[:-1]),
                                            (act, live)):
                        got = deliver_leaf_cuda(msgs, active, lay,
                                                kernel_monoid)
                        want = deliver_fused_classes(
                            ref_aug, act_aug, lay, kernel_monoid,
                            lowering="plain").to(msgs.dtype)
                        if monoid == "or":
                            got, want = got > 0, want > 0
                        same((direction, "leaf", monoid, dtype_name, d,
                              None if active is None else active.dtype),
                             got, want, exact)
                    for act_aug in (None, act):
                        for c in range(lay.n_classes):
                            args = (msgs_aug, act_aug, lay.class_src[c],
                                    lay.class_dst[c], lay.class_bounds[c],
                                    lay.class_rows[c], kernel_monoid)
                            kw = dict(block_n=lay.block_n,
                                      block_e=lay.class_block_e[c])
                            got = deliver_fused_cuda(*args, **kw)
                            want = deliver_fused_plain(
                                ref_aug, *args[1:], **kw).to(msgs.dtype)
                            if monoid == "or":
                                got, want = got > 0, want > 0
                            same((direction, c, monoid, dtype_name, d,
                                  act_aug is not None), got, want, exact)
    return n_checks, max_err


def padded_layout(hg, rng):
    """The DBLP v->he layout with a tenth of the incidences masked dead
    (so some hyperedges have live degree 0) and every class's rows
    padded to twice the bucket (dead slots)."""
    import numpy as np

    from repro_torch.kernels.deliver import build_delivery_layout

    mask = (rng.random(hg.nnz) < 0.9).astype(np.int32)
    args = (hg.src, hg.dst, mask, hg.n_vertices, hg.n_hyperedges)
    rows = build_delivery_layout(*args).class_rows
    return build_delivery_layout(
        *args, class_rows_pad=tuple(2 * r for r in rows), device=hg.device)


def leaf_counts(spec):
    """Message leaves per direction: the vertex program's message on the
    initial state (fwd) and the hyperedge-bound message shape, which is
    ``initial_msg``'s (bwd)."""
    import torch

    from repro_torch.core.api import constant_initial_msg, tree_leaves

    hg = spec.hg0
    ids = torch.arange(hg.n_vertices, dtype=torch.int32, device=hg.device)
    msg0 = constant_initial_msg(spec.initial_msg, hg.n_vertices, hg.device)
    step = torch.zeros((), dtype=torch.int32, device=hg.device)
    out = spec.v_program.procedure(step, ids, hg.v_attr, msg0, hg.degrees())
    return len(tree_leaves(out.msg)), len(tree_leaves(spec.initial_msg))


def run_fused_counted(eng, spec):
    """One fused run with the launch counter zeroed just before and read
    just after; checks it against one launch per leaf and direction."""
    from repro_torch.kernels.deliver.fused import deliver_fused_cuda

    eng._delivery_layouts(spec.hg0)  # built before counting
    n_fwd, n_bwd = leaf_counts(spec)
    deliver_fused_cuda.launches = 0
    res = eng.run(spec, delivery="pallas_fused")
    launches = deliver_fused_cuda.launches
    pairs = res.decision["measured"]["pairs_run"]
    log(f"  {spec.name}: fused launches {launches} = {pairs} pairs x "
        f"({n_fwd} fwd leaves + {n_bwd} bwd leaves), one launch per leaf")
    if launches != pairs * (n_fwd + n_bwd) or launches == 0:
        fail(f"{spec.name}: {launches} launches, expected one per leaf: "
             f"{pairs * (n_fwd + n_bwd)}")
    return res, launches


def build_kernels():
    """Phase 1: one ``nvcc`` per kernel source, all started together;
    returns each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.deliver.fused import _kernel_lib as fused_lib
    from repro_torch.kernels.flash.flash import _kernel_lib as flash_lib
    from repro_torch.kernels.isect.isect import _kernel_lib as isect_lib
    from repro_torch.kernels.segsum.segsum import _kernel_lib as segsum_lib

    sources = {"deliver_fused": ("deliver_fused.cu",),
               "isect": ("isect.cu",), "segsum": ("segsum.cu",),
               "flash": ("flash.cu",)}

    def one(item):
        t0 = time.perf_counter()
        _nvcc.build(*item)
        return item[0], time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(pool.map(one, sources.items()))
    for load in (fused_lib, isect_lib, segsum_lib, flash_lib):
        load()
    return seconds


def ptxas_summary(text):
    """(kernel, registers, spill store bytes, spill load bytes, smem
    bytes) per entry function in ``nvcc -Xptxas -v`` output; the flash
    templates named by their parameters."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          name)
            f = re.search(r"flash_kernelI(\w)Li(\d+)E", name)
            k = re.search(r"(k2a_[a-z]+)(I.*?Li(\d+)E)?", name)
            b = re.search(r"k2b_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                          name)
            if t:
                name = (f"bf16 wgmma DP={t.group(1)} BK={t.group(2)}, "
                        f"{t.group(3)} block(s) per SM")
            elif f:
                name = f"float32 fma NJ={f.group(2)}"
            elif k:
                dtype = "bf16" if "bfloat16" in name else "float32"
                name = k.group(1) + (f" {dtype} VEC={k.group(3)}"
                                     if k.group(3) else "")
            elif b:
                dtype = "float32" if b.group(1) == "f" else "bf16"
                name = (f"k2b {dtype} "
                        f"{'narrow D' if b.group(3) == '1' else 'wide VEC'}"
                        f"={b.group(2)}")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spill,
                         int(m.group(2) or 0)))
            name, spill = None, (0, 0)
    return rows


def time_delivery(hg, fwd, bwd, flush):
    """Phase 4's kernel timings: per class the one-class launch, per leaf
    the one launch against the sum of its class bounds, its plain
    version and the ``xla`` lowering.  Returns the K1 entry's numbers,
    summed over the two leaves."""
    import torch

    from repro_torch.core import Program, deliver
    from repro_torch.kernels.deliver import fused

    dev = hg.dst.device
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
        leaf_bound = 0.0
        for c in range(lay.n_classes):
            args = (msgs_aug, None, lay.class_src[c], lay.class_dst[c],
                    lay.class_bounds[c], lay.class_rows[c], "sum")
            kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[c])
            k_ms = time_cuda(lambda: fused.deliver_fused_cuda(*args, **kw),
                             flush)
            k_dev = time_device(
                lambda: fused.deliver_fused_cuda(*args, **kw), flush)
            p_ms = time_cuda(lambda: fused.deliver_fused_plain(*args, **kw),
                             flush)
            lanes = int(lay.class_src[c].shape[0])
            rows = lay.class_rows[c]
            real = lay.class_dst[c] < rows
            nnz_c = int(real.sum())
            msg_rows = int(torch.unique(lay.class_src[c][real]).numel())
            # Each input read once, each output written once: the src and
            # dst index streams, the tile table, the message rows the
            # class references, the output rows (all 4-byte words).  The
            # same count whatever runs it: one class or a whole leaf.
            n_bytes = 4 * (2 * lanes + lay.class_bounds[c].numel()
                           + msg_rows + rows)
            bound = max(n_bytes / HBM_BYTES_PER_S, nnz_c / FP32_OPS_PER_S)
            leaf_bound += bound * 1e3
            span = fused.class_span(lanes, rows, lay.block_n)
            log(f"  {name} class {c} (width {lay.class_widths[c]}, rows "
                f"{rows}, lanes {lanes}, blocks {-(-rows // span)} of "
                f"{span} rows): one-class launch {k_ms * 1e3:.1f} us "
                f"(device {k_dev * 1e3:.1f} us), "
                f"plain {p_ms * 1e3:.1f} us, bound {bound * 1e6:.1f} us "
                f"({n_bytes / 1e6:.2f} MB, {nnz_c} real lanes, {msg_rows} "
                f"message rows)")
        msgs_1d = msgs[:, 0].contiguous()
        f_ms = time_cuda(
            lambda: fused.deliver_leaf_cuda(msgs, None, lay, "sum"), flush)
        f_dev = time_device(
            lambda: fused.deliver_leaf_cuda(msgs, None, lay, "sum"), flush)
        p_ms = time_cuda(
            lambda: fused.deliver_fused_classes(msgs_aug, None, lay, "sum",
                                                lowering="plain"), flush)
        x_ms = time_cuda(
            lambda: deliver(msgs_1d, None, src, dst, n_dst, sum_prog), flush)
        totals["ms"] += f_ms
        totals["plain_ms"] += p_ms
        totals["bound_ms"] += leaf_bound
        totals["library_ms"] += x_ms
        log(f"  {name} leaf: fused delivery, one launch (all classes, rows "
            f"written to their destinations) {f_ms * 1e3:.1f} us (device "
            f"{f_dev * 1e3:.1f} us) against the sum of its class bounds "
            f"{leaf_bound * 1e3:.1f} us ({leaf_bound / f_ms:.1%}; of the "
            f"device time {leaf_bound / f_dev:.1%}); plain (per class + "
            f"inv_perm "
            f"gather) {p_ms * 1e3:.1f} us; xla lowering (index_select "
            f"gather + where + scatter_reduce: stock calls, not one) "
            f"{x_ms * 1e3:.1f} us")

    return totals


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

    # The run cache: id shapes that stress it, at every width class of
    # the kernel (one word, words, the census's int4 row, the loop past
    # 128 words) and on an unaligned base (the word path at W = 104).
    for w_case in (1, 3, 101, 104, 200, "104 unaligned"):
        w_r = 104 if w_case == "104 unaligned" else w_case
        words = rng.integers(-2**31, 2**31, (5000 * w_r + 1,),
                             dtype=np.int64)
        words[rng.random(words.shape) < 0.05] = -1
        flat = card_ids(words, dev)
        table = (flat[1:] if w_case == "104 unaligned"
                 else flat[:-1]).view(5000, w_r)
        if (w_case == "104 unaligned") != (table.data_ptr() % 16 != 0):
            fail("the unaligned case is not unaligned")
        for case, abc in run_cases(rng, 5000).items():
            abc = tuple(card_ids(x, dev) for x in abc)
            same(f"K3b W={w_case} {case} ({len(abc[0])})",
                 isect_fused_cuda(table, *abc),
                 isect_fused_plain(table, *abc, tile=PLAIN_TILE))
            if len(abc) == 2:
                ua, ub = (table.index_select(0, x) for x in abc)
                same(f"K3a W={w_case} {case}", isect_cuda(ua, ub),
                     isect_plain(ua, ub, tile=PLAIN_TILE))
    return n_checks, max_err, host_uni


def run_cases(rng, e):
    """Id streams (host arrays) that stress the kernel's run cache:
    alternating ids, runs that cross the 32-pair chunks and the blocks'
    turns (lengths around 32 and 256, and long ones), P no multiple of
    32, runs of one, and triples mixing a long run with changing ids."""
    import numpy as np

    def runs(lengths, p):
        return np.repeat(rng.integers(0, e, len(lengths)), lengths)[:p]

    p = 300_007
    long_runs = rng.choice([1, 31, 32, 33, 255, 256, 257, 5000], 4 * p // 32)
    alt = np.tile(rng.integers(0, e, 2), p // 2 + 1)[:p]
    ones = rng.integers(0, e, p)
    a = runs(long_runs, p)
    return {
        "alternating": (alt, np.roll(alt, 1)),
        "runs across chunks": (a, runs(long_runs[::-1], p)),
        "run of one vs runs": (ones, a),
        "P=33": (a[:33], ones[:33]),
        "P=1": (a[:1], ones[:1]),
        "triples: runs, alternating, ones": (a, alt, ones),
        "triples: same run": (a, a, a),
    }


def l2_read_rate(bits):
    """Bytes/s of a repeated streaming read of ``bits`` from L2: one
    ``torch.sum`` over the table read 16 times (a stride-0 view), warm,
    median of 20.  A torch reduction's rate: a floor on the card's L2
    read rate, not its peak."""
    import torch

    flat = bits.view(torch.float32).reshape(1, -1)
    reads = flat.expand(16, -1)
    for _ in range(3):
        reads.sum(dim=1)
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reads.sum(dim=1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    rate = 16 * bits.numel() * 4 / (statistics.median(times) * 1e-3)
    log(f"  L2 read rate: torch.sum over the {bits.numel() * 4 / 1e6:.1f} "
        f"MB table read 16 times, warm: {rate / 1e12:.3f} TB/s")
    return rate


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
    l2_rate = l2_read_rate(bits)
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
        # What a kernel without the run cache reads from L2: every id's
        # row, every pair (not the bound: the rows come from L2).
        l2_bytes = p * len(abc) * w * 4
        log(f"  K3b {name}: P={p} W={w} rows={rows}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{max(b_s, o_s) * 1e3:.4f} ms (bytes {b_s * 1e3:.4f} ms, "
            f"popcounts {o_s * 1e3:.4f} ms); {p * w / (k_ms * 1e-3):.4g} "
            f"popcounts/s; L2 row traffic uncached {l2_bytes / 1e9:.2f} GB "
            f"= {l2_bytes / l2_rate * 1e3:.4f} ms at the measured L2 rate")
    k_ms = time_cuda(lambda: isect_cuda(bits, bits), flush)
    k_dev = time_device(lambda: isect_cuda(bits, bits), flush)
    p_ms = time_cuda(lambda: isect_plain(bits, bits, tile=PLAIN_TILE),
                     flush)
    # a and b are the same [E, W] table: one input, read once.
    b_s = (4 * e * w + 4 * e) / HBM_BYTES_PER_S
    o_s = e * w / popc_rate
    log(f"  K3a whole index (cardinalities): E={e} W={w}: kernel "
        f"{k_ms:.4f} ms (device {k_dev:.4f} ms), plain {p_ms:.4f} ms, bound "
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

    return k3a_launches, k3b_launches, est


def card_rates():
    """(SMs, max SM clock in Hz) of card 0, from torch and nvidia-smi."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]) * 1e6
    return sms, clock


def segsum_tol(e, n, dtype):
    """(rtol, atol) of a segment sum against its plain version.  float32:
    ``tests/test_kernels.py``'s (rtol 1e-5, an atol that grows with the
    square root of a segment's depth, ~e/n addends).  bfloat16: both sum
    in float32 and round once, so they differ by at most one bf16 step
    of the value (2**-7 of it): rtol is two steps, atol a floor for the
    values near 0."""
    import torch

    if dtype == torch.bfloat16:
        return 2.0 ** -6, 2.0 ** -10
    return 1e-5, 1e-4 * max(1.0, (e / n) ** 0.5 / 3.0)


def check_close(tag, got, want, rtol, atol):
    """Fails unless ``got`` is within tolerance of ``want`` (float32
    compare); returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{tag}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
             f"{want.dtype}")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        fail(f"{tag}: max abs err {err} over rtol {rtol} atol {atol}")
    return err


def segsum_phase(hg, flush):
    """Phase 7: K2a and K2b through ``segment_sum_mxu`` on the DBLP
    incidences at full scale (the main path, launches counted), each
    against its plain version, the edge cases, and the timings.  Returns
    the two kernels' entries of the kernel line."""
    import torch

    from repro_torch.kernels.segsum import (
        csr_row_offsets,
        segment_sum_mxu,
        segsum_cuda,
        segsum_plain,
        segsum_sorted_cuda,
        segsum_sorted_plain,
    )

    t0 = time.perf_counter()
    dev = hg.dst.device
    n, e = hg.n_hyperedges, hg.nnz
    gen = torch.Generator(device=dev).manual_seed(7)
    dst = hg.dst.contiguous()                       # the generator's order
    order = torch.sort(dst, stable=True).indices    # as sorted_by_dst()
    dst_s = hg.sorted_by_dst().dst.contiguous()
    if not torch.equal(dst_s, dst[order]):
        fail("sorted_by_dst() is not the stable sort of dst")
    off = csr_row_offsets(dst_s, n)
    configs = []
    for dtype, d in ((torch.float32, 1), (torch.float32, 64),
                     (torch.bfloat16, 64)):
        msgs = torch.randn(e, d, generator=gen, device=dev).to(dtype)
        configs.append((dtype, d, msgs, msgs[order].contiguous()))

    # -- the main path: the entry point, unsorted and sorted ------------------
    segsum_cuda.launches = 0
    segsum_sorted_cuda.launches = 0
    outs = [(segment_sum_mxu(m, dst, n),
             segment_sum_mxu(m_s, dst_s, n, sorted_dst=True))
            for _, _, m, m_s in configs]
    launches = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    if launches != (len(configs), len(configs)):
        fail(f"segment_sum_mxu launched K2a/K2b {launches} times, expected "
             f"{len(configs)} each")
    log(f"  main path: {len(configs)} configs x (unsorted, sorted) through "
        f"segment_sum_mxu: K2a {launches[0]} launches, K2b {launches[1]}")

    err = {"segsum": 0.0, "segsum_sorted": 0.0}
    perm = torch.randperm(e, generator=gen, device=dev)
    dst_p = dst[perm].contiguous()
    for (dtype, d, m, m_s), (got, got_s) in zip(configs, outs):
        rtol, atol = segsum_tol(e, n, dtype)
        tag = f"{str(dtype)[6:]} D={d}"
        err["segsum"] = max(err["segsum"], check_close(
            f"K2a {tag}", got, segsum_plain(m, dst, n), rtol, atol))
        err["segsum_sorted"] = max(err["segsum_sorted"], check_close(
            f"K2b {tag}", got_s, segsum_sorted_plain(m_s, off, n), rtol,
            atol))
        if not same_bits(got_s, segsum_sorted_cuda(m_s, off, n)):
            fail(f"K2b {tag}: two runs differ")
        m_p = m[perm].contiguous()
        err["segsum"] = max(err["segsum"], check_close(
            f"K2a {tag} shuffled", segsum_cuda(m_p, dst_p, n),
            segsum_plain(m_p, dst_p, n), rtol, atol))
        check_close(f"K2a vs K2b {tag}", got, got_s, rtol, atol)

    # -- edge cases ----------------------------------------------------------
    # One segment takes every edge: integer-valued messages, so that
    # every order of the 2.8 M additions gives the same float32 bits.
    m_int = torch.randint(-8, 9, (e, 64), generator=gen, device=dev).float()
    zeros = torch.zeros_like(dst)
    want = segsum_plain(m_int, zeros, 3)
    for sorted_dst in (False, True):
        if not same_bits(segment_sum_mxu(m_int, zeros, 3,
                                         sorted_dst=sorted_dst), want):
            fail(f"one segment (sorted={sorted_dst}) != plain, bitwise")
    m1 = configs[1][2]                              # float32, D = 64
    cut = 512 * 1000 + 77                           # not a block_e multiple
    rtol, atol = segsum_tol(cut, n, torch.float32)
    check_close("E not a block_e multiple (K2a)",
                segment_sum_mxu(m1[:cut], dst[:cut], n),
                segsum_plain(m1[:cut], dst[:cut], n), rtol, atol)
    check_close("E not a block_e multiple (K2b)",
                segment_sum_mxu(configs[1][3][:cut], dst_s[:cut], n,
                                sorted_dst=True),
                segsum_plain(configs[1][3][:cut], dst_s[:cut], n), rtol,
                atol)
    rtol, atol = segsum_tol(e, n, torch.float32)
    bad = dst.clone()
    hit = torch.rand(e, generator=gen, device=dev) < 0.01
    bad[hit] = torch.tensor([-1, n, n + 5, 2**31 - 1], dtype=torch.int32,
                            device=dev)[torch.randint(
                                4, (int(hit.sum()),), generator=gen,
                                device=dev)]
    keep = ~hit
    check_close("ids outside [0, N) dropped (K2a)",
                segment_sum_mxu(m1, bad, n),
                segsum_plain(m1[keep], dst[keep], n), rtol, atol)
    pad = lambda x, lo, hi: torch.cat([lo, x, hi])
    bad_s = pad(dst_s, torch.full((100,), -3, dtype=torch.int32, device=dev),
                torch.tensor([n] * 100 + [2**31 - 1] * 5, dtype=torch.int32,
                             device=dev))
    m_pad = pad(configs[1][3], torch.ones(100, 64, device=dev),
                torch.ones(105, 64, device=dev))
    check_close("ids outside [0, N) dropped (K2b)",
                segment_sum_mxu(m_pad, bad_s, n, sorted_dst=True),
                segsum_plain(configs[1][3], dst_s, n), rtol, atol)
    before = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    for sorted_dst in (False, True):
        z = segment_sum_mxu(m1[:0], dst[:0], n, sorted_dst=sorted_dst)
        if z.shape != (n, 64) or z.any():
            fail("E = 0 does not give zeros")
    if (segsum_cuda.launches, segsum_sorted_cuda.launches) != before:
        fail("E = 0 launched a kernel")
    # Apache's vertex side: rows of every length up to 6,465 edges.
    from repro_torch.data import make_dataset

    hg_a = make_dataset("apache", 1.0, seed=0, device=dev)
    v_s = torch.sort(hg_a.src, stable=True).values.contiguous()
    n_v = hg_a.n_vertices
    m_v = torch.randn(v_s.numel(), 64, generator=gen, device=dev)
    off_v = csr_row_offsets(v_s, n_v)
    longest = int(off_v.diff().max())
    got_v = segment_sum_mxu(m_v, v_s, n_v, sorted_dst=True)
    rtol, atol = segsum_tol(v_s.numel(), n_v, torch.float32)
    err["segsum_sorted"] = max(err["segsum_sorted"], check_close(
        "K2b Apache vertex side", got_v, segsum_plain(m_v, v_s, n_v), rtol,
        atol))
    if not same_bits(got_v, segsum_sorted_cuda(m_v, off_v, n_v)):
        fail("K2b Apache vertex side: two runs differ")
    del hg_a
    log(f"phase 7: K2a/K2b checks passed (max abs err K2a "
        f"{err['segsum']:.3g}, K2b {err['segsum_sorted']:.3g}; K2b bitwise "
        f"repeatable; one segment, E = {cut}, dropped ids, E = 0, Apache "
        f"vertex side: {v_s.numel()} edges into {n_v} rows, the longest "
        f"{longest}) in {time.perf_counter() - t0:.1f} s")

    # -- timings -------------------------------------------------------------
    t0 = time.perf_counter()
    entries = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
               for name in ("segsum", "segsum_sorted")}
    entries["segsum"]["shuffled_ms"] = 0.0
    # The library call computes K2's function: float32 sums (bf16
    # messages cast by ``.float()``), rounded to the type of msgs; for
    # float32 both casts are no-ops.
    index_add_f32 = lambda m, ids, d, dtype: torch.zeros(
        n, d, dtype=torch.float32, device=dev).index_add_(
            0, ids, m.float()).to(dtype)
    for dtype, d, m, m_s in configs:
        size = m.element_size()
        # Bytes each form must move: the messages read, the rows written,
        # and K2a's ids or K2b's offsets read (K2b never reads the ids).
        rows_bytes = e * d * size + n * d * size
        runs = {
            "segsum": (lambda: segsum_cuda(m, dst, n),
                       lambda: segsum_plain(m, dst, n),
                       lambda: index_add_f32(m, dst, d, dtype),
                       rows_bytes + 4 * e),
            "segsum_sorted": (lambda: segsum_sorted_cuda(m_s, off, n),
                              lambda: segsum_sorted_plain(m_s, off, n),
                              lambda: index_add_f32(m_s, dst_s, d, dtype),
                              rows_bytes + 4 * (n + 1)),
        }
        for name, (kernel, plain, library, n_bytes) in runs.items():
            k_ms = time_cuda(kernel, flush)
            p_ms = time_cuda(plain, flush)
            l_ms = time_cuda(library, flush)
            b_s, o_s = n_bytes / HBM_BYTES_PER_S, e * d / FP32_OPS_PER_S
            ent = entries[name]
            for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                             ("library_ms", l_ms), ("bytes_s", b_s),
                             ("ops_s", o_s)):
                ent[key] += val
            log(f"  {'K2a' if name == 'segsum' else 'K2b'} "
                f"{str(dtype)[6:]} D={d}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
                f"{max(b_s, o_s) * 1e3:.4f} ms ({n_bytes / 1e6:.1f} MB)")
        m_p = m[perm].contiguous()
        p_ms = time_cuda(lambda: segsum_cuda(m_p, dst_p, n), flush)
        e_ms = time_cuda(lambda: segment_sum_mxu(m_s, dst_s, n,
                                                 sorted_dst=True), flush)
        del m_p
        entries["segsum"]["shuffled_ms"] += p_ms
        log(f"    K2a on shuffled ids {p_ms:.4f} ms; "
            f"segment_sum_mxu(sorted_dst=True) with its check and offsets "
            f"{e_ms:.4f} ms")
    # One tile (K2a) or one row (K2b) takes every edge: K2a's work items
    # and K2b's blocks meet in their combine trees, which must not
    # serialise on one block.  Apache's vertex side: a row of 6,465
    # edges beside rows of about 130.
    off_1 = csr_row_offsets(zeros, 3)
    l_ms = time_cuda(lambda: torch.zeros(3, 64, device=dev).index_add_(
        0, zeros, m_int), flush)
    rows_1 = e * 64 * 4 + 3 * 64 * 4
    for name, kernel, n_bytes in (
            ("K2a", lambda: segsum_cuda(m_int, zeros, 3), rows_1 + 4 * e),
            ("K2b", lambda: segsum_sorted_cuda(m_int, off_1, 3),
             rows_1 + 4 * 4)):
        k_ms = time_cuda(kernel, flush)
        bound_1 = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  {name} one segment (E = {e} into row 0 of 3, float32 D=64): "
            f"kernel {k_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
            f"{bound_1:.4f} ms")
    entries["segsum_sorted"].update(one_segment_ms=k_ms,
                                    one_segment_library_ms=l_ms,
                                    one_segment_bound_ms=bound_1)
    del m_int
    e_v = v_s.numel()
    k_ms = time_cuda(lambda: segsum_sorted_cuda(m_v, off_v, n_v), flush)
    l_ms = time_cuda(lambda: torch.zeros(n_v, 64, device=dev).index_add_(
        0, v_s, m_v), flush)
    bound_v = ((e_v * 64 * 4 + n_v * 64 * 4 + 4 * (n_v + 1))
               / HBM_BYTES_PER_S * 1e3)
    log(f"  K2b Apache vertex side (E = {e_v} into {n_v} rows, float32 "
        f"D=64): kernel {k_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
        f"{bound_v:.4f} ms")
    entries["segsum_sorted"].update(skew_ms=k_ms, skew_library_ms=l_ms,
                                    skew_bound_ms=bound_v)
    for ent in entries.values():
        b_s, o_s = ent.pop("bytes_s"), ent.pop("ops_s")
        ent["bound_ms"] = max(b_s, o_s) * 1e3
        ent["bound_by"] = "bytes" if b_s >= o_s else "operations"
    log(f"phase 7: timed in {time.perf_counter() - t0:.1f} s (L2 flushed, "
        f"median of {N_TIMED}; index_add_ into float32 of msgs.float(), "
        f"cast to the type of msgs)")
    for name, launched in zip(entries, launches):
        entries[name]["launches"] = launched
        entries[name]["max_abs_err"] = err[name]
    return entries


# (label, dtype, causal, B, H, S, D): llama3.2-1b's attention width
# (32 heads of 64), gemma3-12b's (16 heads of 256) and
# command-r-plus-104b's (96 heads of 128): one case for each of the
# bfloat16 kernel's head-dim templates.
FLASH_CASES = (
    ("llama3.2-1b prefill_32k, one sequence", "bfloat16", True, 1, 32,
     32768, 64),
    ("llama3.2-1b float32", "float32", True, 1, 32, 4096, 64),
    ("llama3.2-1b bidirectional", "bfloat16", False, 1, 32, 4096, 64),
    ("gemma3-12b", "bfloat16", True, 1, 16, 8192, 256),
    # 32,040 is no multiple of the kernels' 64- or 128-key tiles or the
    # JAX wrapper's 128: the last key and query tiles are partial.
    ("llama3.2-1b S=32040 (partial tiles)", "bfloat16", True, 1, 32, 32040,
     64),
    ("command-r-plus-104b", "bfloat16", True, 1, 96, 8192, 128),
)
FLASH_REPEAT_CASE = 0  # the bfloat16 case checked bitwise over two runs
# Limits of K4 against its plain version.  Elementwise (rtol, atol): f32
# as tests/test_kernels.py; bf16 from the readings (one bf16 step, the
# outputs of late rows about 1/sqrt(row) in size).  Per row, the largest
# error over the row's largest value (ROW_REL): a correct bf16 kernel is
# within about one step of the row's top (2**-7); a dropped key tile or
# a late row's denominator off by a few percent reads above the limit
# (both planted below).
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 5e-3)}
FLASH_ROW_REL = {"float32": 1e-4, "bfloat16": 2e-2}
TENSOR_FLOPS_PER_CLOCK_PER_SM = 4096   # dense bf16: 989.4 TFLOP/s at
                                       # 1830 MHz on 132 SMs
FMA_FLOPS_PER_CLOCK_PER_SM = 256       # float32: 128 FMA lanes
EX2_PER_CLOCK_PER_SM = 16              # MUFU


def flash_pairs(causal, b, h, s):
    """(query, key) pairs one attention call keeps: causal keeps
    S (S + 1) / 2 of the S^2."""
    return b * h * (s * (s + 1) // 2 if causal else s * s)


def flash_bound(dtype, causal, b, h, s, d, sms, clock):
    """(bytes s, operations s) of one attention call: q, k, v, out once
    over the memory rate; the larger of its flops (4 D per pair kept)
    over the tensor (bf16) or FMA (f32) rate and its exps over the MUFU
    rate."""
    import torch

    pairs = flash_pairs(causal, b, h, s)
    size = torch.tensor([], dtype=dtype).element_size()
    per_clock = (TENSOR_FLOPS_PER_CLOCK_PER_SM if dtype == torch.bfloat16
                 else FMA_FLOPS_PER_CLOCK_PER_SM)
    flops_s = 4 * d * pairs / (per_clock * sms * clock)
    exps_s = pairs / (EX2_PER_CLOCK_PER_SM * sms * clock)
    return 4 * b * h * s * d * size / HBM_BYTES_PER_S, max(flops_s, exps_s)


def row_rel_err(got, want):
    """Max over rows of max |got - want| / max |want| along the last
    axis: the error in units of each row's own size."""
    g, w = got.float(), want.float()
    top = w.abs().amax(dim=-1).clamp_min(1e-30)
    return ((g - w).abs().amax(dim=-1) / top).max().item()


def drop_key_tile(x, start, width=64):
    """``x [B, H, S, D]`` without keys ``[start, start + width)``."""
    import torch

    return torch.cat([x[:, :, :start], x[:, :, start + width:]], dim=2)


def flash_phase(dev, flush, sms, clock):
    """Phase 8: K4 through ``flash_attention`` at the attention widths of
    llama3.2-1b and gemma3-12b (the main path, launches counted), each
    against its plain version, and the timings.  Returns the kernel's
    entry of the kernel line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import (
        flash_attention,
        flash_cuda,
        flash_plain,
    )

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(8)
    inputs = []
    for _, dtype_name, _, b, h, s, d in FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        inputs.append(tuple(torch.randn(b, h, s, d, generator=gen,
                                        device=dev).to(dtype)
                            for _ in range(3)))
    flash_cuda.launches = 0
    outs = [flash_attention(*qkv, causal=case[2])
            for case, qkv in zip(FLASH_CASES, inputs)]
    launches = flash_cuda.launches
    if launches != len(FLASH_CASES):
        fail(f"flash_attention launched K4 {launches} times, expected "
             f"{len(FLASH_CASES)}")
    log(f"  main path: {len(FLASH_CASES)} flash_attention calls, K4 "
        f"{launches} launches")
    case = FLASH_CASES[FLASH_REPEAT_CASE]
    again = flash_cuda(*inputs[FLASH_REPEAT_CASE], causal=case[2])
    torch.cuda.synchronize()
    if not same_bits(again.view(torch.int16), outs[FLASH_REPEAT_CASE].view(
            torch.int16)):
        fail(f"K4 {case[0]}: two runs differ in their bits")
    log(f"  {case[0]}: bitwise equal over two runs")
    del again
    plain = lambda qkv, causal: flash_plain(*qkv, causal=causal,
                                            block_q=4096, block_k=4096)
    max_err = 0.0
    for case, qkv, got in zip(FLASH_CASES, inputs, outs):
        label, dtype_name, causal = case[:3]
        rtol, atol = FLASH_TOL[dtype_name]
        bound = FLASH_ROW_REL[dtype_name]
        want = plain(qkv, causal)
        err = check_close(f"K4 {label}", got, want, rtol, atol)
        rel = row_rel_err(got, want)
        if rel > bound:
            fail(f"K4 {label}: row-relative error {rel:.3g} over {bound}")
        max_err = max(max_err, err)
        if not torch.isfinite(got).all():
            fail(f"K4 {label}: non-finite output")
        # Planted faults, which the row-relative limit must see: a key
        # tile dropped from the middle (for causal, read on the last
        # query, which attends to every key), and the later half of the
        # rows' denominators 5% high.
        q, k, v = qkv
        s = k.shape[2]
        cut = [drop_key_tile(x, s // 2) for x in (k, v)]
        if causal:
            planted = [(want[:, :, -1:], flash_plain(
                q[:, :, -1:], *cut, causal=False, block_k=4096))]
        else:
            planted = [(want, plain((q, *cut), False))]
        half = want[:, :, s // 2:]
        planted.append((half, (half.float() / 1.05).to(half.dtype)))
        faults = [row_rel_err(f, w) for w, f in planted]
        if min(faults) <= bound:
            fail(f"K4 {label}: a planted fault reads {min(faults):.3g}, "
                 f"within the limit {bound}")
        lib = F.scaled_dot_product_attention(*qkv, is_causal=causal)
        lib_err = (got.float() - lib.float()).abs().max().item()
        log(f"  {label}: K4 == plain within rtol {rtol} atol {atol} (max "
            f"abs err {err:.3g}); row-relative {rel:.3g} of {bound} (planted"
            f" dropped key tile {faults[0]:.3g}, denominator 5% high "
            f"{faults[1]:.3g}); {lib_err:.3g} from "
            f"scaled_dot_product_attention")
        del want, planted, cut
    del outs
    log(f"phase 8: K4 checks passed in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ent = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bytes_s = ops_s = 0.0
    for case, qkv in zip(FLASH_CASES, inputs):
        label, dtype_name, causal, b, h, s, d = case
        reps = dict(n_timed=3, n_warm=1)
        k_ms = time_cuda(lambda: flash_cuda(*qkv, causal=causal), flush,
                         **reps)
        p_ms = time_cuda(lambda: plain(qkv, causal), flush, **reps)
        l_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            *qkv, is_causal=causal), flush, **reps)
        b_s, o_s = flash_bound(getattr(torch, dtype_name), causal, b, h, s,
                               d, sms, clock)
        for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms)):
            ent[key] += val
        bytes_s += b_s
        ops_s += o_s
        mask = "causal" if causal else "bidirectional"
        kind = "bytes" if b_s >= o_s else "operations"
        bound_ms = max(b_s, o_s) * 1e3
        tflops = 4 * d * flash_pairs(causal, b, h, s) / (k_ms * 1e-3) / 1e12
        log(f"  {label} ({dtype_name}, {mask}, B={b} H={h} S={s} D={d}): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({kind}); {bound_ms / k_ms:.1%} of "
            f"the bound, {tflops:.1f} TFLOP/s, {k_ms / l_ms:.2f}x sdpa")
    log(f"phase 8: timed in {time.perf_counter() - t0:.1f} s (median of 3;"
        f" {sms} SMs at {clock / 1e6:.0f} MHz)")
    ent["bound_ms"] = max(bytes_s, ops_s) * 1e3
    ent["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
    ent["launches"] = launches
    ent["max_abs_err"] = max_err
    return ent


SERVE_SOURCES = (0, 17, 424242)  # phase 9: compiled SSSP vs Engine.run
SERVE_BATCH = 64                 # SSSP sources in one run_batch
PPR_BATCH = 8                    # personalized-walk seeds in one run_batch
N_WALL = 5                       # medians of 5 for the walls


def rel_err(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def wall_ms(call, n=N_WALL):
    """Median host wall (ms) of ``call()`` through a synchronize, and
    the last call's Result."""
    import torch

    times, res = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), res


def leaf_bound_ms(lay, d):
    """The byte bound of one leaf at width ``d`` (float32): each class's
    index streams and tile table, the slot map and zero-degree list, the
    rows of the senders its live lanes name, and every output row, once
    each, at 3.35 TB/s."""
    import torch

    idx, senders = 0, []
    for c in range(lay.n_classes):
        real = lay.class_dst[c] < lay.class_rows[c]
        senders.append(lay.class_src[c][real])
        idx += 2 * int(lay.class_src[c].shape[0])
        idx += int(lay.class_bounds[c].numel())
    n_msg = int(torch.unique(torch.cat(senders)).numel())
    n_bytes = 4 * (idx + lay.n_dst + n_msg * d + lay.n_dst * d)
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes


def serving_phase(hg, flush):
    """Phase 9: compile-once serving on DBLP at full scale through
    ``Engine(delivery="pallas_fused").compile``: each path's K1 launches
    counted from 0 and read after, its results held against
    ``Engine.run`` (or sequential ``run(query=)``), the cache's hits and
    captures checked, and the walls, queries/s and K1 at wide messages
    timed.  Returns the K1 entry's compiled-path keys."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (
        connected_components_spec,
        pagerank_spec,
        random_walk_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine, Program, deliver
    from repro_torch.kernels.deliver import fused
    from repro_torch.kernels.deliver import _mask_per_query
    from repro_torch.sparse.segment import MONOIDS

    dev = hg.dst.device
    eng = Engine(device=dev, delivery="pallas_fused", collect_stats=True)
    served = []

    def counted(tag, call, leaves):
        """One compiled call with K1's counter zeroed just before and
        read just after: one launch per leaf and pair, all replayed."""
        fused.deliver_fused_cuda.launches = 0
        res = call()
        torch.cuda.synchronize()
        launches = fused.deliver_fused_cuda.launches
        m = res.decision["measured"]
        served.append(res)
        if not m["graph"]:
            fail(f"{tag}: no CUDA graph replayed")
        if launches == 0 or launches != m["pairs_run"] * leaves:
            fail(f"{tag}: {launches} K1 launches, expected "
                 f"{m['pairs_run']} pairs x {leaves} leaves")
        return res, launches

    def no_new_capture(tag, traces):
        stats = eng.cache_stats()
        if stats["traces"] != traces:
            fail(f"{tag}: {stats['traces'] - traces} new captures on a "
                 "cache hit")

    # -- PageRank-30 -----------------------------------------------------------
    pr = pagerank_spec(hg, iters=30)
    c_pr = eng.compile(pr)
    t0 = time.perf_counter()
    c_pr.run()
    t_first = time.perf_counter() - t0
    traces, hits = eng.cache_stats()["traces"], eng.cache_stats()["hits"]
    pr_c, pr_launches = counted("pagerank-30", c_pr.run, 3)
    if eng.cache_stats()["hits"] != hits + 1:
        fail("pagerank-30: the second call was no cache hit")
    no_new_capture("pagerank-30", traces)
    pr_r = eng.run(pr)
    rel = max(rel_err(a, b) for a, b in zip(pr_c.value, pr_r.value))
    if not rel <= 1e-5:
        fail(f"compiled pagerank vs Engine.run relative error {rel}")
    log(f"  pagerank-30: first call {t_first:.2f} s (padded layouts, leaf "
        f"plans, warm-up pair, capture); then a cache hit, no new capture, "
        f"{pr_launches} K1 launches replayed ({pr_c.decision['measured']['pairs_run']} "
        f"pairs x 3 leaves); vs Engine.run max relative error {rel:.3g}")

    # -- SSSP from several sources, components --------------------------------
    sp = shortest_paths_spec(hg, 0)
    c_sp = eng.compile(sp)
    c_sp.run()
    traces = eng.cache_stats()["traces"]
    for s in SERVE_SOURCES:
        got, _ = counted(f"sssp from {s}", lambda: c_sp.run(query=s), 2)
        want = eng.run(shortest_paths_spec(hg, s))
        for a, b in zip(got.value, want.value):
            if not same_bits(a, b):
                fail(f"compiled sssp from {s} != Engine.run")
        for a, b in zip(got.superstep_stats, want.superstep_stats):
            if not torch.equal(a, b):
                fail(f"compiled sssp from {s}: activity stats differ")
        log(f"  sssp from {s}: bitwise, equal stats, "
            f"{got.decision['measured']['pairs_run']} pairs, "
            f"{got.decision['measured']['host_syncs']} host syncs")
    no_new_capture("sssp", traces)
    cc = connected_components_spec(hg)
    c_cc = eng.compile(cc)
    c_cc.run()
    cc_c, _ = counted("components", c_cc.run, 2)
    cc_r = eng.run(cc)
    for a, b in zip(cc_c.value, cc_r.value):
        if not same_bits(a, b):
            fail("compiled components != Engine.run")
    log(f"  components: bitwise, "
        f"{cc_c.decision['measured']['pairs_run']} pairs")

    # -- run_batch: 64 SSSP sources, 8 PPR seeds -------------------------------
    rng = np.random.default_rng(9)
    sources = rng.integers(0, hg.n_vertices, SERVE_BATCH).astype(np.int32)
    sources[0] = 0
    # The batched entry's memory: what the cache counts for it, against
    # what the card allocated and reserved around its build (the
    # padded structure and layouts exist already; the result is freed).
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    c_sp.run_batch(sources)
    t_first_b = time.perf_counter() - t0
    torch.cuda.synchronize()
    alloc_mb = (torch.cuda.memory_allocated(dev) - alloc0) / 2**20
    reserved_mb = (torch.cuda.memory_reserved(dev) - reserved0) / 2**20
    batch_exe = next(reversed(eng._exec_cache.values()))
    entry_mb = batch_exe.nbytes / 2**20
    pool_mb = batch_exe.pool_bytes / 2**20
    log(f"  sssp x{SERVE_BATCH} entry: {entry_mb:.1f} MB counted by the "
        f"cache (graph pool {pool_mb:.1f} MB); around its build the card "
        f"allocated {alloc_mb:+.1f} MB and reserved {reserved_mb:+.1f} MB")
    if not 0 < batch_exe.nbytes <= eng.cache_stats()["capacity_bytes"]:
        fail(f"sssp x{SERVE_BATCH} entry counts {batch_exe.nbytes} bytes")
    traces = eng.cache_stats()["traces"]
    batch, b_launches = counted(f"sssp x{SERVE_BATCH}", lambda: c_sp.run_batch(sources),
                                2)
    no_new_capture("sssp x64", traces)
    slowest = 0
    for i, s in enumerate(sources):
        one = c_sp.run(query=int(s))
        served.append(one)
        for a, b in zip(one.value, batch.value):
            if not same_bits(a, b[i]):
                fail(f"run_batch sssp row {i} (source {s}) != run(query=)")
        for a, b in zip(one.superstep_stats, batch.superstep_stats):
            if not torch.equal(a, b[i]):
                fail(f"run_batch sssp row {i}: activity stats differ")
        slowest = max(slowest, one.decision["measured"]["pairs_run"])
    if batch.supersteps_executed != slowest:
        fail(f"run_batch sssp ran {batch.supersteps_executed} pairs, the "
             f"slowest query {slowest}")
    reached = int(torch.isfinite(batch.value[0]).sum())
    log(f"  sssp x{SERVE_BATCH}: first call {t_first_b:.2f} s; bitwise "
        f"against {SERVE_BATCH} run(query=) calls, equal stats, "
        f"{batch.supersteps_executed} pairs (the slowest query's), "
        f"{b_launches} K1 launches at D = {SERVE_BATCH}, {reached} "
        f"(vertex, source) pairs reached")

    rw = random_walk_spec(hg, iters=30)
    c_rw = eng.compile(rw)
    seeds = rng.integers(0, hg.n_vertices, PPR_BATCH).astype(np.int32)
    c_rw.run_batch(seeds)
    ppr, _ = counted(f"ppr x{PPR_BATCH}", lambda: c_rw.run_batch(seeds), 2)
    ppr_rel = 0.0
    for i, s in enumerate(seeds):
        one = c_rw.run(query=int(s))
        served.append(one)
        ppr_rel = max(ppr_rel, rel_err(ppr.value[i], one.value))
        mass = float(one.value.sum())
        if not abs(mass - 1.0) < 1e-3 or not torch.isfinite(one.value).all():
            fail(f"ppr seed {s}: mass {mass}")
    if not ppr_rel <= 1e-5:
        fail(f"run_batch ppr vs run(query=) relative error {ppr_rel}")
    log(f"  ppr x{PPR_BATCH}: vs {PPR_BATCH} run(query=) calls max "
        f"relative error {ppr_rel:.3g}")
    for res in served:
        if "degraded_from" in res.decision:
            fail(f"a {res.config.delivery} Result degraded from "
                 f"{res.decision['degraded_from']}")

    # -- a K1 launch failure surfaces: no plain twin serves the card ----------
    class Failing:
        @staticmethod
        def deliver_fused_launch(*args):
            return 1

    entries = eng.cache_stats()["entries"]
    real_lib = fused._kernel_lib
    fused._kernel_lib = lambda: Failing
    try:
        eng.compile(pagerank_spec(hg, iters=2)).run()
    except RuntimeError as err:
        raised = str(err)
    else:
        raised = None
    finally:
        fused._kernel_lib = real_lib
    if raised is None or "launch failed" not in raised:
        fail(f"a failing K1 launch did not raise from run(): {raised}")
    if eng.cache_stats()["entries"] != entries:
        fail("the failed build left a cache entry")
    log(f"  a failing K1 launch raised from run() ({raised!r}); no cache "
        f"entry left")

    # -- timings ----------------------------------------------------------------
    log(f"  timings (host wall through a synchronize, median of {N_WALL}):")
    walls = {}
    for label, compiled, one_shot in (
            ("pagerank-30", c_pr.run, lambda: eng.run(pr)),
            ("sssp from 0", lambda: c_sp.run(query=0), lambda: eng.run(sp))):
        c_ms, c_res = wall_ms(compiled)
        r_ms, r_res = wall_ms(one_shot)
        walls[label] = (c_ms, r_ms)
        cm, rm = c_res.decision["measured"], r_res.decision["measured"]
        log(f"    {label}: compiled {c_ms:.3f} ms (dispatch "
            f"{cm['dispatch_s'] * 1e3:.3f}, device wait "
            f"{cm['device_wait_s'] * 1e3:.3f}, {cm['host_syncs']} host "
            f"syncs) vs Engine.run {r_ms:.3f} ms (dispatch "
            f"{rm['dispatch_s'] * 1e3:.3f}, device wait "
            f"{rm['device_wait_s'] * 1e3:.3f}, {rm['host_syncs']} host "
            f"syncs): {r_ms / c_ms:.2f}x")
    b_ms, _ = wall_ms(lambda: c_sp.run_batch(sources), 3)
    t0 = time.perf_counter()
    for s in sources:
        c_sp.run(query=int(s))
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for s in sources[:16]:
        eng.run(shortest_paths_spec(hg, int(s)))
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3 / 16 * SERVE_BATCH
    log(f"    sssp x{SERVE_BATCH}: run_batch {b_ms:.2f} ms "
        f"({SERVE_BATCH / b_ms * 1e3:.1f} queries/s, median of 3) vs "
        f"{SERVE_BATCH} sequential run(query=) {seq_ms:.2f} ms "
        f"({SERVE_BATCH / seq_ms * 1e3:.1f} queries/s) vs Engine.run "
        f"{run_ms:.2f} ms ({SERVE_BATCH / run_ms * 1e3:.1f} queries/s, 16 "
        f"timed)")

    # -- K1 at wide messages on the bucket-padded layout ----------------------
    prep = c_sp._prepared(None, rebind=True)
    fwd, hgp = prep.delivery[0], prep.hgp
    min_prog = Program(procedure=None, combiner="min")
    log(f"  K1 on the bucket-padded v->he layout (n_src {fwd.n_src}, n_dst "
        f"{fwd.n_dst}, {fused.leaf_plan(fwd).zero_dst.numel()} zero-degree "
        f"destinations), float32 min, no activity; L2 flushed, median of "
        f"{N_TIMED}:")
    wide = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for d in (1, 8, SERVE_BATCH):
        msgs = torch.randint(-1000, 1000, (fwd.n_src, d), device=dev,
                             generator=gen).float()
        got = fused.deliver_leaf_cuda(msgs, None, fwd, "min")
        want = fused.deliver_leaf_plain(msgs, None, fwd, "min")
        if not same_bits(got, want):
            fail(f"K1 at D = {d} != deliver_leaf_plain")
        k_ms = time_cuda(
            lambda: fused.deliver_leaf_cuda(msgs, None, fwd, "min"), flush)
        k_dev = time_device(
            lambda: fused.deliver_leaf_cuda(msgs, None, fwd, "min"), flush)
        p_ms = time_cuda(
            lambda: fused.deliver_leaf_plain(msgs, None, fwd, "min"), flush)
        # The port's xla lowering of the same leaf: gather, mask the
        # padding lanes, segment min.
        x_leaf = lambda: deliver(msgs, None, hgp.src, hgp.dst, fwd.n_dst,
                                 min_prog, e_mask=hgp.e_mask)
        if not same_bits(x_leaf(), want):
            fail(f"xla leaf at D = {d} != deliver_leaf_plain")
        x_ms = time_cuda(x_leaf, flush)
        bound, n_bytes = leaf_bound_ms(fwd, d)
        wide[d] = (k_ms, p_ms, bound, k_dev, x_ms)
        line = (f"    D = {d}: {k_ms * 1e3:.1f} us (device "
                f"{k_dev * 1e3:.1f} us), plain "
                f"{p_ms * 1e3:.1f} us, xla {x_ms * 1e3:.1f} us, bound "
                f"{bound * 1e3:.1f} us "
                f"({n_bytes / 1e6:.1f} MB; {bound / k_ms:.1%} of it, of "
                f"the device time {bound / k_dev:.1%})")
        if d > 1:
            act = torch.rand(fwd.n_src, d, device=dev, generator=gen) < 0.5
            m_ms = time_cuda(lambda: _mask_per_query(msgs, act,
                                                     MONOIDS["min"]), flush)
            line += (f"; the per-query activity pass before it "
                     f"{m_ms * 1e3:.1f} us")
        log(line)
        del msgs
    stats = eng.cache_stats()
    sizes = ", ".join(
        f"{m['algorithm']}/{m['batch_pad'] or 1} {m['bytes'] / 2**20:.1f}"
        for m in stats["entry_shapes"])
    log(f"  cache: {stats['entries']} entries, {stats['traces']} captures, "
        f"{stats['hits']} hits, {stats['bytes'] / 2**20:.1f} MB held of "
        f"{stats['capacity_bytes'] / 2**20:.0f} MB (MB each: {sizes})")
    if stats["bytes"] > stats["capacity_bytes"]:
        fail("the executable cache holds more than its byte bound")
    return {
        "compiled_launches": pr_launches,
        "compiled_pagerank_ms": walls["pagerank-30"][0],
        "one_shot_pagerank_ms": walls["pagerank-30"][1],
        "compiled_sssp_ms": walls["sssp from 0"][0],
        "one_shot_sssp_ms": walls["sssp from 0"][1],
        "batch64_qps": SERVE_BATCH / b_ms * 1e3,
        "sequential64_qps": SERVE_BATCH / seq_ms * 1e3,
        "d8_ms": wide[8][0], "d8_device_ms": wide[8][3],
        "d8_bound_ms": wide[8][2], "d8_library_ms": wide[8][4],
        "d64_ms": wide[SERVE_BATCH][0],
        "d64_device_ms": wide[SERVE_BATCH][3],
        "d64_plain_ms": wide[SERVE_BATCH][1],
        "d64_bound_ms": wide[SERVE_BATCH][2],
        "d64_library_ms": wide[SERVE_BATCH][4],
    }


DELIVERY_SCALES = (0.002, 0.01, 0.05, 0.25, 1.0)  # phase 10: DBLP sizes
DELIVERY_WIDTHS = (1, 2, 8, 16, 64)               # float32 columns
DELIVERY_BAND = 0.10  # a point this close to the crossover only logs


def delivery_probe(hg, d):
    """A monoid spec whose messages are ``d`` float32 columns: what
    ``select_delivery`` reads to price one delivery pair at width d."""
    import torch

    from repro_torch.algorithms import AlgorithmSpec
    from repro_torch.core import Program

    prog = Program(procedure=None, combiner="sum")
    return AlgorithmSpec(
        hg0=hg, initial_msg=torch.zeros(d) if d > 1 else torch.zeros(()),
        v_program=prog, he_program=prog, max_iters=1,
        extract=lambda out: out, name=f"probe[D={d}]")


def delivery_grid(hg_full, flush):
    """Phase 10: one delivery pair (v->he, then he->v), float32 sum, no
    activity, through the port's ``xla`` lowering (``deliver`` with no
    layout: gather, mask, segment reduce) and the fused K1 leaf
    (``deliver`` with the Engine's layouts), on DBLP at
    ``DELIVERY_SCALES`` and ``DELIVERY_WIDTHS``: each checked against the
    other (1e-5), timed in turns (``time_two``: L2 flushed, from an
    idle card, median of 20), and priced by ``select_delivery``.
    Beside them, ``loop_ms``: a pair's share of 20 pairs queued back to
    back, as a superstep loop runs them (informational).  Returns the
    grid's records."""
    import torch

    from repro_torch.core import Engine, Program, deliver, select_delivery
    from repro_torch.data import make_dataset
    from repro_torch.obs import delivery_traffic_pair

    dev = hg_full.dst.device
    prog = Program(procedure=None, combiner="sum")
    gen = torch.Generator(device=dev).manual_seed(11)
    records = []
    log("phase 10: one delivery pair (fwd + bwd), float32 sum, no "
        "activity; xla (gather + mask + segment reduce) vs the fused K1 "
        f"leaf; in turns, L2 flushed, from an idle card, median of "
        f"{N_TIMED}; loop: a pair's share of {N_TIMED} back to back; ms")
    log("  scale      nnz   D   xla_ms  fused_ms  xla/fused  auto          "
        "xla_loop fused_loop")
    for scale in DELIVERY_SCALES:
        hg = (hg_full if scale == 1.0
              else make_dataset("dblp", scale, seed=0, device=dev))
        fwd, bwd = Engine(device=dev)._delivery_layouts(hg)
        nv, ne = hg.n_vertices, hg.n_hyperedges
        for d in DELIVERY_WIDTHS:
            shape = (lambda n: (n,)) if d == 1 else (lambda n: (n, d))
            m_v = torch.rand(shape(nv), generator=gen, device=dev)
            m_he = torch.rand(shape(ne), generator=gen, device=dev)

            def pair(fused):
                out_he = deliver(m_v, None, hg.src, hg.dst, ne, prog,
                                 layout=fwd if fused else None)
                out_v = deliver(m_he, None, hg.dst, hg.src, nv, prog,
                                layout=bwd if fused else None)
                return out_he, out_v

            for a, b in zip(pair(True), pair(False)):
                check_close(f"delivery pair scale {scale} D={d}", a, b,
                            1e-5, 1e-5)
            x_ms, f_ms = time_two(lambda: pair(False), lambda: pair(True),
                                  flush)
            loop = {}
            for fused in (False, True):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(N_TIMED):
                    pair(fused)
                end.record()
                end.synchronize()
                loop[fused] = start.elapsed_time(end) / N_TIMED
            pick, why = select_delivery(delivery_probe(hg, d), hg)
            traffic = delivery_traffic_pair((fwd, bwd), 4.0 * d)
            records.append({
                "scale": scale, "nnz": hg.nnz, "d": d, "xla_ms": x_ms,
                "fused_ms": f_ms, "xla_loop_ms": loop[False],
                "fused_loop_ms": loop[True], "auto_picks": pick,
                "reason": why["reason"],
                "model_traffic_ratio": (traffic["reference_total_bytes"]
                                        / traffic["total_bytes"]),
                "fused_speedup": x_ms / f_ms,
            })
            log(f"  {scale:<6} {hg.nnz:>9} {d:>3} {x_ms:8.4f} {f_ms:9.4f} "
                f"{x_ms / f_ms:10.3f}  {pick:<12}  {loop[False]:7.4f} "
                f"{loop[True]:8.4f}")
            del m_v, m_he
        del fwd, bwd
    return records


def check_delivery_term(records):
    """Phase 10's check: at every grid point ``select_delivery`` picks the
    faster path, unless the two are within ``DELIVERY_BAND`` of each
    other (logged).  Also the calibration record of the traffic model
    (``obs.delivery_calibration``)."""
    from repro_torch.obs import delivery_calibration

    wrong = []
    for r in records:
        faster = "pallas_fused" if r["fused_ms"] < r["xla_ms"] else "xla"
        gap = (abs(r["fused_ms"] - r["xla_ms"])
               / min(r["fused_ms"], r["xla_ms"]))
        if r["auto_picks"] == faster:
            continue
        point = (f"scale {r['scale']} D={r['d']}: auto picks "
                 f"{r['auto_picks']}, {faster} is faster by {gap:.1%}")
        if gap <= DELIVERY_BAND:
            log(f"  within {DELIVERY_BAND:.0%} of the crossover: {point}")
        else:
            wrong.append(point)
    cal = delivery_calibration({f"{r['scale']}/D={r['d']}": r
                                for r in records})["summary"]
    log(f"  traffic model vs measured speedup over {cal['regimes']} "
        f"points: mean |log2 residual| {cal['mean_abs_residual_log2']:.3f}, "
        f"max {cal['max_abs_residual_log2']:.3f}, suggested scale "
        f"{cal['suggested_model_scale']:.3f}; auto agrees with the "
        f"faster path at {cal['decision_accuracy']:.0%} of the points")
    if wrong:
        fail("select_delivery picks the slower path: " + "; ".join(wrong))


def graph_pagerank_plain(g, iters=30, alpha=0.15):
    """``graph_pagerank``'s plain version: both sums by ``index_add_``
    over the edges in their own order (the JAX package's
    ``segment_sum``)."""
    import torch

    from repro_torch.kernels.segsum import segsum_plain

    nv = g.n_vertices
    w = g.e_attr.float()
    out_w = segsum_plain(w[:, None], g.src, nv)[:, 0].clamp(min=1e-12)
    rank = torch.ones(nv, dtype=torch.float32, device=w.device)
    for _ in range(iters):
        contrib = (rank / out_w)[g.src] * w
        rank = alpha + (1.0 - alpha) * segsum_plain(contrib[:, None],
                                                    g.dst, nv)[:, 0]
    return rank


CLIQUE_EDGES = 33_490_568  # DBLP's symmetrized expansion (numpy, seed 0)
FIG1_EDGES = [[0, 1], [0, 1, 2, 3], [0, 3, 4], [2, 3]]


def clique_phase(hg, flush):
    """Phase 11: the clique representation on DBLP at full scale:
    ``to_graph``, ``graph_pagerank`` (K2b once an iteration; its
    out-weights by ``index_add_``, which measured faster than K2a there)
    against its plain version, K2 launches counted over
    ``Engine(representation="clique").run``, K2b repeated bitwise, the
    two design points timed, K2b and K2a against ``index_add_`` at the
    clique's shapes, ``resolve`` on DBLP and on Fig. 1, and a traced
    ``explain`` + ``run``.  Returns K2b's entry of the kernel line at
    the clique's shapes and K2a's numbers there."""
    import torch

    from repro_torch.algorithms import graph_pagerank, vertex_pagerank_spec
    from repro_torch.core import Engine, HyperGraph, to_graph
    from repro_torch.kernels.segsum import (
        csr_row_offsets,
        segsum_cuda,
        segsum_plain,
        segsum_sorted_cuda,
        segsum_sorted_plain,
    )
    from repro_torch.obs import Tracer

    dev = hg.dst.device
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    g = to_graph(hg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_edges = int(g.src.numel())
    log(f"  to_graph: {n_edges} symmetric edges in {build_s:.2f} s")
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    if n_edges != CLIQUE_EDGES:
        fail(f"to_graph gave {n_edges} edges, expected {CLIQUE_EDGES}")

    spec = vertex_pagerank_spec(hg, iters=30)
    clique = Engine(device=dev, representation="clique")
    segsum_cuda.launches = segsum_sorted_cuda.launches = 0
    res = clique.run(spec)
    torch.cuda.synchronize()
    launches = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    log(f"  {at()} Engine(representation='clique').run("
        f"vertex_pagerank_spec): K2a {launches[0]} launches, K2b "
        f"{launches[1]}")
    if launches != (0, 30):
        fail(f"the clique run launched K2a/K2b {launches} times, expected "
             "(0, 30)")
    want = graph_pagerank_plain(g)
    rank = graph_pagerank(g)
    rel = rel_err(rank, want)
    rel_run = rel_err(res.value, want)
    log(f"  {at()} graph_pagerank vs plain: max relative error "
        f"{rel:.3g}; the Engine run's {rel_run:.3g}")
    if not (rel <= 1e-5 and rel_run <= 1e-5):
        fail(f"graph_pagerank vs plain relative error {rel}, {rel_run}")
    if (res.value.shape != (hg.n_vertices,)
            or not torch.isfinite(res.value).all()
            or (res.value <= 0).any()):
        fail("clique ranks are not finite, positive, of shape [n]")

    # The per-iteration sum's inputs, as graph_pagerank builds them.
    nv = g.n_vertices
    w = g.e_attr
    order = torch.sort(g.dst, stable=True).indices
    dst_s = g.dst[order]
    off = csr_row_offsets(dst_s, nv)
    contrib = (torch.rand(nv, device=dev)[g.src[order]] * w[order])[:, None]
    first = segsum_sorted_cuda(contrib, off, nv)
    for i in range(30):
        if not same_bits(segsum_sorted_cuda(contrib, off, nv), first):
            fail(f"K2b call {i + 2} of 31 with one set of offsets differs")
    rtol, atol = segsum_tol(n_edges, nv, torch.float32)
    k2b_err = check_close("K2b at the clique shape", first,
                          segsum_sorted_plain(contrib, off, nv), rtol, atol)
    w2 = w[:, None].contiguous()
    k2a_err = check_close("K2a out_w", segsum_cuda(w2, g.src, nv),
                          segsum_plain(w2, g.src, nv), rtol, atol)
    log(f"  {at()} K2b: 31 calls with one set of offsets, bitwise equal")

    # -- resolve: bipartite on DBLP, clique on Fig. 1 -------------------------
    rep = Engine(device=dev).resolve(spec)[0].representation
    if rep != "bipartite":
        fail(f"auto resolves {rep} on DBLP, expected bipartite")
    fig1 = HyperGraph.from_hyperedge_lists(FIG1_EDGES, n_vertices=5,
                                           device=dev)
    s1 = vertex_pagerank_spec(fig1, iters=8)
    r1 = Engine(device=dev).run(s1)
    rel1 = rel_err(r1.value, graph_pagerank_plain(to_graph(fig1), 8))
    log(f"  {at()} auto: {rep} on DBLP, {r1.representation} on Fig. 1 "
        f"(vs plain "
        f"{rel1:.3g})")
    if r1.representation != "clique" or not rel1 <= 1e-5:
        fail(f"Fig. 1: {r1.representation}, relative error {rel1}")

    # -- a traced explain + run on the card ----------------------------------
    tr = Tracer()
    traced = Engine(device=dev, tracer=tr)
    ex = traced.explain(spec)
    res_t = traced.run(spec)
    for axis, field in (("representation", "representation"),
                        ("backend", "backend"), ("delivery", "delivery")):
        if ex["axes"][axis]["winner"] != getattr(res_t.config, field):
            fail(f"explain's {axis} winner {ex['axes'][axis]['winner']} != "
                 f"run's {getattr(res_t.config, field)}")
    if ex["config"] != res_t.config:
        fail("explain's config != run's")
    runs = [sp for sp in tr.spans() if sp.name == "engine.run"]
    if not runs or any("device_wait_s" not in sp.args for sp in runs):
        fail("engine.run spans without device_wait_s")
    d_in = ex["axes"]["delivery"]["inputs"]
    log(f"  {at()} traced explain + run: winners {res_t.representation} / "
        f"{res_t.backend} / {res_t.config.delivery} ({d_in['lowering']}, "
        f"{ex['axes']['delivery']['reason']}); spans "
        f"{sorted({sp.name for sp in tr.spans()})}, engine.run device wait "
        f"{runs[-1].args['device_wait_s'] * 1e3:.3f} ms")

    # -- timings --------------------------------------------------------------
    bip = Engine(device=dev, representation="bipartite",
                 delivery="pallas_fused")
    bip.run(spec)  # layouts built, warm
    c_ms, _ = wall_ms(lambda: clique.run(spec), 3)
    b_ms, _ = wall_ms(lambda: bip.run(spec), 3)
    p_ms, _ = wall_ms(lambda: graph_pagerank(g), 3)
    log(f"  {at()} vertex PageRank-30 (host wall through a synchronize, "
        f"median of "
        f"3): clique {c_ms:.1f} ms (to_graph included; graph_pagerank "
        f"alone {p_ms:.2f} ms) vs bipartite fused {b_ms:.2f} ms")
    e = n_edges
    entries = {}
    for name, kernel, plain, library, n_bytes in (
            ("segsum", lambda: segsum_cuda(w2, g.src, nv),
             lambda: segsum_plain(w2, g.src, nv),
             lambda: torch.zeros(nv, 1, device=dev).index_add_(0, g.src, w2),
             4 * (2 * e + nv)),
            ("segsum_sorted", lambda: segsum_sorted_cuda(contrib, off, nv),
             lambda: segsum_sorted_plain(contrib, off, nv),
             lambda: torch.zeros(nv, 1, device=dev).index_add_(
                 0, dst_s, contrib),
             4 * (e + nv + nv + 1))):
        k_ms = time_cuda(kernel, flush)
        p_k = time_cuda(plain, flush)
        l_ms = time_cuda(library, flush)
        b_s, o_s = n_bytes / HBM_BYTES_PER_S, e / FP32_OPS_PER_S
        entries[name] = {
            "ms": k_ms, "plain_ms": p_k, "library_ms": l_ms,
            "bound_ms": max(b_s, o_s) * 1e3,
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "launches": launches[0 if name == "segsum" else 1],
            "max_abs_err": k2a_err if name == "segsum" else k2b_err,
        }
        log(f"  {'K2a out_w' if name == 'segsum' else 'K2b per iteration'} "
            f"(E = {e} into {nv} rows, float32 D=1): kernel {k_ms:.4f} ms, "
            f"plain {p_k:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
            f"{max(b_s, o_s) * 1e3:.4f} ms; the kernel is "
            f"{'faster' if k_ms < l_ms else 'SLOWER'} than index_add_")
    entries["segsum_sorted"].update(
        clique_ms=c_ms, bipartite_ms=b_ms, graph_pagerank_ms=p_ms,
        to_graph_s=build_s,
        caller="algorithms/graph_pagerank.py: the sum by destination, "
               "once an iteration (Engine clique run)")
    log(f"  {at()} phase 11 timings done")
    return entries


SERVE_REQUESTS = 256      # phase 12: the front-end's trace
SERVE_MIX = 0.6           # its SSSP share (the launcher's default)
SERVE_MAX_BATCH = 16      # the launcher's default bucket
SERVE_ITERS = 12          # the launcher's superstep budget
SERVE_SAMPLE = 16         # served results held against sequential runs
FUTURE_TIMEOUT_S = 300    # no future may take longer to resolve
FAULT_PLAN = {"rules": [
    {"point": "execute", "trigger": "every", "n": 7, "error": "transient"},
    {"point": "serve.flush", "trigger": "nth", "n": 3, "error": "transient"},
    {"point": "serve.worker", "trigger": "nth", "n": 2},
]}


def checkpoint_case(tag, spec, leaves, root, compiled=False):
    """Phase 12 (a), one spec on DBLP through ``pallas_fused``: the run
    with ``checkpoint_every=7`` bitwise equal to the run without; a run
    killed by ``checkpoint.chunk`` (``nth=2``, fatal) after pair 14; a
    fresh Engine resuming from pair 14, bitwise equal (values and
    trace), its K1 launches counted from 0 (the resumed pairs only).
    ``compiled``: all through ``Engine.compile(spec)`` (the
    ``_run_checkpointed`` route).  Returns the resumed run's launches and
    the save and restore seconds."""
    import torch

    from repro_torch.core import Engine, tree_leaves
    from repro_torch.faults import FaultInjector, InjectedFault
    from repro_torch.kernels.deliver import fused
    from repro_torch.obs import Tracer

    dev = spec.hg0.device
    tracer = Tracer()

    def engine(**kw):
        return Engine(device=dev, delivery="pallas_fused",
                      collect_stats=True, tracer=tracer, **kw)

    def run(eng, **kw):
        if compiled:
            return eng.compile(spec, **kw).run()
        return eng.run(spec, **kw)

    def same(got, want, what):
        for a, b in zip(tree_leaves(got.value), tree_leaves(want.value)):
            if a.device.type != "cuda" or not same_bits(a, b):
                fail(f"{tag}: {what} values differ from the uninterrupted run")
        for a, b in zip(got.superstep_stats, want.superstep_stats):
            if not torch.equal(a, b):
                fail(f"{tag}: {what} activity trace differs")

    base = run(engine())
    same(run(engine(), checkpoint_every=7,
             checkpoint_dir=f"{root}/whole"), base, "checkpointed")
    plan = {"rules": [{"point": "checkpoint.chunk", "trigger": "nth",
                       "n": 2, "error": "fatal"}]}
    try:
        run(engine(fault_injector=FaultInjector.from_json(plan)),
            checkpoint_every=7, checkpoint_dir=f"{root}/killed")
    except InjectedFault:
        pass
    else:
        fail(f"{tag}: checkpoint.chunk nth=2 did not kill the run")
    if not os.path.isdir(f"{root}/killed/step_00000014"):
        fail(f"{tag}: no snapshot of pair 14 survived the kill")
    fused.deliver_fused_cuda.launches = 0
    res = run(engine(), checkpoint_every=7, checkpoint_dir=f"{root}/killed")
    torch.cuda.synchronize()
    launches = fused.deliver_fused_cuda.launches
    same(res, base, "resumed")
    spans = tracer.spans()
    saves = [s.dur_s for s in spans if s.name == "faults.checkpoint_save"]
    restores = [s.dur_s for s in spans
                if s.name == "faults.checkpoint_restore"]
    if len(restores) != 1:
        fail(f"{tag}: {len(restores)} restores, expected 1")
    if compiled:
        if res.decision.get("checkpointed", {}).get("every") != 7:
            fail(f"{tag}: the compiled run did not take _run_checkpointed")
        pairs = (launches // leaves if launches else 0)
    else:
        m = res.decision["measured"]
        if m["resumed_from"] != 14:
            fail(f"{tag}: resumed from pair {m['resumed_from']}, not 14")
        pairs = m["pairs_run"]
        if launches != pairs * leaves:
            fail(f"{tag}: {launches} K1 launches resuming, expected "
                 f"{pairs} pairs x {leaves} leaves")
    log(f"  {tag}: checkpointed every 7 bitwise; killed after pair 14; "
        f"resumed bitwise (values and trace), {launches} K1 launches "
        f"({pairs} pairs resumed); {len(saves)} saves, "
        f"{statistics.median(saves) * 1e3:.1f} ms median, "
        f"{max(saves) * 1e3:.1f} max; restore "
        f"{restores[0] * 1e3:.1f} ms")
    return launches, statistics.median(saves), restores[0]


def replay(fe, trace, timeout=FUTURE_TIMEOUT_S):
    """Submit the whole trace, then wait for each future (with a
    timeout: a hang fails the phase).  Returns the outcomes (a
    ``ServedResult`` or the typed error) and the wall seconds."""
    import concurrent.futures

    from repro_torch.faults import FaultError

    t0 = time.perf_counter()
    out = []
    try:
        fe.start()
        futs = [fe.submit(key, query=q) for key, q in trace]
        for (key, q), f in zip(trace, futs):
            try:
                out.append(f.result(timeout=timeout))
            except concurrent.futures.TimeoutError:
                fail(f"request {key} {q} did not resolve in {timeout} s")
            except FaultError as err:
                out.append(err)
    finally:
        fe.close()
    return out, time.perf_counter() - t0


def fault_serving_phase(hg):
    """Phase 12: fault-tolerant serving on DBLP at full scale (see the
    module docstring).  Returns K1's phase-12 keys for the kernel line."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.algorithms import (
        pagerank_spec,
        random_walk_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine
    from repro_torch.faults import FaultError, FaultInjector, InjectedFault
    from repro_torch.kernels.deliver import fused
    from repro_torch.launch.serve_hypergraph import (
        agrees,
        batch_buckets,
        make_trace,
    )
    from repro_torch.serve import Frontend, warm

    dev = hg.dst.device
    # -- (a) checkpoint/resume --------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        pr_launches, pr_save, pr_restore = checkpoint_case(
            "pagerank-30", pagerank_spec(hg, iters=30), 3, f"{root}/pr")
        checkpoint_case("sssp from 0 (halts early)",
                        shortest_paths_spec(hg, 0), 2, f"{root}/sp")
        checkpoint_case("compiled pagerank-30", pagerank_spec(hg, iters=30),
                        3, f"{root}/cpr", compiled=True)
    if pr_launches != 16 * 3:
        fail(f"pagerank-30 resumed with {pr_launches} K1 launches, not 48")
    log(f"  (a) {time.perf_counter() - t0:.1f} s")

    # -- (b) the front-end, fault-free -----------------------------------------
    t0 = time.perf_counter()
    eng = Engine(device=dev, delivery="pallas_fused")
    specs = {"sssp": shortest_paths_spec(hg, source=0,
                                         max_iters=SERVE_ITERS),
             "ppr": random_walk_spec(hg, iters=SERVE_ITERS)}
    compiled = {key: eng.compile(spec) for key, spec in specs.items()}

    def frontend(**kw):
        fe = Frontend(eng, max_batch=SERVE_MAX_BATCH, max_delay_ms=5.0, **kw)
        for key, c in compiled.items():
            fe.register(key, c)
        return fe

    buckets = batch_buckets(SERVE_MAX_BATCH)
    report = warm(eng, list(compiled.values()), batch_sizes=buckets,
                  queries=[0, 0])
    captures = eng.cache_stats()["traces"]
    log(f"  warm: {report['traces']} captures in {report['boot_s']:.2f} s "
        f"(buckets {buckets}, both paths, and each unbatched)")
    rng, trace = make_trace(hg.n_vertices, SERVE_REQUESTS, SERVE_MIX, 0)
    fe = frontend()
    fused.deliver_fused_cuda.launches = 0
    clean, wall = replay(fe, trace)
    launches = fused.deliver_fused_cuda.launches
    errors = [r for r in clean if isinstance(r, Exception)]
    if errors:
        fail(f"{len(errors)} fault-free requests failed: {errors[0]!r}")
    if eng.cache_stats()["traces"] != captures:
        fail("the worker captured after warm")
    st = fe.stats()
    flushes = sum(st["flush_reasons"].values())
    pick = rng.choice(len(trace), size=SERVE_SAMPLE, replace=False)
    for i in pick:
        key, q = trace[i]
        if not agrees(key, clean[i].value, compiled[key].run(query=q).value):
            fail(f"served {key} {q} != sequential compiled run")
    qps = len(trace) / wall
    log(f"  (b) {len(trace)} requests ({sum(k == 'sssp' for k, _ in trace)} "
        f"sssp) in {wall:.3f} s: {qps:.1f} requests/s; queue wait p50 "
        f"{st['queue_wait']['p50_s'] * 1e3:.2f} ms p99 "
        f"{st['queue_wait']['p99_s'] * 1e3:.2f} ms, execute p50 "
        f"{st['execute']['p50_s'] * 1e3:.2f} ms p99 "
        f"{st['execute']['p99_s'] * 1e3:.2f} ms; flushes "
        f"{st['flush_reasons']}; {launches} K1 launches "
        f"({launches / flushes:.1f} a flush); {SERVE_SAMPLE} sampled "
        f"results agree with sequential runs (sssp bitwise, ppr 1e-5)")
    for bucket, occ in st["buckets"].items():
        log(f"    bucket {bucket}: {occ['flushes']} flushes, occupancy "
            f"{occ['mean_occupancy']:.2f}")
    cs = eng.cache_stats()
    log(f"    cache: {cs['entries']} entries, {cs['traces']} captures (none "
        f"after warm), {cs['hits']} hits, {cs['misses']} misses, "
        f"{cs['bytes'] / 2**20:.1f} MB")
    # The resilient default against resilience=False on the same trace,
    # in turns (the reference's "<2% fault-free overhead", measured).
    walls = {True: [], False: []}
    for resilient in (False, True, True, False):
        _, w = replay(frontend(resilience=resilient), trace)
        walls[resilient].append(w)
    on, off = min(walls[True]), min(walls[False])
    log(f"    fault-free overhead: resilient {on * 1e3:.1f} ms vs "
        f"resilience=False {off * 1e3:.1f} ms (best of 2 each): "
        f"{(on / off - 1) * 100:+.1f}%")
    log(f"  (b) {time.perf_counter() - t0:.1f} s")

    # -- (c) the same trace under faults ---------------------------------------
    inj = FaultInjector.from_json(FAULT_PLAN)
    eng.fault_injector = inj
    faulted, f_wall = replay(frontend(), trace)
    eng.fault_injector = None
    typed = 0
    for i, (r, ok) in enumerate(zip(faulted, clean)):
        if isinstance(r, Exception):
            if not isinstance(r, FaultError):
                fail(f"request {i} resolved untyped: {r!r}")
            typed += 1
        elif not agrees(trace[i][0], r.value, ok.value):
            fail(f"request {i} under faults != its fault-free value")
    snap = inj.snapshot()
    log(f"  (c) {len(trace)} requests under {len(FAULT_PLAN['rules'])} "
        f"rules in {f_wall:.3f} s: {len(trace) - typed} served (equal to "
        f"the fault-free values), {typed} typed errors; "
        + ", ".join(f"{p} calls {snap['calls'][p]} fired "
                    f"{snap['fired'].get(p, 0)}" for p in sorted(
                        snap["calls"])))
    if snap["never_fired"]:
        fail(f"plan points that never fired: {snap['never_fired']}")

    # -- (d) a fatal fault on the card ------------------------------------------
    degraded0 = eng.metrics.counter("faults.delivery_degraded").value
    eng.fault_injector = FaultInjector.from_json({"rules": [
        {"point": "execute", "trigger": "always", "error": "fatal"}]})
    fatal, _ = replay(frontend(), [("sssp", q) for q in (0, 1, 2, 3)])
    eng.fault_injector = None
    for r in fatal:
        if not isinstance(r, FaultError):
            fail(f"a fatal execute fault was served: {r!r}")
        if not isinstance(r, InjectedFault) and not isinstance(
                r.__cause__, InjectedFault):
            fail(f"a fatal execute fault resolved as {r!r}")
    if eng.metrics.counter("faults.delivery_degraded").value != degraded0:
        fail("a request degraded to the xla twin on the card")
    log(f"  (d) fatal execute fault: 4 of 4 requests resolved typed "
        f"({type(fatal[0]).__name__} from "
        f"{type(fatal[0].__cause__ or fatal[0]).__name__}), 0 degrades")
    del fe, compiled, eng
    torch.cuda.empty_cache()

    # -- (e) the launcher ----------------------------------------------------------
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_hypergraph",
         "--regime", "dblp", "--scale", "1.0", "--requests", "200",
         "--verify", "8"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    if proc.returncode != 0 or "verified 8" not in proc.stdout:
        fail(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"  (e) launcher verified 8 of 8 in {time.perf_counter() - t0:.1f} s")
    return {"phase12_serve_launches": launches,
            "phase12_serve_flushes": flushes,
            "phase12_launches_per_flush": launches / flushes,
            "phase12_requests_per_s": qps,
            "phase12_resume_launches": pr_launches,
            "phase12_checkpoint_save_s": pr_save,
            "phase12_checkpoint_restore_s": pr_restore}


POOL_REPLICAS = 2          # phase 13: replica processes on the one card
POOL_HEARTBEAT_MS = 2000.0  # the launcher's default heartbeat timeout
POOL_BOOT_TIMEOUT_S = 300  # no boot may take longer
HANG_REQUESTS = 48         # phase 13 (d): the head of the trace
# Seeded so that the first instance hangs at its 6th request and the
# second at none of its first 120 (prob draws per instance: seed +
# 1009 x spawn order); (e)'s crashes the first at its 21st request and
# the second at none of its first 250.
HANG_PLAN = {"rules": [{"point": "replica.hang", "trigger": "prob",
                        "p": 0.05, "seed": 1559}]}
CRASH_PLAN = {"rules": [{"point": "replica.crash", "trigger": "prob",
                         "p": 0.02, "seed": 83}]}
LAUNCH_POOL_SCALE = 1.0    # phase 13 (e): the launcher's --scale


def smi_memory():
    """``{pid: MiB}`` of the card's compute processes (``nvidia-smi``)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True)
    out = {}
    for line in proc.stdout.splitlines():
        pid, used = (x.strip() for x in line.split(","))
        if pid.isdigit() and used.isdigit():
            out[int(pid)] = int(used)
    return out


def start_pool(store, plan=None):
    """A ``Router`` over ``POOL_REPLICAS`` replica processes on the card,
    each armed with ``plan``; returns it, every handle it spawns (a
    list that grows with respawns) and the reasons of its deaths."""
    import dataclasses
    import itertools

    import torch

    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import ProcessReplica, ReplicaConfig, Router

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = ReplicaConfig(
        builder="repro_torch.launch.serve_hypergraph:build_paths",
        kwargs={"regime": "dblp", "scale": 1.0, "seed": 0,
                "iters": SERVE_ITERS},
        cache_dir=store, max_batch=SERVE_MAX_BATCH, max_delay_ms=5.0,
        fault_plan=json.dumps(plan) if plan else None,
        require_no_retrace=True, device="cuda",
        exec_cache_bytes=total // 4 // POOL_REPLICAS)
    spawned, order = [], itertools.count()

    def factory(index):
        spawned.append(ProcessReplica(index, dataclasses.replace(
            cfg, seed_offset=1009 * next(order))))
        return spawned[-1]

    router = Router(factory, POOL_REPLICAS,
                    heartbeat_timeout_ms=POOL_HEARTBEAT_MS,
                    max_in_flight=2 * SERVE_MAX_BATCH,
                    registry=MetricsRegistry())
    deaths = []
    mark_dead = router._mark_dead

    def noted(slot, now, why, resolutions):
        deaths.append((slot.index, why))
        return mark_dead(slot, now, why, resolutions)

    router._mark_dead = noted
    return router.start(), spawned, deaths


def close_pool(router, spawned):
    router.close()
    for handle in spawned:
        handle.stop(force=True)


def wait_ready(router, slots, t0, timeout=POOL_BOOT_TIMEOUT_S):
    """Seconds from ``t0`` until each of ``slots`` answered ``ready``;
    fails on a boot error, a death while waiting, or the timeout."""
    seen = {}
    deadline = time.monotonic() + timeout
    deaths = router.stats()["deaths"]
    while len(seen) < len(slots):
        st = router.stats()
        for p in st["per_replica"]:
            if p["index"] in slots and p["state"] == "ready":
                seen.setdefault(p["index"], time.perf_counter() - t0)
        fatal = [s.fatal for s in router.slots if s.fatal]
        if fatal or st["deaths"] > deaths:
            fail(f"a replica failed to boot: {fatal or st['per_replica']}")
        if time.monotonic() > deadline:
            fail(f"replicas {sorted(set(slots) - set(seen))} not ready "
                 f"in {timeout} s")
        time.sleep(0.02)
    return [seen[i] for i in slots]


def pool_replay(router, trace, on_submitted=None,
                timeout=FUTURE_TIMEOUT_S):
    """Submit the whole trace to the router, call ``on_submitted``, then
    wait for each future (with a timeout: a hang fails the phase).
    Returns the outcomes (a ``ServedResult`` or the typed error) and the
    wall seconds."""
    import concurrent.futures

    from repro_torch.faults import FaultError

    t0 = time.perf_counter()
    futs = [router.submit(key, query=q) for key, q in trace]
    if on_submitted is not None:
        on_submitted()
    out = []
    for (key, q), f in zip(trace, futs):
        try:
            out.append(f.result(timeout=timeout))
        except concurrent.futures.TimeoutError:
            fail(f"request {key} {q} did not resolve in {timeout} s")
        except FaultError as err:
            out.append(err)
    return out, time.perf_counter() - t0


def check_served(tag, trace, out, oracle, allowed=()):
    """Every outcome is a value that agrees with the sequential run
    (SSSP bitwise, PPR 1e-5 relative) and reached the router as numpy,
    or one of the ``allowed`` typed errors.  Returns the errors."""
    import numpy as np

    from repro_torch.core import tree_leaves
    from repro_torch.launch.serve_hypergraph import agrees

    errors = []
    for (key, q), r in zip(trace, out):
        if isinstance(r, Exception):
            if not isinstance(r, allowed):
                fail(f"{tag}: request {key} {q} resolved as {r!r}")
            errors.append(r)
            continue
        leaves = tree_leaves(r.value)
        if not all(isinstance(x, np.ndarray) for x in leaves):
            fail(f"{tag}: {key} {q} reached the router as "
                 f"{[type(x).__name__ for x in leaves]}, not numpy")
        if not agrees(key, r.value, oracle[(key, q)]):
            fail(f"{tag}: served {key} {q} != the sequential compiled run")
    return errors


def check_drained(tag, router):
    st = router.stats()
    if st["in_flight"] or st["pending"]:
        fail(f"{tag}: ROUTER LEAK: in_flight={st['in_flight']} "
             f"pending={st['pending']} after drain")
    return st


def pool_phase(hg, single_qps):
    """Phase 13: the replica pool on one card, DBLP at full scale (see
    the module docstring).  Returns K1's phase-13 keys."""
    import tempfile

    import torch

    from repro_torch.algorithms import random_walk_spec, shortest_paths_spec
    from repro_torch.analysis import retrace_smoke
    from repro_torch.core import Engine
    from repro_torch.faults import FrontendClosed, ReplicaLost
    from repro_torch.launch.serve_hypergraph import batch_buckets, make_trace
    from repro_torch.serve import MAX_FAILOVERS, DiskExecutableCache, warm

    dev = hg.dst.device
    specs = {"sssp": shortest_paths_spec(hg, source=0,
                                         max_iters=SERVE_ITERS),
             "ppr": random_walk_spec(hg, iters=SERVE_ITERS)}
    store_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    store = store_dir.name
    # -- (a) the store --------------------------------------------------------
    t0 = time.perf_counter()
    parent = Engine(device=dev,
                    disk_cache=DiskExecutableCache(store, device=dev))
    report = warm(parent, list(specs.values()),
                  batch_sizes=batch_buckets(SERVE_MAX_BATCH), queries=[0, 0])
    disk = parent.disk_cache.stats()
    if report["compiled"] != 6 or disk["disk_stores"] != 6:
        fail(f"the parent's warm recorded {disk['disk_stores']} of 6")
    findings = retrace_smoke(device=dev)
    if findings:
        fail("retrace_smoke: " + "; ".join(f.format() for f in findings))
    compiled = {key: parent.compile(spec) for key, spec in specs.items()}
    _, trace = make_trace(hg.n_vertices, SERVE_REQUESTS, SERVE_MIX, 0)
    t1 = time.perf_counter()
    oracle = {}
    for key, q in trace:
        if (key, q) not in oracle:
            oracle[(key, q)] = compiled[key].run(query=q).value
    torch.cuda.synchronize()
    log(f"  (a) the parent warmed {report['traces']} captures in "
        f"{report['boot_s']:.2f} s and wrote {disk['disk_stores']} records "
        f"({disk['dir']}); retrace_smoke on the card: no findings; "
        f"{len(oracle)} sequential compiled runs (the oracle) in "
        f"{time.perf_counter() - t1:.2f} s; (a) "
        f"{time.perf_counter() - t0:.1f} s")

    # -- (b) the pool ---------------------------------------------------------
    t0 = time.perf_counter()
    router, spawned, deaths = start_pool(store)
    try:
        boots = wait_ready(router, list(range(POOL_REPLICAS)), t0)
        smi = smi_memory()
        per = router.stats()["per_replica"]
        for p, ready_s in zip(per, boots):
            b = p["boot"]
            if b["from_disk"] != 6 or b["compiled"] != 0:
                fail(f"replica {p['index']} booted {b['from_disk']} of 6 "
                     "paths from records")
            log(f"  (b) replica {p['index']} (pid {b['pid']}): ready "
                f"{ready_s:.2f} s after spawn (warm {b['boot_s']:.2f} s), "
                f"{b['warm_records']} records read, {b['traces']} captures "
                f"at boot, {b['memory_reserved'] / 2**20:.0f} MiB reserved "
                f"by torch")
        log(f"    nvidia-smi compute apps, MiB by pid (the host's pids: one "
            f"line may hold every process of this container): {smi}")
        out, wall = pool_replay(router, trace)
        check_served("(b)", trace, out, oracle)
        qps = len(trace) / wall
        time.sleep(0.3)                               # a fresh heartbeat
        per = router.stats()["per_replica"]
        per_flush = []
        for p in per:
            hb, b = p["replica_counts"], p["boot"]
            if hb["traces"] != b["engine_traces"]:
                fail(f"replica {p['index']} captured after warm "
                     f"({b['engine_traces']} -> {hb['traces']})")
            launched = (hb["kernel_launches"]["deliver_fused"]
                        - b["kernel_launches"]["deliver_fused"])
            per_flush.append(launched / max(hb["flushes"], 1))
            log(f"    replica {p['index']}: served {p['served']}, "
                f"{hb['flushes']} flushes, {launched} K1 launches "
                f"({per_flush[-1]:.1f} a flush), no capture after warm")
        log(f"  (b) {len(trace)} requests through {POOL_REPLICAS} replicas "
            f"in {wall:.3f} s: {qps:.1f} requests/s aggregate, against "
            f"{single_qps:.1f} for phase 12's single-process Frontend; "
            f"every value agrees with the sequential runs; (b) "
            f"{time.perf_counter() - t0:.1f} s")

        # -- (c) kill -9 mid-replay ---------------------------------------------
        t0 = time.perf_counter()
        victim = router.slots[0].handle
        served0 = router.stats()["per_replica"][0]["served"]
        killed = []

        def kill():
            deadline = time.monotonic() + 30
            while (router.stats()["per_replica"][0]["served"] < served0 + 16
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            os.kill(victim.pid, 9)
            killed.append(time.perf_counter())

        out, wall = pool_replay(router, trace, on_submitted=kill)
        lost = check_served("(c)", trace, out, oracle,
                            (ReplicaLost, FrontendClosed))
        if len(lost) > MAX_FAILOVERS:
            fail(f"(c) {len(lost)} requests lost, more than "
                 f"MAX_FAILOVERS = {MAX_FAILOVERS}")
        st = check_drained("(c)", router)
        if st["deaths"] < 1 or st["respawns"] < 1:
            fail(f"(c) deaths {st['deaths']}, respawns {st['respawns']}")
        respawn_s = wait_ready(router, [0], killed[0])[0]
        reborn = router.stats()["per_replica"][0]["boot"]
        if reborn["pid"] == victim.pid or reborn["warm_records"] <= 0 \
                or reborn["from_disk"] != 6:
            fail(f"(c) the respawn did not boot from the records: {reborn}")
        if victim.process.exitcode != -9:
            fail(f"(c) the victim exited {victim.process.exitcode}")
        log(f"  (c) kill -9 of replica 0 (pid {victim.pid}) mid-replay: "
            f"{len(trace) - len(lost)} served (equal to the sequential "
            f"runs), {len(lost)} typed; deaths {st['deaths']} "
            f"({deaths}), respawns {st['respawns']}, failovers "
            f"{st['failovers']}, in_flight = pending = 0; the respawn "
            f"(pid {reborn['pid']}) was ready {respawn_s:.2f} s after the "
            f"kill (warm {reborn['boot_s']:.2f} s), "
            f"{reborn['warm_records']} records read, sentinel armed; (c) "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        close_pool(router, spawned)

    # -- (d) a hang ---------------------------------------------------------------
    t0 = time.perf_counter()
    router, spawned, deaths = start_pool(store, HANG_PLAN)
    try:
        wait_ready(router, list(range(POOL_REPLICAS)), t0)
        hang_trace = trace[:HANG_REQUESTS]
        out, wall = pool_replay(router, hang_trace)
        lost = check_served("(d)", hang_trace, out, oracle,
                            (ReplicaLost, FrontendClosed))
        st = check_drained("(d)", router)
        hung = spawned[0]
        if (hung.faults or {}).get("fired", {}).get("replica.hang") != 1:
            fail(f"(d) replica.hang did not fire in replica 0: {hung.faults}")
        if (0, "missed heartbeats") not in deaths:
            fail(f"(d) the hung replica's death: {deaths}")
        log(f"  (d) replica.hang in replica 0: declared dead by the "
            f"heartbeat detector ({deaths}); {len(hang_trace) - len(lost)} "
            f"of {len(hang_trace)} served (equal to the sequential runs), "
            f"{len(lost)} typed, failovers {st['failovers']}, in {wall:.2f} "
            f"s; (d) {time.perf_counter() - t0:.1f} s")
    finally:
        close_pool(router, spawned)
    del parent, compiled, oracle
    torch.cuda.empty_cache()
    store_dir.cleanup()

    # -- (e) the launcher -----------------------------------------------------------
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_hypergraph",
             "--regime", "dblp", "--scale", str(LAUNCH_POOL_SCALE),
             "--replicas", str(POOL_REPLICAS), "--cache-dir", tmp,
             "--warm", "--verify", "8", "--log-every-s", "1000",
             "--fault-plan", json.dumps(CRASH_PLAN)],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    if proc.returncode != 0 or "verified 8" not in proc.stdout \
            or "never fired: none" not in proc.stdout:
        fail(f"the pool launcher exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    log(f"  (e) the launcher's pool under replica.crash verified 8 of 8 in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"phase13_pool_requests_per_s": qps,
            "phase13_single_requests_per_s": single_qps,
            "phase13_launches_per_flush": per_flush,
            "phase13_boot_s": boots,
            "phase13_respawn_boot_s": respawn_s}


DIST_SOURCES = (0, 17, 4242, 99999, 424242, 500000, 777777, 899392)
DIST_TURNS = 3          # phase 14's walls: median of 3, in turns


def _k1_counted(run):
    """``run()`` with K1's launch counter zeroed just before and read
    just after: ``(result, launches)``."""
    from repro_torch.kernels.deliver.fused import deliver_fused_cuda

    deliver_fused_cuda.launches = 0
    res = run()
    return res, deliver_fused_cuda.launches


def distributed_phase(hg, fwd, local3, hg_a, census, flush):
    """Phase 14: the distributed backends on one card (world size 1, an
    NCCL group: NCCL takes one rank per device).  ``local3``: phase 3's
    ``(label, spec, local fused Result)``; ``fwd``: DBLP's whole-graph
    v->he layout; ``census``: phase 6's local Apache census.  Returns
    K1's and the isect kernels' ``dist_*`` keys."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.algorithms import shortest_paths_spec
    from repro_torch.core import AnalyticsSpec, Engine
    from repro_torch.core.distributed import build_shard_delivery
    from repro_torch.kernels.deliver import (
        deliver_leaf_cuda,
        deliver_leaf_plain,
    )
    from repro_torch.kernels.isect import isect_cuda, isect_fused_cuda
    from repro_torch.launch.mesh import init_local_group, make_host_mesh
    from repro_torch.partition import partition

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    dev = hg.device
    store = tempfile.mkdtemp(prefix="chip-smoke-group-")
    init_local_group(0, 1, store, "cuda")
    k1, k3 = {}, {}
    try:
        mesh = make_host_mesh(1)
        log(f"  {dist.get_backend()} group of world size 1 on "
            f"{torch.cuda.get_device_name(0)}, {mesh}")
        # (a) Engine.run under both backends against phase 3's local runs.
        plan = partition("random_vertex_cut", hg, 1)
        eng = Engine(plan=plan, mesh=mesh, device=dev,
                     delivery="pallas_fused", collect_stats=True)
        local = Engine(device=dev, delivery="pallas_fused",
                       collect_stats=True)
        launches, walls = {}, {}
        for label, spec, ref in local3:
            n_fwd, n_bwd = leaf_counts(spec)
            for backend in ("replicated", "sharded"):
                eng.run(spec, backend=backend)  # the shard layouts, built
                res, n = _k1_counted(lambda: eng.run(spec, backend=backend))
                pairs = res.decision["measured"]["pairs_run"]
                if res.backend != backend or res.partition != plan.name:
                    fail(f"phase 14 {label}: ran {res.backend} / "
                         f"{res.partition}")
                if n == 0 or n != pairs * (n_fwd + n_bwd):
                    fail(f"phase 14 {label} {backend}: {n} K1 launches "
                         f"over {pairs} pairs, expected one per leaf")
                if label == "pagerank-30":
                    err = max(rel_err(a, b)
                              for a, b in zip(res.value, ref.value))
                    if not err <= 1e-5:
                        fail(f"phase 14 {label} {backend}: relative error "
                             f"{err} against the local run")
                elif not all(same_bits(a, b)
                             for a, b in zip(res.value, ref.value)):
                    fail(f"phase 14 {label} {backend} != the local run")
                if not all(torch.equal(a, b) for a, b in zip(
                        res.superstep_stats, ref.superstep_stats)):
                    fail(f"phase 14 {label} {backend}: activity differs")
                launches[f"{backend}_{label}"] = n
            times = {"local": [], "replicated": [], "sharded": []}
            for _ in range(DIST_TURNS):
                for key in times:
                    kw = {} if key == "local" else {"backend": key}
                    run_eng = local if key == "local" else eng
                    times[key].append(run_eng.run(spec, **kw).decision[
                        "measured"]["wall_s"] * 1e3)
            walls[label] = {k: statistics.median(v)
                            for k, v in times.items()}
            log(f"  (a) {label}: replicated / sharded == local "
                + ("(1e-5 relative)" if label == "pagerank-30"
                   else "(bitwise)")
                + f", equal activity; K1 launches {launches[f'replicated_{label}']}"
                f" / {launches[f'sharded_{label}']} ({n_fwd + n_bwd} a "
                f"pair); wall {walls[label]['replicated']:.2f} / "
                f"{walls[label]['sharded']:.2f} ms vs local "
                f"{walls[label]['local']:.2f} ms (median of {DIST_TURNS}, "
                "in turns)")
        k1.update(dist_launches=launches, dist_wall_ms=walls)
        log(f"  {at()} (a) done")

        # (b) K1 on the four shard layouts of a P = 4 plan, one process.
        plan4 = partition("random_vertex_cut", hg, 4)
        nv, ne = hg.n_vertices, hg.n_hyperedges
        nv_pad, ne_pad = -(-nv // 4) * 4, -(-ne // 4) * 4
        t0 = time.perf_counter()
        shards = build_shard_delivery(plan4.shard_src, plan4.shard_dst,
                                      plan4.shard_mask, nv_pad, ne_pad,
                                      device=dev)
        t_build = time.perf_counter() - t0
        rng = np.random.default_rng(14)
        msgs = torch.as_tensor(rng.standard_normal((nv_pad, 1)).astype(
            np.float32), device=dev)
        ints = torch.as_tensor(rng.integers(-2**20, 2**20, (nv_pad, 1))
                               .astype(np.int32), device=dev)
        whole_sum = deliver_leaf_cuda(msgs[:nv], None, fwd, "sum")
        whole_min = deliver_leaf_cuda(ints[:nv], None, fwd, "min")
        tot_sum = tot_min = None
        shard_ms, shard_bound, max_err = [], [], 0.0
        for p, (lay, _) in enumerate(shards):
            k_sum = deliver_leaf_cuda(msgs, None, lay, "sum")
            want = deliver_leaf_plain(msgs.double(), None, lay, "sum")
            max_err = max(max_err, (k_sum.double() - want).abs().max().item())
            if not torch.allclose(k_sum.double(), want, rtol=1e-5, atol=1e-5):
                fail(f"phase 14: K1 sum on shard {p} != plain")
            k_min = deliver_leaf_cuda(ints, None, lay, "min")
            if not torch.equal(k_min, deliver_leaf_plain(ints, None, lay,
                                                         "min")):
                fail(f"phase 14: K1 min on shard {p} != plain")
            tot_sum = k_sum if tot_sum is None else tot_sum + k_sum
            tot_min = k_min if tot_min is None else torch.minimum(tot_min,
                                                                  k_min)
            shard_ms.append(time_cuda(
                lambda: deliver_leaf_cuda(msgs, None, lay, "sum"), flush))
            shard_bound.append(leaf_bound_ms(lay, 1)[0])
        if not torch.equal(tot_min[:ne], whole_min):
            fail("phase 14: the shards' K1 min, combined, != the local "
                 "delivery")
        if not torch.allclose(tot_sum[:ne], whole_sum, rtol=1e-5, atol=1e-5):
            fail("phase 14: the shards' K1 sum, combined, != the local "
                 "delivery")
        whole_ms = time_cuda(
            lambda: deliver_leaf_cuda(msgs[:nv], None, fwd, "sum"), flush)
        log(f"  (b) K1 on random_vertex_cut's 4 shard layouts (built in "
            f"{t_build:.1f} s; v->he, D = 1): min bitwise and sum within "
            f"{max_err:.3g} of float64 on each; combined == the local "
            f"delivery (min bitwise, sum 1e-5); leaf ms per shard "
            + ", ".join(f"{t:.4f} (bound {b:.4f})"
                        for t, b in zip(shard_ms, shard_bound))
            + f" vs whole graph {whole_ms:.4f} (bound "
            f"{leaf_bound_ms(fwd, 1)[0]:.4f}); L2 flushed, median of "
            f"{N_TIMED}")
        k1.update(dist_shard_leaf_ms=shard_ms,
                  dist_shard_leaf_bound_ms=shard_bound,
                  dist_whole_leaf_ms=whole_ms, dist_shard_max_abs_err=max_err)
        del shards
        log(f"  {at()} (b) done")

        # (c) the sharded census on phase 6's Apache hypergraph.
        isect_cuda.launches = 0
        isect_fused_cuda.launches = 0
        res = Engine(mesh=mesh, device=dev).analyze(AnalyticsSpec(hg_a))
        k3 = {"isect": isect_cuda.launches,
              "isect_fused": isect_fused_cuda.launches}
        why = res.decision["backend"]["reason"]
        if res.backend != "sharded" or why != (
                "mesh available: tile hyperedge-pair blocks across it"):
            fail(f"phase 14 analyze resolved {res.backend} ({why})")
        fields = ("counts", "ci_low", "ci_high", "n_triples_seen", "n_pairs")
        if not same_census(res.value, census, fields):
            fail("phase 14: the sharded census != phase 6's local census")
        if 0 in k3.values():
            fail(f"phase 14: the sharded census launched {k3}")
        m = res.decision["measured"]
        log(f"  (c) sharded census on apache == phase 6's, field for field; "
            f"K3a {k3['isect']}, K3b {k3['isect_fused']} launches; "
            f"analyze {m['wall_s']:.1f} s (intersect {m['intersect_s']:.3f} "
            "s)")
        log(f"  {at()} (c) done")

        # (d) compile-once serving on both backends.
        label, pr, pr_ref = local3[0]
        sp = local3[1][1]
        graphs, qps = {}, {}
        for backend in ("replicated", "sharded"):
            comp = eng.compile(pr, backend=backend)
            comp.run()
            got, n = _k1_counted(comp.run)
            one = eng.run(pr, backend=backend)
            err = max(rel_err(a, b) for a, b in zip(got.value, one.value))
            if not err <= 1e-5 or n == 0:
                fail(f"phase 14 compiled {label} {backend}: relative error "
                     f"{err}, {n} K1 launches")
            comp_s = eng.compile(sp, backend=backend)
            comp_s.run_batch(np.asarray(DIST_SOURCES))
            t0 = time.perf_counter()
            batch = comp_s.run_batch(np.asarray(DIST_SOURCES))
            torch.cuda.synchronize()
            qps[backend] = len(DIST_SOURCES) / (time.perf_counter() - t0)
            for i, q in enumerate(DIST_SOURCES):
                want = eng.run(shortest_paths_spec(hg, q), backend=backend)
                if not all(same_bits(a[i], b)
                           for a, b in zip(batch.value, want.value)):
                    fail(f"phase 14 run_batch {backend} source {q} != "
                         "Engine.run")
            graphs[backend] = (got.decision["measured"]["graph"],
                               batch.decision["measured"]["graph"])
            if not all(graphs[backend]):
                fail(f"phase 14: no CUDA graph captured on {backend}")
            log(f"  (d) compiled {label} {backend} == Engine.run (1e-5 "
                f"relative; {n} K1 launches replayed); run_batch of "
                f"{len(DIST_SOURCES)} SSSP sources == Engine.run (bitwise), "
                f"{qps[backend]:.1f} queries/s warm; CUDA graph captured "
                "with its collectives")
        k1.update(dist_compiled_graph=graphs, dist_batch_qps=qps)
    finally:
        dist.destroy_process_group()
    log(f"  {at()} phase 14 done")
    return k1, k3


KERNEL_SOURCES = (("deliver_fused", "deliver_fused.cu"),
                  ("isect", "isect.cu"), ("segsum", "segsum.cu"),
                  ("flash", "flash.cu"))
ANALYSIS_TIMEOUT_S = 600   # phase 15 (d): the CLI's whole run


def analysis_phase(dev):
    """Phase 15: the static analysis on the card.  (a) the card's
    shared memory per block, with and without the opt-in, against
    ``repro_torch.analysis.shapes``' constants; (b) every entry
    function's static shared memory from phase 1's ``ptxas -v`` against
    the model's, for all four sources; (c) each kernel at the worst
    geometry its budget admits (``shapes.worst_launches``) against its
    plain version: bitwise on integer payloads (K1, K2a, K2b, K3a),
    phase 8's tolerance for K4; (d) ``python -m repro_torch.analysis
    --device cuda --passes lint,digest,shapes,retrace`` in a subprocess,
    which must exit 0.  Returns per kernel id the model's largest static
    and worst dynamic bytes."""
    import torch

    from repro_torch.analysis import shapes
    from repro_torch.kernels import _nvcc

    limits = shapes.device_limits(dev)
    want = (shapes.DEFAULT_BYTES, shapes.OPTIN_BYTES)
    log(f"  (a) shared memory a block: {limits[0]} bytes, {limits[1]} "
        f"opted in (model {want[0]}, {want[1]})")
    if limits != want:
        fail(f"device shared memory limits {limits} != model {want}")

    logs = {src: _nvcc.build_log(name, (src,))
            for name, src in KERNEL_SOURCES}
    bad = shapes.check_ptxas(logs)
    if bad:
        fail("ptxas static shared memory != model: " + "; ".join(
            f.scope + ": " + f.message for f in bad))
    n_entries = sum(len(shapes.ptxas_static_smem(t)) for t in logs.values())
    log(f"  (b) ptxas static shared memory equals the model for all "
        f"{n_entries} entry functions")
    rows = shapes.instantiations()
    budget = {}
    for kid in ("K1", "K2a", "K2b", "K3a", "K3b", "K4"):
        mine = [r for r in rows if r.kernel == kid]
        worst = max(mine, key=lambda r: r.total / r.limit)
        budget[kid] = {"smem_static": max(r.static for r in mine),
                       "smem_dynamic_worst": max(r.dynamic for r in mine)}
        log(f"  {kid}: static up to {budget[kid]['smem_static']} B, worst "
            f"dynamic {budget[kid]['smem_dynamic_worst']} B; closest to "
            f"its limit: {worst.entry} {worst.static} + {worst.dynamic} = "
            f"{worst.total} of {worst.limit} B "
            f"({worst.limit - worst.total} to spare; {worst.where})")
    if shapes.check_budgets(rows):
        fail("a kernel's shared memory exceeds its limit")

    for kid, label, kernel, plain in shapes.worst_launches(dev):
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        tag = f"phase 15 {kid} {label}"
        if kid == "K4":
            rtol, atol = FLASH_TOL[str(got.dtype).removeprefix("torch.")]
            err = check_close(tag, got, ref, rtol, atol)
            log(f"  (c) {kid} {label}: max abs err {err:.3g} (rtol {rtol}, "
                f"atol {atol})")
        else:
            if got.shape != ref.shape or got.dtype != ref.dtype or (
                    not torch.equal(got, ref)):
                fail(f"{tag}: kernel != plain")
            log(f"  (c) {kid} {label}: bitwise equal to the plain version")

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cuda",
         "--passes", "lint,digest,shapes,retrace"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=ANALYSIS_TIMEOUT_S)
    for line in proc.stdout.splitlines()[-8:]:
        log(f"    {line}")
    if proc.returncode != 0:
        fail(f"python -m repro_torch.analysis exited {proc.returncode}: "
             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    log(f"  (d) python -m repro_torch.analysis --device cuda: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return budget


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
    from repro_torch.core import Engine
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
    from repro_torch.kernels import _nvcc

    flash_log = _nvcc.build_log("flash", ("flash.cu",))
    for name, regs, st, ld, smem in ptxas_summary(flash_log):
        log(f"  ptxas flash {name}: {regs} registers, spills {st} B stored "
            f"/ {ld} B loaded, {smem} B static smem")
    for line in flash_log.splitlines():
        if "wgmma" in line and "Performance Loss" in line:
            log(f"  ptxas: {line.strip()}")
    for name, regs, st, ld, smem in ptxas_summary(
            _nvcc.build_log("segsum", ("segsum.cu",))):
        log(f"  ptxas segsum {name}: {regs} registers, spills {st} B "
            f"stored / {ld} B loaded, {smem} B static smem")

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
    padded = padded_layout(hg, rng)
    p_plan = fused.leaf_plan(padded)
    log(f"  fwd padded: widths {padded.class_widths} rows "
        f"{padded.class_rows}; {int((p_plan.slot_dst < 0).sum())} dead "
        f"slots, {p_plan.zero_dst.numel()} zero-degree destinations")
    for name, lay in (("fwd", fwd), ("bwd", bwd)):
        plan = fused.leaf_plan(lay)
        log(f"  {name} leaf plan: classes in launch order {plan.order}, "
            f"spans {plan.spans} rows, blocks {plan.blocks} "
            f"({sum(plan.blocks)} in one launch), "
            f"{plan.zero_dst.numel()} zero-degree destinations")
    t0 = time.perf_counter()
    n_checks, max_err = check_kernel(
        (("fwd", fwd), ("bwd", bwd), ("fwd padded", padded)), rng)
    del padded, p_plan
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
    totals = time_delivery(hg, fwd, bwd, flush)

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
    # hg stays for phase 7; fwd and phase 3's fused runs, for phase 14.
    local3 = (("pagerank-30", pr, pr_f), ("sssp", sp, sp_f),
              ("components", cc, cc_f))
    del bwd, eng, pr, sp, cc, pr_x, sp_x, cc_x

    # -- phase 5: intersection kernels vs plain at Apache scale ---------------
    hg_a, bits, triples, batches, isect_err, host_uni = (
        intersections_vs_plain(dev, rng))

    # -- phase 6: the analytics path -------------------------------------------
    k3a_launches, k3b_launches, census = analytics_path(
        dev, hg_a, triples, batches, host_uni)

    # -- timings of the intersection kernels -----------------------------------
    t0 = time.perf_counter()
    sms, clock = card_rates()
    popc_rate = sms * POPC_PER_CLOCK_PER_SM * clock
    log(f"timings: {sms} SMs x {POPC_PER_CLOCK_PER_SM} popc/clock x "
        f"{clock / 1e6:.0f} MHz = {popc_rate:.4g} popcounts/s; L2 flushed "
        "before each run; median of 20")
    isect_entries = time_isect(bits, batches, flush, popc_rate)
    log(f"timings: done in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 7: segment sum (K2a, K2b) at DBLP scale -------------------------
    t0 = time.perf_counter()
    segsum_entries = segsum_phase(hg, flush)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s in all")

    # -- phase 8: attention (K4) at llama3.2-1b and gemma3-12b widths -----------
    t0 = time.perf_counter()
    flash_entry = flash_phase(dev, flush, sms, clock)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 9: compile-once serving (CUDA graphs through K1) ----------------
    t0 = time.perf_counter()
    log("phase 9: Engine(delivery='pallas_fused').compile on dblp at full "
        "scale")
    serving = serving_phase(hg, flush)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 10: the card's delivery term ---------------------------------
    t0 = time.perf_counter()
    check_delivery_term(delivery_grid(hg, flush))
    log(f"phase 10: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 11: the clique representation (K2a, K2b) -----------------------
    t0 = time.perf_counter()
    log("phase 11: the clique representation on dblp at full scale")
    clique_entries = clique_phase(hg, flush)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 12: fault-tolerant serving (checkpoints, the front-end) ---------
    t0 = time.perf_counter()
    log("phase 12: fault-tolerant serving on dblp at full scale")
    serve_tier = fault_serving_phase(hg)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 13: the replica pool (store, router, kill -9, hang) ------------
    t0 = time.perf_counter()
    log(f"phase 13: {POOL_REPLICAS} replica processes on one card, dblp at "
        "full scale")
    pool = pool_phase(hg, serve_tier["phase12_requests_per_s"])
    log(f"phase 13: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 14: the distributed backends (world size 1, NCCL) --------------
    t0 = time.perf_counter()
    log("phase 14: the distributed backends on one card, dblp and apache at "
        "full scale")
    dist_k1, dist_k3 = distributed_phase(hg, fwd, local3, hg_a, census, flush)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 15: the static analysis on the card ----------------------------
    t0 = time.perf_counter()
    log("phase 15: shared-memory budgets against the card and ptxas, the "
        "worst geometries, the analysis CLI")
    smem = analysis_phase(dev)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s in all; total "
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
        **serving,
        **serve_tier,
        **pool,
        **dist_k1,
        **smem["K1"],
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
            "dist_census_launches": dist_k3[name],
            **smem["K3a" if name == "isect" else "K3b"],
        })
    # K2b's numbers are at its caller's shapes (phase 11: the clique
    # PageRank); phase 7's, at the DBLP incidences, follow as phase7_*.
    # K2a has no system caller (index_add_ measured faster for the clique
    # out-weights): its line stays phase 7's, with the out-weights'
    # numbers beside it as out_w_*.
    seven = segsum_entries["segsum_sorted"]
    segsum_entries["segsum_sorted"] = {
        **clique_entries["segsum_sorted"],
        **{f"phase7_{key}": val for key, val in seven.items()}}
    segsum_entries["segsum"].update(
        {f"out_w_{key}": clique_entries["segsum"][key]
         for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        caller="none: phase 7's segment_sum_mxu calls (index_add_ measured "
               "faster for graph_pagerank's out-weights)")
    for name, kid, source, replaces, entry in (
            ("segsum", "K2a", "segsum.cu", "segsum/segsum.py:125",
             segsum_entries["segsum"]),
            ("segsum_sorted", "K2b", "segsum.cu", "segsum/segsum.py:157",
             segsum_entries["segsum_sorted"]),
            ("flash", "K4", "flash.cu", "flash/flash.py:93", flash_entry)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
            **smem[kid],
        })
    for name in ("segsum", "segsum_sorted"):
        next(k for k in kernels if k["name"] == name).update(
            {key: val for key, val in segsum_entries[name].items()
             if key.startswith(("phase7_", "out_w_", "shuffled_",
                                "one_segment_", "skew_")) or key in (
                 "caller", "clique_ms", "bipartite_ms",
                 "graph_pagerank_ms", "to_graph_s")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
