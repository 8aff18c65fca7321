#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  It imports nothing of JAX
and nothing of the JAX package.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), the torch / CUDA
   versions, and the build of the fused delivery kernel from
   ``src/repro_torch/csrc/deliver_fused.cu`` (timed);
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
   end-to-end PageRank-30 and SSSP wall time, fused vs ``xla``.

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
N_TIMED = 20
N_WARM = 3


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
    fused._kernel_lib()
    log(f"phase 1: built deliver_fused in {time.perf_counter() - t0:.1f} s")

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
        f"{cc_f.decision['measured']['supersteps']} supersteps")
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
