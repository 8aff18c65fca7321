"""Multi-pod dry-run: trace every (arch x shape x mesh) cell at full size
on fake tensors, check its placements against the production meshes,
and price it on the H100's roofline; the counterpart of the JAX
package's ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out reports/dryrun_torch.json

``main`` makes this process rank 0 of a fake world of 512 ranks
(``launch.mesh.init_fake_world``: the counterpart of the JAX package's
512 forced host devices), which backs both the 16 x 16 single-pod mesh
and the 2 x 16 x 16 multi-pod mesh, and destroys it on exit.  Nothing
is made at import.  The traces run on the host: nothing is allocated
on, or launched to, a card.

Each row keeps the JAX package's keys: ``lower_s`` is the build of the
fake state, ``compile_s`` the trace.  ``partitioned`` says whether the
trace is one device's own program (an LM cell, dense or MoE, a BERT4Rec
cell or a GNN ``pjit`` cell, partitioned by DTensor placements; a
1-device mesh; the edge-sharded GNN step), with its temp and its
collectives: on the production meshes every cell is.  A cell built on
a stand-in of a mesh (``launch.tasks``) traces the whole global step:
its ``memory`` gives each device's arguments and outputs from the
placements, ``temp_gb`` and the collectives are null (the reason in
``notes``), and ``cost_*_per_dev`` are the step's counts spread evenly
over the devices.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

FAKE_WORLD = 512


@functools.lru_cache(maxsize=None)
def _mesh_for(kind: str):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=(kind == "multi"))


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             smoke: bool = False, with_roofline: bool = True) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.tasks import build_task
    from repro_torch.roofline.analysis import analyze_task, collective_stats

    spec = get_config(arch_id, smoke=smoke)
    shape = spec.shape(shape_name)
    if shape.skip:
        return {
            "cell": f"{arch_id}:{shape_name}", "mesh": mesh_kind,
            "status": "skipped", "reason": shape.skip,
        }
    mesh = _mesh_for(mesh_kind)
    t0 = time.perf_counter()
    task = build_task(spec, shape, mesh)
    t_build = time.perf_counter() - t0
    trace = task.trace()
    t_trace = time.perf_counter() - t0 - t_build
    n_dev = task.n_devices

    mem = task.memory_per_device()
    mem_row = {
        "argument_gb": mem["argument"] / 1e9,
        "output_gb": mem["output"] / 1e9,
        "temp_gb": None if mem["temp"] is None else mem["temp"] / 1e9,
        "alias_gb": mem["alias"] / 1e9,
    }
    notes = task.notes
    if task.per_device:
        coll = collective_stats(trace.collectives)
        counts, coll_bytes = coll.counts, coll.total_bytes
        per_dev = 1
    else:
        counts = coll_bytes = None
        per_dev = n_dev
        notes = "; ".join(filter(None, (
            notes, "not partitioned: the global step was traced, so "
            "temp per device and the collectives are not known")))

    row = {
        "cell": f"{arch_id}:{shape_name}",
        "mesh": mesh_kind,
        "status": "ok",
        "devices": n_dev,
        "partitioned": task.per_device,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_trace, 2),
        "memory": mem_row,
        "cost_flops_per_dev": trace.flops / per_dev,
        "cost_bytes_per_dev": trace.bytes / per_dev,
        "collective_counts": counts,
        "collective_bytes_per_dev_static": coll_bytes,
        "notes": notes,
    }
    if with_roofline and mesh_kind == "single":
        row["roofline"] = analyze_task(task).row()
    return row


def iter_cells(archs=None, shapes=None, smoke=False):
    from repro_torch.configs import ARCH_IDS, get_config

    for arch_id in archs or ARCH_IDS:
        spec = get_config(arch_id, smoke=smoke)
        for shape_name in spec.shapes:
            if shapes and shape_name not in shapes:
                continue
            yield arch_id, shape_name


def _gb(x) -> str:
    return "n/a" if x is None else f"{x:.2f}GB"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced configs (CI)")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if not args.all and not args.arch:
        ap.error("pass --arch <id> (repeatable) or --all")

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_world

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = []
    failures = 0
    init_fake_world(FAKE_WORLD)
    try:
        for arch_id, shape_name in iter_cells(args.arch, args.shape,
                                              args.smoke):
            for mesh_kind in meshes:
                label = f"{arch_id}:{shape_name}@{mesh_kind}"
                try:
                    row = run_cell(
                        arch_id, shape_name, mesh_kind, smoke=args.smoke,
                        with_roofline=not args.no_roofline,
                    )
                except Exception as e:  # noqa: BLE001 - report, continue
                    traceback.print_exc()
                    row = {
                        "cell": f"{arch_id}:{shape_name}",
                        "mesh": mesh_kind, "status": "FAILED",
                        "error": f"{type(e).__name__}: {e}",
                    }
                    failures += 1
                results.append(row)
                status = row["status"]
                extra = ""
                if status == "ok":
                    m = row["memory"]
                    extra = (
                        f"compile={row['compile_s']:.1f}s "
                        f"args={_gb(m['argument_gb'])} "
                        f"temp={_gb(m['temp_gb'])}"
                    )
                    if "roofline" in row:
                        r = row["roofline"]
                        extra += (
                            f" dom={r['dominant']}"
                            f" frac={r['roofline_fraction']:.3f}"
                        )
                elif status == "skipped":
                    extra = row["reason"][:60]
                print(f"[{status:7s}] {label:55s} {extra}", flush=True)
    finally:
        dist.destroy_process_group()

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
