"""Every LM cell (dense and MoE), BERT4Rec's four cells at full size and
every GNN ``pjit`` cell (gat-cora, PNA, NequIP, MACE) traced on a
production mesh over a fake world of 512 ranks, partitioned and whole,
for ``test_torch_tasks.py`` and ``test_torch_roofline.py``.  Run as
``python tests/torch_fake_world_cells.py single|multi [--full
ARCH:SHAPE ...]`` (a fake world is a process group:
never in the pytest process); prints one JSON object on its last line,
``{cell: {...}}``.  Imports ``repro_torch`` only (no JAX).

Each cell is built by ``launch.tasks.build_task`` twice: on the mesh,
as the partitioned task (DTensor arguments, rank 0's own program), and
on its stand-in (``launch.mesh.mesh_shape``: the whole global step, the
count it is held against).  ``smoke()`` configs (BERT4Rec's at full
size; the GNN cells' ``molecule`` shape alone on ``multi``), and at full
size the cells ``--full`` names.  ``one`` is a 1 x 1
mesh over rank 0.  The tests import ``fake_world_cells`` and
``hold_partitioned`` from here.
"""
import json
import os
import subprocess
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ("llama3.2-1b", "gemma3-12b", "command-r-plus-104b")
MOE = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
RECSYS = "bert4rec"
GNN = ("gat-cora", "pna", "nequip", "mace")
# What the JAX package's partitioner emits, and no more.
PARTITIONER_KINDS = {"all-reduce", "all-gather", "reduce-scatter"}
# The most a device's work times the devices exceeds the global step's:
# a fallback (heads that do not divide 'model', as the smoke configs'
# 8, 4 and 6 heads over 16 do) replicates work over 'model' only.  The
# traces show 9.37x (gemma3-12b train_4k) to 15.59x (llama3.2-1b
# prefill_32k), and 1.00x where every head divides.
MODEL_EXTENT = 16


# A MoE cell replicates more: its global route (decode, and every cell
# of the smoke configs, whose one group spans all tokens) gathers the
# tokens over the data axes, and the smoke configs' 8 and 4 experts do
# not divide 'model'.  The traces show 3.21x (llama4-maverick
# decode_32k, single pod) to 109.03x (llama4-maverick train_4k, multi
# pod); the bound held is that no device does more than the whole step.


def _cells(archs):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config

    return [f"{a}:{s}" for a in archs
            for s, shape in get_config(a, smoke=True).shapes.items()
            if not shape.skip]


DENSE_CELLS = _cells(DENSE)
MOE_CELLS = _cells(MOE)
# at full size (published widths): a cell's trace is a few hundred ops
RECSYS_CELLS = _cells((RECSYS,))
GNN_CELLS = _cells(GNN)
# on the multi-pod mesh, one shape an arch (its traces take ~3x the
# single pod's)
GNN_MULTI_CELLS = [c for c in GNN_CELLS if c.endswith(":molecule")]


# The reckoning of a GNN ``pjit`` cell's per-device FLOPs
# times the devices over the global trace's: 1.  The trace counts the
# matrix products and K2a's work; every product of these models acts on
# node or edge rows, each device's on its own (the gathers and the
# reductions on its own edges), and the work every device repeats (the
# AdamW update, the loss and the per-graph readout over ``[n_graphs]``
# rows, the degree counts' scatter) holds no product.
GNN_FLOPS_RATIO = 1.0


def recsys_flops_ratio(cell, devices, model_extent):
    """The builder's reckoning of a BERT4Rec cell's per-device FLOPs times
    the devices over the global trace's, at full size: the train step
    runs every matrix product and K4 call on the device's own rows over
    the data axes, replicated over ``model`` (the JAX layout: the batch
    whole over ``model``), so ``model_extent``; serving cuts every
    product by its rows over every axis, so 1; retrieval encodes the one
    sequence on every device (``E``: its products and K4's forward) and
    scores its own candidates (``C``: one product over the padded list),
    so ``(devices E + C) / (E + C)``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.roofline.analysis import flash_work

    spec = get_config(RECSYS)
    kind = spec.shape(cell.split(":")[1]).kind
    if kind == "recsys_train":
        return float(model_extent)
    if kind == "recsys_serve":
        return 1.0
    cfg = spec.model
    s, d = cfg.max_seq, cfg.embed_dim
    f = cfg.d_ff_mult * d
    products = 2 * s * d * (3 * d + d + f) + 2 * s * f * d
    attention, _ = flash_work(1, cfg.n_heads, cfg.n_heads, s, s,
                              d // cfg.n_heads, 4, causal=False)
    e = cfg.n_blocks * (products + attention)
    n_cand = spec.shape(cell.split(":")[1]).dims["n_candidates"]
    c = 2 * d * (-(-n_cand // devices) * devices)
    return (devices * e + c) / (e + c)


def fake_world_cells(kind, *extra):
    """This script's rows for ``kind`` (``single``, ``multi``, ``one``),
    run in a subprocess."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), kind, *extra],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def hold_partitioned(r, most=MODEL_EXTENT, collectives=True):
    """A cell traced as one device's own program: no FLOP counted at
    both the global and the local shape (a device's count times the
    devices at least the global step's, at most ``most`` times: a dense
    cell's ``MODEL_EXTENT``, a MoE cell's device count), the
    partitioner's kinds of collective (none where ``collectives`` is
    false: a serving cell of BERT4Rec, each device on its own rows
    against a replicated table), every argument byte the placements give
    a device, a temp."""
    assert r["per_device"] is True and r["partitioned"] is True
    ratio = r["flops"] * r["devices"] / r["global_flops"]
    assert 1 - 1e-9 <= ratio <= most, ratio
    if collectives:
        assert r["kinds"] and set(r["kinds"]) <= PARTITIONER_KINDS
    else:
        assert r["kinds"] == []
    assert r["argument_bytes"] == r["placed_argument_bytes"]
    assert r["memory"]["temp"] is not None and r["memory"]["temp"] > 0
    assert "not partitioned" not in r["notes"]


def row(spec, shape, mesh):
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.tasks import build_task, per_device_bytes
    from repro_torch.roofline.analysis import analyze_task

    task = build_task(spec, shape, mesh)
    whole = build_task(spec, shape, mesh_shape(mesh))
    trace = task.trace()
    rep = analyze_task(task).row()
    traced = task.micro[1] if task.micro else task.abstract_args
    return {
        "per_device": task.per_device, "partitioned": task.partitioned,
        "devices": task.n_devices, "flops": trace.flops,
        "global_flops": whole.trace().flops,
        "kinds": sorted({r.kind for r in trace.collectives}),
        "groups": sorted({r.group_size for r in trace.collectives}),
        "all_gather_bytes": max([r.nbytes for r in trace.collectives
                                 if r.kind == "all-gather"], default=0),
        "all_gather_rows": sorted({r.rows for r in trace.collectives
                                   if r.kind == "all-gather"}),
        # a GNN cell's padded node and edge counts
        "graph": ([task.abstract_args[1].n_nodes,
                   int(task.abstract_args[1].edge_src.shape[0])]
                  if spec.family == "gnn" else None),
        "argument_bytes": trace.argument_bytes,
        # what the placements give the arguments the trace ran on (one
        # micro-batch of an accumulated train step)
        "placed_argument_bytes": sum(
            per_device_bytes(a, pl, mesh)
            for a, pl in zip(traced, task.placements)),
        "memory": task.memory_per_device(),
        "kernel_calls": trace.kernel_calls,
        "report": {k: rep[k] for k in ("partitioned", "coll_bytes_dev",
                                       "dominant", "hlo_flops",
                                       "peak_mem_gb")},
        "notes": task.notes,
    }


def main(argv):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh

    kind, full = argv[0], argv[argv.index("--full") + 1:] if (
        "--full" in argv) else []
    init_fake_world(512)
    try:
        mesh = {"single": lambda: make_production_mesh(),
                "multi": lambda: make_production_mesh(multi_pod=True),
                "one": lambda: DeviceMesh(
                    "cpu", torch.arange(1).reshape(1, 1),
                    mesh_dim_names=("data", "model"))}[kind]()
        out = {}
        for arch in DENSE + MOE:
            spec = get_config(arch, smoke=True)
            for name, shape in spec.shapes.items():
                if not shape.skip:
                    out[f"{arch}:{name}"] = row(spec, shape, mesh)
        spec = get_config(RECSYS)
        for name, shape in spec.shapes.items():
            out[f"{RECSYS}:{name}"] = row(spec, shape, mesh)
        for cell in GNN_MULTI_CELLS if kind == "multi" else GNN_CELLS:
            arch, name = cell.split(":")
            spec = get_config(arch, smoke=True)
            out[cell] = row(spec, spec.shape(name), mesh)
        for cell in full:
            arch, name = cell.split(":")
            spec = get_config(arch)
            out[f"{cell}@full"] = row(spec, spec.shape(name), mesh)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
