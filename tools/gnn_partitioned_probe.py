#!/usr/bin/env python3
"""The partitioned GNN ``pjit`` step on four ``gloo`` CPU ranks against the
plain step, under whatever torch the machine has.

    python3 tools/gnn_partitioned_probe.py [--archs gat-cora,pna,nequip,mace]

Run from the root of a checkout; needs no card and no JAX (the JAX
package's answers are ``tests/test_torch_gnn_partitioned.py``'s).  For
each mesh, (data 2, model 2) and (data 1, model 4), and each arch at its
``smoke()`` config, it builds the cell (``launch.tasks.build_gnn_task``
on the mesh), takes one ``Task.run`` step and one plain
``train.make_train_step`` step from the same weights on the same graph
(gat-cora: ``random_graph(24, 80)``; the others: 4 molecules, 32 nodes
and 96 edges), and prints both losses and ``grad_norm``s, the largest
first-moment error as a share of the plain moment's largest magnitude,
the partitioned step's seconds and its collectives by op
(``CommDebugMode``).  A version of torch whose DTensor rules differ
shows here first: run it under each machine's torch.
"""
import argparse
import copy
import dataclasses
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = ((2, 2), (1, 4))


def case_inputs(arch):
    """``(module, config, graph)`` of ``arch`` at its smoke config on the
    CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.gnn import equivariant, gat, pna, random_graph

    cfg = get_config(arch, smoke=True).model
    mod = {"gat-cora": gat, "pna": pna}.get(arch, equivariant)
    if mod is equivariant:
        g = random_graph(32, 96, with_positions=True,
                         n_species=cfg.n_species, n_graphs=4, seed=3,
                         device="cpu")
        g = dataclasses.replace(g, labels=torch.randn(
            4, generator=torch.Generator().manual_seed(1)))
    elif arch == "pna":
        g = random_graph(32, 96, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                         n_graphs=4, seed=3, device="cpu")
    else:
        g = random_graph(24, 80, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                         seed=3, device="cpu")
    return mod, cfg, g


def shape_of(cfg, g):
    from repro_torch.configs.base import ShapeSpec

    dims = {"d_feat": getattr(cfg, "d_in", 16),
            "n_classes": getattr(cfg, "n_classes", 8)}
    e = int(g.edge_src.shape[0])
    if g.n_graphs > 1:
        dims.update(n_nodes=g.n_nodes // g.n_graphs,
                    n_edges=e // g.n_graphs, batch=g.n_graphs)
    else:
        dims.update(n_nodes=g.n_nodes, n_edges=e)
    return ShapeSpec("probe", "graph_train", dims)


def run(rank, world, store, shape, archs):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_local_group, make_mesh
    from repro_torch.launch.tasks import build_gnn_task
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    init_local_group(rank, world, store, "cpu")
    try:
        mesh = make_mesh(shape)
        for arch in archs:
            mod, cfg, g = case_inputs(arch)
            task = build_gnn_task(get_config(arch, smoke=True),
                                  shape_of(cfg, g), mesh)
            params = mod.init_params(torch.Generator().manual_seed(0), cfg)
            plain, pm = make_train_step(
                lambda p, b: mod.loss_fn(p, cfg, b), AdamWConfig())(
                    init_train_state(copy.deepcopy(params)), g)
            t0 = time.perf_counter()
            with CommDebugMode() as comm:
                state, m = task.run(init_train_state(params), g)
            seconds = time.perf_counter() - t0
            mu = [(a.full_tensor(), b) for a, b in zip(
                leaves(state.opt_state["mu"]), leaves(plain.opt_state["mu"]))]
            scale = max(float(b.abs().max()) for _, b in mu)
            err = max(float((a - b).abs().max()) for a, b in mu) / scale
            if rank == 0:
                counts = {str(k).split(".")[-1]: n
                          for k, n in comm.get_comm_counts().items()}
                print(f"{arch} {shape}: loss {float(m['loss'].full_tensor())!r}"
                      f" / plain {float(pm['loss'])!r}; grad_norm "
                      f"{float(m['grad_norm'].full_tensor())!r} / "
                      f"{float(pm['grad_norm'])!r}; first moments within "
                      f"{err:.3g} of their largest; {seconds:.2f} s; "
                      f"{counts}", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    import torch

    from repro_torch.launch.mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archs", default="gat-cora,pna,nequip,mace")
    args = ap.parse_args()
    print(f"torch {torch.__version__}", flush=True)
    for shape in MESHES:
        spawn_ranks(run, 4, (tempfile.mkdtemp(prefix="gnn-probe-"), shape,
                             args.archs.split(",")), deadline_s=600)


if __name__ == "__main__":
    main()
