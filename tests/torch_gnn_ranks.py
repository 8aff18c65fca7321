"""The rank side of ``test_torch_gnn_sharded.py``: one ``gloo`` rank of
the edge-sharded GNN step.  Imports ``repro_torch`` only (no JAX).

``run_cases`` forms the group, runs one ``make_edge_sharded_step`` of
each case from the same graph and weights as the test's plain step, and
rank 0 pickles the loss, ``grad_norm``, the parameters and the first
moments (which carry the clipped gradients) for the test to compare.
"""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.gnn_sharded import make_edge_sharded_step
from repro_torch.launch.mesh import init_local_group
from repro_torch.models.gnn import equivariant, gat, pna, random_graph
from repro_torch.train import AdamWConfig, init_train_state
from repro_torch.train.tree import leaves

# gat-cora, nequip and mace as the JAX package's sharded test; pna adds
# the max / min merges.
CASES = {"gat-cora": gat, "nequip": equivariant, "mace": equivariant,
         "pna": pna}
OPT = AdamWConfig()   # the JAX package's sharded test's


def case_inputs(arch):
    """``(module, config, graph, state)`` of a case on the CPU, the same
    in every rank and in the test's process."""
    cfg = get_config(arch, smoke=True).model
    if arch in ("nequip", "mace"):
        g = random_graph(24, 80, with_positions=True,
                         n_species=cfg.n_species, seed=3, device="cpu")
        g = dataclasses.replace(g, labels=torch.zeros(1))
    else:
        g = random_graph(24, 80, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                         seed=3, device="cpu")
    mod = CASES[arch]
    params = mod.init_params(torch.Generator().manual_seed(0), cfg)
    return mod, cfg, g, init_train_state(params)


def result(state, metrics):
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": [p.detach().numpy().copy() for p in
                       leaves(state.params)],
            "mu": [m.numpy().copy() for m in leaves(state.opt_state["mu"])]}


def run_cases(rank, world, store_dir, out_dir):
    init_local_group(rank, world, store_dir, "cpu")
    try:
        out = {}
        for arch in CASES:
            mod, cfg, g, state = case_inputs(arch)
            step = make_edge_sharded_step(mod, cfg, None, OPT)
            out[arch] = result(*step(state, g))
        if rank == 0:
            with open(os.path.join(out_dir, "gnn_ranks.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
