"""The rank side of ``test_torch_gnn_partitioned.py``: one ``gloo`` rank of
the GNN ``pjit`` cells partitioned over a ``(data, model)`` mesh by
DTensor placements.  Imports ``repro_torch`` only (no JAX).

``run_cases`` forms the group and, on each mesh of ``MESHES``, runs
every case of ``CASES`` (``launch.tasks.build_gnn_task`` on the mesh,
its ``run``, then a second step from the state it returns) from the
weights and graphs the test wrote, and one ``gather_nodes`` and one
``mp_segment_sum`` under ``CommDebugMode`` (their values, gradients and
collectives).  Then on (2, 2) the two planted faults, each a train step
of gat-cora: the segment sum's partial reduce-scattered over ``data``
alone, left unreduced over ``model``; and the node gather indexing the
rank's own node shard, with no all-gather.  Rank 0 pickles what it
gathered.
"""
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import init_local_group, make_mesh
from repro_torch.launch.tasks import build_gnn_task, distribute_tree
from repro_torch.models.gnn import GraphBatch, equivariant, gat, pna
from repro_torch.models.sharding import distribute, placements
from repro_torch.sparse import gather, segment
from repro_torch.train import init_train_state
from repro_torch.train.tree import named_leaves

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MODULES = {"gat-cora": gat, "pna": pna, "nequip": equivariant,
           "mace": equivariant}
# (arch, graph): "graph" is random_graph(24, 80), "molecules" a batch of
# 4 molecules of 8 nodes and 24 edges (32 and 96); both divide by 4.
CASES = (("gat-cora", "graph"), ("pna", "graph"), ("pna", "molecules"),
         ("nequip", "graph"), ("nequip", "molecules"),
         ("mace", "molecules"))
GRAPHS = {"graph": dict(n_nodes=24, n_edges=80, n_graphs=1),
          "molecules": dict(n_nodes=32, n_edges=96, n_graphs=4)}
FAULT_CASE = ("gat-cora", "graph")


def _whole(x):
    """A (partitioned) tensor gathered to a host array."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().cpu().numpy().copy()


def _step_result(state, metrics) -> dict:
    return {"loss": float(_whole(metrics["loss"])),
            "grad_norm": float(_whole(metrics["grad_norm"])),
            "lr": float(_whole(metrics["lr"])),
            "leaves": {name: _whole(leaf)
                       for name, leaf in named_leaves(state)}}


def _shape(arch, kind):
    """The cell's shape: its sizes the graph's (padding none: both divide
    the 4 ranks), its feature and class widths the smoke config's."""
    cfg = get_config(arch, smoke=True).model
    g = GRAPHS[kind]
    dims = {"d_feat": getattr(cfg, "d_in", 16),
            "n_classes": getattr(cfg, "n_classes", 8)}
    if g["n_graphs"] > 1:
        dims.update(n_nodes=g["n_nodes"] // g["n_graphs"],
                    n_edges=g["n_edges"] // g["n_graphs"],
                    batch=g["n_graphs"])
    else:
        dims.update(n_nodes=g["n_nodes"], n_edges=g["n_edges"])
    return ShapeSpec(kind, "graph_train", dims)


def _graph(inputs, arch, kind) -> GraphBatch:
    g = inputs["graphs"][arch, kind]
    return GraphBatch(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v for k, v in g.items()})


def train_case(mesh, inputs, arch, kind):
    """Two partitioned steps of ``arch`` on graph ``kind``."""
    spec = get_config(arch, smoke=True)
    task = build_gnn_task(spec, _shape(arch, kind), mesh)
    if not (task.partitioned and task.per_device):
        raise AssertionError(f"{task.name} is not partitioned")
    mod = MODULES[arch]
    params = mod.params_from_jax(inputs["params"][arch, kind], spec.model,
                                 device="cpu")
    g = _graph(inputs, arch, kind)
    state, m1 = task.run(init_train_state(params), g)
    first = _step_result(state, m1)
    first["placed"] = {name: repr(tuple(leaf.placements))
                       for name, leaf in named_leaves(state)}
    state, m2 = task.fn(state, distribute_tree(g, task.placements[1], mesh))
    return {"step1": first, "step2": _step_result(state, m2)}


def _counts(comm) -> dict:
    return {str(op).split(".")[-1]: int(n)
            for op, n in comm.get_comm_counts().items()}


def collectives_case(mesh, inputs):
    """``gather_nodes`` of node rows over both axes by edge ids over both
    axes, and ``mp_segment_sum`` of edge rows by them: values,
    gradients (of ``sum(out * weights)``) and the collectives of each
    one's forward and backward."""
    from torch.distributed.tensor.debug import CommDebugMode

    c = inputs["collectives"]
    pl = placements((("data", "model"),), mesh)
    ids = distribute(torch.from_numpy(c["ids"]), mesh, pl)
    out = {}
    for name, rows, fn in (
            ("gather", c["nodes"], gather.gather_nodes),
            ("segment_sum", c["messages"],
             lambda x, i: segment.mp_segment_sum(x, i, c["n_nodes"]))):
        x = distribute(torch.from_numpy(rows), mesh, pl).requires_grad_()
        with CommDebugMode() as fwd:
            y = fn(x, ids)
        w = distribute(torch.from_numpy(c[f"{name}_weights"]), mesh,
                       tuple(y.placements))
        with CommDebugMode() as bwd:
            y.backward(w)
        out[name] = {"value": _whole(y), "grad": _whole(x.grad),
                     "placements": repr(tuple(y.placements)),
                     "forward": _counts(fwd), "backward": _counts(bwd)}
    # 22 node rows do not divide over 4 ranks: the gather refuses them
    uneven = distribute(torch.from_numpy(c["nodes"][:22]), mesh, pl)
    try:
        gather.gather_nodes(uneven, ids)
        out["uneven"] = "gathered"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def _unreduced_over_model(mesh):
    """The planted fault: a segment sum's partial reduce-scattered over
    ``data`` alone, and each ``model`` rank keeping its piece of that
    without the sum over ``model``."""
    data, model = mesh["data"], mesh["model"]

    def own_rows_sum(partial, rows):
        if rows is None:
            return partial
        part = (segment._ReduceScatterRows.apply(partial, data)
                if data.size() > 1 else partial)
        k = part.shape[0] // model.size()
        return part.narrow(0, model.get_local_rank() * k, k)

    return own_rows_sum


def _own_shard_rows(xl, idx, rows):
    """The planted fault: the node gather indexing the rank's own node
    shard (zero for a node another rank holds), with no all-gather."""
    if rows is None:
        return xl[idx]
    n = xl.shape[0]
    lo = rows.get_local_rank() * n
    mine = (idx >= lo) & (idx < lo + n)
    got = xl[(idx - lo).clamp(0, n - 1)]
    return torch.where(mine.reshape((-1,) + (1,) * (got.dim() - 1)), got,
                       torch.zeros((), dtype=got.dtype))


def fault_cases(inputs, mesh) -> dict:
    out = {}
    real = segment._own_rows_sum
    segment._own_rows_sum = _unreduced_over_model(mesh)
    try:
        out["unreduced_over_model"] = train_case(mesh, inputs, *FAULT_CASE)
    finally:
        segment._own_rows_sum = real
    real = gather._take_rows_local
    gather._take_rows_local = _own_shard_rows
    try:
        out["own_node_shard"] = train_case(mesh, inputs, *FAULT_CASE)
    finally:
        gather._take_rows_local = real
    return out


def run_cases(rank, world, store_dir, in_path, out_dir):
    init_local_group(rank, world, store_dir, "cpu")
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        meshes = {name: make_mesh(shape) for name, shape in MESHES.items()}
        out = {"train": {}, "collectives": {}}
        for name, mesh in meshes.items():
            for case in CASES:
                out["train"][case + (name,)] = train_case(mesh, inputs,
                                                          *case)
            out["collectives"][name] = collectives_case(mesh, inputs)
        out["faults"] = fault_cases(inputs, meshes["2x2"])
        if rank == 0:
            with open(os.path.join(out_dir, "gnn_pjit_ranks.pkl"),
                      "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def collectives_inputs(seed: int) -> dict:
    """Node rows, edge rows, edge ids over 24 nodes and the weights of
    the collectives case's gradients."""
    rng = np.random.default_rng(seed)
    n, e, d = 24, 80, 6
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"n_nodes": n, "ids": rng.integers(0, n, e).astype(np.int32),
            "nodes": draw(n, d), "messages": draw(e, d),
            "gather_weights": draw(e, d), "segment_sum_weights": draw(n, d)}
