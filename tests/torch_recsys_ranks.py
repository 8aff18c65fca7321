"""The rank side of ``test_torch_recsys_partitioned.py``: one ``gloo`` rank
of BERT4Rec's cells partitioned over a ``(data, model)`` mesh by DTensor
placements.  Imports ``repro_torch`` only (no JAX).

``run_cases`` forms the group and, on each mesh of ``MESHES``, runs the
three kinds of cell (``launch.tasks.build_recsys_task`` on the mesh, its
``run``) from the weights, batches and candidates the test wrote: one
train step, the serving scores' top-100 and the retrieval top-100; and
``_embed_partitioned`` on ids cut over every axis against a table cut
over ``model`` (its rows and the table's gradient).  Then on (2, 2): a
checkpoint written there and resumed on (1, 4) beside the straight run,
and the two planted faults (the table's gradient left unreduced over
``data``; each ``model`` rank looking its own candidate ids up in its
own table shard alone).  Rank 0 pickles what it gathered.
"""
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import init_local_group, make_mesh
from repro_torch.launch.tasks import build_recsys_task, distribute_tree
from repro_torch.models import layers
from repro_torch.models.recsys import bert4rec as b4r
from repro_torch.models.sharding import distribute, local_offset, placements
from repro_torch.train import init_train_state
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.tree import named_leaves

ARCH = "bert4rec"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, MASKED, NEG, CAND = 8, 4, 64, 1000
SHAPES = {
    "train": ShapeSpec("train_batch", "recsys_train", {"batch": B}),
    "serve": ShapeSpec("serve_p99", "recsys_serve", {"batch": B}),
    "retrieval": ShapeSpec("retrieval_cand", "recsys_retrieval",
                           {"batch": 1, "n_candidates": CAND}),
}


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


def _params(inputs):
    return b4r.params_from_jax(inputs["params"], device="cpu")


def _batch(inputs, key="batch"):
    return {k: torch.from_numpy(v) for k, v in inputs[key].items()}


def task(kind, mesh):
    t = build_recsys_task(get_config(ARCH, smoke=True), SHAPES[kind], mesh,
                          n_masked=MASKED, n_neg=NEG)
    if not (t.partitioned and t.per_device):
        raise AssertionError(f"{t.name} is not partitioned")
    return t


def train_case(mesh, inputs):
    state, metrics = task("train", mesh).run(
        init_train_state(_params(inputs)), _batch(inputs))
    out = _step_result(state, metrics)
    out["placed"] = {name: repr(leaf.placements)
                     for name, leaf in named_leaves(state)}
    return out


def serve_case(mesh, inputs):
    vals, ids = task("serve", mesh).run(
        _params(inputs), torch.from_numpy(inputs["batch"]["items"]))
    return {"vals": _whole(vals), "ids": _whole(ids),
            "placements": repr(tuple(vals.placements))}


def retrieval_case(mesh, inputs):
    vals, ids = task("retrieval", mesh).run(
        _params(inputs), torch.from_numpy(inputs["batch"]["items"][:1]),
        torch.from_numpy(inputs["cand"]))
    return {"vals": _whole(vals), "ids": _whole(ids),
            "placements": repr(tuple(vals.placements))}


def lookup_case(mesh, inputs):
    """``_embed_partitioned`` with the table over ``model`` and the ids
    over every axis (retrieval's candidates): the rows, their layout and
    the table's gradient of ``(rows * weights).sum()``."""
    table = torch.from_numpy(inputs["params"]["item_embed"])
    d_table = distribute(table, mesh, placements(("model", None), mesh))
    d_table.requires_grad_(True)
    d_ids = distribute(torch.from_numpy(inputs["lookup_ids"]), mesh,
                       placements((("data", "model"),), mesh))
    rows = layers._embed_partitioned(d_table, d_ids)
    weights = distribute(torch.from_numpy(inputs["lookup_weights"]), mesh,
                         tuple(rows.placements))
    (rows * weights).sum().backward()
    return {"rows": _whole(rows), "placements": repr(tuple(rows.placements)),
            "grad": _whole(d_table.grad)}


def checkpoint_case(inputs, ckpt_dir, meshes):
    """Two partitioned steps on (2, 2), straight; and one step on (2, 2),
    a checkpoint, a restore on (1, 4) under its placements and one more
    step there."""
    b1, b2 = _batch(inputs, "batch"), _batch(inputs, "batch2")
    t22, t14 = task("train", meshes["2x2"]), task("train", meshes["1x4"])
    state, _ = t22.run(init_train_state(_params(inputs)), b1)
    _, m_straight = t22.fn(state, distribute_tree(b2, t22.placements[1],
                                                  meshes["2x2"]))
    straight = _step_result(state, m_straight)

    state, _ = t22.run(init_train_state(_params(inputs)), b1)
    path = save_checkpoint(ckpt_dir, 1, state)
    like = init_train_state(_params(inputs))
    restored, step = restore_checkpoint(path, like, mesh=meshes["1x4"],
                                        placements=t14.placements[0])
    placed = {name: repr(leaf.placements)
              for name, leaf in named_leaves(restored)}
    _, m = t14.fn(restored, distribute_tree(b2, t14.placements[1],
                                            meshes["1x4"]))
    return {"step": step, "placed": placed, "straight": straight,
            "resumed": _step_result(restored, m)}


def _unreduced_table_grad(real):
    """The planted fault: ``local_map`` with the table's gradient in
    ``_embed_partitioned`` declared whole over the data axes (where it
    is each data rank's own rows' ``Partial``), so no rank sums it."""
    from torch.distributed.tensor import Replicate

    def local_map(fn, out_placements, in_placements=None,
                  in_grad_placements=None, device_mesh=None, **kw):
        if (in_grad_placements is not None
                and fn.__qualname__.startswith("_embed_partitioned")):
            first = tuple(Replicate() if p.is_partial() else p
                          for p in in_grad_placements[0])
            in_grad_placements = (first,) + tuple(in_grad_placements[1:])
        return real(fn, out_placements, in_placements=in_placements,
                    in_grad_placements=in_grad_placements,
                    device_mesh=device_mesh, **kw)

    return local_map


def _own_shard_lookup(real):
    """The planted fault: ids cut over the vocab's mesh dims (the
    candidates) looked up by each rank in its own vocab shard alone
    (zero for an id another rank holds), with no gather of the ids and
    no sum over those dims; other lookups as ``real``."""
    from torch.distributed.tensor.experimental import local_map

    def lookup(table, ids):
        mesh = table.device_mesh
        tpl, vdims = layers._vocab_split(table, 0)
        ipl = tuple(ids.placements)
        if not any(ipl[i].is_shard() for i in vdims):
            return real(table, ids)
        table = table.redistribute(mesh, tpl)
        lo = local_offset(table, 0)

        def body(tbl, idx):
            n = tbl.shape[0]
            mine = (idx >= lo) & (idx < lo + n)
            rows = tbl[(idx - lo).clamp(0, n - 1)]
            return torch.where(mine[..., None], rows, torch.zeros(
                (), dtype=rows.dtype))

        return local_map(body, out_placements=list(ipl),
                         in_placements=(tpl, ipl), device_mesh=mesh)(
                             table, ids)

    return lookup


def fault_cases(inputs, mesh) -> dict:
    """The two planted faults on ``mesh``: a train step with the table's
    gradient unreduced over ``data``, and retrieval with each ``model``
    rank's candidate ids looked up in its own shard alone."""
    import torch.distributed.tensor.experimental as experimental

    out = {}
    real_map = experimental.local_map
    experimental.local_map = _unreduced_table_grad(real_map)
    try:
        out["unreduced_table_grad"] = train_case(mesh, inputs)
    finally:
        experimental.local_map = real_map
    real_lookup = layers._embed_partitioned
    layers._embed_partitioned = _own_shard_lookup(real_lookup)
    try:
        out["own_shard_retrieval"] = retrieval_case(mesh, inputs)
    finally:
        layers._embed_partitioned = real_lookup
    return out


def run_cases(rank, world, store_dir, in_path, out_dir):
    init_local_group(rank, world, store_dir, "cpu")
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        meshes = {name: make_mesh(shape) for name, shape in MESHES.items()}
        out = {"train": {}, "serve": {}, "retrieval": {}, "lookup": {}}
        for name, mesh in meshes.items():
            out["train"][name] = train_case(mesh, inputs)
            out["serve"][name] = serve_case(mesh, inputs)
            out["retrieval"][name] = retrieval_case(mesh, inputs)
            out["lookup"][name] = lookup_case(mesh, inputs)
        out["checkpoint"] = checkpoint_case(
            inputs, os.path.join(out_dir, "ckpt"), meshes)
        out["faults"] = fault_cases(inputs, meshes["2x2"])
        if rank == 0:
            with open(os.path.join(out_dir, "recsys_ranks.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def lookup_inputs(vocab: int, d: int, seed: int) -> dict:
    """Ids over the whole vocab (a negative one counting from the end
    among them) and the weights of the lookup case's gradient."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-vocab, vocab, CAND).astype(np.int32)
    return {"lookup_ids": ids,
            "lookup_weights": rng.standard_normal((CAND, d)).astype(
                np.float32)}
