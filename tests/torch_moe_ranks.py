"""The rank side of ``test_torch_moe_partitioned.py``: one ``gloo`` rank of
the MoE LM partitioned over a ``(data, model)`` mesh by DTensor
placements.  Imports ``repro_torch`` only (no JAX).

``run_cases`` forms the group and, for each case of ``CASES`` and each
mesh, runs the cell's partitioned steps (``launch.tasks.build_task`` on
the mesh, its ``run``) from the weights, tokens and warm caches the test
wrote: one train step of two micro-batches, the forward's aux loss, a
prefill and four greedy decode steps from the reference's warm cache.
Then on (2, 2): a checkpoint written there and resumed on (1, 4) beside
the straight run, and the three planted faults (a rank routing its own
rows alone on the global route, the load-balance loss as the mean of
the ranks' own losses, the micro-batches cut from each rank's own
rows).  Rank 0 pickles what it gathered.
"""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import init_local_group, make_mesh
from repro_torch.launch.tasks import (build_task, distribute_tree,
                                      lm_param_placements)
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.train import init_train_state
from repro_torch.train import step as train_step
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.tree import named_leaves

QWEN, LLAMA4 = "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"
# case: (arch, MoEConfig fields changed, sequence length).  At B = 4
# and two micro-batches: "global" and "bind" route every micro-batch
# (64 tokens) and the prefill (128) globally, "bind" at a capacity that
# drops slots; "grouped" routes 4 groups of a micro-batch's 512 tokens
# (2 a data rank on (2, 2)) and of the prefill's 1,024; "fallback" 3
# groups of 516 and of 1,032 (3 does not divide 'data' 2: every rank
# routes every group); llama4 (4 experts top-1, a shared expert, MoE
# every 2nd layer, chunked local layers) globally.
CASES = {
    "global": (QWEN, {}, 32),
    "bind": (QWEN, {"capacity_factor": 0.5}, 32),
    "grouped": (QWEN, {"n_groups": 4}, 256),
    "fallback": (QWEN, {"n_groups": 3}, 258),
    "llama4": (LLAMA4, {}, 32),
}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, GEN, ACCUM = 4, 4, 2


def config(case, dtype=torch.float32):
    """Case ``case``'s ``smoke()`` spec computing in ``dtype``."""
    arch, fields, _ = CASES[case]
    spec = get_config(arch, smoke=True)
    model = spec.model
    return dataclasses.replace(spec, model=dataclasses.replace(
        model, compute_dtype=dtype,
        moe=dataclasses.replace(model.moe, **fields)))


def seq_len(case) -> int:
    return CASES[case][2]


def _whole(x):
    """A (partitioned) tensor gathered to a host array."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().cpu().float().numpy().copy()


def _step_result(state, metrics) -> dict:
    return {"loss": float(_whole(metrics["loss"])),
            "grad_norm": float(_whole(metrics["grad_norm"])),
            "lr": float(_whole(metrics["lr"])),
            "leaves": {name: _whole(leaf)
                       for name, leaf in named_leaves(state)}}


def _params(case, inputs):
    return tt.params_from_jax(inputs[case]["params"], config(case).model,
                              device="cpu")


def _batch(toks):
    t = torch.from_numpy(np.asarray(toks)).int()
    return {"tokens": t, "labels": torch.roll(t, -1, dims=1)}


def train_task(case, mesh):
    shape = ShapeSpec("train", "train", {
        "seq_len": seq_len(case), "global_batch": B, "accum_steps": ACCUM})
    task = build_task(config(case), shape, mesh)
    if not task.partitioned:
        raise AssertionError(f"{task.name} is not partitioned")
    return task


def train_case(case, mesh, inputs):
    state = init_train_state(_params(case, inputs))
    state, metrics = train_task(case, mesh).run(
        state, _batch(inputs[case]["tokens"]))
    return _step_result(state, metrics)


def aux_case(case, mesh, inputs):
    """The forward's aux loss on the partitioned weights and tokens."""
    spec = config(case)
    pre = build_task(spec, ShapeSpec("p", "prefill", {
        "seq_len": seq_len(case), "global_batch": B}), mesh)
    params, toks = pre.distribute((
        _params(case, inputs),
        torch.from_numpy(inputs[case]["tokens"]).int()))
    with torch.no_grad():
        _, aux = tt.encode(params, spec.model, toks)
    return float(_whole(aux))


def serve_case(case, mesh, inputs):
    """The partitioned prefill's last logits and ``GEN`` greedy decode
    steps on a float32 cache warmed with the reference's prefill cache
    (each step's logits and ids)."""
    spec = config(case)
    cfg = spec.model
    s = seq_len(case)
    params = _params(case, inputs)
    toks = torch.from_numpy(inputs[case]["tokens"]).int()
    pre = build_task(spec, ShapeSpec("p", "prefill", {
        "seq_len": s, "global_batch": B}), mesh)
    last, _ = pre.run(params, toks)
    dec = build_task(spec, ShapeSpec("d", "decode", {
        "seq_len": s + GEN, "global_batch": B}), mesh)
    full = tt.init_cache(cfg, B, s + GEN, dtype=cfg.compute_dtype,
                         device="cpu")
    for key in full:
        full[key][:, :, :s].copy_(torch.from_numpy(
            inputs[case]["warm"][key]))
    tok = torch.from_numpy(inputs[case]["first"]).int()
    d_params, d_cache, _, _ = dec.distribute(
        (params, full, tok, torch.tensor(s, dtype=torch.int32)))
    out = {"last": _whole(last), "steps": [], "ids": []}
    for i in range(GEN):
        d_tok, d_pos = (distribute_tree(x, pl, mesh) for x, pl in zip(
            (tok, torch.tensor(s + i, dtype=torch.int32)),
            dec.placements[2:]))
        logits, d_cache = dec.fn(d_params, d_cache, d_tok, d_pos)
        lg = _whole(logits)
        out["steps"].append(lg)
        out["ids"].append(lg.argmax(-1))
        tok = torch.from_numpy(lg.argmax(-1)).int()
    return out


def checkpoint_case(inputs, ckpt_dir, meshes):
    """"global": two partitioned steps on (2, 2), straight; and one step
    on (2, 2), a checkpoint, a restore on (1, 4) under its placements
    and one more step there."""
    case = "global"
    b1, b2 = (_batch(inputs[case][key]) for key in ("tokens", "tokens2"))
    t22, t14 = train_task(case, meshes["2x2"]), train_task(case,
                                                           meshes["1x4"])
    state, _ = t22.run(init_train_state(_params(case, inputs)), b1)
    _, m_straight = t22.fn(state, distribute_tree(b2, t22.placements[1],
                                                  meshes["2x2"]))
    straight = _step_result(state, m_straight)

    state, _ = t22.run(init_train_state(_params(case, inputs)), b1)
    path = save_checkpoint(ckpt_dir, 1, state)
    written = {name: _whole(leaf) for name, leaf in named_leaves(state)}
    like = init_train_state(_params(case, inputs))
    restored, step = restore_checkpoint(
        path, like, mesh=meshes["1x4"],
        placements=lm_param_placements(like, meshes["1x4"]))
    placed = {name: repr(leaf.placements)
              for name, leaf in named_leaves(restored)}
    _, m = t14.fn(restored, distribute_tree(b2, t14.placements[1],
                                            meshes["1x4"]))
    return {"path": path, "step": step, "written": written,
            "placed": placed, "straight": straight,
            "resumed": _step_result(restored, m)}


def _mean_of_rank_losses(sums, t, cfg):
    """The planted fault: each data rank's load-balance loss over its own
    tokens, averaged over the ranks (the z-loss left global)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = sums.device_mesh
    ranks = 1
    for i, p in enumerate(sums.placements):
        if p.is_partial():
            ranks *= mesh.size(i)
    own_lb, _ = moe._router_losses(sums.to_local(), t // ranks, cfg)
    lb = DTensor.from_local(own_lb / ranks, mesh, sums.placements,
                            run_check=False)
    whole = sums.redistribute(mesh, (Replicate(),) * mesh.ndim)
    _, z = moe._router_losses(whole, t, cfg)
    return lb.redistribute(mesh, (Replicate(),) * mesh.ndim), z


def _own_rows_micro_batches(batch, n):
    """The planted fault: micro-batch ``i`` is every data rank's ``i``-th
    slice of its own rows, not the JAX package's contiguous rows."""
    from torch.distributed.tensor import DTensor

    def cut(x, i):
        local = x.to_local()
        m = local.shape[0] // n
        part = local[i * m:(i + 1) * m]
        return DTensor.from_local(
            part, x.device_mesh, x.placements, run_check=False,
            shape=(x.shape[0] // n,) + tuple(x.shape[1:]),
            stride=part.stride())

    return [{key: cut(x, i) for key, x in batch.items()} for i in range(n)]


def fault_cases(inputs, mesh) -> dict:
    """The three planted faults' train steps (and aux losses) on
    ``mesh``."""
    out = {}
    real_groups = moe.own_groups
    moe.own_groups = lambda g, rows: max(1, g // rows)
    try:
        out["own_rows_route"] = {"step": train_case("bind", mesh, inputs),
                                 "aux": aux_case("bind", mesh, inputs)}
    finally:
        moe.own_groups = real_groups
    real_losses = moe.partitioned_router_losses
    moe.partitioned_router_losses = _mean_of_rank_losses
    try:
        out["mean_of_rank_losses"] = {
            "step": train_case("global", mesh, inputs),
            "aux": aux_case("global", mesh, inputs)}
    finally:
        moe.partitioned_router_losses = real_losses
    real_micro = train_step._micro_batches
    train_step._micro_batches = _own_rows_micro_batches
    try:
        out["own_rows_micro_batches"] = {
            "step": train_case("global", mesh, inputs)}
    finally:
        train_step._micro_batches = real_micro
    return out


def run_cases(rank, world, store_dir, in_path, out_dir):
    init_local_group(rank, world, store_dir, "cpu")
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        meshes = {name: make_mesh(shape) for name, shape in MESHES.items()}
        out = {"train": {}, "serve": {}, "aux": {}}
        for case in CASES:
            for name, mesh in meshes.items():
                out["train"][case, name] = train_case(case, mesh, inputs)
                out["aux"][case, name] = aux_case(case, mesh, inputs)
                out["serve"][case, name] = serve_case(case, mesh, inputs)
        out["checkpoint"] = checkpoint_case(
            inputs, os.path.join(out_dir, "ckpt"), meshes)
        out["faults"] = fault_cases(inputs, meshes["2x2"])
        if rank == 0:
            with open(os.path.join(out_dir, "moe_ranks.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
