"""The rank side of ``test_torch_lm_partitioned.py``: one ``gloo`` rank of
the dense LM partitioned over a ``(data, model)`` mesh by DTensor
placements.  Imports ``repro_torch`` only (no JAX).

``run_cases`` forms the group and, for each config and mesh, runs the
cell's partitioned steps (``launch.tasks.build_task`` on the mesh, its
``run``: the arguments distributed by the JAX package's placements; the
train step's ``AdamWConfig()`` is the task's) from
the weights, tokens and warm caches the test wrote: one train step of
two micro-batches, a prefill, four greedy decode steps from the
reference's warm cache, and on (2, 2) the same for one sequence, whose
cache's sequence is cut over both axes (in float32, and in bfloat16
fed the float32 run's ids); then llama3.2-1b's train step on (2, 2)
with a mask whose counts differ between groupings of the rows, a
checkpoint written on (2, 2) and resumed on (1, 4) beside the straight
run, and the planted fault (every KV head handed to every rank).  Rank
0 pickles what it gathered.
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
from repro_torch.models import attention
from repro_torch.models import transformer as tt
from repro_torch.train import init_train_state
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.tree import named_leaves

ARCHS = ("llama3.2-1b", "command-r-plus-104b", "gemma3-12b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, GEN, ACCUM = 4, 32, 4, 2
# the long-context decode (one sequence, its cache over every axis):
# gemma3-12b's local layers mask a window across the ranks' shards
LONG_ARCHS = ("llama3.2-1b", "gemma3-12b")


def config(arch, dtype=torch.float32):
    """``arch``'s ``smoke()`` spec computing in ``dtype``."""
    spec = get_config(arch, smoke=True)
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, compute_dtype=dtype))


def _whole(x):
    """A (partitioned) tensor gathered to a host array (bfloat16 held as
    float32, exactly)."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy().copy()


def _gathered(tree) -> dict:
    """``{leaf name: array}`` of a (partitioned) tree, gathered on every
    rank (each gather is a collective: every rank walks the same
    leaves)."""
    return {name: _whole(leaf) for name, leaf in named_leaves(tree)}


def _step_result(state, metrics) -> dict:
    return {"loss": float(_whole(metrics["loss"])),
            "grad_norm": float(_whole(metrics["grad_norm"])),
            "lr": float(_whole(metrics["lr"])),
            "leaves": _gathered(state)}


def _state(arch, inputs):
    cfg = config(arch).model
    return init_train_state(tt.params_from_jax(inputs[arch]["params"], cfg,
                                               device="cpu"))


def _batch(toks):
    t = torch.from_numpy(np.asarray(toks)).int()
    return {"tokens": t, "labels": torch.roll(t, -1, dims=1)}


def masked_train_case(arch, mesh, inputs):
    """The train step with ``inputs[arch]["mask"]`` in the batch,
    distributed as the tokens are."""
    task = train_task(arch, mesh)
    batch = _batch(inputs[arch]["tokens"])
    batch["mask"] = torch.from_numpy(inputs[arch]["mask"])
    rows = task.placements[1]["tokens"]
    state, metrics = task.fn(
        distribute_tree(_state(arch, inputs), task.placements[0], mesh),
        distribute_tree(batch, {key: rows for key in batch}, mesh))
    return _step_result(state, metrics)


def train_task(arch, mesh):
    spec = config(arch)
    shape = ShapeSpec("train", "train", {"seq_len": S, "global_batch": B,
                                         "accum_steps": ACCUM})
    task = build_task(spec, shape, mesh)
    if not task.partitioned:
        raise AssertionError(f"{task.name} is not partitioned")
    return task


def train_case(arch, mesh, inputs):
    task = train_task(arch, mesh)
    state, metrics = task.run(_state(arch, inputs),
                              _batch(inputs[arch]["tokens"]))
    return _step_result(state, metrics)


def serve_case(arch, mesh, inputs):
    """The partitioned prefill (its last logits, and its cache gathered)
    and four greedy decode steps on a float32 cache warmed with the
    reference's prefill cache (each step's logits and ids)."""
    spec = config(arch)
    cfg = spec.model
    params = tt.params_from_jax(inputs[arch]["params"], cfg, device="cpu")
    toks = torch.from_numpy(inputs[arch]["tokens"]).int()
    pre = build_task(spec, ShapeSpec("p", "prefill", {
        "seq_len": S, "global_batch": B}), mesh)
    last, cache = pre.run(params, toks)
    out = {"last": _whole(last), "cache_k": _whole(cache["k"]),
           "cache_v": _whole(cache["v"]),
           "cache_placements": repr(cache["k"].placements)}
    out.update(decode_steps(spec, params, mesh, inputs[arch]["warm"],
                            inputs[arch]["first"]))
    return out


def decode_steps(spec, params, mesh, warm, first, feed=None):
    """``GEN`` steps of the partitioned decode on a cache in the compute
    type warmed with ``warm`` (the reference's prefill cache, ``[L, b,
    S, KvH, hd]``) from the ids ``first``, each step fed the last one's
    greedy ids, or ``feed[i]`` before step ``i + 1``: each step's logits
    and ids, and the cache's placements."""
    b = first.shape[0]
    cfg = spec.model
    dec = build_task(spec, ShapeSpec("d", "decode", {
        "seq_len": S + GEN, "global_batch": b}), mesh)
    full = tt.init_cache(cfg, b, S + GEN, dtype=cfg.compute_dtype,
                         device="cpu")
    for key in full:
        full[key][:, :, :S].copy_(torch.from_numpy(
            warm[key].astype(np.float32)))
    tok = torch.from_numpy(first).int()
    d_params, d_cache, _, _ = dec.distribute(
        (params, full, tok, torch.tensor(S, dtype=torch.int32)))
    out = {"steps": [], "ids": [],
           "decode_placements": repr(d_cache["k"].placements)}
    for i in range(GEN):
        d_tok, d_pos = (distribute_tree(x, pl, mesh) for x, pl in zip(
            (tok, torch.tensor(S + i, dtype=torch.int32)),
            dec.placements[2:]))
        logits, d_cache = dec.fn(d_params, d_cache, d_tok, d_pos)
        lg = _whole(logits)
        out["steps"].append(lg)
        out["ids"].append(lg.argmax(-1))
        tok = torch.from_numpy(lg.argmax(-1) if feed is None
                               else np.asarray(feed[i])).int()
    return out


def long_decode_case(arch, mesh, inputs, dtype=torch.float32):
    """The long-context decode layout: one sequence (a batch below the
    data axes' extent), its cache's sequence cut over every mesh axis.
    In bfloat16, from the reference's bfloat16 prefill cache, fed the
    float32 run's greedy ids."""
    spec = config(arch, dtype)
    params = tt.params_from_jax(inputs[arch]["params"], spec.model,
                                device="cpu")
    if dtype == torch.float32:
        return decode_steps(spec, params, mesh, inputs[arch]["warm1"],
                            inputs[arch]["first1"])
    return decode_steps(spec, params, mesh, inputs[arch]["warm16"],
                        inputs[arch]["first1"], feed=inputs[arch]["ids1"])


def checkpoint_case(inputs, ckpt_dir, meshes):
    """llama3.2-1b: two partitioned steps on (2, 2), straight; and one
    step on (2, 2), a checkpoint, a restore on (1, 4) under its
    placements and one more step there."""
    arch = "llama3.2-1b"
    b1, b2 = _batch(inputs[arch]["tokens"]), _batch(inputs[arch]["tokens2"])
    t22, t14 = train_task(arch, meshes["2x2"]), train_task(arch,
                                                           meshes["1x4"])
    state, _ = t22.run(_state(arch, inputs), b1)
    _, m_straight = t22.fn(state, distribute_tree(b2, t22.placements[1],
                                                  meshes["2x2"]))
    straight = _step_result(state, m_straight)

    state, _ = t22.run(_state(arch, inputs), b1)
    path = save_checkpoint(ckpt_dir, 1, state)
    written = _gathered(state)
    like = _state(arch, inputs)
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


def split_kv_case(mesh, inputs):
    """``decode_attention`` in bfloat16 over a cache whose sequence is cut
    over both axes of ``mesh`` (each rank's partial softmax merged), on
    ``inputs["split_kv"]``'s q, K and V at each of its windows."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import distribute

    inp = inputs["split_kv"]
    q, k, v = (torch.from_numpy(inp[key]).to(torch.bfloat16)
               for key in ("q", "k", "v"))
    q_d = distribute(q, mesh, (Replicate(), Replicate()))
    k_d, v_d = (distribute(x, mesh, (Shard(1), Shard(1))) for x in (k, v))
    return {window: _whole(attention.decode_attention(
        q_d, k_d, v_d, inp["cache_len"], window=window))
        for window in inp["windows"]}


def planted_fault_case(inputs, mesh):
    """llama3.2-1b's train step with every KV head handed to every rank
    (``kv_head_slice`` replaced by the whole range)."""
    real = attention.kv_head_slice
    attention.kv_head_slice = lambda h, kvh, tp, rank: (0, kvh)
    try:
        return train_case("llama3.2-1b", mesh, inputs)
    finally:
        attention.kv_head_slice = real


def cast_case(mesh):
    """``cast_weight`` of a DTensor master: kept (the same DTensor twice),
    remade after an in-place change moves the master's own version
    counter, and equal to the new master's cast."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.layers import cast_weight
    from repro_torch.models.sharding import distribute

    w = torch.nn.Parameter(distribute(
        torch.randn(8, 4, generator=torch.Generator().manual_seed(5)), mesh,
        (Shard(0), Replicate())), requires_grad=True)
    with torch.no_grad():
        first = cast_weight(w, torch.bfloat16)
        kept = cast_weight(w, torch.bfloat16) is first
        before = w._version
        w.mul_(2.0)
        again = cast_weight(w, torch.bfloat16)
        return {"kept": kept, "version_moved": w._version > before,
                "remade": again is not first,
                "equal": bool((_whole(again) == _whole(
                    w.to(torch.bfloat16))).all()),
                "placements": repr(again.placements)}


def run_cases(rank, world, store_dir, in_path, out_dir):
    init_local_group(rank, world, store_dir, "cpu")
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        meshes = {name: make_mesh(shape) for name, shape in MESHES.items()}
        out = {"train": {}, "serve": {}}
        for arch in ARCHS:
            for name, mesh in meshes.items():
                out["train"][arch, name] = train_case(arch, mesh, inputs)
                out["serve"][arch, name] = serve_case(arch, mesh, inputs)
        out["checkpoint"] = checkpoint_case(
            inputs, os.path.join(out_dir, "ckpt"), meshes)
        out["long"] = {arch: long_decode_case(arch, meshes["2x2"], inputs)
                       for arch in LONG_ARCHS}
        out["long16"] = {arch: long_decode_case(
            arch, meshes["2x2"], inputs, torch.bfloat16)
            for arch in LONG_ARCHS}
        out["split_kv"] = split_kv_case(meshes["2x2"], inputs)
        out["masked"] = masked_train_case("llama3.2-1b", meshes["2x2"],
                                          inputs)
        out["fault"] = planted_fault_case(inputs, meshes["1x4"])
        out["cast"] = cast_case(meshes["2x2"])
        if rank == 0:
            with open(os.path.join(out_dir, "lm_ranks.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
