"""``repro_torch.launch.tasks`` against the JAX package's
``repro.launch.tasks``: for every (arch, shape) at full size, the
abstract inputs, the parameter and optimizer leaves, the model FLOPs,
the notes and the skipped cells; every LM leaf's placement on the two
production meshes by the reference's ``_lm_param_spec`` +
``_divisible``; the trace's FLOPs against a hand reckoning; and the
collectives of the edge-sharded GNN step on a fake world of 16, which
runs in a subprocess (no process group in the pytest process).

The reference's tasks are built on a 1 x 1 ``jax.make_mesh`` and never
lowered; the port's on a stand-in of a mesh's shape (its tasks read
only ``mesh_dim_names`` and ``size``).  Each arch's tasks are built
once for the module.  The partitioned cells (LM, BERT4Rec, GNN
``pjit``) traced on a fake world of 512: ``torch_fake_world_cells``."""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.launch import tasks as ref_tasks
from repro_torch import configs
from repro_torch.launch import tasks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StandIn:
    """A mesh's shape and axis names, as the port's tasks read a
    ``DeviceMesh``; ``shape`` as the reference's ``_divisible`` reads a
    ``jax.sharding.Mesh``."""

    def __init__(self, dims, names):
        self.dims, self.mesh_dim_names = tuple(dims), tuple(names)
        self.shape = dict(zip(names, dims))

    def size(self, dim=None):
        return math.prod(self.dims) if dim is None else self.dims[dim]


ONE = StandIn((1, 1), ("data", "model"))
MESHES = {"single": StandIn((16, 16), ("data", "model")),
          "multi": StandIn((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _arch_tasks(arch):
    """{shape: (reference Task, port Task)} of ``arch`` at full size;
    skipped shapes left out."""
    rspec, pspec = ref_configs.get_config(arch), configs.get_config(arch)
    out = {}
    for name, shape in rspec.shapes.items():
        if shape.skip:
            continue
        out[name] = (ref_tasks.build_task(rspec, shape, _ref_mesh()),
                     tasks.build_task(pspec, pspec.shape(name), ONE))
    return out


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_tasks._path_str(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat}


def _port_leaves(tree) -> dict:
    return {name: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for name, t in tasks.named_tensors(tree)}


def _unstacked(ref: dict, cfg) -> dict:
    """The reference's ``layers/<period position>/...`` stacks as the
    port's one block a layer: layer ``i`` from position ``i % period``,
    without the stacked axis (``params_from_jax``'s mapping)."""
    out = {}
    for name, (shape, dtype) in ref.items():
        parts = name.split("/")
        if parts[0] != "layers":
            out[name] = (shape, dtype)
            continue
        assert shape[0] == cfg.n_periods, (name, shape)
        j = int(parts[1])
        for p in range(cfg.n_periods):
            out["/".join(["layers", str(p * cfg.period + j)] + parts[2:])] = (
                shape[1:], dtype)
    return out


def _ref_state_leaves(state, family, cfg):
    params, opt = state
    map_ = (lambda t: _unstacked(_ref_leaves(t), cfg)) if family == "lm" \
        else _ref_leaves
    out = {f"params/{k}": v for k, v in map_(params).items()}
    for moment in ("mu", "nu"):
        out.update({f"opt_state/{moment}/{k}": v
                    for k, v in map_(opt[moment]).items()})
    out["opt_state/step"] = _ref_leaves({"s": opt["step"]})["s"]
    return out


def _ref_graph_leaves(g) -> dict:
    out = {f: (tuple(getattr(g, f).shape), np.dtype(getattr(g, f).dtype).name)
           for f in ("edge_src", "edge_dst", "edge_mask", "node_feat",
                     "positions", "species", "node_mask", "graph_ids",
                     "labels") if getattr(g, f) is not None}
    return out, (g.n_nodes, g.n_graphs)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_tasks_match_reference_at_full_size(arch):
    rspec, pspec = ref_configs.get_config(arch), configs.get_config(arch)
    assert pspec.family == rspec.family
    # The same skipped cells, for the same reasons.
    assert {n: s.skip for n, s in pspec.shapes.items()} == {
        n: s.skip for n, s in rspec.shapes.items()}
    for name, (rt, pt) in _arch_tasks(arch).items():
        assert pt.name == rt.name == f"{arch}:{name}"
        assert pt.model_flops_per_step == rt.model_flops_per_step, name
        assert pt.notes == rt.notes, name
        assert len(pt.abstract_args) == len(rt.abstract_args), name
        for i, (ra, pa) in enumerate(zip(rt.abstract_args, pt.abstract_args)):
            if i == 0 and rspec.family != "recsys" or (
                    rspec.family == "recsys" and hasattr(ra, "opt_state")):
                if hasattr(ra, "opt_state"):       # a TrainState
                    want = _ref_state_leaves(ra, rspec.family, rspec.model)
                else:                              # serving parameters
                    want = (_unstacked(_ref_leaves(ra), rspec.model)
                            if rspec.family == "lm" else _ref_leaves(ra))
                assert _port_leaves(pa) == want, (name, i)
            elif rspec.family == "gnn":
                want, ints = _ref_graph_leaves(ra)
                got = {k: v for k, v in _port_leaves(pa).items()}
                assert got == want, name
                assert (pa.n_nodes, pa.n_graphs) == ints
            else:                                  # batch, cache, ids
                assert _port_leaves(pa) == (
                    _ref_leaves(ra) if isinstance(ra, dict)
                    else {"": _ref_leaves({"x": ra})["x"]}), (name, i)
        # Every argument leaf has a placement.
        for a, pl in zip(pt.abstract_args, pt.placements):
            assert set(pl) == {n for n, _ in tasks.named_tensors(a)}


def _ref_placements(ref_params, cfg, mesh) -> dict:
    """{port leaf name: placements} by the reference's rules."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_params)
    for path, leaf in flat:
        name = ref_tasks._path_str(path)
        spec = ref_tasks._lm_param_spec(name, leaf)
        if not ref_tasks._divisible(leaf.shape, spec, mesh):
            spec = ref_tasks.P()
        spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        names = [name]
        parts = name.split("/")
        if parts[0] == "layers":  # a stacked period position
            assert spec[0] is None
            spec = spec[1:]
            names = ["/".join(["layers", str(p * cfg.period + int(parts[1]))]
                              + parts[2:]) for p in range(cfg.n_periods)]
        pls = []
        for axis in mesh.mesh_dim_names:
            dims = [i for i, e in enumerate(spec)
                    if axis in (e if isinstance(e, tuple) else (e,))]
            pls.append(Shard(dims[0]) if dims else Replicate())
        for n in names:
            out[n] = tuple(pls)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get_config(a).family == "lm"])
def test_lm_placements_equal_reference_spec(arch, mesh):
    rt, pt = _arch_tasks(arch)["prefill_32k"]
    cfg = configs.get_config(arch).model
    stand_in = MESHES[mesh]
    want = _ref_placements(rt.abstract_args[0], cfg, stand_in)
    got = tasks.lm_param_placements(pt.abstract_args[0], stand_in)
    assert got == want
    # Some leaf falls back to replicated only where the rules say so.
    assert any(any(isinstance(p, Shard) for p in pl) for pl in got.values())


def test_lm_batch_cache_placements_on_meshes():
    """The reference's batch, cache and token placements, with the
    long-context branch (batch 1: the KV sequence over every axis)."""
    pspec = configs.get_config("gemma3-12b", smoke=True)
    for mesh in MESHES.values():
        dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
        dp_size = math.prod(mesh.shape[a] for a in dp)
        t = tasks.build_task(pspec, pspec.shape("decode_32k"), mesh)
        k = t.placements[1]["k"]
        assert k == tuple(Shard(1) if a in dp else Shard(2)
                          for a in mesh.mesh_dim_names)
        assert t.placements[2][""] == tuple(
            Shard(0) if a in dp else Replicate()
            for a in mesh.mesh_dim_names)
        assert 128 % dp_size == 0
        t = tasks.build_task(pspec, pspec.shape("long_500k"), mesh)
        assert t.placements[1]["k"] == (Shard(2),) * len(mesh.dims)
        assert t.placements[2][""] == (Replicate(),) * len(mesh.dims)
        assert t.out_placements["0"] == tuple(
            Shard(1) if a == "model" else Replicate()
            for a in mesh.mesh_dim_names)
        t = tasks.build_task(pspec, pspec.shape("train_4k"), mesh)
        assert t.placements[1]["tokens"] == tuple(
            Shard(0) if a in dp else Replicate()
            for a in mesh.mesh_dim_names)
        assert t.placements[0]["opt_state/step"] == (Replicate(),) * len(
            mesh.dims)


def test_per_device_memory_from_placements():
    """A leaf cut 256 ways holds a 256th on each device."""
    pspec = configs.get_config("llama3.2-1b", smoke=True)
    t = tasks.build_task(pspec, pspec.shape("prefill_32k"), MESHES["single"])
    t.trace()
    mem = t.memory_per_device()
    params = t.abstract_args[0]
    pls = tasks.lm_param_placements(params, MESHES["single"])
    want = sum(-(-(x.numel() * 4) // tasks.shard_factor(pls[n], MESHES[
        "single"])) for n, x in tasks.named_tensors(params))
    want += -(-(32 * 32768 * 4) // 16)      # the tokens, over 'data'
    assert mem["argument"] == want
    assert mem["temp"] is None              # the global step: not known


def test_train_flops_equal_hand_reckoning():
    """llama3.2-1b smoke's ``train_4k`` (8 micro-batches of 32 x 4,096
    traced as one, scaled): its matrix products (forward, and twice
    that backward; the chunked cross entropy recomputed in its backward)
    and K4's work (4 D a kept pair forward, 10 D backward)."""
    spec = configs.get_config("llama3.2-1b", smoke=True)
    cfg = spec.model
    assert not cfg.remat and cfg.moe is None
    dims = spec.shape("train_4k").dims
    accum, seq = dims["accum_steps"], dims["seq_len"]
    b = dims["global_batch"] // accum
    t = b * seq
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * t * d * (h * hd) * 2 + 2 * t * d * (kvh * hd) * 2
    ffn = 3 * 2 * t * d * cfg.d_ff
    pairs = b * h * seq * (seq + 1) // 2
    per_layer = 3 * (proj + ffn) + 4 * hd * pairs + 10 * hd * pairs
    ce = 4 * 2 * t * d * cfg.vocab
    want = accum * (cfg.n_layers * per_layer + ce)
    task = tasks.build_task(spec, spec.shape("train_4k"), ONE)
    got = task.trace().flops
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert task.trace().kernel_calls == {"flash": accum * cfg.n_layers,
                                         "flash_bwd": accum * cfg.n_layers}


def test_trace_leaves_the_models_constant_caches_alone():
    """A trace neither drops the CG tables a real run cached (on the
    card they are device memory) nor leaves a fake one behind."""
    from repro_torch.kernels import is_fake
    from repro_torch.models.gnn import equivariant

    cpu = torch.device("cpu")
    real = equivariant._cg_const(1, 1, 0, cpu)
    before = equivariant._cg_const.cache_info().currsize
    spec = configs.get_config("nequip", smoke=True)
    task = tasks.build_task(spec, spec.shape("molecule"), ONE)
    assert task.trace().kernel_calls["segsum"] > 0
    assert equivariant._cg_const.cache_info().currsize == before
    assert equivariant._cg_const(1, 1, 0, cpu) is real
    assert not is_fake(equivariant._cg_const(1, 1, 1, cpu))


SHARDED = """
import json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_fake_world
from repro_torch.launch.tasks import build_task

init_fake_world(16)
try:
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                      mesh_dim_names=("data", "model"))
    spec = get_config("gat-cora", smoke=True)
    task = build_task(spec, spec.shape("full_graph_sm"), mesh,
                      exec_mode="edge_sharded")
    trace = task.trace()
    params = task.abstract_args[0].params
    print(json.dumps({
        "records": [[r.kind, r.nbytes] for r in trace.collectives],
        "n_nodes": task.abstract_args[1].n_nodes,
        "edges": int(task.abstract_args[1].edge_src.shape[0]),
        "param_numel": sum(p.numel() for layer in params["layers"]
                           for p in layer.values()),
        "per_device": task.per_device, "notes": task.notes}))
finally:
    dist.destroy_process_group()
"""


def test_edge_sharded_gat_collectives_on_fake_world():
    proc = subprocess.run(
        [sys.executable, "-c", SHARDED], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["per_device"] is True
    n = out["n_nodes"]
    assert (n, out["edges"]) == (2720, 10560)   # padded to 16's multiples
    assert out["notes"] == "padded nodes=2720 edges=10560 exec=edge_sharded"
    cfg = configs.get_config("gat-cora", smoke=True).model
    # A layer: segment_softmax's max merge (the max and its tie counts,
    # int32) and denominator merge, both [N, H], then the message sum
    # [N, H, D]; backward: the cotangent of each merge's output, in the
    # reverse order.  Last, the gradients' one all-reduce.
    fwd, bwd = [], []
    for heads, width in ((cfg.n_heads, cfg.d_hidden), (1, 7)):
        fwd += [4 * n * heads, 4 * n * heads, 4 * n * heads,
                4 * n * heads * width]
        bwd = [4 * n * heads * width, 4 * n * heads, 4 * n * heads] + bwd
    want = fwd + bwd + [4 * out["param_numel"]]
    records = out["records"]
    assert [k for k, _ in records] == ["all-reduce"] * len(want)
    assert [b for _, b in records] == want
    from repro_torch.roofline.analysis import (CollectiveRecord,
                                               collective_stats)
    stats = collective_stats([CollectiveRecord(k, b) for k, b in records])
    assert stats.counts["all-reduce"] == 2 * 7 + 1
    assert stats.total_bytes == 2 * sum(want)


# --------------------------------------------------------------------------
# the partitioned dense LM on the fake world (tests/torch_fake_world_cells.py)
# --------------------------------------------------------------------------

sys.path.insert(0, os.path.dirname(__file__))
from torch_fake_world_cells import (DENSE_CELLS, GNN_CELLS,  # noqa: E402
                                    GNN_FLOPS_RATIO, MOE_CELLS,
                                    RECSYS_CELLS, fake_world_cells,
                                    hold_partitioned, recsys_flops_ratio)

FULL_CELLS = ("llama3.2-1b:prefill_32k", "llama3.2-1b:decode_32k")
MOE_FULL = "qwen3-moe-235b-a22b:prefill_32k"
GNN_FULL = "gat-cora:ogb_products"


@pytest.fixture(scope="module")
def single_cells():
    return fake_world_cells("single", "--full", *FULL_CELLS, MOE_FULL,
                            GNN_FULL)


@pytest.fixture(scope="module")
def one_cells():
    return fake_world_cells("one")


@pytest.mark.parametrize("cell", DENSE_CELLS)
def test_dense_lm_cell_is_partitioned_on_the_single_pod_mesh(single_cells,
                                                             cell):
    hold_partitioned(single_cells[cell])
    assert single_cells[cell]["groups"] == [16]


@pytest.mark.parametrize("cell", MOE_CELLS)
def test_moe_lm_cell_is_partitioned_on_the_single_pod_mesh(single_cells,
                                                           cell):
    """Each MoE cell on the 16 x 16 mesh: one device's own program, its
    work at least its share of the global step's and at most the whole
    step (``torch_fake_world_cells``: the smoke configs' global route
    and experts that do not divide 'model' replicate it), the
    partitioner's collectives over 16 ranks, every argument byte, a
    temp."""
    r = single_cells[cell]
    hold_partitioned(r, most=r["devices"])
    assert single_cells[cell]["groups"] == [16]


@pytest.mark.parametrize("cell", FULL_CELLS)
def test_full_width_llama_counts_each_flop_once(single_cells, cell):
    """At full width every head divides 'model' (32 heads, 8 KV heads
    sliced per rank): the devices' work is the global step's."""
    r = single_cells[f"{cell}@full"]
    hold_partitioned(r)
    assert abs(r["flops"] * 256 / r["global_flops"] - 1) <= 1e-2


def test_full_width_moe_prefill_counts_each_flop_once(single_cells):
    """qwen3-moe-235b-a22b's prefill at full width on 16 x 16: 32 groups,
    two a data rank, 8 experts a ``model`` rank, 4 query heads and the
    KV head they read.  The devices' work is the global step's but for
    the router's logits, which every ``model`` rank computes for its
    tokens (the JAX layout: tokens whole over ``model``): 15 more copies
    of 2 t d E a layer."""
    r = single_cells[f"{MOE_FULL}@full"]
    hold_partitioned(r)
    cfg = configs.get_config("qwen3-moe-235b-a22b").model
    dims = configs.get_config("qwen3-moe-235b-a22b").shape(
        "prefill_32k").dims
    t = dims["global_batch"] * dims["seq_len"]
    router = 2 * t * cfg.d_model * cfg.moe.n_experts * cfg.n_layers
    want = 1 + 15 * router / r["global_flops"]
    assert abs(r["flops"] * 256 / r["global_flops"] - want) <= 1e-6 * want


@pytest.mark.parametrize("cell", RECSYS_CELLS)
def test_recsys_cell_is_partitioned_on_the_single_pod_mesh(single_cells,
                                                           cell):
    """BERT4Rec's cells at full size on the 16 x 16 mesh: one device's own
    program, its FLOPs times 256 within 1e-6 of the reckoning of
    ``recsys_flops_ratio`` over the global trace's (16 for the train
    step, whose encode runs on every ``model`` rank; 1 for serving; about
    82 for retrieval, whose one sequence every device encodes), the
    train step's and retrieval's collectives over 16 ranks and none in
    serving, and no all-gather of the item table."""
    r = single_cells[cell]
    serve = "serve" in cell
    hold_partitioned(r, most=r["devices"], collectives=not serve)
    ratio = r["flops"] * r["devices"] / r["global_flops"]
    want = recsys_flops_ratio(cell, r["devices"], 16)
    assert abs(ratio - want) <= 1e-6 * want, (ratio, want)
    assert r["groups"] == ([] if serve else [16])
    cfg = configs.get_config("bert4rec").model
    assert r["all_gather_bytes"] < cfg.vocab * cfg.embed_dim * 4 / 16


def _hold_gnn_row(r):
    """A GNN ``pjit`` cell on 16 x 16: one device's own program, its FLOPs
    times 256 within 1e-6 of the reckoning (``GNN_FLOPS_RATIO``), the
    partitioner's collectives over the 256 ranks of the flattened axes
    (one group, not one a mesh dim), and every all-gather a node array's
    (its rows the padded node count): none of an ``[E, ...]`` array."""
    hold_partitioned(r, most=1 + 1e-6)
    ratio = r["flops"] * r["devices"] / r["global_flops"]
    assert abs(ratio - GNN_FLOPS_RATIO) <= 1e-6 * GNN_FLOPS_RATIO, ratio
    assert r["groups"] == [256]
    n_nodes, n_edges = r["graph"]
    assert n_edges not in r["all_gather_rows"]
    assert r["all_gather_rows"] == [n_nodes]
    assert "exec=pjit" in r["notes"]


@pytest.mark.parametrize("cell", GNN_CELLS)
def test_gnn_cell_is_partitioned_on_the_single_pod_mesh(single_cells, cell):
    """Each GNN smoke cell (gat-cora, PNA, NequIP, MACE on the four
    shapes) on the 16 x 16 mesh: the edges and node rows over both
    axes, node rows all-gathered for the gathers and each message sum
    reduce-scattered to the device's rows."""
    _hold_gnn_row(single_cells[cell])


def test_full_width_gat_ogb_products_is_partitioned(single_cells):
    """gat-cora at ``CONFIG`` on ``ogb_products`` (N padded to 2,449,152,
    E to 61,859,328) on 16 x 16: a device holds 241,638 edges and a few
    GB of temp (its largest items the all-gathered ``h`` and the
    ``[N, 64]`` partials, 627 MB each)."""
    r = single_cells[f"{GNN_FULL}@full"]
    _hold_gnn_row(r)
    assert r["graph"] == [2_449_152, 61_859_328]
    assert 627e6 < r["memory"]["temp"] < 5e9


@pytest.mark.parametrize("cell", DENSE_CELLS + MOE_CELLS + RECSYS_CELLS
                         + GNN_CELLS)
def test_one_by_one_mesh_equals_the_global_trace(one_cells, cell):
    """On a 1 x 1 mesh the device's program is the whole step: its FLOPs
    equal the global trace's within 1%, with no collective."""
    r = one_cells[cell]
    assert r["per_device"] is True and r["partitioned"] is True
    assert abs(r["flops"] / r["global_flops"] - 1) <= 1e-2
    assert r["kinds"] == []
    assert r["argument_bytes"] == r["placed_argument_bytes"]
