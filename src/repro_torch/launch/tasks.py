"""Task builders: (arch x shape x mesh) -> a traceable step and its
placements, the counterpart of the JAX package's ``repro.launch.tasks``.

``build_task`` is the one entry the dry-run and the roofline share.
``input_specs`` returns fake-tensor stand-ins for every input of a cell:
full shapes and dtypes, no memory.  Abstract parameters come from the
real initializers run under the task's ``FakeTensorMode`` (the
counterpart of ``jax.eval_shape``), so the dry-run traces exactly what a
real launch would run.

Where the JAX package gives each leaf a ``NamedSharding`` and lets XLA
partition the step, the port names each leaf's placement (a tuple of
``Shard(i)`` / ``Replicate()``, one per mesh dimension, as a DTensor
takes them) by the JAX package's rules (``_lm_param_spec``,
``_divisible``), and traces:

* one device's own program of an LM cell (dense or MoE; train,
  prefill, decode) or a BERT4Rec cell (train, serve, retrieval) on a
  ``DeviceMesh``: its arguments are DTensors under those
  placements (fake ones on the dry-run's fake world,
  ``launch.mesh.init_fake_world``), the step runs on rank 0's own
  shards with the collectives DTensor and the model's partitioned
  forms issue (``models.sharding``), and its results are laid out as
  the JAX package's ``out_shardings`` say.  ``Task.run`` is the same
  step on real tensors (distributed by the placements) over a real
  mesh: the counterpart of calling the JAX package's compiled
  ``Task.lower()``;
* one device's own program of a GNN ``pjit`` cell (gat-cora, PNA,
  NequIP, MACE) on a ``DeviceMesh`` the same way: the edges and the
  node arrays over the mesh's flattened axes, each rank on its own
  edges and node rows (node rows all-gathered for the gathers, message
  sums reduce-scattered to the rank's rows), the state replicated;
* one device's own program of the edge-sharded GNN step
  (``exec_mode="edge_sharded"``), rank 0 of the mesh's flattened group
  on a fake world, counting the collectives the port's own code issues;
* the whole global step on one fake device for any cell on a stand-in
  of a mesh (an object with ``mesh_dim_names`` and ``size``, no
  ranks): the placements then give each device's arguments and
  outputs, and the trace the step's work; on a one-device mesh that is
  the device's own program.

Differences from the JAX package, each on purpose:

* leaves are the port's (one block a layer, ``train.tree``'s names),
  and ``_lm_param_spec`` gives their specs without the period axis the
  JAX package stacks;
* an accumulated LM train step is traced one micro-batch at a time and
  every additive count scaled by ``accum_steps``, as the JAX package's
  dry-run scales its variants (``Task.trace``: the trace holds one
  micro-batch's step, not the gather of the batch's token ids that
  ``train.step._micro_batches`` cuts partitioned micro-batches from);
* ``recsys_train`` composes BERT4Rec's step with ``accum_steps`` 1 (the
  port's micro-batching cuts every leaf on dim 0, the shared negatives
  too), as the JAX package does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.launch.mesh import (dp_axes, flat_axes, mesh_size,
                                     total_devices)
from repro_torch.models.sharding import is_dtensor, placements
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.roofline.analysis import named_tensors


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # Constants made from numpy inside a model (the CG tables) enter as
    # real tensors.
    return FakeTensorMode(allow_non_fake_inputs=True)


def _sds(fake_mode, shape, dtype) -> torch.Tensor:
    with fake_mode:
        return torch.empty(tuple(shape), dtype=dtype)


def _pad_up(n: int, m: int) -> int:
    return -(-n // m) * m


def is_device_mesh(mesh) -> bool:
    """Is ``mesh`` a ``DeviceMesh`` (ranks a step can run on), not a
    stand-in of its shape?"""
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def distribute_tree(tree, pls: dict[str, tuple], mesh):
    """``tree`` (global tensors, real or fake, the same on every rank)
    with each leaf a DTensor under its placements ``pls[name]``
    (``named_tensors``' names: a dataclass leaf, a ``GraphBatch``, by
    its tensor fields); a leaf that required a gradient still does."""
    from repro_torch.models.sharding import distribute
    from repro_torch.train.tree import named_leaves, path_str, unflatten

    def put(leaf, name):
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            # a GraphBatch: its tensor fields, named as ``named_tensors``
            pre = f"{name}/" if name else ""
            return dataclasses.replace(leaf, **{
                f.name: put(getattr(leaf, f.name), pre + f.name)
                for f in dataclasses.fields(leaf)
                if isinstance(getattr(leaf, f.name), torch.Tensor)})
        return distribute(leaf, mesh, pls[name])

    named = named_leaves(tree)
    out = unflatten(tree, [put(t, path_str(name)) for name, t in named])
    for (_, new), (_, old) in zip(named_leaves(out), named):
        if isinstance(old, torch.Tensor) and old.requires_grad:
            new.requires_grad_(True)
    return out


def _laid_out(result, pls: dict[str, tuple], mesh):
    """``result`` (a tuple of tensors and dicts of them) with every
    DTensor leaf redistributed to its placements ``pls[name]``: the JAX
    package's ``out_shardings``."""
    from repro_torch.models.layers import ParamTree

    def put(x, name):
        pre = f"{name}/" if name else ""
        if isinstance(x, dict):
            return {k: put(v, pre + k) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(put(getattr(x, f), pre + f) for f in x._fields))
        if isinstance(x, ParamTree):
            return x  # updated in place: laid out as it was
        if isinstance(x, tuple):
            return tuple(put(v, pre + str(i)) for i, v in enumerate(x))
        if is_dtensor(x) and tuple(x.placements) != pls[name]:
            return x.redistribute(mesh, pls[name])
        return x

    return put(result, "")


def _placed(mesh, fake_mode, tree, pls: dict[str, tuple]):
    """``tree`` as DTensors under ``pls`` (made under ``fake_mode``) on a
    ``DeviceMesh``; itself on a stand-in of one."""
    if not is_device_mesh(mesh):
        return tree
    with fake_mode:
        return distribute_tree(tree, pls, mesh)


def _laid_out_step(mesh, fn, out_pls: dict[str, tuple]):
    """``fn`` with its results laid out by ``out_pls`` (``_laid_out``) on
    a ``DeviceMesh``; ``fn`` itself on a stand-in of one."""
    if not is_device_mesh(mesh):
        return fn
    return lambda *a: _laid_out(fn(*a), out_pls, mesh)


def _tree_placements(tree, mesh, rule) -> dict[str, tuple]:
    """``{leaf name: placements}`` of ``tree``, each leaf's spec from
    ``rule(name, leaf)``."""
    return {name: placements(rule(name, leaf), mesh)
            for name, leaf in named_tensors(tree)}


def _replicated(tree, mesh) -> dict[str, tuple]:
    return _tree_placements(tree, mesh, lambda name, leaf: ())


def shard_factor(pl: tuple, mesh) -> int:
    """Ways a leaf with placements ``pl`` is cut across ``mesh``."""
    from torch.distributed.tensor import Shard

    return math.prod(int(mesh.size(i)) for i, p in enumerate(pl)
                     if isinstance(p, Shard))


def _device_bytes(t: torch.Tensor, pl: tuple, mesh) -> int:
    return -(-(t.numel() * t.element_size()) // shard_factor(pl, mesh))


def per_device_bytes(tree, pls: dict[str, tuple], mesh) -> float:
    """Bytes of ``tree`` one device holds under the placements ``pls``
    (leaves named as ``named_tensors`` names them)."""
    return float(sum(_device_bytes(t, pls[name], mesh)
                     for name, t in named_tensors(tree)))


@dataclasses.dataclass
class Task:
    """Everything needed to trace one (arch x shape x mesh) cell."""

    name: str
    fn: Callable                      # closed over static config
    abstract_args: tuple              # fake tensors (trees)
    placements: tuple                 # per arg, {leaf name: placements}
    out_placements: dict              # {result leaf name: placements}
    mesh: Any
    fake_mode: Any
    # analysis metadata
    model_flops_per_step: float = 0.0
    notes: str = ""
    # The trace is one device's own program (a partitioned cell, a
    # 1-device mesh, the edge-sharded step), not the whole global step.
    per_device: bool = False
    # The args are DTensors and ``run`` distributes real ones.
    partitioned: bool = False
    # An accumulated train step: ``(step of one micro-batch, its args,
    # accum_steps)``; traced once, its additive counts scaled.
    micro: tuple | None = None
    _trace: Any = None
    _result: Any = None

    @property
    def n_devices(self) -> int:
        return total_devices(self.mesh)

    def trace(self):
        """Run the step under the task's ``FakeTensorMode`` and a
        ``roofline.analysis.TraceCounter``: the ``Trace`` (cached)."""
        if self._trace is None:
            from repro_torch.roofline.analysis import TraceCounter

            fn, args, scale = self.micro or (self.fn, self.abstract_args, 1)
            with _model_caches():
                result, trace = TraceCounter().run(fn, args, self.fake_mode)
            if scale > 1:
                trace.flops *= scale
                trace.bytes *= scale
                trace.collectives = trace.collectives * scale
                trace.kernel_calls = {k: v * scale for k, v in
                                      trace.kernel_calls.items()}
            self._trace, self._result = trace, result
        return self._trace

    def distribute(self, args) -> tuple:
        """Real global arguments (the same on every rank of the mesh) as
        a partitioned cell's DTensors, under the task's placements."""
        if not self.partitioned:
            raise ValueError(f"{self.name} is not partitioned")
        return tuple(distribute_tree(a, pl, self.mesh)
                     for a, pl in zip(args, self.placements))

    def run(self, *args):
        """The partitioned step on real global arguments: each rank runs
        its own shards (the counterpart of calling the JAX package's
        compiled step); the results as ``out_placements`` lay them
        out."""
        return self.fn(*self.distribute(args))

    def memory_per_device(self) -> dict[str, float]:
        """Arguments, outputs and aliased outputs a device holds, from
        the placements (bytes), after ``trace``."""
        from repro_torch.roofline.analysis import local_tensor

        trace = self.trace()
        args = sum(per_device_bytes(a, pl, self.mesh)
                   for a, pl in zip(self.abstract_args, self.placements))
        arg_ids = {id(local_tensor(t).untyped_storage())
                   for a in self.abstract_args for _, t in named_tensors(a)}
        alias = sum(_device_bytes(t, self.out_placements[name], self.mesh)
                    for name, t in named_tensors(self._result)
                    if id(local_tensor(t).untyped_storage()) in arg_ids)
        return {"argument": args,
                "output": per_device_bytes(self._result,
                                           self.out_placements, self.mesh),
                "alias": float(alias),
                "temp": trace.temp_bytes if self.per_device else None}


@contextlib.contextmanager
def _model_caches():
    """Bypass the models' per-device constant caches (the CG tables)
    while a trace runs: a constant made under a ``FakeTensorMode`` is
    fake, and a real run of the same device in this process, or a later
    trace under another mode, must not find it.  The caches themselves,
    and what real runs put there (on the card too), stay as they
    were."""
    from repro_torch.models.gnn import equivariant

    cached = equivariant._cg_const
    equivariant._cg_const = cached.__wrapped__
    try:
        yield
    finally:
        equivariant._cg_const = cached


# ==========================================================================
# LM family
# ==========================================================================

def _lm_param_spec(path_str: str, leaf) -> tuple:
    """FSDP (d_model over 'data') x TP (heads/ff/vocab over 'model'), the
    JAX package's rules on the port's leaves (one block a layer: no
    leading period axis)."""
    if "embed/table" in path_str or "item_embed" in path_str:
        return ("model", "data")
    if "lm_head" in path_str:
        return ("data", "model")
    if any(k in path_str for k in ("wq/", "wk/", "wv/")):
        return ("data", "model")
    if "wo/" in path_str:
        return ("model", "data")
    if "moe/router" in path_str:
        return ("data", None)
    if "moe/w_gate" in path_str or "moe/w_up" in path_str:
        return ("model", "data", None)
    if "moe/w_down" in path_str:
        return ("model", None, "data")
    if "shared/w_gate" in path_str or "shared/w_up" in path_str:
        return ("data", "model")
    if "shared/w_down" in path_str:
        return ("model", "data")
    if "ffn/w_gate" in path_str or "ffn/w_up" in path_str:
        return ("data", "model")
    if "ffn/w_down" in path_str:
        return ("model", "data")
    return ()  # norms, biases, scalars


def _divisible(shape, spec: tuple, mesh) -> bool:
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        k = math.prod(mesh_size(mesh, a) for a in axes)
        if dim % k != 0:
            return False
    return True


def _lm_leaf_spec(path_str: str, leaf, mesh) -> tuple:
    spec = _lm_param_spec(path_str, leaf)
    if not _divisible(leaf.shape, spec, mesh):
        spec = ()  # fallback: replicate (guard, not expected)
    return spec


def lm_param_placements(params_abs, mesh) -> dict[str, tuple]:
    """``{leaf name: placements}`` of an LM's parameters (or of a state
    holding them: the rules match by substring)."""
    return _tree_placements(params_abs, mesh,
                            lambda name, leaf: _lm_leaf_spec(name, leaf,
                                                             mesh))


@functools.lru_cache(maxsize=1)
def _abstract_lm_params(cfg):
    """``(fake mode, fake parameters)`` of ``cfg`` from the real
    initializer.  Kept for the last config: the dry-run builds an arch's
    cells one after the other, and its shapes share the parameters."""
    from repro_torch.models.transformer import init_params

    mode = _fake_mode()
    with mode:
        params = init_params(torch.Generator(), cfg)
    return mode, params


def build_lm_task(spec: ArchSpec, shape: ShapeSpec, mesh,
                  accum_steps: int = 1) -> Task:
    """The LM cell's task (dense or MoE): partitioned on a
    ``DeviceMesh``, the whole global step on a stand-in of one
    (``launch.mesh.mesh_shape``)."""
    from repro_torch.models import transformer as tfm

    cfg = spec.model
    dims = shape.dims
    dp = dp_axes(mesh)
    name = f"{spec.arch_id}:{shape.name}"
    partitioned = is_device_mesh(mesh)
    per_device = partitioned or total_devices(mesh) == 1

    if shape.kind == "train":
        seq, batch = dims["seq_len"], dims["global_batch"]
        accum = dims.get("accum_steps", accum_steps)
        loss = lambda p, b: tfm.loss_fn(p, cfg, b)  # noqa: E731
        step = make_train_step(loss, AdamWConfig(), accum)
        mode, params_abs = _abstract_lm_params(cfg)
        with mode:
            state_abs = init_train_state(params_abs)
        batch_abs = {
            "tokens": _sds(mode, (batch, seq), torch.int32),
            "labels": _sds(mode, (batch, seq), torch.int32),
        }
        state_pl = lm_param_placements(state_abs, mesh)
        batch_pl = {k: placements((dp, None), mesh) for k in batch_abs}
        metrics_pl = {k: placements((), mesh)
                      for k in ("grad_norm", "loss", "lr")}
        state_abs = _placed(mesh, mode, state_abs, state_pl)
        out_pl = {**_prefixed("0", state_pl), **_prefixed("1", metrics_pl)}
        micro = None
        if accum > 1:
            n = batch // accum
            micro_step = make_train_step(loss, AdamWConfig(), 1)
            micro = (_laid_out_step(mesh, micro_step, out_pl),
                     (state_abs, _placed(mesh, mode, {
                         k: v[:n] for k, v in batch_abs.items()}, batch_pl)),
                     accum)
        batch_abs = _placed(mesh, mode, batch_abs, batch_pl)
        model_flops = 3 * 2 * tfm.active_param_count(cfg) * batch * seq
        return Task(
            name=name, fn=_laid_out_step(mesh, step, out_pl),
            abstract_args=(state_abs, batch_abs),
            placements=(state_pl, batch_pl),
            out_placements=out_pl,
            mesh=mesh, fake_mode=mode,
            model_flops_per_step=model_flops,
            notes=f"accum_steps={accum}",
            per_device=per_device, partitioned=partitioned, micro=micro,
        )

    if shape.kind == "prefill":
        seq, batch = dims["seq_len"], dims["global_batch"]
        mode, params_abs = _abstract_lm_params(cfg)
        p_pl = lm_param_placements(params_abs, mesh)
        tokens_abs = _sds(mode, (batch, seq), torch.int32)

        def fn(p, t):
            with torch.no_grad():
                return tfm.prefill(p, cfg, t)

        # the sequence dim sharded over 'model': the split-KV layout
        # decode consumes.
        cache_pl = placements((None, dp, "model", None, None), mesh)
        tokens_pl = {"": placements((dp, None), mesh)}
        out_pl = {"0": placements((dp, "model"), mesh),
                  "1/k": cache_pl, "1/v": cache_pl}
        model_flops = 2 * tfm.active_param_count(cfg) * batch * seq
        return Task(
            name=name, fn=_laid_out_step(mesh, fn, out_pl),
            abstract_args=(_placed(mesh, mode, params_abs, p_pl),
                           _placed(mesh, mode, tokens_abs, tokens_pl)),
            placements=(p_pl, tokens_pl),
            out_placements=out_pl,
            mesh=mesh, fake_mode=mode,
            model_flops_per_step=model_flops, per_device=per_device,
            partitioned=partitioned,
        )

    if shape.kind == "decode":
        seq, batch = dims["seq_len"], dims["global_batch"]
        mode, params_abs = _abstract_lm_params(cfg)
        p_pl = lm_param_placements(params_abs, mesh)
        with mode:
            cache_abs = tfm.init_cache(cfg, batch, seq, device="cpu")
        dp_size = math.prod(mesh_size(mesh, a) for a in dp)
        if batch >= dp_size:
            # batch carries DP; KV sequence split over 'model' (split-KV)
            cache_spec = (None, dp, "model", None, None)
        else:
            # long-context: batch tiny; sequence-parallel KV over all axes
            cache_spec = (None, None, tuple(mesh.mesh_dim_names), None, None)
        if not _divisible(cache_abs["k"].shape, cache_spec, mesh):
            cache_spec = (None, dp, None, None, None)
        cache_pl = placements(cache_spec, mesh)
        token_abs = _sds(mode, (batch,), torch.int32)
        token_spec = (dp,) if batch % dp_size == 0 else ()
        pos_abs = _sds(mode, (), torch.int32)

        def fn(p, c, t, pos):
            with torch.no_grad():
                return tfm.serve_step(p, cfg, c, t, pos)

        logits_spec = (dp, "model") if token_spec else (None, "model")
        model_flops = 2 * tfm.active_param_count(cfg) * batch
        pls = (p_pl, {"k": cache_pl, "v": cache_pl},
               {"": placements(token_spec, mesh)}, {"": placements((), mesh)})
        out_pl = {"0": placements(logits_spec, mesh),
                  "1/k": cache_pl, "1/v": cache_pl}
        return Task(
            name=name, fn=_laid_out_step(mesh, fn, out_pl),
            abstract_args=tuple(
                _placed(mesh, mode, a, pl) for a, pl in zip(
                    (params_abs, cache_abs, token_abs, pos_abs), pls)),
            placements=pls,
            out_placements=out_pl,
            mesh=mesh, fake_mode=mode,
            model_flops_per_step=model_flops, per_device=per_device,
            partitioned=partitioned,
        )

    raise ValueError(f"unknown LM shape kind {shape.kind}")


def _prefixed(prefix: str, pls: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in pls.items()}


# ==========================================================================
# GNN family
# ==========================================================================

def _gnn_model_cfg(spec: ArchSpec, dims: dict):
    """Specialize the model config to the shape's feature/class dims."""
    m = spec.model
    if hasattr(m, "d_in"):
        m = dataclasses.replace(
            m, d_in=dims.get("d_feat", m.d_in),
            n_classes=dims.get("n_classes", m.n_classes),
        )
    return m


def _gnn_sizes(shape: ShapeSpec, n_dev: int) -> tuple[int, int, int]:
    """(n_nodes, n_edges, n_graphs) padded to device multiples."""
    d = shape.dims
    if "batch_nodes" in d:  # sampled minibatch: the device-side block
        seeds = d["batch_nodes"]
        f0, f1 = d["fanout0"], d["fanout1"]
        n_nodes = seeds * (1 + f0 + f0 * f1) + 1
        n_edges = seeds * (f0 + f0 * f1)
        n_graphs = 1
    elif "batch" in d:      # batched molecules
        n_graphs = d["batch"]
        n_nodes = d["n_nodes"] * n_graphs
        n_edges = d["n_edges"] * n_graphs
    else:
        n_nodes, n_edges, n_graphs = d["n_nodes"], d["n_edges"], 1
    return _pad_up(n_nodes, n_dev), _pad_up(n_edges, n_dev), n_graphs


def _gnn_model_flops(spec: ArchSpec, cfg, n_nodes: int,
                     n_edges: int) -> float:
    """Analytic fwd+bwd model FLOPs (~2x matmul-fwd x3 for training).
    Coarse (+-2x) — used only for the useful-ratio / roofline-fraction
    columns, documented as estimates."""
    if hasattr(cfg, "n_heads"):          # GAT family
        per_layer = (
            2 * n_nodes * cfg.d_in * cfg.n_heads * cfg.d_hidden
            + 4 * n_edges * cfg.n_heads * cfg.d_hidden
        )
        fwd = cfg.n_layers * per_layer
    elif hasattr(cfg, "d_in"):           # PNA family
        h = cfg.d_hidden
        per_layer = (
            4 * n_edges * cfg.d_in * h + 2 * n_nodes * (12 * h) * h
        )
        fwd = cfg.n_layers * per_layer
    else:  # equivariant (nequip / mace): has l_max
        from repro_torch.models.gnn.irreps import allowed_paths

        c = cfg.d_hidden
        paths = allowed_paths(cfg.l_max)
        tp = sum(
            2 * c * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
            for (l1, l2, l3) in paths
        )
        radial = 2 * (cfg.n_rbf * cfg.radial_hidden
                      + cfg.radial_hidden * len(paths) * c)
        mix = 2 * 2 * (cfg.l_max + 1) * c * c * 3
        per_layer = n_edges * (tp + radial) + n_nodes * mix
        if getattr(cfg, "kind", "") == "mace":
            per_layer += (
                (cfg.correlation_order - 1) * n_nodes * c * tp // c
            )
        fwd = cfg.n_layers * per_layer
    return 3.0 * fwd  # fwd+bwd


def flat_group(mesh):
    """A process group over every rank of ``mesh`` (the flattened axes
    the edge-sharded step cuts the edges over)."""
    import torch.distributed as dist

    return dist.new_group(mesh.mesh.flatten().tolist())


def build_gnn_task(spec: ArchSpec, shape: ShapeSpec, mesh,
                   exec_mode: str = "pjit") -> Task:
    """exec_mode: 'pjit' (the JAX package's placements: the edges and the
    node arrays over the mesh's flattened axes, the state and metrics
    replicated; partitioned on a ``DeviceMesh``, each rank running its
    own edges and node rows through the models' partitioned forms,
    ``sparse.gather.gather_nodes`` and ``sparse.segment``'s DTensor
    branches; the whole global step on a stand-in of one) or
    'edge_sharded' (``launch.gnn_sharded``'s step: the edges cut over
    the mesh's flattened group, node arrays and parameters replicated;
    traced as rank 0's own program, so the mesh must lie on an
    initialised world, a fake one in the dry-run).  ``n_nodes`` and
    ``n_graphs`` stay global, N and E padded to the device count."""
    from repro_torch.models.gnn import equivariant, gat, pna
    from repro_torch.models.gnn.graph import GraphBatch

    cfg = _gnn_model_cfg(spec, shape.dims)
    n_dev = total_devices(mesh)
    fa = flat_axes(mesh)
    n_nodes, n_edges, n_graphs = _gnn_sizes(shape, n_dev)
    name = f"{spec.arch_id}:{shape.name}"
    # prefix match: smoke configs carry a "-smoke" suffix
    is_equiv = spec.arch_id.startswith(("mace", "nequip"))
    mode = _fake_mode()

    def sds(shape_, dtype):
        return _sds(mode, shape_, dtype)

    edges = dict(edge_src=sds((n_edges,), torch.int32),
                 edge_dst=sds((n_edges,), torch.int32),
                 edge_mask=sds((n_edges,), torch.float32))
    if is_equiv:
        mod = equivariant
        batch_abs = GraphBatch(
            **edges, n_nodes=n_nodes,
            positions=sds((n_nodes, 3), torch.float32),
            species=sds((n_nodes,), torch.int32),
            node_mask=sds((n_nodes,), torch.float32),
            graph_ids=sds((n_nodes,), torch.int32),
            n_graphs=n_graphs,
            labels=sds((n_graphs,), torch.float32),
        )
        node_leaf_specs = {
            "positions": (fa, None), "species": (fa,),
            "node_mask": (fa,), "graph_ids": (fa,),
        }
        label_spec = ()
    else:
        mod = gat if spec.arch_id.startswith("gat") else pna
        d_feat = shape.dims.get("d_feat", 16)
        batch_abs = GraphBatch(
            **edges, n_nodes=n_nodes,
            node_feat=sds((n_nodes, d_feat), torch.float32),
            node_mask=sds((n_nodes,), torch.float32),
            graph_ids=sds((n_nodes,), torch.int32),
            n_graphs=n_graphs,
            labels=sds((n_nodes,), torch.int32),
        )
        node_leaf_specs = {
            "node_feat": (fa, None), "node_mask": (fa,),
            "graph_ids": (fa,),
        }
        label_spec = (fa,)

    with mode:
        params_abs = mod.init_params(torch.Generator(), cfg)
        state_abs = init_train_state(params_abs)
    partitioned = exec_mode == "pjit" and is_device_mesh(mesh)
    per_device = partitioned or n_dev == 1
    if exec_mode == "edge_sharded":
        from repro_torch.launch.gnn_sharded import make_edge_sharded_step

        step = make_edge_sharded_step(mod, cfg, flat_group(mesh))
        per_device = True
    else:
        loss = lambda p, b: mod.loss_fn(p, cfg, b)  # noqa: E731
        step = make_train_step(loss, AdamWConfig())

    def batch_spec(field, leaf):
        if field in GraphBatch.EDGE_FIELDS:
            return (fa,) if leaf.dim() == 1 else (fa, None)
        if exec_mode == "edge_sharded":
            return ()  # node arrays replicated (MESH repl. backend)
        if field in node_leaf_specs:
            return node_leaf_specs[field]
        if field == "labels":
            return label_spec
        return ()

    # The state replicated: its gradients are sums over every rank's own
    # edges and nodes, reduced before the update (``train.step``).
    state_pl = _replicated(state_abs, mesh)
    batch_pl = _tree_placements(batch_abs, mesh, batch_spec)
    metrics_pl = {k: placements((), mesh) for k in ("grad_norm", "loss", "lr")}
    out_pl = {**_prefixed("0", state_pl), **_prefixed("1", metrics_pl)}
    args = (state_abs, batch_abs)
    if partitioned:
        step = _laid_out_step(mesh, step, out_pl)
        args = (_placed(mesh, mode, state_abs, state_pl),
                _placed(mesh, mode, batch_abs, batch_pl))
    return Task(
        name=name, fn=step,
        abstract_args=args,
        placements=(state_pl, batch_pl),
        out_placements=out_pl,
        mesh=mesh, fake_mode=mode,
        model_flops_per_step=_gnn_model_flops(spec, cfg, n_nodes, n_edges),
        notes=f"padded nodes={n_nodes} edges={n_edges} exec={exec_mode}",
        per_device=per_device, partitioned=partitioned,
    )


# ==========================================================================
# RecSys family
# ==========================================================================

def own_rows_top_k(scores, k: int):
    """``(values, ids)`` of the ``k`` largest scores of each row:
    ``torch.topk``; for DTensor scores, each rank's over its own rows
    (``local_map``, the JAX package's ``shard_map`` of ``lax.top_k``),
    laid out as the scores' rows are (whole rows: the last dim uncut)."""
    if not is_dtensor(scores):
        return tuple(torch.topk(scores, k))
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(scores.placements)
    return local_map(lambda s: tuple(torch.topk(s, k)),
                     out_placements=(pl, pl), in_placements=(pl,),
                     device_mesh=scores.device_mesh)(scores)


def build_recsys_task(spec: ArchSpec, shape: ShapeSpec, mesh,
                      n_masked: int = 20, n_neg: int = 8192) -> Task:
    """BERT4Rec's cell: partitioned on a ``DeviceMesh`` (the JAX
    package's placements), the whole global step on a stand-in of
    one."""
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.models.sharding import constrain

    cfg = spec.model
    dims = shape.dims
    dp = dp_axes(mesh)
    fa = flat_axes(mesh)
    name = f"{spec.arch_id}:{shape.name}"
    mode = _fake_mode()
    partitioned = is_device_mesh(mesh)
    per_device = partitioned or total_devices(mesh) == 1
    with mode:
        params_abs = b4r.init_params(torch.Generator(), cfg)

    def param_spec(path_str, leaf):
        return ("model", None) if "item_embed" in path_str else ()

    repl = placements((), mesh)

    def _b4r_fwd_flops(batch: int) -> float:
        d = cfg.embed_dim
        s_len = cfg.max_seq
        per_block = (
            8 * s_len * d * d          # qkv+o proj
            + 4 * s_len * s_len * d    # scores + AV
            + 4 * s_len * d * cfg.d_ff_mult * d
        )
        return batch * cfg.n_blocks * per_block

    if shape.kind == "recsys_train":
        batch = dims["batch"]
        batch_abs = {
            "items": _sds(mode, (batch, cfg.max_seq), torch.int32),
            "masked_pos": _sds(mode, (batch, n_masked), torch.int32),
            "labels": _sds(mode, (batch, n_masked), torch.int32),
            "negatives": _sds(mode, (n_neg,), torch.int32),
        }
        loss = lambda p, b: b4r.loss_sampled(p, cfg, b)  # noqa: E731
        step = make_train_step(loss, AdamWConfig())
        with mode:
            state_abs = init_train_state(params_abs)
        # the table and its moments over 'model', the rest replicated
        state_pl = _tree_placements(state_abs, mesh, param_spec)
        batch_pl = {"items": placements((dp, None), mesh),
                    "masked_pos": placements((dp, None), mesh),
                    "labels": placements((dp, None), mesh),
                    "negatives": repl}
        metrics_pl = {k: repl for k in ("grad_norm", "loss", "lr")}
        out_pl = {**_prefixed("0", state_pl), **_prefixed("1", metrics_pl)}
        sampled_softmax = 2 * batch * n_masked * (1 + n_neg) * cfg.embed_dim
        return Task(
            name=name, fn=_laid_out_step(mesh, step, out_pl),
            abstract_args=(_placed(mesh, mode, state_abs, state_pl),
                           _placed(mesh, mode, batch_abs, batch_pl)),
            placements=(state_pl, batch_pl),
            out_placements=out_pl,
            mesh=mesh, fake_mode=mode,
            model_flops_per_step=3 * (_b4r_fwd_flops(batch)
                                      + sampled_softmax),
            per_device=per_device, partitioned=partitioned,
        )

    if shape.kind == "recsys_serve":
        batch = dims["batch"]
        items_abs = _sds(mode, (batch, cfg.max_seq), torch.int32)

        # serving shards the batch over EVERY axis and replicates the
        # table (the JAX package's layout); each device sorts only its
        # own rows' scores.
        def fn(p, items):
            with torch.no_grad():
                scores = b4r.serve_score(p, cfg, items)      # [B, V]
                scores = constrain(scores, "flat", None)
                return own_rows_top_k(scores, 100)

        p_pl = _replicated(params_abs, mesh)
        items_pl = {"": placements((fa, None), mesh)}
        out_pl = {"0": placements((fa, None), mesh),
                  "1": placements((fa, None), mesh)}
        return Task(
            name=name, fn=_laid_out_step(mesh, fn, out_pl),
            abstract_args=(_placed(mesh, mode, params_abs, p_pl),
                           _placed(mesh, mode, items_abs, items_pl)),
            placements=(p_pl, items_pl),
            out_placements=out_pl,
            mesh=mesh, fake_mode=mode,
            model_flops_per_step=_b4r_fwd_flops(batch)
            + 2 * batch * cfg.vocab * cfg.embed_dim,
            per_device=per_device, partitioned=partitioned,
        )

    if shape.kind == "recsys_retrieval":
        n_cand = dims["n_candidates"]
        items_abs = _sds(mode, (1, cfg.max_seq), torch.int32)
        cand_abs = _sds(mode, (_pad_up(n_cand, total_devices(mesh)),),
                        torch.int32)

        # the table over 'model' (training's layout), the candidates over
        # every axis: the scores gathered whole, one top-k over them all
        def fn(p, items, cand):
            with torch.no_grad():
                scores = constrain(b4r.retrieval_score(p, cfg, items, cand),
                                   None)
                vals, idx = torch.topk(scores, 100)
            return vals, idx

        p_pl = _tree_placements(params_abs, mesh, param_spec)
        pls = (p_pl, {"": repl}, {"": placements((fa,), mesh)})
        out_pl = {"0": repl, "1": repl}
        return Task(
            name=name, fn=_laid_out_step(mesh, fn, out_pl),
            abstract_args=tuple(
                _placed(mesh, mode, a, pl) for a, pl in zip(
                    (params_abs, items_abs, cand_abs), pls)),
            placements=pls,
            out_placements=out_pl,
            mesh=mesh, fake_mode=mode, per_device=per_device,
            partitioned=partitioned,
        )

    raise ValueError(f"unknown recsys shape kind {shape.kind}")


# ==========================================================================
# dispatch
# ==========================================================================

def build_task(spec: ArchSpec, shape: ShapeSpec, mesh, **kw) -> Task:
    if spec.family == "lm":
        return build_lm_task(spec, shape, mesh, **kw)
    if spec.family == "gnn":
        return build_gnn_task(spec, shape, mesh, **kw)
    if spec.family == "recsys":
        return build_recsys_task(spec, shape, mesh)
    raise ValueError(spec.family)


def input_specs(arch_id: str, shape_name: str, mesh=None, smoke=False):
    """Fake-tensor stand-ins for every model input of one cell (the
    documented dry-run entry point)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh

    mesh = mesh or make_production_mesh()
    spec = get_config(arch_id, smoke=smoke)
    task = build_task(spec, spec.shape(shape_name), mesh)
    return task.abstract_args
