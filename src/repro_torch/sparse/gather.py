"""Row gathers.  ``take_rows`` is ``jnp.take(table, ids, axis=0)`` in its
``fill`` mode, as the JAX package takes rows, shared by the LM's and
BERT4Rec's embeddings and by ``embedding_bag``.  ``gather_nodes`` and
``take_local`` are the GNN side's: a node array's rows picked by edge
ids, and a replicated table's rows picked by node ids; on DTensors each
runs on the rank's own edges or nodes (``local_map``)."""
from __future__ import annotations

import math

import torch

# ``models.sharding`` is imported where it is used: ``models`` imports
# this module (``layers.embed``).


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ``ids.shape + table.shape[1:]``,
    NaN rows for ids outside ``[-V, V)`` (floating tables).  Nothing is
    read back to the host."""
    n = table.shape[0]
    idx = torch.where(ids < 0, ids + n, ids)
    ok = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, max(n - 1, 0))]
    if not table.is_floating_point():
        return rows
    ok = ok.reshape(tuple(ok.shape) + (1,) * (table.dim() - 1))
    return torch.where(ok, rows, torch.full((), math.nan, dtype=rows.dtype,
                                            device=rows.device))


def clamped_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``ids`` as int64 by the JAX package's indexing rule: a negative id
    counts from the end, then every id is clamped into ``[0, n)``."""
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp_(0, max(n - 1, 0))


class _GatherRows(torch.autograd.Function):
    """``all_gather(x)[idx]`` over the 1-D mesh ``rows``: this rank's rows
    ``x`` gathered whole once, then indexed by its own ids.  Backward:
    the cotangent added into ``[N, ...]`` at the ids (``index_add_``),
    then one reduce-scatter back to this rank's rows."""

    @staticmethod
    def forward(ctx, x, idx, rows):
        from repro_torch.models.sharding import all_gather_rows

        ctx.save_for_backward(idx)
        ctx.rows = rows
        ctx.n = x.shape[0] * rows.size()
        return all_gather_rows(x, rows)[idx]

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.models.sharding import reduce_scatter_rows

        (idx,) = ctx.saved_tensors
        whole = grad.new_zeros((ctx.n,) + tuple(grad.shape[1:]))
        whole.index_add_(0, idx, grad)
        return reduce_scatter_rows(whole, ctx.rows), None, None


def _edge_layout(ids, n_rows: int):
    """``(mesh, placements, row mesh)`` of DTensor edge ids ``ids`` over
    node rows ``n_rows`` laid out as they are; raises where a cut is
    uneven (the task pads the nodes and edges to the device count)."""
    from repro_torch.models.sharding import row_mesh

    mesh, pl = ids.device_mesh, tuple(ids.placements)
    rows = row_mesh(mesh, pl)
    k = 1 if rows is None else rows.size()
    if ids.shape[0] % k or n_rows % k:
        raise ValueError(f"{ids.shape[0]} edges and {n_rows} nodes do not "
                         f"divide evenly over {k} ranks")
    return mesh, pl, rows


def _gather_partitioned(x, ids, jax_rule=False):
    """``gather_nodes`` of DTensors (see there); the ids taken by the JAX
    package's rule (``clamped_ids``) where ``jax_rule``, as they are
    (``x[ids]``) otherwise."""
    from torch.distributed.tensor.experimental import local_map

    n = x.shape[0]
    mesh, pl, rows = _edge_layout(ids, n)
    if tuple(x.placements) != pl:
        raise ValueError(f"node rows laid out {tuple(x.placements)}, edge "
                         f"ids {pl}: both must be cut over the same mesh "
                         "dims")

    def body(xl, il):
        return _take_rows_local(xl, clamped_ids(il, n) if jax_rule else il,
                                rows)

    return local_map(body, out_placements=list(pl), in_placements=(pl, pl),
                     device_mesh=mesh)(x, ids)


def _take_rows_local(xl, idx, rows):
    """Rows ``idx`` of the whole node array whose rows ``xl`` this rank
    holds (all of them where ``rows`` is None)."""
    return xl[idx] if rows is None else _GatherRows.apply(xl, idx, rows)


def gather_nodes(x: torch.Tensor, ids: torch.Tensor,
                 jax_rule: bool = False) -> torch.Tensor:
    """Rows of node array ``x [N, ...]`` picked by edge ids ``ids
    [E]``: ``x[ids]`` (by the JAX package's indexing rule, negative ids
    from the end and every id clamped into range, where ``jax_rule``).

    DTensors (``x`` over its rows, ``ids`` over the edges, both cut over
    the same mesh dims, evenly) run under ``local_map``: the rows are
    all-gathered once over those dims flattened (``row_mesh``: one
    collective, not one a mesh dim), then indexed by the rank's own ids;
    the backward adds the cotangent into ``[N, ...]`` and
    reduce-scatters it once back to the rank's rows.  Where the
    placements cut nothing (a 1 x 1 mesh, ``Replicate``), no collective
    runs.  The nodes are gathered, not the edges' rows looked up where
    they lie: a graph has far more edges than nodes."""
    from repro_torch.models.sharding import is_dtensor

    if not is_dtensor(x):
        return x[clamped_ids(ids, x.shape[0]) if jax_rule else ids]
    return _gather_partitioned(x, ids, jax_rule)


def take_local(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A replicated DTensor ``table`` with DTensor
    ``ids``: each rank looks its own ids up in its copy (``local_map``,
    no collective), the rows laid out as the ids; the table's gradient
    is ``Partial`` over the ids' cut, summed where the step reduces its
    replicated gradients (not DTensor's index backward, which would
    gather the rows' whole cotangent)."""
    from repro_torch.models.sharding import is_dtensor

    if not is_dtensor(ids):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = ids.device_mesh, tuple(ids.placements)
    whole = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    return local_map(lambda t, i: t[i], out_placements=list(pl),
                     in_placements=(whole, pl),
                     in_grad_placements=(grad, pl),
                     device_mesh=mesh)(table, ids)
