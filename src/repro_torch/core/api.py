"""The MESH programming model: "think like a vertex *or hyperedge*".

PyTorch port of the paper's Listing-1 API.  Procedures are vectorized
over the whole entity set; ``ctx.become`` is the returned attribute;
``ctx.broadcast`` is the returned message; per-destination messages are
the optional per-incidence ``edge_transform``.

A ``Program`` owns the ``MessageCombiner`` for the messages it *sends*.
``combiner=None`` auto-derives it from the message type, via
``sparse.segment.derive_monoid_for``.

Attribute and message trees are nested tuples / lists / dicts of tensors
(``None`` is an empty tree); ``tree_map`` and ``tree_leaves`` walk them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sparse.segment import Monoid, derive_monoid_for, resolve_monoid

Pytree = Any


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``), keeping the container structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class ProcedureOut(NamedTuple):
    """What one superstep of a vertex/hyperedge program produces.

    attr: updated attribute tree, leading dim = entity count
      (``ctx.become``).
    msg: outgoing message tree, leading dim = entity count
      (``ctx.broadcast``, combined at the destination with the sender
      program's combiner).
    active: optional ``[n] bool``; inactive entities send nothing this
      superstep (their message rows are replaced by the combiner
      identity).  ``None`` = all active.
    """

    attr: Pytree
    msg: Pytree
    active: torch.Tensor | None = None


# (step, ids[n], attr, in_msg, degree[n]) -> ProcedureOut;  ``step`` is a
# 0-d int32 tensor on the entities' device (select on it with
# ``torch.where``, as the JAX package does on its traced step).
Procedure = Callable[
    [torch.Tensor, torch.Tensor, Pytree, Pytree, torch.Tensor], ProcedureOut
]

# optional per-incidence message transform:
# (msg_rows_tree, e_attr_tree) -> msg_rows_tree
EdgeTransform = Callable[[Pytree, Pytree], Pytree]


@dataclasses.dataclass(frozen=True)
class Program:
    """One side's behavior (vertex Program or hyperedge Program).

    ``reducer`` generalizes the MessageCombiner beyond monoids: it
    receives the per-incidence message rows plus destination ids and
    produces the combined per-destination message (the paper's
    ``Seq``-typed messages).  When ``reducer`` is None the monoid path
    (``combiner``) is used.
    """

    procedure: Procedure
    combiner: str | Monoid | None = None  # None => auto-derive per leaf
    edge_transform: EdgeTransform | None = None
    # (rows tree [nnz,...], dst_ids [nnz], num_dst, live [nnz] bool|None)
    #   -> combined msg tree [num_dst, ...]
    reducer: Callable | None = None

    def monoid_for(self, msg_leaf: torch.Tensor) -> Monoid:
        if self.combiner is None:
            return derive_monoid_for(msg_leaf)
        return resolve_monoid(self.combiner)


def constant_initial_msg(template: Pytree, n: int, device=None) -> Pytree:
    """Broadcast the user's ``initialMsg`` to every entity (superstep 0)."""
    def one(x):
        x = torch.as_tensor(x, device=device)
        return x.expand((n,) + tuple(x.shape))

    return tree_map(one, template)


def identity_rows(monoid: Monoid, template_leaf: torch.Tensor, n: int):
    return torch.full((n,) + tuple(template_leaf.shape[1:]),
                      monoid.identity(template_leaf.dtype),
                      dtype=template_leaf.dtype, device=template_leaf.device)
