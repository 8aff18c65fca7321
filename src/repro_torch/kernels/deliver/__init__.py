"""Fused incidence delivery — the delivery-kernel registry.

``repro_torch.core.engine.deliver`` routes through here when a
``DeliveryLayout`` is supplied (the ``delivery='pallas_fused'`` design
point: in the port it means "the fused layout path").  One fused data
path, three lowerings:

* ``cuda`` — the hand-written Hopper kernel
  (``fused.deliver_leaf_cuda``), one launch per leaf over every degree
  class, the rows written straight to their destinations;
* ``plain`` — the per-class contract in stock torch ops
  (``fused.deliver_fused_plain``) assembled with ``inv_perm``, the
  kernel's oracle;
* ``ell`` — the layout's sliced-ELL tables through stock torch ops
  (``xla.deliver_ell_leaf``), the host lowering.

``select_lowering`` picks ``cuda`` for CUDA tensors and ``ell`` on the
CPU; an explicit ``lowering=`` of ``ell`` or ``plain`` is accepted on
any device.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.deliver.fused import (
    LeafPlan,
    class_span,
    deliver_fused_classes,
    deliver_fused_cuda,
    deliver_fused_plain,
    deliver_leaf_cuda,
    deliver_leaf_plain,
    layout_from_numpy,
    leaf_plan,
)
from repro_torch.kernels.deliver.layout import (
    ClassPlan,
    DeliveryLayout,
    build_delivery_layout,
    classify_degrees,
    layout_pair,
    plan_degree_classes,
    plan_ell_width,
    tile_block_bounds,
)
from repro_torch.kernels.deliver.xla import deliver_ell_leaf
from repro_torch.sparse.segment import MONOIDS

__all__ = [
    "DELIVERY_MODES",
    "LOWERINGS",
    "ClassPlan",
    "DeliveryLayout",
    "LeafPlan",
    "build_delivery_layout",
    "class_span",
    "classify_degrees",
    "deliver_ell_leaf",
    "deliver_fused_classes",
    "deliver_fused_cuda",
    "deliver_fused_plain",
    "deliver_leaf_cuda",
    "deliver_leaf_plain",
    "fused_deliver",
    "layout_from_numpy",
    "layout_pair",
    "leaf_plan",
    "plan_degree_classes",
    "plan_ell_width",
    "select_lowering",
    "tile_block_bounds",
]

# The ``ExecutionConfig.delivery`` axis values (as in the JAX package).
DELIVERY_MODES = ("auto", "xla", "pallas_fused")
LOWERINGS = ("cuda", "plain", "ell")

Pytree = Any


def select_lowering(device) -> str:
    """``cuda`` for CUDA tensors, ``ell`` on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "ell"


def _pallas_leaf(leaf, layout, monoid, active, *, lowering):
    """Shape-normalize one leaf for the 2-D kernels."""
    shape = tuple(leaf.shape)
    msgs2d = leaf.reshape(shape[0], math.prod(shape[1:]))
    if monoid.name == "or":
        # The kernel has no bool path: lower "or" as int32 max.
        out = _pallas_leaf(
            msgs2d.to(torch.int32), layout, MONOIDS["max"], active,
            lowering=lowering,
        )
        # > 0, not a bool cast: empty destinations hold the max identity
        # (iinfo.min), which must read back as False.
        return (out > 0).reshape((layout.n_dst,) + shape[1:])
    fn = deliver_leaf_cuda if lowering == "cuda" else deliver_leaf_plain
    out = fn(msgs2d.contiguous(), active, layout, monoid.name)
    return out.reshape((layout.n_dst,) + shape[1:])


def _mask_per_query(leaf, active, monoid):
    """Each inactive (sender, query) of ``active`` (``[n_src, B]``)
    sends the monoid's identity instead of its message.  The fold is
    then that of the live senders: exactly for min, max, prod, or and
    integer sums; a float sum can differ only in the sign of a zero."""
    live = active if active.dtype == torch.bool else active != 0
    live = live.reshape(tuple(live.shape) + (1,) * (leaf.dim() - live.dim()))
    ident = torch.full((), monoid.identity(leaf.dtype), dtype=leaf.dtype,
                       device=leaf.device)
    return torch.where(live, leaf, ident)


def fused_deliver(
    out_msg: Pytree,
    active,
    layout: DeliveryLayout,
    program,
    lowering: str | None = None,
) -> Pytree:
    """Deliver + combine a message tree through the fused layout.

    Drop-in for the reference gather/mask/segment path of
    ``repro_torch.core.engine.deliver`` on the monoid path (the caller
    guarantees ``program.reducer is None`` and no ``edge_transform``);
    per-leaf monoids resolve exactly as in the reference.

    A batch of queries (``run_batch``) carries its query axis inner:
    leaves ``[n_src, B, ...]`` go through the kernel as rows of ``B·d``
    values, one launch for the whole batch, and ``active`` is ``[n_src,
    B]``.  The kernel masks by sender only, so per-query activity is
    folded into the messages first (``_mask_per_query``).
    """
    def one(leaf):
        monoid = program.monoid_for(leaf)
        low = lowering or select_lowering(leaf.device)
        if low not in LOWERINGS:
            raise ValueError(f"lowering must be one of {LOWERINGS}, "
                             f"got {low!r}")
        act = active
        if act is not None and act.dim() > 1:
            leaf, act = _mask_per_query(leaf, act, monoid), None
        if low == "ell":
            return deliver_ell_leaf(leaf, layout, monoid, act)
        return _pallas_leaf(leaf, layout, monoid, act, lowering=low)

    # Imported here: repro_torch.core imports this package, so a
    # module-level import would be circular when this package is
    # imported first.
    from repro_torch.core.api import tree_map

    return tree_map(one, out_msg)
