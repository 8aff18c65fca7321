"""The fused delivery data path in stock torch ops (sliced-ELL + sorted
COO): the host lowering, as the JAX package picks its ELL form off-TPU.

* each degree class's incidences sit in its own dense ``[rows_c, k_c]``
  id table: one gather and one dense axis reduction per class;
* the per-class partials concatenate (plus one identity row for
  zero-degree destinations) and assemble with ONE gather through the
  layout's ``inv_perm``;
* hub incidences past the last class width take a segment reduce and
  merge in with one ``combine`` — skipped when the layout has no
  residual.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.deliver.layout import DeliveryLayout
from repro_torch.sparse.segment import Monoid


def _reduce_axis1(x: torch.Tensor, monoid: Monoid) -> torch.Tensor:
    if monoid.name == "or":
        return x.any(dim=1)
    if monoid.name == "sum":
        return x.sum(dim=1, dtype=x.dtype)
    if monoid.name == "prod":
        return x.prod(dim=1, dtype=x.dtype)
    if x.shape[1] == 0:
        return torch.full((x.shape[0],) + tuple(x.shape[2:]),
                          monoid.identity(x.dtype), dtype=x.dtype,
                          device=x.device)
    return x.amin(dim=1) if monoid.name == "min" else x.amax(dim=1)


def deliver_ell_leaf(
    msgs: torch.Tensor,
    layout: DeliveryLayout,
    monoid: Monoid,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """One leaf's fused delivery: ``[n_src, ...] -> [n_dst, ...]``."""
    ident = monoid.identity(msgs.dtype)
    ident_row = torch.full((1,) + tuple(msgs.shape[1:]), ident,
                           dtype=msgs.dtype, device=msgs.device)
    msgs_aug = torch.cat([msgs, ident_row], dim=0)

    act_aug = None
    if active is not None:
        act_aug = torch.cat([
            active.to(torch.bool),
            torch.ones(1, dtype=torch.bool, device=msgs.device),
        ])

    trail = (1,) * (msgs.dim() - 1)
    ident_t = torch.full((), ident, dtype=msgs.dtype, device=msgs.device)

    outs = []
    for ell in layout.class_ell:
        rows_c, k = ell.shape
        rows = msgs_aug.index_select(0, ell.reshape(-1)).reshape(
            (rows_c, k) + tuple(msgs.shape[1:])
        )
        if act_aug is not None:
            live = act_aug.index_select(0, ell.reshape(-1)).reshape(rows_c, k)
            rows = torch.where(live.reshape((rows_c, k) + trail), rows,
                               ident_t)
        outs.append(_reduce_axis1(rows, monoid))
    # Assembly is a pure gather: slot order is class-major, and the
    # appended identity row serves every zero-degree destination.
    out = torch.cat(outs + [ident_row], dim=0).index_select(
        0, layout.inv_perm
    )

    if layout.rem_nnz == 0:
        return out
    rem_rows = msgs_aug.index_select(0, layout.rem_src)
    if act_aug is not None:
        rem_live = act_aug.index_select(0, layout.rem_src)
        rem_rows = torch.where(rem_live.reshape((-1,) + trail), rem_rows,
                               ident_t)
    overflow = monoid.segment(rem_rows, layout.rem_dst, layout.n_dst)
    return monoid.combine(out, overflow)
