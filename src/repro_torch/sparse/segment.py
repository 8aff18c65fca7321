"""Segment reductions — the single primitive under all MESH supersteps.

A MESH superstep is ``gather -> per-edge transform -> combine-by-key``.
The combine step must be a commutative monoid so that pre-aggregation
before a network hop is legal and the reduction may reassociate freely.
This module defines the monoid registry (the analogue of the paper's
Algebird auto-derived ``MessageCombiner``) and the segment reduction,
in PyTorch.

``segment`` is ``scatter_reduce(..., include_self=True)`` into an
identity-filled output: empty segments read the identity, exactly as
``jax.ops.segment_*`` fill them, and ids outside ``[0, num_segments)``
are dropped (the JAX ``FILL_OR_DROP`` rule).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Commutative monoid: identity + combine + a segment reduction.

    ``segment`` satisfies ``segment(x, ids, n)[i] == fold(combine,
    identity, [x[j] for j where ids[j]==i])`` — the law the parity
    tests assert against the JAX registry.
    """

    name: str
    identity: Callable[[torch.dtype], int | float | bool]
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    segment: Callable[..., torch.Tensor]


def _min_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


# scatter_reduce's name for each monoid's reduction.
_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax", "prod": "prod"}


def scatter_fold(out: torch.Tensor, index: torch.Tensor, rows: torch.Tensor,
                 monoid_name: str) -> torch.Tensor:
    """Fold ``rows`` into ``out`` (identity-filled, ``[n, ...]``) along
    dim 0 by ``index`` (``[len(rows)]`` int64, all in range).

    Float min/max propagate NaN, as ``jnp.minimum``/``jnp.maximum`` do:
    the scatter's own NaN handling is not specified across devices, so a
    row that saw a NaN is set to NaN explicitly.
    """
    idx = index.reshape((-1,) + (1,) * (rows.dim() - 1)).expand_as(rows)
    out = out.scatter_reduce(0, idx, rows, _SCATTER_REDUCE[monoid_name],
                             include_self=True)
    if monoid_name in ("min", "max") and rows.dtype.is_floating_point:
        nan = torch.zeros(out.shape, dtype=torch.int32, device=out.device)
        nan = nan.scatter_reduce(0, idx, rows.isnan().to(torch.int32),
                                 "amax", include_self=True)
        out = torch.where(nan > 0, torch.full_like(out, float("nan")), out)
    return out


def _segment(monoid_name: str):
    def segment(x: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
        ident = MONOIDS[monoid_name].identity(x.dtype)
        ids = ids.to(torch.int64)
        # Out-of-range ids land in one spare segment that is sliced off.
        ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                          torch.full_like(ids, num_segments))
        out = torch.full((num_segments + 1,) + tuple(x.shape[1:]), ident,
                         dtype=x.dtype, device=x.device)
        return scatter_fold(out, ids, x, monoid_name)[:num_segments]

    return segment


def _or_segment(x: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    # ``> 0`` (not a bool cast): an int32 segment max fills EMPTY
    # segments with iinfo.min, which a bool cast would read as True — the
    # monoid law requires the identity (False) for empty folds.
    return _segment("max")(x.to(torch.int32), ids, num_segments) > 0


MONOIDS: dict[str, Monoid] = {
    "sum": Monoid("sum", identity=lambda dt: 0, combine=torch.add,
                  segment=_segment("sum")),
    "max": Monoid("max", identity=_max_identity, combine=torch.maximum,
                  segment=_segment("max")),
    "min": Monoid("min", identity=_min_identity, combine=torch.minimum,
                  segment=_segment("min")),
    "prod": Monoid("prod", identity=lambda dt: 1, combine=torch.mul,
                   segment=_segment("prod")),
    "or": Monoid("or", identity=lambda dt: 0, combine=torch.logical_or,
                 segment=_or_segment),
}


def resolve_monoid(combiner: str | Monoid) -> Monoid:
    if isinstance(combiner, Monoid):
        return combiner
    try:
        return MONOIDS[combiner]
    except KeyError as e:
        raise ValueError(
            f"unknown combiner {combiner!r}; known: {sorted(MONOIDS)}"
        ) from e


def derive_monoid_for(x: torch.Tensor) -> Monoid:
    """Auto-derive a MessageCombiner from the message type: floats and
    ints default to ``sum``, bools to ``or``.  Algorithms needing max/min
    (label propagation, SSSP) say so explicitly."""
    if x.dtype == torch.bool:
        return MONOIDS["or"]
    return MONOIDS["sum"]


def segment_reduce(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str | Monoid = "sum",
) -> torch.Tensor:
    """Reduce ``data`` rows by key; empty segments get the identity."""
    return resolve_monoid(combiner).segment(data, segment_ids, num_segments)
