"""EmbeddingBag built from a gather + a per-bag segment reduce, the
counterpart of the JAX package's ``repro.sparse.embedding_bag``.

PyTorch has ``nn.EmbeddingBag``; the port builds the bag from its own
primitives instead, as the JAX package does, so that the same reduction
serves recsys multi-hot pooling, the MESH engine's delivery (a bag is
one hyperedge's incidence list) and GNN neighbourhood pooling:

* ``mode="sum"`` is ``mp_segment_sum``: K2a on a CUDA tensor
  (``kernels.segsum.SegmentSumFn``, with its gradient), its plain
  version on a CPU one.  The reference promises no order of
  ``bag_ids``, so the unsorted form (K2a), never the sorted one;
* ``mean`` is ``segment_mean`` (that sum over the bag's count);
* ``max`` is ``mp_segment_max`` (the scatter), with non-finite results
  (an empty bag's ``-inf``) set to 0, as the reference does.

Rows are taken as ``jnp.take`` takes them (``sparse.gather.take_rows``,
its ``fill`` mode): an id in ``[-V, 0)`` counts from the end and an id
outside ``[-V, V)`` gives a row of NaN.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sparse.gather import take_rows
from repro_torch.sparse.segment import (
    mp_segment_max,
    mp_segment_sum,
    segment_mean,
)


@dataclasses.dataclass(frozen=True)
class EmbeddingBagSpec:
    vocab_size: int
    dim: int
    mode: str = "sum"  # sum | mean | max
    dtype: torch.dtype = torch.float32

    def init(self, gen: torch.Generator) -> torch.Tensor:
        """A ``[vocab_size, dim]`` table of normal draws times
        ``dim ** -0.5`` from ``gen``, on its device."""
        scale = self.dim**-0.5
        return (torch.randn((self.vocab_size, self.dim), generator=gen,
                            device=gen.device) * scale).to(self.dtype)


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    bag_ids: torch.Tensor,
    num_bags: int,
    *,
    mode: str = "sum",
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pool rows of ``table`` selected by ``indices`` into ``num_bags`` bags.

    Args:
      table: ``[vocab, dim]`` embedding table.
      indices: ``[nnz]`` int row ids (flattened ragged multi-hot).
      bag_ids: ``[nnz]`` int bag id per index, in ``[0, num_bags)`` (ids
        outside it are dropped), in any order.
      num_bags: the bag count.
      mode: ``sum`` | ``mean`` | ``max``.
      weights: optional ``[nnz]`` per-sample weights (sum/mean only),
        multiplied into the rows before the reduce.
    """
    rows = take_rows(table, indices)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    if mode == "mean":
        return segment_mean(rows, bag_ids, num_bags)
    if mode == "max":
        out = mp_segment_max(rows, bag_ids, num_bags)
        return torch.where(torch.isfinite(out), out, 0.0)
    return mp_segment_sum(rows, bag_ids, num_bags)


def embedding_bag_dense(
    table: torch.Tensor,
    indices: torch.Tensor,
    *,
    mode: str = "sum",
    pad_id: int | None = None,
) -> torch.Tensor:
    """Rectangular variant: ``indices [batch, bag_width]`` (padded
    multi-hot) -> ``[batch, dim]``.  The segment reduce becomes a dense
    masked reduction over the bag axis — no scatter at all."""
    rows = take_rows(table, indices)  # [batch, width, dim]
    if pad_id is not None:
        mask = (indices != pad_id)[..., None].to(rows.dtype)
        rows = rows * mask
        denom = torch.clamp(mask.sum(dim=1), min=1.0)
    else:
        denom = torch.full(rows.shape[:1] + rows.shape[2:], rows.shape[1],
                           dtype=rows.dtype, device=rows.device)
    if mode == "mean":
        return rows.sum(dim=1) / denom
    if mode == "max":
        if pad_id is not None:
            rows = torch.where((indices == pad_id)[..., None], -math.inf,
                               rows)
        out = rows.amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)
    return rows.sum(dim=1)
