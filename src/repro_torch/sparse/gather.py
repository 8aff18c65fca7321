"""Row gathers as the JAX package takes them: ``take_rows`` is
``jnp.take(table, ids, axis=0)`` in its ``fill`` mode, shared by the
LM's and BERT4Rec's embeddings and by ``embedding_bag``."""
from __future__ import annotations

import math

import torch


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
