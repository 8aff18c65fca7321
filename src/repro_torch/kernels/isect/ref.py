"""Plain oracle for the bitset intersection kernels, as the JAX package's
``repro.kernels.isect.ref``: gather both rows, AND, popcount, sum."""
from __future__ import annotations

import torch

from repro_torch.kernels.isect.isect import popcount_words


def pair_intersect_ref(
    bits: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor
) -> torch.Tensor:
    """``[E, W]`` 32-bit bitsets (int32 words), ``[P]`` pair ids ->
    ``[P]`` int32 sizes."""
    inter = bits.index_select(0, ea.long()) & bits.index_select(0, eb.long())
    return popcount_words(inter).sum(dim=1).to(torch.int32)
