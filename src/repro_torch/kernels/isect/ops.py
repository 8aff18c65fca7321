"""Public wrapper for the bitset intersection kernel (both forms)."""
from __future__ import annotations

import torch

from repro_torch.kernels.isect.isect import isect_cuda, isect_fused_cuda


def pair_intersect_bitset(
    bits: torch.Tensor,
    ea: torch.Tensor,
    eb: torch.Tensor,
    ec: torch.Tensor | None = None,
    *,
    fused: bool = True,
    tile: int = 2048,
) -> torch.Tensor:
    """Intersection size per hyperedge pair (or triple, with ``ec``) over
    a packed bitset index.

    ``bits`` is the ``[E, W]`` int32 member bitset
    (``repro_torch.motifs.intersect.build_index(hg, "bitset").data``);
    ``ea`` / ``eb`` / ``ec`` are ``[P]`` hyperedge ids.  Returns ``[P]``
    int32 on ``bits``' device.

    ``fused=True`` (default): rows are gathered inside the kernel (K3b),
    so the ``[P, W]`` operands never exist.  ``fused=False`` gathers the
    rows with ``index_select`` first and runs the pre-gathered form
    (K3a); it takes pairs only.  The kernel takes any ``P`` and ``W``:
    nothing is padded.  On the CPU both forms run the plain version,
    ``tile`` pairs at a time.
    """
    ea = ea.to(device=bits.device, dtype=torch.int32).contiguous()
    eb = eb.to(device=bits.device, dtype=torch.int32).contiguous()
    if ec is not None:
        ec = ec.to(device=bits.device, dtype=torch.int32).contiguous()
    if fused:
        return isect_fused_cuda(bits, ea, eb, ec, tile=tile)
    if ec is not None:
        raise ValueError("the pre-gathered form (fused=False) takes pairs")
    a = bits.index_select(0, ea)
    b = bits.index_select(0, eb)
    return isect_cuda(a, b, tile=tile)
