"""Bitset intersection: ``pair_intersect_bitset`` over the hand-written
CUDA kernel (``csrc/isect.cu``), its plain torch versions and the
oracle ``ref.pair_intersect_ref``."""
from repro_torch.kernels.isect.isect import (
    isect_cuda,
    isect_fused_cuda,
    isect_fused_plain,
    isect_plain,
    popcount_words,
)
from repro_torch.kernels.isect.ops import pair_intersect_bitset
from repro_torch.kernels.isect.ref import pair_intersect_ref

__all__ = [
    "isect_cuda",
    "isect_fused_cuda",
    "isect_fused_plain",
    "isect_plain",
    "pair_intersect_bitset",
    "pair_intersect_ref",
    "popcount_words",
]
