"""Bitset intersection: ``pair_intersect_bitset`` over the hand-written
CUDA kernel (``csrc/isect.cu``) and its plain torch versions."""
from repro_torch.kernels.isect.isect import (
    isect_cuda,
    isect_fused_cuda,
    isect_fused_plain,
    isect_plain,
    popcount_words,
)
from repro_torch.kernels.isect.ops import pair_intersect_bitset

__all__ = [
    "isect_cuda",
    "isect_fused_cuda",
    "isect_fused_plain",
    "isect_plain",
    "pair_intersect_bitset",
    "popcount_words",
]
