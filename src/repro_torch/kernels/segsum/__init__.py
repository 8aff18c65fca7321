"""Segment sum: ``segment_sum_mxu`` over the hand-written CUDA kernels
(``csrc/segsum.cu``: K2a unsorted, K2b sorted) and their plain torch
versions."""
from repro_torch.kernels.segsum.ops import csr_row_offsets, segment_sum_mxu
from repro_torch.kernels.segsum.ref import segment_sum_ref
from repro_torch.kernels.segsum.segsum import (
    segsum_cuda,
    segsum_plain,
    segsum_sorted_cuda,
    segsum_sorted_plain,
)

__all__ = [
    "csr_row_offsets",
    "segment_sum_mxu",
    "segment_sum_ref",
    "segsum_cuda",
    "segsum_plain",
    "segsum_sorted_cuda",
    "segsum_sorted_plain",
]
