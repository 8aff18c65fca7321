"""Public wrapper for the segment-sum kernels (both forms)."""
from __future__ import annotations

import torch

from repro_torch.kernels.segsum.segsum import segsum_cuda, segsum_sorted_cuda


def csr_row_offsets(dst: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR row offsets ``[num_segments + 1]`` (int32) of non-decreasing
    int32 ids: row ``r`` owns edges ``[off[r], off[r + 1])``.  Ids below
    0 sort before row 0's offset and ids >= ``num_segments`` after the
    last, so both fall outside every row."""
    return torch.searchsorted(
        dst, torch.arange(num_segments + 1, dtype=torch.int32,
                          device=dst.device), out_int32=True)


def segment_sum_mxu(
    msgs: torch.Tensor,
    dst: torch.Tensor,
    num_segments: int,
    *,
    sorted_dst: bool = False,
    block_n: int = 128,
    block_e: int = 512,
) -> torch.Tensor:
    """Drop-in for ``jax.ops.segment_sum(msgs, dst, num_segments)``:
    ``msgs [E, D]`` (float32 or bfloat16) summed by ``dst [E]`` into
    ``[num_segments, D]`` of the type of ``msgs``, in float32.

    The name is the JAX package's, whose kernel runs the sum on the TPU's
    matrix unit (MXU); here the sum runs in the hand-written CUDA kernels
    of ``csrc/segsum.cu`` on a CUDA tensor and in their plain versions on
    a CPU one.  JAX's ``interpret`` flag has no counterpart.

    ``sorted_dst=True`` says ``dst`` is non-decreasing (a
    ``HyperGraph.sorted_by_dst`` product), which is checked here (one
    host sync; a ``ValueError`` if not).  The CSR row offsets are then
    made here, and the sorted form (K2b) reads only each output tile's
    own edges, ``block_n`` rows per thread block, with the same bits on
    every run.  Otherwise the unsorted form (K2a) buckets the edges by
    output tile of ``block_n`` rows and sums each tile in shared memory,
    ``block_e`` edges per work item, in an order that atomics choose:
    its last bits may change between runs.  Nothing is padded: the
    kernels take any ``E`` and ``num_segments``.

    Where it differs from the JAX package's ``segment_sum_mxu``, it
    follows ``segment_sum_ref`` (``jax.ops.segment_sum``), the oracle the
    JAX tests hold that kernel to:

    * ``E = 0`` gives zeros (the Pallas path raises a ``TypeError``);
    * a non-finite message stays in its own row (the TPU kernel's one-hot
      product turns ``0 * inf`` into NaN in the other rows of its tile:
      ``[1, inf, 2, 3]`` into ids ``[0, 1, 2, 70]``, ``num_segments = 3``,
      gives ``[nan, inf, nan]`` there and ``[1, inf, 2]`` here).

    Ids outside ``[0, num_segments)``, negative ones included, are
    dropped, as by both JAX versions.
    """
    if msgs.dim() != 2:
        raise ValueError(f"msgs must be [E, D], got shape {tuple(msgs.shape)}")
    if dst.shape != msgs.shape[:1]:
        raise ValueError(f"dst must be [E] = [{msgs.shape[0]}], got shape "
                         f"{tuple(dst.shape)}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    msgs = msgs.contiguous()
    if dst.dtype != torch.int32:
        # Clamp before narrowing so that no id wraps into range.
        dst = dst.clamp(-1, num_segments).to(torch.int32)
    dst = dst.to(msgs.device).contiguous()
    if not sorted_dst:
        return segsum_cuda(msgs, dst, num_segments, block_n=block_n,
                           block_e=block_e)
    if not bool((dst[1:] >= dst[:-1]).all()):
        raise ValueError("sorted_dst=True needs non-decreasing dst ids "
                         "(see HyperGraph.sorted_by_dst)")
    return segsum_sorted_cuda(msgs, csr_row_offsets(dst, num_segments),
                              num_segments, block_n=block_n)
