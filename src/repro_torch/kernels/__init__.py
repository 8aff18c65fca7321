"""Hand-written Hopper kernels for the port's hot spots.

deliver/ - fused incidence delivery: gather + live mask + monoid
           segment-combine over a dst-sorted, degree-classed CSR layout
           (CUDA, ``csrc/deliver_fused.cu``), with a plain torch version
           and the sliced-ELL stock-op lowering for the host.
isect/   - bitset intersection: AND + popcount over hyperedge member
           rows, per pair or triple, rows pre-gathered or gathered in
           the kernel (CUDA, ``csrc/isect.cu``).
segsum/  - segment sum of message rows by destination id, in any order
           (tile buckets summed in shared memory) or dst-sorted (equal
           shares of the merge path of row ends and edges, bitwise
           repeatable) (CUDA, ``csrc/segsum.cu``).
flash/   - attention with an online softmax, causal or bidirectional,
           head dim up to 256 (CUDA, ``csrc/flash.cu``), and its backward
           for training (CUDA, ``csrc/flash_bwd.cu``).

Each kernel has a plain PyTorch version beside it in the same module
(the CPU path and the kernel's oracle) and a launch counter on its
wrapper.  ``_nvcc`` builds the CUDA sources at first use;
``check_operand`` is the input check every wrapper makes.

A fake tensor (``torch._subclasses.FakeTensor``: shapes, no memory, as
the dry-run traces a step) takes a kernel's fake route where the
dry-run reaches it (K4 forward and backward, K2a): the CUDA route's
shape checks, its outputs allocated as fake tensors, and the kernel's
work charged to the trace (``roofline.analysis.kernel_work``).
``is_fake`` tells such a tensor apart.
"""


def is_fake(t) -> bool:
    """Is ``t`` a fake tensor (shapes only, no data)?"""
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(t)


def check_operand(name: str, t, dtype, ndim: int, device) -> None:
    """What every kernel wrapper checks before it passes a pointer: a
    tensor on ``device``, of ``dtype`` (any when None), ``ndim``-D and
    contiguous.  Raises ``TypeError`` / ``ValueError`` otherwise."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
