"""Hand-written Hopper kernels for the port's hot spots.

deliver/ - fused incidence delivery: gather + live mask + monoid
           segment-combine over a dst-sorted, degree-classed CSR layout
           (CUDA, ``csrc/deliver_fused.cu``), with a plain torch version
           and the sliced-ELL stock-op lowering for the host.
isect/   - bitset intersection: AND + popcount over hyperedge member
           rows, per pair or triple, rows pre-gathered or gathered in
           the kernel (CUDA, ``csrc/isect.cu``).
segsum/  - segment sum of message rows by destination id, in any order
           (atomics) or dst-sorted (one block per tile of rows, no
           atomics) (CUDA, ``csrc/segsum.cu``).
flash/   - attention forward with an online softmax, causal or
           bidirectional, head dim up to 256 (CUDA, ``csrc/flash.cu``).

Each kernel has a plain PyTorch version beside it in the same module
(the CPU path and the kernel's oracle) and a launch counter on its
wrapper.  ``_nvcc`` builds the CUDA sources at first use;
``check_operand`` is the input check every wrapper makes.
"""


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
