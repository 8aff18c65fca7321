"""Hand-written Hopper kernels for the port's hot spots.

deliver/ - fused incidence delivery: gather + live mask + monoid
           segment-combine over a dst-sorted, degree-classed CSR layout
           (CUDA, ``csrc/deliver_fused.cu``), with a plain torch version
           and the sliced-ELL stock-op lowering for the host.

Each kernel has a plain PyTorch version beside it in the same module
(the CPU path and the kernel's oracle) and a launch counter on its
wrapper.  ``_nvcc`` builds the CUDA sources at first use.
"""
