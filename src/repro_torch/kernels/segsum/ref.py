"""Plain oracle for the segment-sum kernels, as the JAX package's
``repro.kernels.segsum.ref`` (``jax.ops.segment_sum``): the kernels' own
plain version, ``segsum.segsum_plain`` (float32 sums, ids outside
``[0, num_segments)`` dropped, the type of ``msgs`` returned), under the
oracle's name."""
from repro_torch.kernels.segsum.segsum import segsum_plain as segment_sum_ref

__all__ = ["segment_sum_ref"]
