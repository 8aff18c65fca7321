"""Roofline analysis from traced dry-run steps (fake tensors), priced on
the H100's peaks; ``collective_stats`` takes the place of the JAX
package's ``parse_collectives`` (there is no HLO to parse)."""
from repro_torch.roofline.analysis import (
    HW,
    CollectiveStats,
    RooflineReport,
    analyze_task,
    collective_stats,
)

__all__ = [
    "HW",
    "CollectiveStats",
    "RooflineReport",
    "analyze_task",
    "collective_stats",
]
