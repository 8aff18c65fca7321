"""Hypergraph partitioning: the paper's central design axis (host numpy,
the port's copy of ``repro.partition``)."""
from repro_torch.partition.base import PartitionPlan, PartitionStats, build_plan
from repro_torch.partition.strategies import STRATEGIES, partition

__all__ = [
    "PartitionPlan",
    "PartitionStats",
    "build_plan",
    "STRATEGIES",
    "partition",
]
