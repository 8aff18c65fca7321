"""Datasets: synthetic hypergraph generators calibrated to the paper's
Table I regimes."""
from repro_torch.data.generators import (
    DATASET_REGIMES,
    make_dataset,
    powerlaw_hypergraph,
)

__all__ = ["DATASET_REGIMES", "powerlaw_hypergraph", "make_dataset"]
