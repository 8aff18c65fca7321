"""Model zoo of the port: the LM family (``transformer``, ``attention``,
``moe``, ``layers``, ``sharding``) and the GNN family (``gnn``: GAT,
PNA, NequIP, MACE), the counterpart of the JAX package's
``repro.models``.  The recsys name (``BERT4RecConfig``) joins with
ROADMAP item 12d."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.models.gnn import (
    EquivariantConfig,
    GATConfig,
    GraphBatch,
    PNAConfig,
    random_graph,
)

__all__ = [
    "LMConfig",
    "MoEConfig",
    "EquivariantConfig",
    "GATConfig",
    "GraphBatch",
    "PNAConfig",
    "random_graph",
]
