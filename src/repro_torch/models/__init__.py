"""Model zoo of the port: the LM family (``transformer``, ``attention``,
``moe``, ``layers``, ``sharding``), the GNN family (``gnn``: GAT, PNA,
NequIP, MACE) and the recsys family (``recsys``: BERT4Rec), the
counterpart of the JAX package's ``repro.models``."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.models.gnn import (
    EquivariantConfig,
    GATConfig,
    GraphBatch,
    PNAConfig,
    random_graph,
)
from repro_torch.models.recsys import BERT4RecConfig

__all__ = [
    "LMConfig",
    "MoEConfig",
    "EquivariantConfig",
    "GATConfig",
    "GraphBatch",
    "PNAConfig",
    "random_graph",
    "BERT4RecConfig",
]
