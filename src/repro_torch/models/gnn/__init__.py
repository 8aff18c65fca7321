"""GNN model zoo of the port: GAT, PNA, NequIP, MACE over the
``GraphBatch`` container, the counterpart of the JAX package's
``repro.models.gnn``."""
from repro_torch.models.gnn.graph import GraphBatch, graph_from_jax, random_graph
from repro_torch.models.gnn.gat import GATConfig
from repro_torch.models.gnn.pna import PNAConfig
from repro_torch.models.gnn.equivariant import EquivariantConfig

__all__ = [
    "GraphBatch",
    "graph_from_jax",
    "random_graph",
    "GATConfig",
    "PNAConfig",
    "EquivariantConfig",
]
