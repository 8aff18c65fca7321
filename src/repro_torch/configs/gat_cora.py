"""gat-cora [gnn]: n_layers=2 d_hidden=8 n_heads=8 attention aggregator.
[arXiv:1710.10903; paper]"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.gat import GATConfig

CONFIG = ArchSpec(
    arch_id="gat-cora",
    family="gnn",
    model=GATConfig(
        name="gat-cora",
        n_layers=2,
        d_hidden=8,
        n_heads=8,
        n_classes=7,
        d_in=1433,
    ),
    shapes=GNN_SHAPES,
    source="arXiv:1710.10903; paper",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="gat-cora-smoke",
        family="gnn",
        model=GATConfig(
            name="gat-smoke", n_layers=2, d_hidden=4, n_heads=2,
            n_classes=4, d_in=8,
        ),
        shapes=GNN_SHAPES,
    )
