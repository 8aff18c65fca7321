"""pna [gnn]: n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=identity-amplification-attenuation. [arXiv:2004.05718; paper]"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.pna import PNAConfig

CONFIG = ArchSpec(
    arch_id="pna",
    family="gnn",
    model=PNAConfig(
        name="pna",
        n_layers=4,
        d_hidden=75,
        n_classes=8,
        d_in=16,
    ),
    shapes=GNN_SHAPES,
    source="arXiv:2004.05718; paper",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="pna-smoke",
        family="gnn",
        model=PNAConfig(
            name="pna-smoke", n_layers=2, d_hidden=8, n_classes=4, d_in=8,
        ),
        shapes=GNN_SHAPES,
    )
