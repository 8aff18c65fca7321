"""nequip [gnn]: n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5
O(3)-equivariant interatomic potential. [arXiv:2101.03164; paper]"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.equivariant import EquivariantConfig

CONFIG = ArchSpec(
    arch_id="nequip",
    family="gnn",
    model=EquivariantConfig(
        name="nequip",
        kind="nequip",
        n_layers=5,
        d_hidden=32,
        l_max=2,
        n_rbf=8,
        cutoff=5.0,
    ),
    shapes=GNN_SHAPES,
    source="arXiv:2101.03164; paper",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="nequip-smoke",
        family="gnn",
        model=EquivariantConfig(
            name="nequip-smoke", kind="nequip", n_layers=2, d_hidden=8,
            l_max=1, n_rbf=4, n_species=4,
        ),
        shapes=GNN_SHAPES,
    )
