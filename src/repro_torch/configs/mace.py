"""mace [gnn]: n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8
E(3)-ACE higher-order equivariant message passing. [arXiv:2206.07697; paper]
"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.equivariant import EquivariantConfig

CONFIG = ArchSpec(
    arch_id="mace",
    family="gnn",
    model=EquivariantConfig(
        name="mace",
        kind="mace",
        n_layers=2,
        d_hidden=128,
        l_max=2,
        n_rbf=8,
        cutoff=5.0,
        correlation_order=3,
    ),
    shapes=GNN_SHAPES,
    source="arXiv:2206.07697; paper",
    notes="many-body (cardinality-k) interactions = the hypergraph-native "
          "arch of the pool; see DESIGN.md §7",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="mace-smoke",
        family="gnn",
        model=EquivariantConfig(
            name="mace-smoke", kind="mace", n_layers=2, d_hidden=8,
            l_max=2, n_rbf=4, correlation_order=3, n_species=4,
        ),
        shapes=GNN_SHAPES,
    )
