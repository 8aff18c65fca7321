"""Launch layer of the port: meshes, task builders, the dry-run,
trainers, serving.

Hypergraph analytics launches through ``repro_torch.launch.hypergraph``
(the ``Engine`` facade; ``--devices N``: N ranks over ``launch.mesh``'s
process group and mesh) and serves through
``repro_torch.launch.serve_hypergraph``; LM/GNN/recsys training and LM
decode serving through ``train`` / ``serve`` / ``gnn_sharded``, and the
dry-run of every (arch x shape x mesh) cell through ``dryrun`` (over
``tasks``).
"""
from repro_torch.launch.mesh import (
    dp_axes,
    flat_axes,
    make_host_mesh,
    make_production_mesh,
    total_devices,
)

__all__ = [
    "dp_axes",
    "flat_axes",
    "make_host_mesh",
    "make_production_mesh",
    "total_devices",
]
