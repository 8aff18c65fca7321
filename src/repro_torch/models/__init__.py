"""Model zoo of the port: the LM family (``transformer``, ``attention``,
``moe``, ``layers``, ``sharding``), the counterpart of the JAX package's
``repro.models``.  The GNN and recsys names (``GATConfig``,
``PNAConfig``, ``EquivariantConfig``, ``GraphBatch``, ``random_graph``,
``BERT4RecConfig``) join with ROADMAP items 12c and 12d."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

__all__ = ["LMConfig", "MoEConfig"]
