"""bert4rec [recsys]: embed_dim=64 n_blocks=2 n_heads=2 seq_len=200,
bidirectional sequence interaction over a 1M-item catalog.
[arXiv:1904.06690; paper]"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys.bert4rec import BERT4RecConfig

CONFIG = ArchSpec(
    arch_id="bert4rec",
    family="recsys",
    model=BERT4RecConfig(
        name="bert4rec",
        n_items=1_000_000,
        embed_dim=64,
        n_blocks=2,
        n_heads=2,
        max_seq=200,
    ),
    shapes=RECSYS_SHAPES,
    source="arXiv:1904.06690; paper",
    notes="encoder-only: no autoregressive decode shapes assigned (all 4 "
          "cells run)",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="bert4rec-smoke",
        family="recsys",
        model=BERT4RecConfig(
            name="bert4rec-smoke", n_items=1000, embed_dim=16,
            n_blocks=2, n_heads=2, max_seq=16,
        ),
        shapes=RECSYS_SHAPES,
    )
