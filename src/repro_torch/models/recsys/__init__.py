"""RecSys models of the port: BERT4Rec over a production-size item
embedding table, the counterpart of the JAX package's
``repro.models.recsys``."""
from repro_torch.models.recsys.bert4rec import BERT4RecConfig

__all__ = ["BERT4RecConfig"]
