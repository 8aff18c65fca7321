"""Training substrate, the counterpart of the JAX package's
``repro.train``: AdamW, the train-step factory, checkpointing, and
``train_state_from_jax`` (a JAX ``TrainState`` carried over, for the
parity tests)."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    schedule,
)
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
    train_state_from_jax,
)
from repro_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "schedule",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "train_state_from_jax",
    "latest_checkpoint",
    "restore_checkpoint",
    "save_checkpoint",
]
