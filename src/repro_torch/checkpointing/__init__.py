"""Checkpoints of the port in the JAX package's layout
(``repro/checkpointing/``)."""
from .store import load_pytree, restore_train_state, save_pytree, save_train_state

__all__ = ["load_pytree", "restore_train_state", "save_pytree",
           "save_train_state"]
