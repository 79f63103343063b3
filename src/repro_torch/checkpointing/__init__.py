"""Checkpoints of the port in the JAX package's layout
(``repro/checkpointing/``), of one process or of a sharded run."""
from .store import (load_pytree, restore_sharded_train_state,
                    restore_train_state, save_pytree,
                    save_sharded_train_state, save_train_state)

__all__ = ["load_pytree", "restore_sharded_train_state",
           "restore_train_state", "save_pytree", "save_sharded_train_state",
           "save_train_state"]
