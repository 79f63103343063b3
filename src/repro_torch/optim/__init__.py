"""AdamW with mixed-precision states and LR schedules (``repro/optim/``
counterpart)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "linear_warmup"]
