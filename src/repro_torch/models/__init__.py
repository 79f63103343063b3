"""Model zoo of the port (dense decoders so far)."""
from .common import ModelConfig
from .transformer import (LM, init_lm, init_paged_state, paged_decode_step,
                          paged_prefill_step, supports_paged_decode)

__all__ = ["LM", "ModelConfig", "init_lm", "init_paged_state",
           "paged_decode_step", "paged_prefill_step", "supports_paged_decode"]
