"""Model zoo of the port: dense decoders (serving and training) and SSM
decoders (training and prefill)."""
from .common import ModelConfig
from .transformer import (LM, build_stacks, decode_step, init_decode_state,
                          init_lm, init_paged_state, lm_forward, lm_loss,
                          paged_decode_step, paged_prefill_step,
                          supports_paged_decode)

__all__ = ["LM", "ModelConfig", "build_stacks", "decode_step",
           "init_decode_state", "init_lm", "init_paged_state", "lm_forward",
           "lm_loss", "paged_decode_step", "paged_prefill_step",
           "supports_paged_decode"]
