"""Model zoo of the port: dense, MoE, SSM and hybrid decoders (serving and
training)."""
from .common import ModelConfig
from .transformer import (LM, build_stacks, decode_step, init_decode_state,
                          init_lm, init_paged_state, lm_forward, lm_loss,
                          paged_decode_step, paged_prefill_step,
                          reset_decode_lane, supports_paged_decode)

__all__ = ["LM", "ModelConfig", "build_stacks", "decode_step",
           "init_decode_state", "init_lm", "init_paged_state", "lm_forward",
           "lm_loss", "paged_decode_step", "paged_prefill_step",
           "reset_decode_lane", "supports_paged_decode"]
