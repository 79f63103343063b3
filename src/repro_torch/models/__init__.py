"""Model zoo of the port: dense, MoE, SSM and hybrid decoders and the
encoder-decoder, for serving and training."""
from .common import ModelConfig
from .encdec import (EncDec, decode_train, encdec_decode_step, encdec_loss,
                     encode, init_encdec, init_encdec_decode_state)
from .transformer import (LM, build_stacks, decode_step, init_decode_state,
                          init_lm, init_paged_state, lm_forward, lm_loss,
                          paged_decode_step, paged_prefill_step,
                          reset_decode_lane, supports_paged_decode)

__all__ = ["EncDec", "LM", "ModelConfig", "build_stacks", "decode_step",
           "decode_train", "encdec_decode_step", "encdec_loss", "encode",
           "init_decode_state", "init_encdec", "init_encdec_decode_state",
           "init_lm", "init_paged_state", "lm_forward", "lm_loss",
           "paged_decode_step", "paged_prefill_step", "reset_decode_lane",
           "supports_paged_decode"]
