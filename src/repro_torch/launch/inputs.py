"""``input_specs()`` — ``meta`` stand-ins for every model input of every
(architecture x input shape), with no storage (``repro/launch/inputs.py``,
whose ``ShapeDtypeStruct``\\ s these replace)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import InputShape, ModelConfig

# sliding-window span used to make `long_500k` sub-quadratic on attention
# architectures (dense/moe/vlm/audio); SSM/hybrid run it natively.
LONG_CONTEXT_WINDOW = 8192

# the port's token and label dtype (``data/pipeline.py`` draws int32)
TOKEN_DTYPE = torch.int32


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape model adjustments (DESIGN.md §4)."""
    if (shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid")
            and cfg.sliding_window is None):
        return cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Batch inputs for train/prefill modes, ``meta`` tensors (shapes
    only): ``tokens`` and ``labels`` (B, S) of
    :data:`TOKEN_DTYPE`; a VLM's fp32 ``patches`` (B, vision_tokens,
    d_vision); an encoder-decoder's fp32 ``frames`` (B, encoder_seq,
    d_model); no ``labels`` outside ``train``."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty((B, S), dtype=TOKEN_DTYPE, device="meta"),
           "labels": torch.empty((B, S), dtype=TOKEN_DTYPE, device="meta")}
    if cfg.arch_type == "vlm":
        out["patches"] = torch.empty((B, cfg.vision_tokens, cfg.d_vision),
                                     dtype=torch.float32, device="meta")
    if cfg.is_encoder_decoder:
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=torch.float32, device="meta")
    if shape.mode != "train":
        out.pop("labels")
    return out


def decode_dims(cfg: ModelConfig, shape: InputShape) -> Tuple[int, int]:
    """(batch, kv-context) for decode shapes."""
    return shape.global_batch, shape.seq_len
