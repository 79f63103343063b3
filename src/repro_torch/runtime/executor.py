"""The serving engine's device steps (``runtime/executor.py`` counterpart).

The JAX package jit-compiles each step with shardings and donated pools.
PyTorch runs eagerly on one device, so a built step is the model function
under ``torch.inference_mode()``; the pools are updated in place.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.models.attention import Pool
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (LM, paged_decode_step,
                                            paged_prefill_step)


def make_paged_decode_step(cfg: ModelConfig) -> Callable[..., torch.Tensor]:
    """``(params, pools, token (B,), page_rows (B,P), lengths (B,))`` ->
    logits (B, V); the pools are written in place."""

    @torch.inference_mode()
    def step(params: LM, pools: List[Pool], token: torch.Tensor,
             page_rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return paged_decode_step(params, pools, token, page_rows, lengths,
                                 cfg)

    return step


def make_paged_prefill_step(cfg: ModelConfig) -> Callable[..., torch.Tensor]:
    """``(params, pools, tokens (PB,S), page_rows (PB,P), base, prompt_len
    (PB,))`` -> last-prompt-position logits (PB, V); the pools are written
    in place."""

    @torch.inference_mode()
    def step(params: LM, pools: List[Pool], tokens: torch.Tensor,
             page_rows: torch.Tensor, base: int,
             prompt_len: torch.Tensor) -> torch.Tensor:
        return paged_prefill_step(params, pools, tokens, page_rows, base,
                                  prompt_len, cfg)

    return step
