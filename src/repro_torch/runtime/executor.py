"""Device steps: training, prefill, the dense-cache decode step and the
serving engine's (``runtime/executor.py`` counterpart), on one device.

The JAX package jit-compiles each step with shardings and donated buffers.
PyTorch runs eagerly, so a built step is the model function itself: the
training step runs value-and-grad of ``lm_loss`` and the AdamW update, which
writes the parameters and optimizer state in place; the prefill and serving
steps run under ``torch.inference_mode()``, and the serving steps update the
caches or pools in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import Pool
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (LM, build_stacks, decode_step,
                                            init_lm, lm_forward, lm_loss,
                                            paged_decode_step,
                                            paged_prefill_step)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device: torch.device = "cuda"
                     ) -> Tuple[LM, Dict[str, Any]]:
    """Random weights from ``seed`` on ``device`` and their AdamW state.
    Raises NotImplementedError for an arch the port does not build."""
    params = init_lm(cfg, seed=seed, device=resolve_device(device))
    return params, adamw_init(list(params.parameters()), opt_cfg)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[AdamWConfig] = None, *,
                    remat_segments: Optional[Sequence[bool]] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``(params, opt_state, batch)`` -> ``{"loss", "grad_norm", "lr"}``
    (0-d tensors on the params' device); params and opt_state are updated
    in place.  ``batch`` holds int ``tokens`` and ``labels`` (B, S).
    ``remat_segments`` goes to :func:`lm_loss` (the JAX executor takes it
    from the plan's policy; the port reads no plans yet).  Raises
    NotImplementedError for an arch the port does not build."""
    build_stacks(cfg)
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params: LM, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        leaves = list(params.parameters())
        loss = lm_loss(params, batch, cfg, remat_segments=remat_segments)
        grads = torch.autograd.grad(loss, leaves)
        metrics = adamw_update(leaves, grads, opt_state, opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    return step


def make_prefill_step(cfg: ModelConfig
                      ) -> Callable[[LM, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """``(params, batch)`` -> logits (B, S, V): the inference forward of
    ``batch["tokens"]`` (B, S), :func:`lm_forward` without the loss, for
    every arch the port builds.  Raises NotImplementedError for another."""
    build_stacks(cfg)

    @torch.inference_mode()
    def step(params: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return lm_forward(params, batch["tokens"], cfg)[0]

    return step


def make_serve_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor,
                                                            Dict[str, Any]]]:
    """``(params, state, token (B,))`` -> ``(logits (B, V), state)``: one
    decode step on the KV caches and SSM states of ``init_decode_state``,
    written in place, for dense, SSM and hybrid decoders.  Raises
    NotImplementedError for an arch the port does not build."""
    build_stacks(cfg)

    @torch.inference_mode()
    def step(params: LM, state: Dict[str, Any], token: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        return decode_step(params, state, token, cfg)

    return step


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
