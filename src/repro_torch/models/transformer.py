"""Decoder-only language model (dense) and its paged serving steps.

The JAX package stacks the L blocks' weights with a leading layer axis and
runs them with ``lax.scan``; here the model is an ``nn.Module`` holding a
``ModuleList`` of L blocks, walked by a Python loop.  Weights keep the JAX
layout (``x @ w``, ``w`` of shape (d_in, d_out)) and names::

  LM
    embed       (V, d)
    blocks[i]   DenseBlock: ln1 (d,), attn (Attention), ln2 (d,), mlp (SwiGLU)
    final_norm  (d,)
    head        (d, V), or None when the embeddings are tied
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device

from .attention import (Attention, Pool, attention_decode_paged,
                        attention_prefill_paged, init_attention,
                        init_page_pool)
from .common import ModelConfig
from .embedding import embed, init_embedding
from .layers import init_dense, rms_norm
from .mlp import SwiGLU, init_swiglu, swiglu_mlp


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    def __init__(self, ln1: torch.Tensor, attn: Attention, ln2: torch.Tensor,
                 mlp: SwiGLU):
        super().__init__()
        self.ln1 = _param(ln1)
        self.attn = attn
        self.ln2 = _param(ln2)
        self.mlp = mlp


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks: List[DenseBlock],
                 final_norm: torch.Tensor, head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _param(final_norm)
        self.register_parameter("head", _param(head))


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.n_experts > 1:
        raise NotImplementedError(
            f"the port builds dense decoders only so far; {cfg.name!r} has "
            f"arch_type={cfg.arch_type!r}, n_experts={cfg.n_experts}")


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: torch.device = "cuda") -> LM:
    """Random weights drawn on ``device`` from ``torch.Generator(seed)``,
    with the JAX package's distributions (not its numbers)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev)
    d, dt = cfg.d_model, cfg.dtype

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    blocks = [DenseBlock(ones(), init_attention(cfg, **kw), ones(),
                         init_swiglu(d, cfg.d_ff, dt, **kw))
              for _ in range(cfg.n_layers)]
    head = (None if cfg.tie_embeddings
            else init_dense(d, cfg.vocab_size, dt, **kw))
    return LM(init_embedding(cfg.vocab_size, d, dt, **kw), blocks, ones(),
              head)


def _logits(params: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if params.head is not None:
        return x @ params.head
    return x @ params.embed.T


def supports_paged_decode(cfg: ModelConfig) -> bool:
    """Paged serving covers pure-attention decoders; SSM/hybrid state is not
    paged and enc-dec needs cross-attention."""
    return (not cfg.is_encoder_decoder
            and cfg.arch_type not in ("ssm", "hybrid"))


def init_paged_state(cfg: ModelConfig, n_pages: int, page_size: int, *,
                     device: torch.device = "cuda") -> List[Pool]:
    """One K/V page pool per layer, shared by every lane: KV memory is
    n_pages * page_size tokens per layer however many lanes there are."""
    if not supports_paged_decode(cfg):
        raise NotImplementedError(
            f"paged decode does not support arch_type={cfg.arch_type!r}")
    dev = resolve_device(device)
    return [init_page_pool(cfg, n_pages, page_size, device=dev)
            for _ in range(cfg.n_layers)]


def _paged_layers(params: LM, pools: List[Pool], x: torch.Tensor,
                  cfg: ModelConfig,
                  attn_fn: Callable[[Attention, torch.Tensor, Pool],
                                    torch.Tensor]) -> torch.Tensor:
    for blk, pool in zip(params.blocks, pools):
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        x = x + attn_fn(blk.attn, h, pool)
        h = rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + swiglu_mlp(blk.mlp, h)
    return x


def paged_decode_step(params: LM, pools: List[Pool], token: torch.Tensor,
                      page_rows: torch.Tensor, lengths: torch.Tensor,
                      cfg: ModelConfig, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """One decode step on the paged KV cache: token (B,) -> logits (B, V).

    ``page_rows`` (B, P) / ``lengths`` (B,) come from the serving engine's
    page table (one table for every layer; each layer owns its pool).  The
    new tokens' K/V are written into ``pools`` in place."""
    x = embed(params.embed, token)[:, None, :]
    win = window if window is not None else cfg.sliding_window
    x = _paged_layers(
        params, pools, x, cfg,
        lambda p, h, pool: attention_decode_paged(
            p, h, pool, page_rows, lengths, cfg, window=win))
    return _logits(params, x, cfg)[:, 0]


def paged_prefill_step(params: LM, pools: List[Pool], tokens: torch.Tensor,
                       page_rows: torch.Tensor, base: int,
                       prompt_len: torch.Tensor, cfg: ModelConfig, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """One chunked-prefill step: prompt chunk ``tokens`` (B, S) covering
    absolute positions [base, base + S), K/V written into ``pools`` in
    place.  Returns logits (B, V) at each lane's *last prompt position*
    (meaningful only for lanes whose prompt ends inside this chunk)."""
    B, S = tokens.shape
    x = embed(params.embed, tokens)
    win = window if window is not None else cfg.sliding_window
    x = _paged_layers(
        params, pools, x, cfg,
        lambda p, h, pool: attention_prefill_paged(
            p, h, pool, page_rows, base, prompt_len, cfg, window=win))
    last = (prompt_len.long() - 1 - base).clamp(0, S - 1)       # (B,)
    xl = x[torch.arange(B, device=x.device), last][:, None, :]  # (B,1,d)
    return _logits(params, xl, cfg)[:, 0]
