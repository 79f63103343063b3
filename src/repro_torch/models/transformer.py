"""Decoder-only language models (dense and SSM): training forward and loss,
the dense model's decode step over dense KV caches, and its paged serving
steps.

The JAX package stacks the L blocks' weights with a leading layer axis and
runs them with ``lax.scan``; here the model is an ``nn.Module`` holding a
``ModuleList`` of L blocks, walked by a Python loop.  Weights keep the JAX
layout (``x @ w``, ``w`` of shape (d_in, d_out)) and names::

  LM
    embed       (V, d)
    blocks[i]   DenseBlock: ln1 (d,), attn (Attention), ln2 (d,), mlp (SwiGLU)
                or SSMBlock: ln1 (d,), ssm (SSM)
    final_norm  (d,)
    head        (d, V), or None when the embeddings are tied

Parameters are trainable; the serving steps run under
``torch.inference_mode()``.  Decode (:func:`decode_step`, dense-cache or
paged) covers pure-attention decoders; SSM decode is not ported yet.
Training (:func:`lm_forward`, :func:`lm_loss`) covers every arch that
:func:`build_stacks` builds, dense and SSM; on the card an attention
layer's gradients run through the flash-attention backward kernel.
``remat_segments`` ports the JAX
package's per-segment remat (``apply_stack(remat=...)``, ``jax.checkpoint``
around each scanned block) as ``torch.utils.checkpoint`` around each block
of the segment: its activations are recomputed in the backward.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from .attention import (Attention, Pool, attention, attention_decode,
                        attention_decode_paged, attention_prefill_paged,
                        init_attention, init_kv_cache, init_page_pool)
from .common import ModelConfig
from .embedding import embed, init_embedding
from .layers import cross_entropy_loss, init_dense, rms_norm
from .mlp import SwiGLU, init_swiglu, swiglu_mlp
from .ssm import SSM, init_ssm, ssm_block


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t)


class DenseBlock(nn.Module):
    def __init__(self, ln1: torch.Tensor, attn: Attention, ln2: torch.Tensor,
                 mlp: SwiGLU):
        super().__init__()
        self.ln1 = _param(ln1)
        self.attn = attn
        self.ln2 = _param(ln2)
        self.mlp = mlp


class SSMBlock(nn.Module):
    def __init__(self, ln1: torch.Tensor, ssm: SSM):
        super().__init__()
        self.ln1 = _param(ln1)
        self.ssm = ssm


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks: List[nn.Module],
                 final_norm: torch.Tensor, head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _param(final_norm)
        self.register_parameter("head", _param(head))


def build_stacks(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Sequence of (kind, n_layers) segments for the architectures the port
    builds: one segment of dense or of SSM blocks."""
    if cfg.arch_type == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.arch_type != "dense" or cfg.n_experts > 1:
        raise NotImplementedError(
            f"the port builds dense and SSM decoders only so far; "
            f"{cfg.name!r} has arch_type={cfg.arch_type!r}, "
            f"n_experts={cfg.n_experts}")
    return [("dense", cfg.n_layers)]


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: torch.device = "cuda") -> LM:
    """Random weights drawn on ``device`` from ``torch.Generator(seed)``,
    with the JAX package's distributions (not its numbers)."""
    ((kind, n),) = build_stacks(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev)
    d, dt = cfg.d_model, cfg.dtype

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    if kind == "ssm":
        blocks = [SSMBlock(ones(), init_ssm(cfg, **kw)) for _ in range(n)]
    else:
        blocks = [DenseBlock(ones(), init_attention(cfg, **kw), ones(),
                             init_swiglu(d, cfg.d_ff, dt, **kw))
                  for _ in range(n)]
    head = (None if cfg.tie_embeddings
            else init_dense(d, cfg.vocab_size, dt, **kw))
    return LM(init_embedding(cfg.vocab_size, d, dt, **kw), blocks, ones(),
              head)


def _logits(params: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if params.head is not None:
        return x @ params.head
    return x @ params.embed.T


def dense_block(p: DenseBlock, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *,
                window: Optional[int] = None) -> torch.Tensor:
    """Pre-norm causal attention and SwiGLU MLP, each with its residual."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attention(p.attn, h, positions, cfg, window=window)
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + swiglu_mlp(p.mlp, h)


def ssm_block_outer(p: SSMBlock, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, **_) -> torch.Tensor:
    """Pre-norm SSM mixer with its residual (positions unused)."""
    return x + ssm_block(p.ssm, rms_norm(x, p.ln1, cfg.norm_eps), cfg)


_BLOCK_APPLY = {"dense": dense_block, "ssm": ssm_block_outer}


def lm_forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
               remat_segments: Optional[Sequence[bool]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> logits (B,S,V) and the auxiliary loss (zero: dense
    and SSM blocks have none).

    Query ``s`` sits at position ``s``; attention takes the config's
    ``sliding_window``.  Segment ``i`` of :func:`build_stacks` is
    rematerialised when ``remat_segments[min(i, len - 1)]`` is true (the
    JAX rule: a one-entry list covers every segment)."""
    x = embed(params.embed, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    win = cfg.sliding_window
    blocks = iter(params.blocks)
    for si, (kind, n) in enumerate(build_stacks(cfg)):
        fn = _BLOCK_APPLY[kind]
        remat = (bool(remat_segments[min(si, len(remat_segments) - 1)])
                 if remat_segments else False)
        for _ in range(n):
            blk = next(blocks)
            if remat:
                x = checkpoint(fn, blk, x, positions, cfg, window=win,
                               use_reentrant=False)
            else:
                x = fn(blk, x, positions, cfg, window=win)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), aux


def lm_loss(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat_segments: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (``-100`` ignored), plus the weighted aux loss."""
    logits, aux = lm_forward(params, batch["tokens"], cfg,
                             remat_segments=remat_segments)
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss + cfg.router_aux_coef * aux


# --------------------------------------------------------------------------
# decode over dense KV caches
# --------------------------------------------------------------------------

def check_dense_decode(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless the port decodes ``cfg``: dense
    decoders only.  The JAX package also decodes SSM and hybrid models;
    SSM serving is the port's next slice."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"the port decodes pure-attention models only so far; "
            f"{cfg.name!r} has arch_type={cfg.arch_type!r}: SSM serving "
            "(ssd_step, init_ssm_state, ssm_block_decode) is the next slice")
    build_stacks(cfg)


def init_decode_state(cfg: ModelConfig, batch: int, context: int, *,
                      device: torch.device = "cuda") -> Dict[str, Any]:
    """``{"caches": one K/V cache per layer (:func:`init_kv_cache`),
    "index": 0-d int32}``; the serve loop makes ``index`` per lane (B,)."""
    check_dense_decode(cfg)
    dev = resolve_device(device)
    return {"caches": [init_kv_cache(cfg, batch, context, device=dev)
                       for _ in range(cfg.n_layers)],
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params: LM, state: Dict[str, Any], token: torch.Tensor,
                cfg: ModelConfig, *, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B,) -> logits (B, V) and the new state.

    The token's K/V are written into ``state["caches"]`` in place; the new
    state holds the same caches and ``index + 1``.  Attention takes
    ``window``, else the config's ``sliding_window``."""
    check_dense_decode(cfg)
    x = embed(params.embed, token)[:, None, :]
    index = state["index"]
    win = window if window is not None else cfg.sliding_window
    x = _cache_layers(
        params, state["caches"], x, cfg,
        lambda p, h, cache: attention_decode(p, h, cache, index, cfg,
                                             window=win)[0])
    return (_logits(params, x, cfg)[:, 0],
            {"caches": state["caches"], "index": index + 1})


# --------------------------------------------------------------------------
# paged decode (serving engine)
# --------------------------------------------------------------------------

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


def _cache_layers(params: LM, caches: List[Pool], x: torch.Tensor,
                  cfg: ModelConfig,
                  attn_fn: Callable[[Attention, torch.Tensor, Pool],
                                    torch.Tensor]) -> torch.Tensor:
    """The dense blocks over one cache or pool a layer: ln1, ``attn_fn``,
    residual, ln2, SwiGLU, residual."""
    for blk, pool in zip(params.blocks, caches):
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
    x = _cache_layers(
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
    x = _cache_layers(
        params, pools, x, cfg,
        lambda p, h, pool: attention_prefill_paged(
            p, h, pool, page_rows, base, prompt_len, cfg, window=win))
    last = (prompt_len.long() - 1 - base).clamp(0, S - 1)       # (B,)
    xl = x[torch.arange(B, device=x.device), last][:, None, :]  # (B,1,d)
    return _logits(params, xl, cfg)[:, 0]
