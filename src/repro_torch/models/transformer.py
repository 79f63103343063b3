"""Decoder-only language models (dense, SSM and the zamba2-style hybrid):
training forward and loss, the decode step over dense KV caches and SSM
states, and the dense model's paged serving steps.

The JAX package stacks the L blocks' weights with a leading layer axis and
runs them with ``lax.scan``; here the model is an ``nn.Module`` holding a
``ModuleList`` of L blocks, walked by a Python loop.  Weights keep the JAX
layout (``x @ w``, ``w`` of shape (d_in, d_out)) and names::

  LM
    embed        (V, d)
    blocks[i]    DenseBlock: ln1 (d,), attn (Attention), ln2 (d,), mlp (SwiGLU)
                 or SSMBlock: ln1 (d,), ssm (SSM)
    shared_attn  SharedAttention: ln (d,), attn (Attention); hybrid only, one
                 block whose weights every attention call shares
    final_norm   (d,)
    head         (d, V), or None when the embeddings are tied

Parameters are trainable; the serving steps run under
``torch.inference_mode()``.  The dense-cache decode (:func:`decode_step`)
covers dense, SSM and hybrid decoders; the paged steps cover pure-attention
decoders.  Training (:func:`lm_forward`, :func:`lm_loss`) covers every arch
that :func:`build_stacks` builds; on the card an attention layer's
gradients run through the flash-attention backward kernel.
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
from .ssm import (SSM, init_ssm, init_ssm_state, ssm_block,
                  ssm_block_decode)


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


class SharedAttention(nn.Module):
    """The hybrid's weight-shared attention block: ln (d,), attn."""

    def __init__(self, ln: torch.Tensor, attn: Attention):
        super().__init__()
        self.ln = _param(ln)
        self.attn = attn


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks: List[nn.Module],
                 final_norm: torch.Tensor, head: Optional[torch.Tensor],
                 shared_attn: Optional[SharedAttention] = None):
        super().__init__()
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.register_module("shared_attn", shared_attn)
        self.final_norm = _param(final_norm)
        self.register_parameter("head", _param(head))


def build_stacks(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Sequence of (kind, n_layers) segments for the architectures the port
    builds: one segment of dense or of SSM blocks.  The hybrid is one SSM
    segment; its shared attention block is interleaved by the model
    functions, as in the JAX package."""
    if cfg.n_experts > 1 or cfg.arch_type == "moe":
        raise NotImplementedError(
            f"{cfg.name!r} is a MoE model (n_experts={cfg.n_experts}): the "
            "port has no MoE block yet (ROADMAP.md queue 1, item 3)")
    if cfg.arch_type in ("ssm", "hybrid"):
        return [("ssm", cfg.n_layers)]
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"the port builds dense, SSM and hybrid decoders only so far; "
            f"{cfg.name!r} has arch_type={cfg.arch_type!r} (ROADMAP.md "
            "queue 1, item 4)")
    return [("dense", cfg.n_layers)]


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: torch.device = "cuda") -> LM:
    """Random weights drawn on ``device`` from ``torch.Generator(seed)``,
    with the JAX package's distributions (not its numbers)."""
    parts = init_lm_parts(cfg, seed=seed, device=device)
    return LM(parts["embed"], [parts["blocks"][i]
                               for i in range(cfg.n_layers)],
              parts["final_norm"], parts["head"], parts["shared_attn"])


def init_lm_parts(cfg: ModelConfig, *, seed: int = 0,
                  device: torch.device = "cuda",
                  keep: Optional[Callable[[Any], bool]] = None
                  ) -> Dict[str, Any]:
    """:func:`init_lm`'s draws, in its order (blocks 0..L-1, the shared
    attention block, the head, the embedding), as {"embed", "blocks" (layer
    index -> block), "final_norm", "head", "shared_attn"}.  ``keep(part)``,
    asked for each layer index and for ``"embed"``, ``"head"`` and
    ``"shared_attn"``, drops a part it refuses as soon as it is drawn (its
    entry is None, or absent from "blocks"): a pipeline stage holds the
    same numbers as the whole model without ever holding the whole model."""
    ((kind, n),) = build_stacks(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev)
    d, dt = cfg.d_model, cfg.dtype
    keep = keep or (lambda part: True)

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    blocks = {}
    for i in range(n):
        blk = (SSMBlock(ones(), init_ssm(cfg, **kw)) if kind == "ssm" else
               DenseBlock(ones(), init_attention(cfg, **kw), ones(),
                          init_swiglu(d, cfg.d_ff, dt, **kw)))
        if keep(i):
            blocks[i] = blk
        del blk
    shared = (SharedAttention(ones(), init_attention(cfg, **kw))
              if cfg.arch_type == "hybrid" and cfg.attn_every else None)
    head = (None if cfg.tie_embeddings
            else init_dense(d, cfg.vocab_size, dt, **kw))
    embed = init_embedding(cfg.vocab_size, d, dt, **kw)
    return {"embed": embed if keep("embed") else None, "blocks": blocks,
            "final_norm": ones(),
            "head": head if keep("head") else None,
            "shared_attn": shared if keep("shared_attn") else None}


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


def _segments(cfg: ModelConfig) -> List[Tuple[str, int, int, bool]]:
    """(kind, first block, end block, shared attention after it) of each
    segment: the one stack of :func:`build_stacks`, or for the hybrid SSM
    segments of ``attn_every`` layers, each full one followed by the
    shared attention block (a shorter tail segment is not)."""
    ((kind, n),) = build_stacks(cfg)
    if cfg.arch_type != "hybrid" or not cfg.attn_every:
        return [(kind, 0, n, False)]
    k = cfg.attn_every
    return [(kind, i, min(n, i + k), i + k <= n) for i in range(0, n, k)]


def lm_forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
               remat_segments: Optional[Sequence[bool]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> logits (B,S,V) and the auxiliary loss (zero: dense
    and SSM blocks have none).

    Query ``s`` sits at position ``s``; attention takes the config's
    ``sliding_window``.  The hybrid runs SSM segments of ``attn_every``
    layers, the shared attention block (causal) after each full one.
    Segment ``i`` is rematerialised when ``remat_segments[min(i, len -
    1)]`` is true (the JAX rule: a one-entry list covers every segment);
    the shared block is not."""
    x = embed(params.embed, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    win = cfg.sliding_window
    sa = params.shared_attn
    for si, (kind, i, j, shared) in enumerate(_segments(cfg)):
        fn = _BLOCK_APPLY[kind]
        remat = (bool(remat_segments[min(si, len(remat_segments) - 1)])
                 if remat_segments else False)
        for blk in params.blocks[i:j]:
            if remat:
                x = checkpoint(fn, blk, x, positions, cfg, window=win,
                               use_reentrant=False)
            else:
                x = fn(blk, x, positions, cfg, window=win)
        if shared and sa is not None:
            h = rms_norm(x, sa.ln, cfg.norm_eps)
            x = x + attention(sa.attn, h, positions, cfg, window=win)
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

def init_decode_state(cfg: ModelConfig, batch: int, context: int, *,
                      device: torch.device = "cuda") -> Dict[str, Any]:
    """The dense-cache decode state of ``batch`` lanes::

      "caches"      one K/V cache (:func:`init_kv_cache`, ``context`` slots)
                    per attention call of a step, in call order: a layer's
                    for a dense model, one per shared-block call
                    (``n_layers // attn_every``) for the hybrid, none for
                    an SSM model
      "ssm_states"  one :func:`init_ssm_state` per SSM layer (SSM and
                    hybrid models): "ssm" (B,H,P,N), "conv" (B,K-1,di+2N),
                    fp32
      "index"       0-d int32; the serve loop makes it per lane (B,)

    :func:`decode_step` writes every cache and state in place.  Raises
    NotImplementedError for an arch :func:`build_stacks` does not build."""
    segments = _segments(cfg)
    dev = resolve_device(device)
    n_attn = (cfg.n_layers if cfg.arch_type == "dense"
              else sum(shared for *_, shared in segments))
    state: Dict[str, Any] = {
        "caches": [init_kv_cache(cfg, batch, context, device=dev)
                   for _ in range(n_attn)]}
    if cfg.arch_type != "dense":
        state["ssm_states"] = [init_ssm_state(cfg, batch, device=dev)
                               for _ in range(cfg.n_layers)]
    state["index"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def reset_decode_lane(state: Dict[str, Any], lane: int) -> None:
    """Start lane ``lane`` of a per-lane decode state over, in place: its
    index to 0, and its rows of every SSM state and conv history to zeros.
    The index alone hides a previous request's K/V (the decode mask admits
    only slots below it); an SSM state carries the whole past and must be
    cleared, or the next request on the lane reads its predecessor's."""
    state["index"][lane] = 0
    for st in state.get("ssm_states", ()):
        st["ssm"][lane].zero_()
        st["conv"][lane].zero_()


def decode_step(params: LM, state: Dict[str, Any], token: torch.Tensor,
                cfg: ModelConfig, *, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B,) -> logits (B, V) and the new state.

    The token's K/V are written into ``state["caches"]`` and each SSM
    layer's state into ``state["ssm_states"]``, in place; the new state
    holds the same tensors and ``index + 1``.  Attention takes ``window``,
    else the config's ``sliding_window``.  The hybrid runs the shared
    attention block after each full segment of ``attn_every`` SSM layers,
    as :func:`lm_forward` does, each call on a cache of its own."""
    build_stacks(cfg)
    x = embed(params.embed, token)[:, None, :]
    index = state["index"]
    win = window if window is not None else cfg.sliding_window
    if cfg.arch_type == "dense":
        x = _cache_layers(
            params, state["caches"], x, cfg,
            lambda p, h, cache: attention_decode(p, h, cache, index, cfg,
                                                 window=win)[0])
    else:
        x = _ssm_decode_layers(params, state, x, index, cfg, win)
    return _logits(params, x, cfg)[:, 0], dict(state, index=index + 1)


def _ssm_decode_layers(params: LM, state: Dict[str, Any], x: torch.Tensor,
                       index: torch.Tensor, cfg: ModelConfig,
                       window: Optional[int]) -> torch.Tensor:
    """The SSM blocks one token: ln1, ``ssm_block_decode`` on the layer's
    state, residual; after each full segment of the hybrid, the shared
    attention block on the next of ``state["caches"]``."""
    sa, caches = params.shared_attn, iter(state["caches"])
    for _, i, j, shared in _segments(cfg):
        for blk, st in zip(params.blocks[i:j], state["ssm_states"][i:j]):
            h = rms_norm(x, blk.ln1, cfg.norm_eps)
            x = x + ssm_block_decode(blk.ssm, h, st, cfg)[0]
        if shared and sa is not None:
            h = rms_norm(x, sa.ln, cfg.norm_eps)
            x = x + attention_decode(sa.attn, h, next(caches), index, cfg,
                                     window=window)[0]
    return x


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
