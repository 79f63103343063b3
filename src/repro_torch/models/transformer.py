"""Decoder-only language models (dense, MoE, SSM and the zamba2-style
hybrid): training forward and loss, the decode step over dense KV caches
and SSM states, and the attention models' paged serving steps.

The JAX package stacks the L blocks' weights with a leading layer axis and
runs them with ``lax.scan``; here the model is an ``nn.Module`` holding a
``ModuleList`` of L blocks, walked by a Python loop.  Weights keep the JAX
layout (``x @ w``, ``w`` of shape (d_in, d_out)) and names::

  LM
    embed        (V, d)
    blocks[i]    DenseBlock: ln1 (d,), attn (Attention), ln2 (d,), mlp (SwiGLU)
                 or MoEBlock: ln1 (d,), attn (Attention), ln2 (d,), moe (MoE)
                 or SSMBlock: ln1 (d,), ssm (SSM)
    shared_attn  SharedAttention: ln (d,), attn (Attention); hybrid only, one
                 block whose weights every attention call shares
    final_norm   (d,)
    head         (d, V), or None when the embeddings are tied

Parameters are trainable; the serving steps run under
``torch.inference_mode()``.  The dense-cache decode (:func:`decode_step`)
covers dense, MoE, SSM and hybrid decoders; the paged steps cover
pure-attention decoders (dense and MoE).  A MoE model's blocks are
``first_k_dense`` dense blocks, then MoE blocks (:func:`build_stacks`);
its aux loss is summed over the MoE blocks.  Training
(:func:`lm_forward`, :func:`lm_loss`) covers every arch that
:func:`build_stacks` builds; on the card an attention layer's
gradients run through the flash-attention backward kernel.
``remat_segments`` ports the JAX
package's per-segment remat (``apply_stack(remat=...)``, ``jax.checkpoint``
around each scanned block) as ``torch.utils.checkpoint`` around each block
of the segment: its activations are recomputed in the backward.
"""
from __future__ import annotations

import functools
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
from .moe import MoE, init_moe, moe_ffn
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


class MoEBlock(nn.Module):
    def __init__(self, ln1: torch.Tensor, attn: Attention, ln2: torch.Tensor,
                 moe: MoE):
        super().__init__()
        self.ln1 = _param(ln1)
        self.attn = attn
        self.ln2 = _param(ln2)
        self.moe = moe


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
    """Sequence of (kind, n_layers) segments, as the JAX package's: one
    segment of SSM blocks (SSM and hybrid; the hybrid's shared attention
    block is interleaved by the model functions), ``first_k_dense`` dense
    blocks then MoE blocks for a model with experts, else one segment of
    dense blocks.  Raises NotImplementedError for an arch the port does
    not build (VLM, audio)."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return [("ssm", cfg.n_layers)]
    if cfg.arch_type not in ("dense", "moe"):
        raise NotImplementedError(
            f"the port builds dense, MoE, SSM and hybrid decoders only so "
            f"far; {cfg.name!r} has arch_type={cfg.arch_type!r} (ROADMAP.md "
            "queue 1, item 5)")
    if cfg.n_experts > 1:
        segs = [("dense", cfg.first_k_dense)] if cfg.first_k_dense else []
        return segs + [("moe", cfg.n_layers - cfg.first_k_dense)]
    return [("dense", cfg.n_layers)]


def is_attention_stack(cfg: ModelConfig) -> bool:
    """True for a model of attention blocks only (dense or MoE): one K/V
    cache or pool a layer."""
    return all(kind != "ssm" for kind, _ in build_stacks(cfg))


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: torch.device = "cuda",
            shard: Optional[Callable[[str, Any], Any]] = None) -> LM:
    """Random weights drawn on ``device`` from ``torch.Generator(seed)``,
    with the JAX package's distributions (not its numbers).  On the
    ``meta`` device only the shapes exist.  ``shard`` goes to
    :func:`init_lm_parts`."""
    parts = init_lm_parts(cfg, seed=seed, device=device, shard=shard)
    return LM(parts["embed"], [parts["blocks"][i]
                               for i in range(cfg.n_layers)],
              parts["final_norm"], parts["head"], parts["shared_attn"])


def init_lm_parts(cfg: ModelConfig, *, seed: int = 0,
                  device: torch.device = "cuda",
                  keep: Optional[Callable[[Any], bool]] = None,
                  shard: Optional[Callable[[str, Any], Any]] = None
                  ) -> Dict[str, Any]:
    """:func:`init_lm`'s draws, in its order (blocks 0..L-1, the shared
    attention block, the head, the embedding), as {"embed", "blocks" (layer
    index -> block), "final_norm", "head", "shared_attn"}.  ``keep(part)``,
    asked for each layer index and for ``"embed"``, ``"head"`` and
    ``"shared_attn"``, drops a part it refuses as soon as it is drawn (its
    entry is None, or absent from "blocks"): a pipeline stage holds the
    same numbers as the whole model without ever holding the whole model.
    ``shard(name, part)`` replaces each kept part as soon as it is drawn
    (``blocks.<i>``, ``shared_attn``, ``head``, ``embed``,
    ``final_norm``): a sharded run keeps its rank's shards of the same
    numbers (``runtime/sharding.py::ShardContext.shard_part``).  A MoE
    block draws its experts one at a time (``models/moe.py::init_moe``)."""
    kinds = [kind for kind, n in build_stacks(cfg) for _ in range(n)]
    dev = resolve_device(device)
    g = torch.Generator(device="cpu" if dev.type == "meta" else dev
                        ).manual_seed(seed)
    kw = dict(generator=g, device=dev)
    d, dt = cfg.d_model, cfg.dtype
    keep = keep or (lambda part: True)
    shard = shard or (lambda name, part: part)

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    blocks = {}
    for i, kind in enumerate(kinds):
        if kind == "ssm":
            blk = SSMBlock(ones(), init_ssm(cfg, **kw))
        elif kind == "moe":
            blk = MoEBlock(ones(), init_attention(cfg, **kw), ones(),
                           init_moe(cfg, **kw))
        else:
            blk = DenseBlock(ones(), init_attention(cfg, **kw), ones(),
                             init_swiglu(d, cfg.d_ff, dt, **kw))
        if keep(i):
            blocks[i] = shard(f"blocks.{i}", blk)
        del blk
    shared = (SharedAttention(ones(), init_attention(cfg, **kw))
              if cfg.arch_type == "hybrid" and cfg.attn_every else None)
    shared = shard("shared_attn", shared) if keep("shared_attn") else None
    head = (None if cfg.tie_embeddings
            else init_dense(d, cfg.vocab_size, dt, **kw))
    head = shard("head", head) if keep("head") else None
    embed = init_embedding(cfg.vocab_size, d, dt, **kw)
    return {"embed": shard("embed", embed) if keep("embed") else None,
            "blocks": blocks, "final_norm": shard("final_norm", ones()),
            "head": head, "shared_attn": shared}


def _logits(params: LM, x: torch.Tensor, cfg: ModelConfig,
            shard=None) -> torch.Tensor:
    """Final norm and head (``embed.T`` when tied); with a sharding
    context ``shard``, the rank's vocabulary columns."""
    if shard is None:
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        if params.head is not None:
            return x @ params.head
        return x @ params.embed.T
    x = shard.to_tp(rms_norm(x, shard.w(params.final_norm), cfg.norm_eps))
    if params.head is not None:
        return x @ shard.w(params.head)
    return x @ shard.w(params.embed).T


def dense_block(p: DenseBlock, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, window: Optional[int] = None,
                shard=None) -> torch.Tensor:
    """Pre-norm causal attention and SwiGLU MLP, each with its residual;
    ``shard`` runs both tensor-parallel (``runtime/sharding.py``)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attention(p.attn, h, positions, cfg, window=window, shard=shard)
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + swiglu_mlp(p.mlp, h, shard)


def moe_block(p: MoEBlock, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, window: Optional[int] = None,
              shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm causal attention and the MoE FFN, each with its residual:
    -> (x, aux).  ``shard`` raises NotImplementedError in ``moe_ffn``."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attention(p.attn, h, positions, cfg, window=window, shard=shard)
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    y, aux = moe_ffn(p.moe, h, cfg, shard=shard)
    return x + y, aux


def ssm_block_outer(p: SSMBlock, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, shard=None, **_) -> torch.Tensor:
    """Pre-norm SSM mixer with its residual (positions unused); ``shard``
    runs the mixer tensor-parallel (``runtime/sharding.py``)."""
    return x + ssm_block(p.ssm, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                         shard=shard)


def shared_block(p: SharedAttention, x: torch.Tensor,
                 positions: torch.Tensor, cfg: ModelConfig, *,
                 window: Optional[int] = None, shard=None) -> torch.Tensor:
    """The hybrid's shared attention block with its residual."""
    h = rms_norm(x, p.ln, cfg.norm_eps)
    return x + attention(p.attn, h, positions, cfg, window=window,
                         shard=shard)


_BLOCK_APPLY = {"dense": dense_block, "moe": moe_block,
                "ssm": ssm_block_outer}


def _segments(cfg: ModelConfig) -> List[Tuple[str, int, int, bool]]:
    """(kind, first block, end block, shared attention after it) of each
    segment: the stacks of :func:`build_stacks` (a MoE model's dense
    blocks, then its MoE blocks), or for the hybrid SSM segments of
    ``attn_every`` layers, each full one followed by the shared attention
    block (a shorter tail segment is not)."""
    stacks = build_stacks(cfg)
    if cfg.arch_type != "hybrid" or not cfg.attn_every:
        out, i = [], 0
        for kind, n in stacks:
            out.append((kind, i, i + n, False))
            i += n
        return out
    ((kind, n),) = stacks
    k = cfg.attn_every
    return [(kind, i, min(n, i + k), i + k <= n) for i in range(0, n, k)]


def lm_forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
               remat_segments: Optional[Sequence[bool]] = None,
               shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> logits (B,S,V) and the auxiliary loss: the sum of
    the MoE blocks' load-balance losses (dense and SSM blocks have none).

    Query ``s`` sits at position ``s``; attention takes the config's
    ``sliding_window``.  The hybrid runs SSM segments of ``attn_every``
    layers, the shared attention block (causal) after each full one.
    Segment ``i`` is rematerialised when ``remat_segments[min(i, len -
    1)]`` is true (the JAX rule: a one-entry list covers every segment);
    the shared block is not.

    ``shard`` (``runtime/sharding.py::ShardContext``) runs the model on a
    rank's shards: each block through ``shard.block`` (its ZeRO weights
    gathered, TP inside, under sequence sharding the stash this rank's
    token slice), the embedding and the logits vocab-parallel; the logits
    are then the rank's vocabulary columns."""
    x = embed(params.embed, tokens, shard)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    win = cfg.sliding_window
    sa = params.shared_attn
    run_shared = shared_block
    if shard is not None:
        x = shard.seq_slice(x)
        run_shared = functools.partial(shard.block, shared_block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (kind, i, j, shared) in enumerate(_segments(cfg)):
        fn = _BLOCK_APPLY[kind]
        if shard is not None:
            fn = functools.partial(shard.block, fn)
        remat = (bool(remat_segments[min(si, len(remat_segments) - 1)])
                 if remat_segments else False)
        for blk in params.blocks[i:j]:
            if remat:
                out = checkpoint(fn, blk, x, positions, cfg, window=win,
                                 use_reentrant=False)
            else:
                out = fn(blk, x, positions, cfg, window=win)
            if kind == "moe":
                x, a = out
                aux = aux + a
            else:
                x = out
        if shared and sa is not None:
            x = run_shared(sa, x, positions, cfg, window=win)
    if shard is not None:
        x = shard.seq_gather(x)
    return _logits(params, x, cfg, shard), aux


def lm_loss(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat_segments: Optional[Sequence[bool]] = None,
            shard=None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (``-100`` ignored), plus the MoE blocks' aux loss
    weighted by ``router_aux_coef`` (zero without experts).  With a sharding context
    ``shard``, ``batch`` is the rank's data shard and the result its share:
    summed over ``data`` the shares give the global batch's loss, and
    their gradients its gradient."""
    logits, aux = lm_forward(params, batch["tokens"], cfg,
                             remat_segments=remat_segments, shard=shard)
    loss = cross_entropy_loss(logits, batch["labels"], shard=shard)
    return loss + cfg.router_aux_coef * aux


# --------------------------------------------------------------------------
# decode over dense KV caches
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, context: int, *,
                      device: torch.device = "cuda",
                      shard=None) -> Dict[str, Any]:
    """The dense-cache decode state of ``batch`` lanes::

      "caches"      one K/V cache (:func:`init_kv_cache`, ``context`` slots)
                    per attention call of a step, in call order: a layer's
                    for a dense or MoE model, one per shared-block call
                    (``n_layers // attn_every``) for the hybrid, none for
                    an SSM model
      "ssm_states"  one :func:`init_ssm_state` per SSM layer (SSM and
                    hybrid models): "ssm" (B,H,P,N), "conv" (B,K-1,di+2N),
                    fp32
      "index"       0-d int32; the serve loop makes it per lane (B,)

    With ``shard`` (``runtime/sharding.py::ShardContext``) each cache and
    state is the rank's share (``runtime/sharding.py::decode_state_specs``)
    and ``"layout"`` holds where it lies (``shard.decode_layout``); the
    index stays whole on every rank.

    :func:`decode_step` writes every cache and state in place.  Raises
    NotImplementedError for an arch :func:`build_stacks` does not build."""
    segments = _segments(cfg)
    dev = resolve_device(device)
    attn_stack = is_attention_stack(cfg)
    n_attn = (cfg.n_layers if attn_stack
              else sum(shared for *_, shared in segments))
    state: Dict[str, Any] = {
        "caches": [init_kv_cache(cfg, batch, context, device=dev,
                                 shard=shard)
                   for _ in range(n_attn)]}
    if not attn_stack:
        state["ssm_states"] = [init_ssm_state(cfg, batch, device=dev,
                                              shard=shard)
                               for _ in range(cfg.n_layers)]
    state["index"] = torch.zeros((), dtype=torch.int32, device=dev)
    if shard is not None:
        span = (context if cfg.sliding_window is None
                else min(context, cfg.sliding_window))
        state["layout"] = shard.decode_layout(batch, span)
    return state


def reset_decode_lane(state: Dict[str, Any], lane: int) -> None:
    """Start lane ``lane`` of a per-lane decode state over, in place: its
    index to 0, and its rows of every SSM state and conv history to zeros
    (on the rank that holds them, in a sharded state).
    The index alone hides a previous request's K/V (the decode mask admits
    only slots below it); an SSM state carries the whole past and must be
    cleared, or the next request on the lane reads its predecessor's."""
    state["index"][lane] = 0
    layout = state.get("layout")
    if layout is not None:
        lo, hi = layout.lanes
        if not lo <= lane < hi:
            return
        lane -= lo
    for st in state.get("ssm_states", ()):
        st["ssm"][lane].zero_()
        st["conv"][lane].zero_()


def decode_step(params: LM, state: Dict[str, Any], token: torch.Tensor,
                cfg: ModelConfig, *, window: Optional[int] = None,
                shard=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B,) -> logits (B, V) and the new state.

    The token's K/V are written into ``state["caches"]`` and each SSM
    layer's state into ``state["ssm_states"]``, in place; the new state
    holds the same tensors and ``index + 1``.  Attention takes ``window``,
    else the config's ``sliding_window``.  The hybrid runs the shared
    attention block after each full segment of ``attn_every`` SSM layers,
    as :func:`lm_forward` does, each call on a cache of its own.

    ``shard`` (``runtime/sharding.py::ShardContext``) runs a rank's share
    of a state from ``init_decode_state(shard=)``: its lanes of ``token``
    (every lane's, on every rank), each block through ``shard.block``
    (ZeRO weights gathered) on its caches and states, the embedding and the
    logits vocab-parallel under TP; the logits returned are every lane's
    whole rows, the same on every rank."""
    build_stacks(cfg)
    index = state["index"]
    idx, layout = index, state.get("layout")
    if shard is not None:
        if layout is None:
            raise ValueError("a sharded decode step takes a state of "
                             "init_decode_state(shard=)")
        lo, hi = layout.lanes
        token = token[lo:hi]
        idx = index[lo:hi] if index.dim() else index
    x = embed(params.embed, token, shard)[:, None, :]
    win = window if window is not None else cfg.sliding_window
    if is_attention_stack(cfg):
        x = _cache_layers(
            params, state["caches"], x, cfg,
            lambda p, h, cache, shard: attention_decode(
                p, h, cache, idx, cfg, window=win, shard=shard,
                layout=layout)[0], shard)
    else:
        x = _ssm_decode_layers(params, state, x, idx, cfg, win, shard,
                               layout)
    logits = _logits(params, x, cfg, shard)[:, 0]
    if shard is not None:
        logits = shard.gather_lanes(shard.gather_vocab(logits),
                                    layout.batch)
    return logits, dict(state, index=index + 1)


def _ssm_decode_layer(blk: SSMBlock, x: torch.Tensor, st, cfg: ModelConfig,
                      shard=None) -> torch.Tensor:
    h = rms_norm(x, blk.ln1, cfg.norm_eps)
    return x + ssm_block_decode(blk.ssm, h, st, cfg, shard)[0]


def _shared_decode_layer(sa: SharedAttention, x: torch.Tensor, cache: Pool,
                         index: torch.Tensor, cfg: ModelConfig,
                         window: Optional[int], layout,
                         shard=None) -> torch.Tensor:
    h = rms_norm(x, sa.ln, cfg.norm_eps)
    return x + attention_decode(sa.attn, h, cache, index, cfg, window=window,
                                shard=shard, layout=layout)[0]


def _ssm_decode_layers(params: LM, state: Dict[str, Any], x: torch.Tensor,
                       index: torch.Tensor, cfg: ModelConfig,
                       window: Optional[int], shard=None,
                       layout=None) -> torch.Tensor:
    """The SSM blocks one token: ln1, ``ssm_block_decode`` on the layer's
    state, residual; after each full segment of the hybrid, the shared
    attention block on the next of ``state["caches"]``."""
    sa, caches = params.shared_attn, iter(state["caches"])
    ssm_layer, shared_layer = _ssm_decode_layer, _shared_decode_layer
    if shard is not None:
        ssm_layer = functools.partial(shard.block, ssm_layer)
        shared_layer = functools.partial(shard.block, shared_layer)
    for _, i, j, shared in _segments(cfg):
        for blk, st in zip(params.blocks[i:j], state["ssm_states"][i:j]):
            x = ssm_layer(blk, x, st, cfg)
        if shared and sa is not None:
            x = shared_layer(sa, x, next(caches), index, cfg, window, layout)
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
                     device: torch.device = "cuda",
                     shard=None) -> List[Pool]:
    """One K/V page pool per layer, shared by every lane: KV memory is
    n_pages * page_size tokens per layer however many lanes there are.
    With ``shard`` under TP, each pool holds the rank's KV heads
    (``runtime/sharding.py::paged_state_specs``)."""
    if not supports_paged_decode(cfg):
        raise NotImplementedError(
            f"paged decode does not support arch_type={cfg.arch_type!r}")
    dev = resolve_device(device)
    return [init_page_pool(cfg, n_pages, page_size, device=dev, shard=shard)
            for _ in range(cfg.n_layers)]


def _dense_cache_layer(blk: nn.Module, x: torch.Tensor, pool: Pool,
                       cfg: ModelConfig, attn_fn, shard=None) -> torch.Tensor:
    """A dense or MoE block over its cache or pool; a MoE block's aux loss
    is discarded, as the reference's decode discards it."""
    h = rms_norm(x, blk.ln1, cfg.norm_eps)
    x = x + attn_fn(blk.attn, h, pool, shard)
    h = rms_norm(x, blk.ln2, cfg.norm_eps)
    if isinstance(blk, MoEBlock):
        return x + moe_ffn(blk.moe, h, cfg, shard=shard)[0]
    return x + swiglu_mlp(blk.mlp, h, shard)


def _cache_layers(params: LM, caches: List[Pool], x: torch.Tensor,
                  cfg: ModelConfig,
                  attn_fn: Callable[..., torch.Tensor],
                  shard=None) -> torch.Tensor:
    """The dense or MoE blocks over one cache or pool a layer: ln1,
    ``attn_fn(p, h, pool, shard)``, residual, ln2, SwiGLU or MoE FFN,
    residual; with ``shard``
    each block through ``shard.block`` (its ZeRO weights gathered, the
    MLP tensor-parallel)."""
    layer = (_dense_cache_layer if shard is None
             else functools.partial(shard.block, _dense_cache_layer))
    for blk, pool in zip(params.blocks, caches):
        x = layer(blk, x, pool, cfg, attn_fn)
    return x


def paged_decode_step(params: LM, pools: List[Pool], token: torch.Tensor,
                      page_rows: torch.Tensor, lengths: torch.Tensor,
                      cfg: ModelConfig, *, window: Optional[int] = None,
                      shard=None) -> torch.Tensor:
    """One decode step on the paged KV cache: token (B,) -> logits (B, V).

    ``page_rows`` (B, P) / ``lengths`` (B,) come from the serving engine's
    page table (one table for every layer; each layer owns its pool).  The
    new tokens' K/V are written into ``pools`` in place.

    ``shard`` (``runtime/sharding.py::ShardContext``) runs it on a rank:
    every lane (tokens, page rows and lengths are whole on every rank, as
    the reference replicates them), head-parallel under TP on pools of
    ``init_paged_state(shard=)``; the logits are whole rows, the same on
    every rank."""
    x = embed(params.embed, token, shard)[:, None, :]
    win = window if window is not None else cfg.sliding_window
    x = _cache_layers(
        params, pools, x, cfg,
        lambda p, h, pool, shard: attention_decode_paged(
            p, h, pool, page_rows, lengths, cfg, window=win, shard=shard),
        shard)
    logits = _logits(params, x, cfg, shard)[:, 0]
    return logits if shard is None else shard.gather_vocab(logits)


def paged_prefill_step(params: LM, pools: List[Pool], tokens: torch.Tensor,
                       page_rows: torch.Tensor, base: int,
                       prompt_len: torch.Tensor, cfg: ModelConfig, *,
                       window: Optional[int] = None,
                       shard=None) -> torch.Tensor:
    """One chunked-prefill step: prompt chunk ``tokens`` (B, S) covering
    absolute positions [base, base + S), K/V written into ``pools`` in
    place.  Returns logits (B, V) at each lane's *last prompt position*
    (meaningful only for lanes whose prompt ends inside this chunk).
    ``shard`` as :func:`paged_decode_step`."""
    B, S = tokens.shape
    x = embed(params.embed, tokens, shard)
    win = window if window is not None else cfg.sliding_window
    x = _cache_layers(
        params, pools, x, cfg,
        lambda p, h, pool, shard: attention_prefill_paged(
            p, h, pool, page_rows, base, prompt_len, cfg, window=win,
            shard=shard), shard)
    last = (prompt_len.long() - 1 - base).clamp(0, S - 1)       # (B,)
    xl = x[torch.arange(B, device=x.device), last][:, None, :]  # (B,1,d)
    logits = _logits(params, xl, cfg, shard)[:, 0]
    return logits if shard is None else shard.gather_vocab(logits)
