"""Whisper-style encoder-decoder transformer (``repro/models/encdec.py``
counterpart): training and serving.

As in the reference, the mel-spectrogram and conv feature extractor is a
stub: the encoder takes precomputed frame embeddings (B, T_enc, d).  The
transformer is the Whisper recipe: a non-causal encoder, a causal decoder
with cross-attention, learned positional embeddings, LayerNorm and GELU
MLPs, and a one-token decode step over self-attention K/V caches and
cross K/V precomputed once.  The reference's choices are kept:

* the encoder's and the decoder's self-attention apply RoPE on top of the
  learned positions (``attention`` projects with RoPE at the token
  positions);
* decoder positions index the learned table modulo its length, so a
  sequence longer than the table wraps (``encdec.py:110-111``, ``:158-159``);
  RoPE takes the unwrapped position;
* the logits are ``x @ embed.T`` (the output projection is tied);
* the decode state holds one scalar ``index`` shared by every lane.

The JAX package stacks each side's blocks on a leading layer axis; here
they are a ``ModuleList`` each, walked by a Python loop.  Weights keep the
JAX layout and names::

  EncDec
    enc_pos       (encoder_seq, d)
    enc_blocks[i] EncBlock: ln1, attn (Attention), ln2, mlp (GeluMLP)
    enc_ln        LayerNorm: w (d,), b (d,)
    embed         (V, d)
    dec_pos       (max_dec_len, d)
    dec_blocks[i] DecBlock: ln1, self_attn, ln_x, cross_attn (no QKV bias),
                  ln2, mlp
    dec_ln        LayerNorm

On the card every attention runs the flash kernels (``kernels/ops.py``):
the encoder's S = T self-attention, the decoder's causal self-attention,
cross-attention at S != T, and the decode step's self-attention over its
cache.  :func:`encdec_loss` trains through :func:`encode` and
:func:`decode_train`, whose attentions run the flash backward too (at
S != T for cross-attention), with the reference's ``remat``: each block
recomputed in the backward (``torch.utils.checkpoint``, as
``jax.checkpoint`` around the reference's scan body).  The decode path
(:func:`init_encdec_decode_state`, :func:`encdec_decode_step`) runs under
``torch.inference_mode``; ``runtime/executor.py``'s prefill step runs
:func:`encode` and :func:`decode_train` under it too.

Every function takes a sharding context ``shard``
(``runtime/sharding.py::ShardContext``), with which it runs on a rank's
shards as the decoder-only models do: each block through ``shard.block``
(ZeRO weights gathered on use; with ``remat`` the checkpoint around it),
attention, cross-attention and the GELU MLP tensor-parallel on the rank's
heads and d_ff columns, both stacks on token slices under
``policy.seq_shard`` (the encoder's output gathered whole before the
decoder reads it), the embedding, the tied logits and the loss
vocab-parallel where the table splits over ``model`` and on the whole
table elsewhere.  The decode state then holds the rank's lanes, its self
caches' context (or KV heads) and, under TP, its cross K/V heads.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from .attention import (Attention, attention, attention_decode,
                        cross_attention, init_attention, init_kv_cache,
                        precompute_cross_kv)
from .common import ModelConfig
from .embedding import embed, init_embedding, init_learned_pos
from .layers import cross_entropy_loss, layer_norm
from .mlp import GeluMLP, gelu_mlp, init_gelu_mlp


class LayerNorm(nn.Module):
    """w (d,), b (d,): the reference's ``{"w", "b"}``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class EncBlock(nn.Module):
    def __init__(self, ln1: LayerNorm, attn: Attention, ln2: LayerNorm,
                 mlp: GeluMLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecBlock(nn.Module):
    def __init__(self, ln1: LayerNorm, self_attn: Attention, ln_x: LayerNorm,
                 cross_attn: Attention, ln2: LayerNorm, mlp: GeluMLP):
        super().__init__()
        self.ln1, self.self_attn, self.ln_x = ln1, self_attn, ln_x
        self.cross_attn, self.ln2, self.mlp = cross_attn, ln2, mlp


class EncDec(nn.Module):
    def __init__(self, enc_pos: torch.Tensor, enc_blocks: List[EncBlock],
                 enc_ln: LayerNorm, embed: torch.Tensor,
                 dec_pos: torch.Tensor, dec_blocks: List[DecBlock],
                 dec_ln: LayerNorm):
        super().__init__()
        self.enc_pos = nn.Parameter(enc_pos)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_ln = enc_ln
        self.embed = nn.Parameter(embed)
        self.dec_pos = nn.Parameter(dec_pos)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.dec_ln = dec_ln


def _ln(x: torch.Tensor, p: LayerNorm, cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(x, p.w, p.b, cfg.norm_eps)


def _init_ln(cfg: ModelConfig, device: torch.device) -> LayerNorm:
    return LayerNorm(torch.ones(cfg.d_model, dtype=cfg.dtype, device=device),
                     torch.zeros(cfg.d_model, dtype=cfg.dtype, device=device))


def init_enc_block(cfg: ModelConfig, *, generator: torch.Generator,
                   device: torch.device) -> EncBlock:
    kw = dict(generator=generator, device=device)
    attn = init_attention(cfg, **kw)
    mlp = init_gelu_mlp(cfg.d_model, cfg.d_ff, cfg.dtype, **kw)
    return EncBlock(_init_ln(cfg, device), attn, _init_ln(cfg, device), mlp)


def init_dec_block(cfg: ModelConfig, *, generator: torch.Generator,
                   device: torch.device) -> DecBlock:
    kw = dict(generator=generator, device=device)
    self_attn = init_attention(cfg, **kw)
    cross_attn = init_attention(cfg, cross=True, **kw)
    mlp = init_gelu_mlp(cfg.d_model, cfg.d_ff, cfg.dtype, **kw)
    return DecBlock(_init_ln(cfg, device), self_attn, _init_ln(cfg, device),
                    cross_attn, _init_ln(cfg, device), mlp)


def init_encdec(cfg: ModelConfig, *, max_dec_len: int = 4096, seed: int = 0,
                device: torch.device = "cuda",
                shard: Optional[Callable[[str, Any], Any]] = None) -> EncDec:
    """Random weights drawn on ``device`` from ``torch.Generator(seed)`` in
    the reference's order (the encoder's positions and blocks, the
    embedding, the decoder's positions and blocks), with its distributions
    (not its numbers).  The decoder's positional table holds
    ``max_dec_len`` rows; the encoder's ``encoder_seq`` (1500 if unset).
    On the ``meta`` device only the shapes exist.  ``shard(name, part)``
    replaces each part as soon as it is drawn (``enc_pos``,
    ``enc_blocks.<i>``, ``enc_ln``, ``embed``, ``dec_pos``,
    ``dec_blocks.<i>``, ``dec_ln``), so a sharded run keeps its rank's
    shards of the single process's numbers, each whole part freed once
    sliced (``runtime/sharding.py::ShardContext.shard_part``)."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu" if dev.type == "meta" else dev
                        ).manual_seed(seed)
    kw = dict(generator=g, device=dev)
    d, dt = cfg.d_model, cfg.dtype
    shard = shard or (lambda name, part: part)
    enc_pos = shard("enc_pos", init_learned_pos(cfg.encoder_seq or 1500, d,
                                                dt, **kw))
    enc = [shard(f"enc_blocks.{i}", init_enc_block(cfg, **kw))
           for i in range(cfg.n_enc_layers or cfg.n_layers)]
    enc_ln = shard("enc_ln", _init_ln(cfg, dev))
    table = shard("embed", init_embedding(cfg.vocab_size, d, dt, **kw))
    dec_pos = shard("dec_pos", init_learned_pos(max_dec_len, d, dt, **kw))
    dec = [shard(f"dec_blocks.{i}", init_dec_block(cfg, **kw))
           for i in range(cfg.n_layers)]
    return EncDec(enc_pos, enc, enc_ln, table, dec_pos, dec,
                  shard("dec_ln", _init_ln(cfg, dev)))


def _enc_block(p: EncBlock, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, shard=None) -> torch.Tensor:
    h = _ln(x, p.ln1, cfg)
    x = x + attention(p.attn, h, positions, cfg, causal=False, shard=shard)
    return x + gelu_mlp(p.mlp, _ln(x, p.ln2, cfg), shard)


def _run_blocks(fn, blocks, x: torch.Tensor, *args, remat: bool,
                shard=None) -> torch.Tensor:
    """``x = fn(block, x, *args)`` over ``blocks``; with ``remat`` each
    block's activations are recomputed in the backward; with ``shard``
    the stack enters and leaves the rank's token slices
    (``shard.seq_slice``, ``shard.seq_gather``) and each block runs
    through ``shard.block`` on them."""
    seq = False
    if shard is not None:
        x, seq = shard.seq_slice(x)
        fn = functools.partial(shard.block, fn, seq=seq)
    for p in blocks:
        x = (checkpoint(fn, p, x, *args, use_reentrant=False) if remat
             else fn(p, x, *args))
    if shard is not None:
        x = shard.seq_gather(x, seq)
    return x


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False, shard=None) -> torch.Tensor:
    """frames (B, T_enc, d), the stub front end's output -> the encoder's
    output (B, T_enc, d) in the model's dtype: the learned positions
    added, the blocks (pre-norm non-causal self-attention and GELU MLP,
    each with its residual; with ``remat`` recomputed in the backward),
    the final LayerNorm.  With ``shard`` the frames are the rank's lanes
    and the output is whole in the token dim on every ``model`` rank."""
    B, T, _ = frames.shape
    x = frames.to(params.enc_pos.device, cfg.dtype) + params.enc_pos[:T]
    positions = torch.arange(T, device=x.device).expand(B, T)
    x = _run_blocks(_enc_block, params.enc_blocks, x, positions, cfg,
                    remat=remat, shard=shard)
    return _ln(x, params.enc_ln, cfg)


def _dec_block(p: DecBlock, x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor, cfg: ModelConfig,
               shard=None) -> torch.Tensor:
    h = _ln(x, p.ln1, cfg)
    x = x + attention(p.self_attn, h, positions, cfg, causal=True,
                      shard=shard)
    h = _ln(x, p.ln_x, cfg)
    kv = precompute_cross_kv(p.cross_attn, enc_out, cfg, shard=shard)
    x = x + cross_attention(p.cross_attn, h, kv, cfg, shard=shard)
    return x + gelu_mlp(p.mlp, _ln(x, p.ln2, cfg), shard)


def _dec_pos(params: EncDec, positions: torch.Tensor) -> torch.Tensor:
    """Rows of the learned table at ``positions`` modulo its length, by a
    gather (a 0-d index tensor used as a subscript would be read on the
    host)."""
    table = params.dec_pos
    idx = (positions % table.shape[0]).reshape(-1)
    return table.index_select(0, idx).reshape(*positions.shape,
                                              table.shape[1])


def _logits(params: EncDec, x: torch.Tensor, cfg: ModelConfig,
            shard=None) -> torch.Tensor:
    """The final LayerNorm and the tied projection; with ``shard`` the
    rank's vocabulary columns where the table splits over ``model``."""
    x = _ln(x, params.dec_ln, cfg)
    if shard is None:
        return x @ params.embed.T
    return shard.tied_logits(x, params.embed)


def decode_train(params: EncDec, tokens: torch.Tensor,
                 enc_out: torch.Tensor, cfg: ModelConfig, *,
                 remat: bool = False, shard=None) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) against the encoder's output
    -> logits (B, S, V).  Token ``s`` sits at position ``s`` (the learned
    table's row ``s`` modulo its length).  With ``remat`` each block is
    recomputed in the backward.  With ``shard``, tokens and ``enc_out``
    (whole in the token dim) are the rank's lanes, and the logits its
    vocabulary columns where the table splits over ``model``."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = embed(params.embed, tokens, shard) + _dec_pos(params, pos)
    positions = pos.expand(B, S)
    x = _run_blocks(_dec_block, params.dec_blocks, x, positions, enc_out,
                    cfg, remat=remat, shard=shard)
    return _logits(params, x, cfg, shard)


def encdec_loss(params: EncDec, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig, *, remat: bool = False,
                shard=None) -> torch.Tensor:
    """Mean cross entropy of :func:`decode_train`'s logits of
    ``batch["tokens"]`` (B, S) over :func:`encode` of ``batch["frames"]``
    (B, T_enc, d) against ``batch["labels"]`` (B, S) (``-100`` ignored):
    the reference's ``encdec_loss``, ``remat`` applied to both stacks.
    With ``shard``, ``batch`` is the rank's rows and the result its share
    of the global batch's loss (``ShardContext.cross_entropy``)."""
    enc_out = encode(params, batch["frames"], cfg, remat=remat, shard=shard)
    logits = decode_train(params, batch["tokens"], enc_out, cfg, remat=remat,
                          shard=shard)
    return cross_entropy_loss(logits, batch["labels"], shard=shard)


def _cross_kv(p: DecBlock, enc_out: torch.Tensor, cfg: ModelConfig,
              shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return precompute_cross_kv(p.cross_attn, enc_out, cfg, shard=shard)


@torch.inference_mode()
def init_encdec_decode_state(params: EncDec, frames: torch.Tensor,
                             cfg: ModelConfig, context: int, *,
                             shard=None) -> Dict[str, Any]:
    """Run the encoder once, precompute every decoder layer's cross K/V and
    allocate the self-attention caches::

      "cross_kv"    one (k, v) of (B, T_enc, KV, dh) a decoder layer
      "self_cache"  one K/V cache of ``context`` slots a decoder layer
                    (:func:`~repro_torch.models.attention.init_kv_cache`)
      "index"       0-d int32, shared by every lane

    :func:`encdec_decode_step` writes the caches in place.

    With ``shard`` (every rank calling with every lane's ``frames``) the
    state is the rank's share: its lanes (over ``data``, when they split,
    ``runtime/sharding.py::decode_state_specs``), each self cache's
    context (or KV heads) over ``model`` (``init_kv_cache(shard=)``), the
    cross K/V of its lanes and, under TP, of its KV heads; one ``index``;
    and ``"layout"``, where the caches lie (``shard.decode_layout``)."""
    B = frames.shape[0]
    if shard is None:
        enc_out = encode(params, frames, cfg)
        cross = [_cross_kv(p, enc_out, cfg) for p in params.dec_blocks]
        layout = None
    else:
        shard.bind(params)
        lo, hi = shard.lane_range(B)
        enc_out = encode(params, frames[lo:hi], cfg, shard=shard)
        cross = [shard.block(_cross_kv, p, enc_out, cfg)
                 for p in params.dec_blocks]
        layout = shard.decode_layout(B, context)
    state = {"cross_kv": cross,
             "self_cache": [init_kv_cache(cfg, B, context,
                                          device=enc_out.device, shard=shard)
                            for _ in params.dec_blocks],
             "index": torch.zeros((), dtype=torch.int32,
                                  device=enc_out.device)}
    if layout is not None:
        state["layout"] = layout
    return state


def _dec_decode_layer(p: DecBlock, x: torch.Tensor, cache, ckv,
                      index: torch.Tensor, cfg: ModelConfig, layout=None,
                      shard=None) -> torch.Tensor:
    h = _ln(x, p.ln1, cfg)
    x = x + attention_decode(p.self_attn, h, cache, index, cfg, shard=shard,
                             layout=layout)[0]
    x = x + cross_attention(p.cross_attn, _ln(x, p.ln_x, cfg), ckv, cfg,
                            shard=shard)
    return x + gelu_mlp(p.mlp, _ln(x, p.ln2, cfg), shard)


@torch.inference_mode()
def encdec_decode_step(params: EncDec, state: Dict[str, Any],
                       token: torch.Tensor, cfg: ModelConfig, *,
                       shard=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B,) -> logits (B, V) and the new state.

    Every lane sits at the state's one ``index``: the token's learned
    position is that row of the table (modulo its length), and its
    self-attention K/V are written into each layer's cache in place
    (:func:`~repro_torch.models.attention.attention_decode`); the new state
    holds the same tensors and ``index + 1``.

    With ``shard`` and a state of ``init_encdec_decode_state(shard=)``,
    every rank calls it with every lane's ``token`` and runs its share
    (each layer through ``shard.block``, the self-attention on its cache
    slice, ``runtime/sharding.py::DecodeLayout``); the logits returned are
    every lane's whole rows, the same on every rank."""
    index = state["index"]
    layout, layer = state.get("layout"), _dec_decode_layer
    if shard is not None:
        if layout is None:
            raise ValueError("a sharded decode step takes a state of "
                             "init_encdec_decode_state(shard=)")
        lo, hi = shard.lane_range(layout.batch)
        token = token[lo:hi]
        layer = functools.partial(shard.block, layer)
    x = embed(params.embed, token, shard)[:, None, :] + _dec_pos(params,
                                                                 index)
    for p, cache, ckv in zip(params.dec_blocks, state["self_cache"],
                             state["cross_kv"]):
        x = layer(p, x, cache, ckv, index, cfg, layout)
    logits = _logits(params, x, cfg, shard)[:, 0]
    if shard is not None:
        logits = shard.gather_lanes(shard.gather_vocab(logits), layout.batch)
    return logits, dict(state, index=index + 1)
