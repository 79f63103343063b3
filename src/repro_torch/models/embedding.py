"""Token and learned positional embeddings, and the VLM's projector of
vision patch embeddings to the LM's width."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import gelu, init_dense, randn


def init_embedding(vocab: int, d: int, dtype: torch.dtype = torch.bfloat16, *,
                   generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    return randn(vocab, d, scale=0.02, dtype=dtype, generator=generator,
                 device=device)


def init_learned_pos(max_len: int, d: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """(max_len, d) positional table, N(0, 0.01^2) as the reference's."""
    return randn(max_len, d, scale=0.01, dtype=dtype, generator=generator,
                 device=device)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          shard=None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``; with a sharding context ``shard``
    (``runtime/sharding.py``) the vocab-parallel lookup."""
    if shard is not None:
        return shard.embed(table, tokens)
    return F.embedding(tokens, table)


class Projector(nn.Module):
    """The VLM frontend's 2-layer MLP projector, in the JAX layout and
    names: w1 (d_vision, d), b1 (d,), w2 (d, d), b2 (d,)."""

    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor):
        super().__init__()
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)


def init_projector(d_in: int, d_out: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   generator: torch.Generator,
                   device: torch.device) -> Projector:
    """Random w1 then w2 (the reference's draws), zero biases."""
    kw = dict(generator=generator, device=device)
    w1 = init_dense(d_in, d_out, dtype, **kw)
    w2 = init_dense(d_out, d_out, dtype, **kw)
    return Projector(w1, torch.zeros(d_out, dtype=dtype, device=device), w2,
                     torch.zeros(d_out, dtype=dtype, device=device))


def project(p: Projector, x: torch.Tensor, shard=None) -> torch.Tensor:
    """Patches (..., d_vision) -> (..., d): ``gelu(x @ w1 + b1)`` in fp32
    (the tanh approximation), cast back to x's dtype, then ``@ w2 + b2``,
    the reference's arithmetic.  With a sharding context ``shard``
    (``runtime/sharding.py``): w1 column-parallel with the rank's slice of
    b1, w2 row-parallel, its partial sums added over ``model`` before b2 is
    added once; ZeRO shards gathered on use."""
    if shard is None:
        h = gelu((x @ p.w1 + p.b1).float()).to(x.dtype)
        return h @ p.w2 + p.b2
    x = shard.to_tp(x)
    h = gelu((x @ shard.w(p.w1) + shard.tp_local(p.b1)).float()).to(x.dtype)
    return shard.from_tp(h @ shard.w(p.w2)) + p.b2
