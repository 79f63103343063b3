"""Token and learned positional embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_embedding(vocab: int, d: int, dtype: torch.dtype = torch.bfloat16, *,
                   generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def init_learned_pos(max_len: int, d: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """(max_len, d) positional table, N(0, 0.01^2) as the reference's."""
    w = torch.randn(max_len, d, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.01).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          shard=None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``; with a sharding context ``shard``
    (``runtime/sharding.py``) the vocab-parallel lookup."""
    if shard is not None:
        return shard.embed(table, tokens)
    return F.embedding(tokens, table)
