"""SwiGLU feed-forward block (LLaMA / Qwen family)."""
from __future__ import annotations

import torch
from torch import nn

from .layers import init_dense, swiglu


class SwiGLU(nn.Module):
    """Weights in the JAX layout: w_gate/w_up (d, d_ff), w_down (d_ff, d)."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate)
        self.w_up = nn.Parameter(w_up)
        self.w_down = nn.Parameter(w_down)


def init_swiglu(d: int, d_ff: int, dtype: torch.dtype = torch.bfloat16, *,
                generator: torch.Generator, device: torch.device) -> SwiGLU:
    kw = dict(generator=generator, device=device)
    return SwiGLU(init_dense(d, d_ff, dtype, **kw),
                  init_dense(d, d_ff, dtype, **kw),
                  init_dense(d_ff, d, dtype, **kw))


def swiglu_mlp(p: SwiGLU, x: torch.Tensor, shard=None) -> torch.Tensor:
    """With a sharding context ``shard`` (``runtime/sharding.py``), the
    Megatron MLP: w_gate/w_up column-parallel and w_down row-parallel on
    the rank's d_ff columns, the partial sums added over ``model``."""
    if shard is None:
        return swiglu(x @ p.w_gate, x @ p.w_up) @ p.w_down
    x = shard.to_tp(x)
    return shard.from_tp(swiglu(x @ p.w_gate, x @ p.w_up) @ p.w_down)
