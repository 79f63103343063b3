"""Feed-forward blocks: SwiGLU (LLaMA / Qwen family) and GELU (Whisper)."""
from __future__ import annotations

import torch
from torch import nn

from .layers import gelu, init_dense, swiglu


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


class GeluMLP(nn.Module):
    """Weights in the JAX layout: w_fc (d, d_ff), b_fc (d_ff,), w_proj
    (d_ff, d), b_proj (d,)."""

    def __init__(self, w_fc: torch.Tensor, b_fc: torch.Tensor,
                 w_proj: torch.Tensor, b_proj: torch.Tensor):
        super().__init__()
        self.w_fc = nn.Parameter(w_fc)
        self.b_fc = nn.Parameter(b_fc)
        self.w_proj = nn.Parameter(w_proj)
        self.b_proj = nn.Parameter(b_proj)


def init_gelu_mlp(d: int, d_ff: int, dtype: torch.dtype = torch.bfloat16, *,
                  generator: torch.Generator,
                  device: torch.device) -> GeluMLP:
    """Random w_fc then w_proj (the reference's draws), zero biases."""
    kw = dict(generator=generator, device=device)
    w_fc = init_dense(d, d_ff, dtype, **kw)
    w_proj = init_dense(d_ff, d, dtype, **kw)
    return GeluMLP(w_fc, torch.zeros(d_ff, dtype=dtype, device=device),
                   w_proj, torch.zeros(d, dtype=dtype, device=device))


def gelu_mlp(p: GeluMLP, x: torch.Tensor, shard=None) -> torch.Tensor:
    """With a sharding context ``shard`` (``runtime/sharding.py``), the
    Megatron MLP: w_fc column-parallel with the rank's slice of b_fc,
    w_proj row-parallel, its partial sums added over ``model`` before
    b_proj is added once."""
    if shard is None:
        return gelu(x @ p.w_fc + p.b_fc) @ p.w_proj + p.b_proj
    x = shard.to_tp(x)
    h = gelu(x @ p.w_fc + shard.tp_local(p.b_fc))
    return shard.from_tp(h @ p.w_proj) + p.b_proj
