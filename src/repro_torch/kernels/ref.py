"""Plain PyTorch versions of the Hopper kernels.

They are the kernels' oracles: the CPU path of ``kernels/ops.py`` runs them,
the tests hold them against the JAX package, and ``chip_smoke.py`` holds
each kernel against them on the card.  Nothing on the main path calls them
when the tensors lie on a CUDA device.
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: Optional[torch.Tensor] = None,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,S,H,dh); k/v (B,T,KV,dh) grouped-query attention -> (B,S,H,dh).

    Query row ``s`` of lane ``b`` sits at absolute position
    ``q_offset[b] + s`` (``s`` when ``q_offset`` is None); key ``t`` is
    admissible when ``t < kv_len[b]`` (every key when None), ``t <= qpos``
    if ``causal`` and ``t > qpos - window`` if a window is given.  Rows with
    no admissible key are exact zeros.  Scores and softmax in fp32; the
    output has q's dtype.
    """
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, S, KV, G, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (dh ** 0.5)
    off = (torch.zeros(B, dtype=torch.int64, device=dev) if q_offset is None
           else q_offset.to(torch.int64))
    qpos = off[:, None] + torch.arange(S, device=dev)[None, :]     # (B,S)
    kpos = torch.arange(T, device=dev)
    mask = torch.ones(B, S, T, dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len.to(torch.int64)[:, None, None]
    m5 = mask[:, None, None]                                       # (B,1,1,S,T)
    scores = scores.masked_fill(~m5, float("-inf"))
    # rows with no admissible key: softmax over all -inf is NaN; they are
    # exact zeros, matching the kernel
    probs = torch.softmax(scores.masked_fill(~m5.any(-1, keepdim=True), 0.0),
                          dim=-1)
    probs = probs * m5.any(-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dim, in fp32, cast
    back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
