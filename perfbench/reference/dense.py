"""Plain fp32 reference of the dense decoder family, from the Qwen3
description (arXiv:2505.09388, hf:Qwen/Qwen3-8B): pre-norm blocks of
grouped-query attention (RMSNorm of each query and key head, then rotary
embeddings by rotating halves, base ``rope_theta``; causal softmax of
q.k / sqrt(head_dim)) and a SwiGLU MLP, each added to the residual; a final
RMSNorm and the head.  Weights in the ``x @ w`` layout, (d_in, d_out)."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import rms_norm


def n_layers(config: Dict[str, Any]) -> int:
    return config["num_hidden_layers"]


def norm_eps(config: Dict[str, Any]) -> float:
    return float(config["rms_norm_eps"])


def head_leaf(config: Dict[str, Any]) -> str:
    return "embed" if config["tie_word_embeddings"] else "head"


def embed(w, tokens, config):
    return w["embed"][tokens]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, dh) at positions 0..S-1."""
    S, dh = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm):
    """Causal softmax attention; q (B,S,H,dh), k/v (B,S,KV,dh).  Computed
    one KV head (and its group of query heads) at a time, so that one
    group's scores are the largest transient."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    group = H // KV
    above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    out = []
    for g in range(KV):
        qg = q[:, :, g * group:(g + 1) * group].transpose(1, 2)  # B G S dh
        kg = k[:, :, g:g + 1].transpose(1, 2)                   # B 1 S dh
        vg = v[:, :, g:g + 1].transpose(1, 2)
        s = mm(qg * dh ** -0.5, kg.transpose(-1, -2))
        p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
        out.append(mm(p, vg).transpose(1, 2))                    # B S G dh
    return torch.cat(out, dim=2)


def layer(w, i, x, config, mm):
    p = f"blocks.{i}."
    B, S, _ = x.shape
    H, KV, dh = (config["num_attention_heads"],
                 config["num_key_value_heads"], config["head_dim"])
    eps, theta = norm_eps(config), float(config["rope_theta"])
    h = rms_norm(x, w[p + "ln1"], eps)
    q = mm(h, w[p + "attn.wq"]).view(B, S, H, dh)
    k = mm(h, w[p + "attn.wk"]).view(B, S, KV, dh)
    v = mm(h, w[p + "attn.wv"]).view(B, S, KV, dh)
    q = rope(rms_norm(q, w[p + "attn.q_norm"], eps), theta)
    k = rope(rms_norm(k, w[p + "attn.k_norm"], eps), theta)
    o = attention(q, k, v, mm).reshape(B, S, H * dh)
    x = x + mm(o, w[p + "attn.wo"])
    h = rms_norm(x, w[p + "ln2"], eps)
    gate = F.silu(mm(h, w[p + "mlp.w_gate"]))
    return x + mm(gate * mm(h, w[p + "mlp.w_up"]), w[p + "mlp.w_down"])
