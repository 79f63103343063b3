"""LayerSpec workloads for the assigned architectures — feeds the
Galvatron-BMW search (the port's copy of ``repro/configs/specs.py``).
Unlike the paper models, these assume flash attention (no stashed
probability matrices)."""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.layerspec import (LayerSpec, dense_layer, embed_layer,
                                  head_layer, moe_layer, ssm_layer)
from repro_torch.models.common import ModelConfig


def layerspecs_for(cfg: ModelConfig, seq_len: int, *,
                   window: Optional[int] = None) -> List[LayerSpec]:
    win = window if window is not None else cfg.sliding_window
    specs: List[LayerSpec] = [
        embed_layer("embed", seq_len, cfg.d_model, cfg.vocab_size)]

    if cfg.arch_type in ("dense", "vlm"):
        seq = seq_len + (cfg.vision_tokens if cfg.arch_type == "vlm" else 0)
        for i in range(cfg.n_layers):
            specs.append(dense_layer(
                f"layer{i}", seq, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, qkv_bias=cfg.qkv_bias, window=win))
    elif cfg.arch_type == "moe":
        for i in range(cfg.n_layers):
            if cfg.is_moe_layer(i):
                specs.append(moe_layer(
                    f"layer{i}", seq_len, cfg.d_model, cfg.n_heads,
                    cfg.n_kv_heads, cfg.d_ff, cfg.n_experts, cfg.top_k,
                    d_ff_shared=cfg.shared_expert_ff,
                    dense_residual_ff=cfg.dense_residual_ff, window=win,
                    capacity_factor=cfg.capacity_factor))
            else:
                specs.append(dense_layer(
                    f"layer{i}", seq_len, cfg.d_model, cfg.n_heads,
                    cfg.n_kv_heads, cfg.d_ff * cfg.top_k, window=win))
    elif cfg.arch_type == "ssm":
        for i in range(cfg.n_layers):
            specs.append(ssm_layer(f"layer{i}", seq_len, cfg.d_model,
                                   d_state=cfg.ssm_state,
                                   expand=cfg.ssm_expand))
    elif cfg.arch_type == "hybrid":
        for i in range(cfg.n_layers):
            specs.append(ssm_layer(f"layer{i}", seq_len, cfg.d_model,
                                   d_state=cfg.ssm_state,
                                   expand=cfg.ssm_expand))
            if cfg.is_attn_layer(i):
                specs.append(dense_layer(
                    f"shared_attn{i}", seq_len, cfg.d_model, cfg.n_heads,
                    cfg.n_kv_heads, cfg.d_ff, window=win))
    elif cfg.arch_type == "audio":
        enc_seq = cfg.encoder_seq or 1500
        n_enc = cfg.n_enc_layers or cfg.n_layers
        for i in range(n_enc):
            specs.append(dense_layer(f"enc{i}", enc_seq, cfg.d_model,
                                     cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                                     causal=False, gated=False))
        for i in range(cfg.n_layers):
            specs.append(dense_layer(f"dec{i}", seq_len, cfg.d_model,
                                     cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                                     gated=False))
    else:
        raise ValueError(cfg.arch_type)

    specs.append(head_layer("head", seq_len, cfg.d_model, cfg.vocab_size))
    return specs
