# The port's copy of repro/configs/paper_models.py: the same names and arithmetic.
"""The paper's evaluation models (Table I) as cost-estimator workloads.

These drive the reproduction benchmarks (Tables II–VI, Fig. 5).  Parameter
counts are validated against Table I in tests.  ``store_attn_matrix=True``
reflects the paper's 2022/23 PyTorch implementations (no flash attention —
attention probabilities are stashed for backward).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.layerspec import (LayerSpec, cross_attn_extra, dense_layer,
                                  embed_layer, head_layer, merge)
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig


def bert(n_layers: int, d: int, seq: int = 512, vocab: int = 30522,
         name: str = "bert") -> List[LayerSpec]:
    heads = d // 64
    specs = [embed_layer("embed", seq, d, vocab)]
    for i in range(n_layers):
        specs.append(dense_layer(f"enc{i}", seq, d, heads, heads, 4 * d,
                                 causal=False, gated=False, qkv_bias=True,
                                 store_attn_matrix=True))
    return specs


def vit(n_layers: int, d: int, n_patches: int = 197,
        n_classes: int = 1000) -> List[LayerSpec]:
    heads = d // 64
    specs = [embed_layer("patch_embed", n_patches, d, 768)]  # 16x16x3 proj
    for i in range(n_layers):
        specs.append(dense_layer(f"enc{i}", n_patches, d, heads, heads, 4 * d,
                                 causal=False, gated=False, qkv_bias=True,
                                 store_attn_matrix=True))
    return specs


def t5(n_enc: int, n_dec: int, d: int, enc_seq: int, dec_seq: int,
       vocab: int = 32128) -> List[LayerSpec]:
    heads = d // 64
    specs = [embed_layer("embed", enc_seq, d, vocab)]
    for i in range(n_enc):
        specs.append(dense_layer(f"enc{i}", enc_seq, d, heads, heads, 4 * d,
                                 causal=False, gated=False,
                                 store_attn_matrix=True))
    for i in range(n_dec):
        base = dense_layer(f"dec{i}", dec_seq, d, heads, heads, 4 * d,
                           causal=True, gated=False, store_attn_matrix=True)
        cross = cross_attn_extra(dec_seq, enc_seq, d, heads, heads,
                                 store_attn_matrix=True)
        specs.append(merge(f"dec{i}", base, cross))
    return specs


def swin(depths: Tuple[int, ...], dims: Tuple[int, ...],
         img_tokens: int = 3136, window: int = 49,
         n_classes: int = 1000) -> List[LayerSpec]:
    """Swin: hierarchical stages, window attention, patch merging between
    stages (tokens /4, dim x2).  Uneven per-layer workloads — the paper's
    showcase for layer-wise strategy search (Fig. 6 case B)."""
    specs = [embed_layer("patch_embed", img_tokens, dims[0], 48)]
    tokens = img_tokens
    for si, (depth, d) in enumerate(zip(depths, dims)):
        heads = max(1, d // 32)
        for li in range(depth):
            specs.append(dense_layer(
                f"s{si}l{li}", tokens, d, heads, heads, 4 * d,
                causal=False, gated=False, qkv_bias=True,
                store_attn_matrix=True, window=window))
        if si + 1 < len(dims):
            tokens //= 4
    return specs


def gpt3(n_layers: int, d: int, seq: int = 2048,
         vocab: int = 50257) -> List[LayerSpec]:
    heads = d // 128
    specs = [embed_layer("embed", seq, d, vocab)]
    for i in range(n_layers):
        specs.append(dense_layer(f"dec{i}", seq, d, heads, heads, 4 * d,
                                 causal=True, gated=False, qkv_bias=True,
                                 store_attn_matrix=True))
    specs.append(head_layer("head", seq, d, vocab))
    return specs


PAPER_MODELS: Dict[str, List[LayerSpec]] = {}


def paper_model_specs(name: str) -> List[LayerSpec]:
    if not PAPER_MODELS:
        PAPER_MODELS.update({
            "bert-huge-32": bert(32, 1280),
            "bert-huge-48": bert(48, 1280),
            "bert-xhuge": bert(128, 2560),
            "vit-huge-32": vit(32, 1280),
            "vit-huge-48": vit(48, 1280),
            "vit-xhuge": vit(128, 2560),
            "t5-large-32": t5(16, 16, 1024, 512, 512),
            "t5-large-48": t5(24, 24, 1024, 512, 512),
            "t5-512/4-32": t5(16, 16, 1024, 512, 4),
            "t5-512/4-48": t5(24, 24, 1024, 512, 4),
            "swin-huge-32": swin((2, 2, 26, 2), (320, 640, 1280, 2560)),
            "swin-huge-48": swin((2, 2, 42, 2), (320, 640, 1280, 2560)),
            "gpt3-15b": gpt3(48, 5120),
            "gpt3-39b": gpt3(48, 8192),
            "gpt3-65b": gpt3(80, 8192),
        })
    return PAPER_MODELS[name]


# A runnable GPT-3-15B-shaped dense config (usable end to end in the
# runtime, beyond the cost-model tables).
GPT3_15B_RUNTIME = register(ModelConfig(
    name="gpt3-15b", arch_type="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=20480, vocab_size=50257,
    rope_theta=10_000.0, norm_eps=1e-5,
))
