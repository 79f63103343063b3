"""Model FLOPs of one training step of the dense family.

6 x matmul parameters x tokens (the blocks' projections and the head; the
embedding lookup is no product and is not counted; a tied head counts
once; norm weights are not matmul parameters), plus attention's 12 x
causal pairs x heads x head_dim a layer (3 x the forward's 4: the
backward's products twice the forward's).  Recomputation is never counted.

qwen3-8b-l6 at 2 x 4096: 6 x 1,779,957,760 x 8192 + 12 x 16,781,312 x 32
x 128 x 6 = 9.2436e13.
"""
from __future__ import annotations

from typing import Any, Dict

from .attention import training_pairs


def matmul_params(config: Dict[str, Any]) -> int:
    d, f = config["hidden_size"], config["intermediate_size"]
    q = config["num_attention_heads"] * config["head_dim"]
    kv = config["num_key_value_heads"] * config["head_dim"]
    block = d * q + 2 * d * kv + q * d + 3 * d * f
    return config["num_hidden_layers"] * block + d * config["vocab_size"]


def model_flops(config: Dict[str, Any], traffic: Dict[str, Any]) -> float:
    B, S = int(traffic["batch"]), int(traffic["seq"])
    attn = (12.0 * training_pairs(B, S) * config["num_attention_heads"]
            * config["head_dim"] * config["num_hidden_layers"])
    return 6.0 * matmul_params(config) * B * S + attn
