"""Model FLOPs of one training step of the Mamba2 family.

6 x matmul parameters x tokens (in_proj, out_proj, and the tied head
once, at the vocabulary padded as the model pads it; the depthwise causal convolution, 4 taps a channel, and the norm
weights are not matmul parameters), plus the SSD recurrence's 12 x P x N
a token and head a layer (``counts/ssd.py``: forward 4, backward 8),
whatever chunk a kernel uses.  Recomputation is never counted.

mamba2-370m at 8 x 2048: 6 x 367,640,576 x 16384 + 12 x 64 x 128 x 32 x
16384 x 48 = 3.8614e13.
"""
from __future__ import annotations

from typing import Any, Dict

from .ssd import token_head_ops


def padded_vocab(config: Dict[str, Any]) -> int:
    """The table's rows: the vocabulary padded up to a multiple of
    ``pad_vocab_size_multiple``."""
    m = int(config.get("pad_vocab_size_multiple", 1))
    return -(-int(config["vocab_size"]) // m) * m


def matmul_params(config: Dict[str, Any]) -> int:
    d, N, P = config["d_model"], config["d_state"], config["headdim"]
    di = config["expand"] * d
    H = di // P
    block = d * (2 * di + 2 * N + H) + di * d
    return config["n_layer"] * block + padded_vocab(config) * d


def model_flops(config: Dict[str, Any], traffic: Dict[str, Any]) -> float:
    tokens = int(traffic["batch"]) * int(traffic["seq"])
    d, N, P = config["d_model"], config["d_state"], config["headdim"]
    H = config["expand"] * d // P
    f, b = token_head_ops(P, N)
    ssd = (f + b) * H * tokens * config["n_layer"]
    return 6.0 * matmul_params(config) * tokens + ssd
