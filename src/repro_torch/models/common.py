"""Model configuration: the port's copy of ``repro/models/common.py``.

Same fields, the same derived widths and the same ``reduced()`` arithmetic,
so that a configuration names the same model in both packages; ``dtype`` is
a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    # attention variant: None = full causal; int = sliding window span
    sliding_window: Optional[int] = None

    # ---- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0
    dense_residual_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "sort"

    # ---- SSM / hybrid ------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4
    attn_every: int = 0
    shared_attention: bool = False

    # ---- encoder-decoder (audio) -------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    encoder_seq: int = 0
    encoder_causal: bool = False

    # ---- VLM ----------------------------------------------------------------
    vision_tokens: int = 0
    d_vision: int = 0

    dtype: torch.dtype = torch.bfloat16

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.dh

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 1 and i >= self.first_k_dense

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid models: which layer indices run (shared) attention."""
        if self.arch_type not in ("hybrid",):
            return self.arch_type != "ssm"
        return self.attn_every > 0 and (i + 1) % self.attn_every == 0

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                n_experts: Optional[int] = None) -> "ModelConfig":
        """Smoke-test variant of the same family (<=2 layers, d<=512, <=4 experts)."""
        d = min(d_model, self.d_model)
        n_heads = max(2, min(self.n_heads, d // 64))
        dh = d // n_heads
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        ne = self.n_experts
        if ne:
            ne = min(n_experts if n_experts is not None else 4, ne)
        changes = dict(
            n_layers=n_layers,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=dh,
            d_ff=min(self.d_ff, 2 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=ne,
            top_k=min(self.top_k, max(1, ne // 2)) if ne else 0,
            shared_expert_ff=min(self.shared_expert_ff, d) if self.shared_expert_ff else 0,
            dense_residual_ff=min(self.dense_residual_ff, d) if self.dense_residual_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, dh),
            ssm_chunk=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2) if self.n_enc_layers else 0,
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens else 0,
            d_vision=min(self.d_vision, d) if self.d_vision else 0,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
        )
        return dataclasses.replace(self, **changes)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the dry run's input shapes (``repro/models/common.py``'s):
    ``seq_len`` tokens for each of ``global_batch`` sequences, in ``mode``
    ``"train"``, ``"prefill"`` or ``"decode"`` (a decode shape's
    ``seq_len`` is its KV context)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
