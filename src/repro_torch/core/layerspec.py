# The port's copy of repro/core/layerspec.py: the same names and arithmetic.
"""Analytic per-layer workload descriptions for the cost estimator (§V).

The estimator needs, per layer: parameter count, forward FLOPs, and the
activation footprint split into *boundary* activations ``bnd`` (layer inputs,
kept even under CKPT) and *intermediate* activations ``int`` (released by
CKPT during forward, recomputed and held during backward).

All byte numbers are per *sample* (one sequence) so the cost model can scale
them by the per-device micro-batch.  ``ACT_CALIBRATION`` is a single global
constant fitted against the paper's profiled Table I activation sizes
(dropout masks, optimizer workspace, fragmentation); parameter counts are
exact analytic values.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

BYTES_ACT = 2          # bf16 / fp16 activations
ACT_CALIBRATION = 2.1  # fitted once against paper Table I (see tests)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Workload of one model layer (full, unsharded)."""

    name: str
    kind: str                     # attn_mlp | moe | ssm | embed | head | conv
    param_count: float            # total parameters
    flops_per_sample: float       # forward FLOPs for one sample (full seq)
    bnd_bytes_per_sample: float   # boundary (input) activation bytes
    int_bytes_per_sample: float   # intermediate activation bytes
    seq_len: int = 0
    # fraction of params that TP can shard (embeddings/norms are replicated)
    tp_frac: float = 1.0
    # K+V panel bytes per sample (full sequence) — the payload one ring-
    # attention hand-off moves per sp shard; 0 for layers without attention
    kv_bytes_per_sample: float = 0.0
    # MoE bookkeeping (expert params can additionally be expert-sharded)
    n_experts: int = 0
    top_k: int = 0
    expert_param_frac: float = 0.0   # fraction of params living in experts
    # fraction of intermediate activation bytes / forward FLOPs spent in the
    # routed experts — the parts EP shards across the expert group
    expert_act_frac: float = 0.0
    expert_flops_frac: float = 0.0
    # router capacity factor: each expert processes up to
    # ceil(T * top_k / E * capacity_factor) tokens (padding overhead EP pays)
    capacity_factor: float = 1.0

    def active_param_count(self) -> float:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.n_experts > 1:
            dense = self.param_count * (1.0 - self.expert_param_frac)
            expert = self.param_count * self.expert_param_frac
            return dense + expert * self.top_k / self.n_experts
        return self.param_count


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

def _attn_flops(seq: int, d: int, n_heads: int, n_kv: int, causal: bool,
                window: Optional[int] = None) -> float:
    d_head = d // n_heads
    kv_dim = n_kv * d_head
    proj = 2 * seq * (d * d + 2 * d * kv_dim + d * d)      # q, kv, o
    attn_span = seq if window is None else min(seq, window)
    score = 2 * seq * attn_span * d                         # QK^T
    av = 2 * seq * attn_span * d                            # PV
    if causal and window is None:
        score /= 2
        av /= 2
    return proj + score + av


def _attn_act(seq: int, d: int, n_heads: int, n_kv: int,
              store_attn_matrix: bool, window: Optional[int]) -> float:
    """Intermediate activation bytes of one attention block per sample."""
    d_head = d // n_heads
    kv_dim = n_kv * d_head
    toks = seq * BYTES_ACT
    acts = toks * (d            # normed input
                   + d + 2 * kv_dim   # q, k, v
                   + d          # attn context
                   + d)         # o-proj output / residual
    if store_attn_matrix:
        span = seq if window is None else min(seq, window)
        acts += 2 * n_heads * seq * span * BYTES_ACT   # probs + mask/softmax
    else:
        acts += n_heads * seq * 4 * 2                  # flash: m & l stats fp32
    return acts


def _mlp_flops(seq: int, d: int, d_ff: int, gated: bool) -> float:
    mats = 3 if gated else 2
    return 2 * seq * d * d_ff * mats


def _mlp_act(seq: int, d: int, d_ff: int, gated: bool) -> float:
    toks = seq * BYTES_ACT
    if gated:
        return toks * (d + 3 * d_ff + d)   # normed in, gate, up, act, out
    return toks * (d + 2 * d_ff + d)


def dense_layer(name: str, seq: int, d: int, n_heads: int, n_kv: int,
                d_ff: int, *, causal: bool = True, gated: bool = True,
                qkv_bias: bool = False, store_attn_matrix: bool = False,
                window: Optional[int] = None) -> LayerSpec:
    """One pre-norm transformer block (attention + MLP)."""
    d_head = d // n_heads
    kv_dim = n_kv * d_head
    p_attn = d * d + 2 * d * kv_dim + d * d
    if qkv_bias:
        p_attn += d + 2 * kv_dim
    p_mlp = d * d_ff * (3 if gated else 2)
    p_norm = 2 * d
    params = p_attn + p_mlp + p_norm
    flops = _attn_flops(seq, d, n_heads, n_kv, causal, window) + \
        _mlp_flops(seq, d, d_ff, gated)
    bnd = seq * d * BYTES_ACT
    inter = (_attn_act(seq, d, n_heads, n_kv, store_attn_matrix, window) +
             _mlp_act(seq, d, d_ff, gated)) * ACT_CALIBRATION
    return LayerSpec(name=name, kind="attn_mlp", param_count=params,
                     flops_per_sample=flops, bnd_bytes_per_sample=bnd,
                     int_bytes_per_sample=inter, seq_len=seq,
                     tp_frac=(p_attn + p_mlp) / params,
                     kv_bytes_per_sample=2 * seq * kv_dim * BYTES_ACT)


def moe_layer(name: str, seq: int, d: int, n_heads: int, n_kv: int,
              d_ff_expert: int, n_experts: int, top_k: int, *,
              d_ff_shared: int = 0, dense_residual_ff: int = 0,
              causal: bool = True, store_attn_matrix: bool = False,
              window: Optional[int] = None,
              capacity_factor: float = 1.0) -> LayerSpec:
    """Transformer block whose MLP is a top-k routed mixture of experts.

    ``d_ff_shared`` adds always-on shared experts (Kimi-K2 style);
    ``dense_residual_ff`` adds a dense FFN residual branch (Arctic style).
    """
    d_head = d // n_heads
    kv_dim = n_kv * d_head
    p_attn = d * d + 2 * d * kv_dim + d * d
    p_router = d * n_experts
    p_expert = 3 * d * d_ff_expert * n_experts
    p_shared = 3 * d * d_ff_shared if d_ff_shared else 0
    p_dense = 3 * d * dense_residual_ff if dense_residual_ff else 0
    p_norm = 2 * d
    params = p_attn + p_router + p_expert + p_shared + p_dense + p_norm

    flops = _attn_flops(seq, d, n_heads, n_kv, causal, window)
    flops += 2 * seq * d * n_experts                       # router
    f_expert = _mlp_flops(seq, d, d_ff_expert, True) * top_k  # routed experts
    flops += f_expert
    if d_ff_shared:
        flops += _mlp_flops(seq, d, d_ff_shared, True)
    if dense_residual_ff:
        flops += _mlp_flops(seq, d, dense_residual_ff, True)

    bnd = seq * d * BYTES_ACT
    inter = _attn_act(seq, d, n_heads, n_kv, store_attn_matrix, window)
    a_expert = _mlp_act(seq, d, d_ff_expert, True) * top_k
    inter += a_expert
    if d_ff_shared:
        inter += _mlp_act(seq, d, d_ff_shared, True)
    if dense_residual_ff:
        inter += _mlp_act(seq, d, dense_residual_ff, True)
    inter += seq * n_experts * BYTES_ACT                    # router logits
    a_frac = a_expert / inter      # ratio unaffected by ACT_CALIBRATION
    inter *= ACT_CALIBRATION
    return LayerSpec(name=name, kind="moe", param_count=params,
                     flops_per_sample=flops, bnd_bytes_per_sample=bnd,
                     int_bytes_per_sample=inter, seq_len=seq,
                     tp_frac=(p_attn + p_expert + p_shared + p_dense) / params,
                     n_experts=n_experts, top_k=top_k,
                     expert_param_frac=p_expert / params,
                     expert_act_frac=a_frac,
                     expert_flops_frac=f_expert / flops,
                     capacity_factor=capacity_factor,
                     kv_bytes_per_sample=2 * seq * kv_dim * BYTES_ACT)


def ssm_layer(name: str, seq: int, d: int, *, d_state: int = 128,
              expand: int = 2, n_heads: int | None = None,
              d_conv: int = 4, has_mlp_ff: int = 0) -> LayerSpec:
    """Mamba2 (SSD) block; optionally followed by a gated MLP."""
    d_inner = expand * d
    headdim = 64
    nheads = n_heads if n_heads is not None else d_inner // headdim
    n_groups = 1
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + nheads
    p_in = d * d_in_proj
    p_conv = d_conv * (d_inner + 2 * n_groups * d_state)
    p_dt = nheads * 2                                     # dt bias, A_log
    p_out = d_inner * d
    p_norm = 2 * d + d_inner                              # pre-norm + gated norm
    p_mlp = 3 * d * has_mlp_ff if has_mlp_ff else 0
    params = p_in + p_conv + p_dt + p_out + p_norm + p_mlp

    flops = 2 * seq * d * d_in_proj
    flops += 2 * seq * d_conv * (d_inner + 2 * n_groups * d_state)
    # SSD chunked scan ~ 6 * seq * d_inner * d_state (state update + output)
    flops += 6 * seq * d_inner * d_state
    flops += 2 * seq * d_inner * d
    if has_mlp_ff:
        flops += _mlp_flops(seq, d, has_mlp_ff, True)

    bnd = seq * d * BYTES_ACT
    inter = seq * BYTES_ACT * (d + d_in_proj + 2 * d_inner + d)
    inter += seq * nheads * d_state * BYTES_ACT / 8       # chunk states (1/chunk)
    if has_mlp_ff:
        inter += _mlp_act(seq, d, has_mlp_ff, True)
    inter *= ACT_CALIBRATION
    return LayerSpec(name=name, kind="ssm", param_count=params,
                     flops_per_sample=flops, bnd_bytes_per_sample=bnd,
                     int_bytes_per_sample=inter, seq_len=seq,
                     tp_frac=(p_in + p_out + p_mlp) / params)


def embed_layer(name: str, seq: int, d: int, vocab: int, *,
                tied_head: bool = False) -> LayerSpec:
    params = vocab * d
    flops = 0.0    # gather
    bnd = seq * d * BYTES_ACT
    inter = seq * d * BYTES_ACT * ACT_CALIBRATION
    return LayerSpec(name=name, kind="embed", param_count=params,
                     flops_per_sample=flops, bnd_bytes_per_sample=bnd,
                     int_bytes_per_sample=inter, seq_len=seq, tp_frac=1.0)


def head_layer(name: str, seq: int, d: int, vocab: int) -> LayerSpec:
    params = vocab * d
    flops = 2 * seq * d * vocab
    bnd = seq * d * BYTES_ACT
    inter = seq * vocab * 4 * ACT_CALIBRATION   # logits fp32
    return LayerSpec(name=name, kind="head", param_count=params,
                     flops_per_sample=flops, bnd_bytes_per_sample=bnd,
                     int_bytes_per_sample=inter, seq_len=seq, tp_frac=1.0)


def cross_attn_extra(seq_q: int, seq_kv: int, d: int, n_heads: int,
                     n_kv: int, store_attn_matrix: bool) -> LayerSpec:
    """Extra cross-attention sublayer for encoder-decoder decoders."""
    d_head = d // n_heads
    kv_dim = n_kv * d_head
    params = d * d + 2 * d * kv_dim + d * d + 2 * d
    flops = 2 * seq_q * (d * d + d * d) + 2 * seq_kv * 2 * d * kv_dim
    flops += 2 * seq_q * seq_kv * d * 2
    bnd = seq_q * d * BYTES_ACT
    inter = (seq_q * (2 * d) + seq_kv * 2 * kv_dim) * BYTES_ACT
    if store_attn_matrix:
        inter += n_heads * seq_q * seq_kv * 2 * BYTES_ACT
    inter *= ACT_CALIBRATION
    return LayerSpec(name="cross_attn", kind="attn_mlp", param_count=params,
                     flops_per_sample=flops, bnd_bytes_per_sample=bnd,
                     int_bytes_per_sample=inter, seq_len=seq_q,
                     tp_frac=(params - 2 * d) / params)


def merge(name: str, *specs: LayerSpec) -> LayerSpec:
    """Fuse sublayer specs into one search-granularity layer."""
    return LayerSpec(
        name=name,
        kind=specs[0].kind,
        param_count=sum(s.param_count for s in specs),
        flops_per_sample=sum(s.flops_per_sample for s in specs),
        bnd_bytes_per_sample=specs[0].bnd_bytes_per_sample,
        int_bytes_per_sample=sum(s.int_bytes_per_sample for s in specs),
        seq_len=specs[0].seq_len,
        tp_frac=(sum(s.tp_frac * s.param_count for s in specs)
                 / max(1.0, sum(s.param_count for s in specs))),
        kv_bytes_per_sample=sum(s.kv_bytes_per_sample for s in specs),
        n_experts=max(s.n_experts for s in specs),
        top_k=max(s.top_k for s in specs),
        expert_param_frac=(sum(s.expert_param_frac * s.param_count for s in specs)
                           / max(1.0, sum(s.param_count for s in specs))),
        expert_act_frac=(sum(s.expert_act_frac * s.int_bytes_per_sample
                             for s in specs)
                         / max(1.0, sum(s.int_bytes_per_sample for s in specs))),
        expert_flops_frac=(sum(s.expert_flops_frac * s.flops_per_sample
                               for s in specs)
                           / max(1.0, sum(s.flops_per_sample for s in specs))),
        capacity_factor=max(s.capacity_factor for s in specs),
    )


def total_params(specs: List[LayerSpec]) -> float:
    return sum(s.param_count for s in specs)


def total_activation_bytes(specs: List[LayerSpec]) -> float:
    return sum(s.bnd_bytes_per_sample + s.int_bytes_per_sample for s in specs)
