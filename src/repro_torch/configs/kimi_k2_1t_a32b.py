"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-parameter MoE: 61 layers,
384 experts, top-8 routing, d_ff(expert)=2048, one shared expert, first
layer dense (DeepSeek-V3-style layout)."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

KIMI_K2 = register(ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, shared_expert_ff=2048, first_k_dense=1,
    rope_theta=1e6, norm_eps=1e-6,
))
