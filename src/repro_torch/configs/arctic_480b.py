"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE
hybrid: 35 layers, 128 experts top-2 (d_ff=4864 per expert) with an
always-on dense residual branch."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

ARCTIC_480B = register(ModelConfig(
    name="arctic-480b", arch_type="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, dense_residual_ff=4864,
    rope_theta=1e6, norm_eps=1e-6,
))
