"""Zamba2-1.2B [arXiv:2411.15242] — hybrid: Mamba2 backbone with a
weight-SHARED full-attention block interleaved (here: every 6 SSM layers),
MHA (kv=32), ssm_state=64."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

ZAMBA2_1_2B = register(ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, shared_attention=True,
    rope_theta=10_000.0, norm_eps=1e-5, tie_embeddings=True,
))
