"""Mamba2-370m [arXiv:2405.21060] — attention-free SSD (state-space
duality): 48 layers, d=1024, ssm_state=128."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

MAMBA2_370M = register(ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    norm_eps=1e-5, tie_embeddings=True,
))
