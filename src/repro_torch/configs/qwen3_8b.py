"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA, QK-norm."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

QWEN3_8B = register(ModelConfig(
    name="qwen3-8b", arch_type="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1e6, norm_eps=1e-6,
))
