"""Qwen2-72B [arXiv:2407.10671] — dense, GQA (8 KV heads), QKV bias."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

QWEN2_72B = register(ModelConfig(
    name="qwen2-72b", arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, norm_eps=1e-6,
))
