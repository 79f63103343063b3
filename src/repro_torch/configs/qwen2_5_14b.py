"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family card] — dense, GQA, QKV bias."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

QWEN2_5_14B = register(ModelConfig(
    name="qwen2.5-14b", arch_type="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, norm_eps=1e-6,
))
