"""InternVL2-26B [arXiv:2404.16821] — InternViT (stub frontend) + InternLM2
language backbone.  The 48L/6144/48H (GQA kv=8) LM; the vision encoder
provides precomputed patch embeddings (256 a picture, of InternViT-6B's
width 3200), which a 2-layer MLP projector maps to the LM's width."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

INTERNVL2_26B = register(ModelConfig(
    name="internvl2-26b", arch_type="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    rope_theta=1e6, norm_eps=1e-5,
    vision_tokens=256, d_vision=3200,     # InternViT-6B hidden size
))
