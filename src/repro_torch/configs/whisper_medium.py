"""Whisper-medium [arXiv:2212.04356] — encoder-decoder, 24+24 layers,
d=1024, 16 heads (MHA), GELU MLP d_ff=4096.  Conv/mel frontend is a stub:
the encoder consumes precomputed frame embeddings (1500 frames)."""
from repro_torch.configs import register
from repro_torch.models.common import ModelConfig

WHISPER_MEDIUM = register(ModelConfig(
    name="whisper-medium", arch_type="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    is_encoder_decoder=True, n_enc_layers=24, encoder_seq=1500,
    norm_eps=1e-5, tie_embeddings=True,
))
