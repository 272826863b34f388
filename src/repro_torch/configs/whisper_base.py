"""Whisper-base [arXiv:2212.04356] — enc-dec, conv frontend stubbed."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder layers
    n_encoder_layers=6,
    encoder_seq=1500,            # 30 s of audio after the (stub) conv frontend
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    norm_type="layernorm",
    act="gelu",
    use_bias=True,
    tie_embeddings=True,
)
