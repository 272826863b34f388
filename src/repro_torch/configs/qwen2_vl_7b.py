"""Qwen2-VL-7B [arXiv:2409.12191] — VLM backbone, M-RoPE, dynamic resolution.

Vision encoder is a STUB: input_specs feeds precomputed patch embeddings and
(t, h, w) position triples; the language decoder with M-RoPE is implemented.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    mrope=True,
    mrope_sections=(16, 24, 24),
    embeds_input=True,
    rope_theta=1e6,
)
