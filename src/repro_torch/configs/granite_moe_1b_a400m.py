"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE 32e top-8."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                    # per-expert FFN width
    vocab_size=49155,
    head_dim=64,
    n_experts=32,
    top_k=8,
    rope_theta=1e4,
)
