"""Command-R+ 104B [hf:CohereForAI/c4ai-command-r-v01] — dense, parallel block, no bias."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    norm_type="layernorm",
    parallel_block=True,         # Cohere parallel attention + FFN
    use_bias=False,
    rope_theta=7.5e4,
    tie_embeddings=True,
)
