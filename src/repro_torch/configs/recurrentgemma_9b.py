"""RecurrentGemma-9B [arXiv:2402.19427] — hybrid RG-LRU + local attention, 1:2."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                 # 12 x (rec, rec, attn) + 2-layer rec tail
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                # MQA in the local-attention blocks
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    rglru_width=4096,
    conv_width=4,
    local_window=2048,
    act="gelu",
)
