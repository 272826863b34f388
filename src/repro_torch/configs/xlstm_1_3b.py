"""xLSTM-1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks (7:1 pattern)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,                 # 6 x (7 mLSTM + 1 sLSTM)
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                      # blocks carry their own projections
    vocab_size=50304,
    head_dim=512,
    xlstm_pattern=("m",) * 7 + ("s",),
    xlstm_up_factor=2.0,
    conv_width=4,
)
