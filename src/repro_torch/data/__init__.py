"""The port's own copy of ``repro.data`` (numpy only)."""

from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
