"""Serving layer of the port: the paged engine, its executor, sampling."""

from repro_torch.serving.engine import Engine, EngineStats, GenRequest
from repro_torch.serving.executor import EngineExecutor
from repro_torch.serving.sampling import sample

__all__ = ["Engine", "EngineStats", "EngineExecutor", "GenRequest", "sample"]
