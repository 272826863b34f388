"""Serving layer of the port: the slot, paged and speculative engine, its
executors, sampling."""

from repro_torch.serving.engine import Engine, EngineStats, GenRequest
from repro_torch.serving.executor import EngineExecutor, SpecEngineExecutor
from repro_torch.serving.sampling import sample

__all__ = ["Engine", "EngineStats", "EngineExecutor", "GenRequest",
           "SpecEngineExecutor", "sample"]
