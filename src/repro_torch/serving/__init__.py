"""Serving layer of the port: the slot, paged, speculative and
disaggregated engines, their executors, sampling."""

from repro_torch.serving.engine import (Engine, EngineStats, GenRequest,
                                        KVHandoff)
from repro_torch.serving.executor import (DisaggEngineExecutor,
                                          EngineExecutor, SpecEngineExecutor)
from repro_torch.serving.sampling import sample

__all__ = ["DisaggEngineExecutor", "Engine", "EngineStats", "EngineExecutor",
           "GenRequest", "KVHandoff", "SpecEngineExecutor", "sample"]
