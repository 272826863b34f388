"""repro_torch.sim — the port's own copy of ``repro.sim``: the event loop,
workloads, metrics, the analytic service model and the simulated
executors (colocated, speculative, disaggregated) that the protocol
runs on."""

from repro_torch.sim.events import EventLoop
from repro_torch.sim.executor import (DisaggTokenBucketExecutor, Executor,
                                      ExecutorLoad, SpecTokenBucketExecutor,
                                      TokenBucketExecutor)
from repro_torch.sim.metrics import CompletedRequest, MetricsCollector
from repro_torch.sim.servicemodel import BackendProfile, make_profile
from repro_torch.sim.workload import (ArrivalPhase, Request, WorkloadSpec,
                                      make_requests, two_phase,
                                      uniform_phases)

__all__ = [
    "EventLoop", "Executor", "ExecutorLoad", "TokenBucketExecutor",
    "SpecTokenBucketExecutor", "DisaggTokenBucketExecutor",
    "CompletedRequest", "MetricsCollector",
    "BackendProfile", "make_profile", "ArrivalPhase", "Request",
    "WorkloadSpec", "make_requests", "two_phase", "uniform_phases",
]
