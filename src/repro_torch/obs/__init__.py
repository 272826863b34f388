"""repro_torch.obs — the port's own copy of ``repro.obs`` (DESIGN.md
§Observability): lifecycle spans, the metrics registry, and the
Perfetto/Chrome trace exporter with the per-request latency breakdown."""

from repro_torch.obs.export import (breakdown_report, latency_breakdown,
                                    to_chrome_trace, write_chrome_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry,
                                     set_registry)
from repro_torch.obs.tracer import (_SIM, _WALL, Span, Tracer, WallSpan,
                                    get_tracer, set_tracer, wall_now)

__all__ = [
    "_SIM", "_WALL", "Span", "Tracer", "WallSpan", "get_tracer",
    "set_tracer", "wall_now",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "set_registry",
    "to_chrome_trace", "write_chrome_trace", "latency_breakdown",
    "breakdown_report",
]
