"""repro_torch.obs — the port's own copy of ``repro.obs`` (DESIGN.md
§Observability): lifecycle spans and the Perfetto/Chrome trace exporter
with the per-request latency breakdown.  The port keeps no metrics
registry: its counters are ``EngineStats``, the engines' prefix-cache
attributes and ``Network.msg_counts``."""

from repro_torch.obs.export import (breakdown_report, latency_breakdown,
                                    to_chrome_trace, write_chrome_trace)
from repro_torch.obs.tracer import (_SIM, _WALL, Span, Tracer, WallSpan,
                                    get_tracer, set_tracer, wall_now)

__all__ = [
    "_SIM", "_WALL", "Span", "Tracer", "WallSpan", "get_tracer",
    "set_tracer", "wall_now",
    "to_chrome_trace", "write_chrome_trace", "latency_breakdown",
    "breakdown_report",
]
