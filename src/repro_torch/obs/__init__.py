"""repro_torch.obs — the port's own copy of ``repro.obs`` (DESIGN.md
§Observability): lifecycle spans and the metrics registry.  The
Perfetto exporter (``repro.obs.export``) comes with ``--trace``
(ROADMAP Queue A item 5)."""

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
]
