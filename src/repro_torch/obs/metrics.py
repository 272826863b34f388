"""Labeled counters/gauges/histograms (DESIGN.md §Observability).

The unified sink the repo's ad-hoc accumulators feed through: routing
message counts and drop/give-up events from ``core.network``, preemption
and prefix-cache counters from the engines.  Series are identified by a
metric name plus a sorted label set (``counter("net.msg", kind="probe")``),
so one metric fans out into per-kind/per-node series without string
mangling at the call sites.  ``snapshot()`` renders everything as a
JSON-able dict for bench payloads and test assertions.

Instruments are deliberately minimal — a counter is one float and an
``inc`` — because they sit on the simulator's hot paths (every routed
message); anything cleverer (rates, windows) belongs in the consumer.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Any, Dict, Tuple

# histogram defaults sized for request latencies in seconds
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level (queue depths, headroom)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Cumulative-bucket histogram with count and sum.

    ``bounds`` are upper bucket edges; observations above the last bound
    land in the implicit +inf bucket (tracked by ``count`` alone).
    """

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        i = bisect_left(self.bounds, v)
        if i < len(self.counts):
            self.counts[i] += 1
        self.count += 1
        self.sum += v


def _series_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """A namespace of labeled series, lazily created on first touch.

    Re-requesting a series with the same name+labels returns the same
    instrument (so call sites may cache it or not); requesting an
    existing series as a different instrument type is a bug and raises.
    """

    def __init__(self) -> None:
        self._series: Dict[str, Any] = {}

    def _get(self, cls: type, name: str, labels: Dict[str, Any],
             *args: Any) -> Any:
        key = _series_key(name, labels)
        inst = self._series.get(key)
        if inst is None:
            inst = self._series[key] = cls(*args)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"series {key!r} already registered as "
                f"{type(inst).__name__}, requested as {cls.__name__}")
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels, buckets)

    def snapshot(self) -> Dict[str, Any]:
        """Everything recorded so far as a JSON-able dict, keyed by the
        rendered series name (``name{label=value,...}``)."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for key in sorted(self._series):
            inst = self._series[key]
            if isinstance(inst, Counter):
                out["counters"][key] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][key] = inst.value
            else:
                out["histograms"][key] = {
                    "count": inst.count, "sum": inst.sum,
                    "bounds": list(inst.bounds),
                    "counts": list(inst.counts)}
        return out

    def value(self, name: str, **labels: Any) -> float:
        """Current value of a counter/gauge series (0.0 if never touched)
        — the test-friendly read path."""
        inst = self._series.get(_series_key(name, labels))
        return inst.value if inst is not None else 0.0

    def clear(self) -> None:
        self._series.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry; instrumented objects resolve it
    at construction when not handed an explicit one."""
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Install ``reg`` as the process-wide default; returns the old one."""
    global _REGISTRY
    old, _REGISTRY = _REGISTRY, reg
    return old
