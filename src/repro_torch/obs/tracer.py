"""Lifecycle spans over two clock domains (DESIGN.md §Observability).

A :class:`Span` is one closed interval of a request's (or a batch step's)
life: a name from the span taxonomy, the request id it belongs to (empty
for batch-scoped engine spans), the node/executor that produced it, start
and end timestamps, and free-form JSON-able attributes.  Spans carry a
``clock`` tag because the repo runs on two different time bases that must
never be mixed: the discrete-event simulator's ``EventLoop.now`` (seconds
of *simulated* time, shared by ``core`` and ``sim``) and the process wall
clock (``time.perf_counter``, used by the real engines in
``serving``).  The exporter keeps them apart as separate Perfetto
processes.

Two recording styles:

* **Explicit timestamps** (:meth:`Tracer.span` / :meth:`Tracer.event`)
  for the sim domain, where the caller already knows both endpoints from
  ``EventLoop.now`` and the request's stamped times.
* **Measured blocks** (:meth:`Tracer.wall`) for the serving domain: a
  context manager that ALWAYS measures ``perf_counter`` — its ``dt``
  feeds the ``EngineStats`` accumulators (``decode_wall_s``,
  ``decode_launch_s``, ...) whether or not tracing is on — and appends a
  span only when the tracer is enabled.  Blocks nest: a step's
  ``engine.decode_step`` holds its ``engine.decode.*`` parts.  This is
  the one sanctioned way to time a block in instrumented layers; the
  ``obs-lint/wall-clock`` rule (DESIGN.md §7) keeps raw
  ``time.perf_counter()`` calls from creeping back in.

``Span`` itself is constructed only inside ``repro.obs``
(``obs-lint/span-construction``, same pattern as the gossip
digest-construction rule): everything else goes through the ``Tracer``
API, so a disabled tracer really is a handful of attribute checks and
span streams stay well-formed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

# clock domains
_SIM = "sim"      # EventLoop.now — simulated seconds (core/sim layers)
_WALL = "wall"    # time.perf_counter — process seconds (serving layer)


@dataclass
class Span:
    """One closed interval ``[t0, t1]`` of a request's lifecycle.

    ``rid`` is the request id ("" for batch-scoped engine spans), ``who``
    the node or executor that produced it.  ``t0 == t1`` marks an instant
    event (``executor.admit``, ``executor.preempt``), which the exporter
    renders as a Perfetto instant rather than a zero-width slice.
    """

    name: str
    rid: str
    who: str
    t0: float
    t1: float
    clock: str = _SIM
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Append-only span sink; ``enabled=False`` is a cheap no-op.

    The default process-wide tracer (``get_tracer()``) starts disabled,
    so instrumented code pays one truthiness check per would-be span.
    Drivers that want a trace either ``set_tracer(Tracer())`` for the
    scope of a run or pass an explicit tracer to the objects they build.
    """

    __slots__ = ("enabled", "spans")

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.spans: List[Span] = []

    # ------------------------------------------------------------ recording
    def span(self, name: str, rid: str, who: str, t0: float, t1: float,
             clock: str = _SIM, **attrs: Any) -> None:
        """Record a completed interval with explicit endpoints (the sim
        domain's style: both times come from ``EventLoop.now``)."""
        if self.enabled:
            # repro: allow[obs-lint/span-construction] the port's own copy of repro.sim/obs
            self.spans.append(Span(name, rid, who, t0, t1, clock, attrs))

    def event(self, name: str, rid: str, who: str, t: float,
              clock: str = _SIM, **attrs: Any) -> None:
        """Record an instant (``t0 == t1``): admissions, preemptions."""
        if self.enabled:
            # repro: allow[obs-lint/span-construction] the port's own copy of repro.sim/obs
            self.spans.append(Span(name, rid, who, t, t, clock, attrs))

    def wall(self, name: str, rid: str = "", who: str = "",
             **attrs: Any) -> "WallSpan":
        """A measured wall-clock block (see :class:`WallSpan`)."""
        return WallSpan(self, name, rid, who, attrs)

    # ------------------------------------------------------------- reading
    def clear(self) -> None:
        self.spans.clear()


class WallSpan:
    """Timed wall-clock block: always measures, records when enabled.

    The measurement is unconditional because the serving layer's
    ``EngineStats`` accumulators (``decode_wall_s`` etc.) are fed from
    ``dt`` and must keep working with tracing off; only the span append
    is gated on the tracer.  Hand-rolled (no ``contextlib``) to keep the
    per-decode-step overhead to two clock reads and one allocation.
    """

    __slots__ = ("_tracer", "_name", "_rid", "_who", "_attrs", "t0", "t1")

    def __init__(self, tracer: Tracer, name: str, rid: str, who: str,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self._name = name
        self._rid = rid
        self._who = who
        self._attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0

    def __enter__(self) -> "WallSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.t1 = time.perf_counter()
        t = self._tracer
        if t.enabled:
            # repro: allow[obs-lint/span-construction] the port's own copy of repro.sim/obs
            t.spans.append(Span(self._name, self._rid, self._who,
                                self.t0, self.t1, _WALL, self._attrs))
        return False

    @property
    def dt(self) -> float:
        return self.t1 - self.t0


_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-wide default tracer (disabled until a driver swaps in
    an enabled one); instrumented objects resolve it at construction when
    not handed an explicit tracer."""
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-wide default; returns the one it
    replaced so drivers can restore it."""
    global _TRACER
    old, _TRACER = _TRACER, tracer
    return old


def wall_now() -> float:
    """The sanctioned wall clock for instrumented layers: request
    timestamps (``enqueued_at``/``started_at``/...) are stamped through
    this so the ``obs-lint/wall-clock`` rule can hold the serving layer
    to a single auditable time base."""
    return time.perf_counter()
