"""Deterministic discrete-event loop.

The WWW.Serve experiments (paper Figs 4-8) ran on real GPUs over 750s of wall
clock.  We reproduce them with a seeded discrete-event simulator: protocol
logic (routing, gossip, ledger, duels) executes the *real* implementation;
only backend generation time is modeled (see ``sim.servicemodel``).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class EventLoop:
    """Minimal heapq-based event loop with deterministic tie-breaking."""

    def __init__(self) -> None:
        self._heap: List[_Event] = []
        self._seq = itertools.count()
        self.now: float = 0.0
        self._stopped = False

    def schedule(self, delay: float, fn: Callable[[], None]) -> _Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ev = _Event(self.now + delay, next(self._seq), fn)
        heapq.heappush(self._heap, ev)
        return ev

    def schedule_at(self, time: float, fn: Callable[[], None]) -> _Event:
        return self.schedule(max(0.0, time - self.now), fn)

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def stop(self) -> None:
        self._stopped = True

    def run(self, until: Optional[float] = None) -> float:
        """Run until the heap drains or ``until`` (sim seconds) is reached."""
        self._stopped = False
        while self._heap and not self._stopped:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if until is not None and ev.time > until:
                # put it back; caller may resume later
                heapq.heappush(self._heap, ev)
                self.now = until
                break
            self.now = ev.time
            ev.fn()
        else:
            if until is not None and self.now < until:
                self.now = until
        return self.now

    def pending(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)
