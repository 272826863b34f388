"""SLO attainment, latency statistics, and windowed traces."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class CompletedRequest:
    rid: str
    origin: str
    executor: str
    arrival: float
    finish: float
    slo_s: float
    delegated: bool
    is_duel_extra: bool = False
    ttft: float = float("nan")        # arrival -> first output token
    queue_wait: float = float("nan")  # enqueue at executor -> admission

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def slo_met(self) -> bool:
        return self.latency <= self.slo_s


@dataclass
class MetricsCollector:
    completed: List[CompletedRequest] = field(default_factory=list)

    def record(self, c: CompletedRequest) -> None:
        self.completed.append(c)

    # -- aggregates (user traffic only; duel challengers/judges excluded) ----
    def _user(self) -> List[CompletedRequest]:
        return [c for c in self.completed if not c.is_duel_extra]

    def slo_attainment(self, scale: float = 1.0) -> float:
        """Fraction of user requests finishing within scale*slo threshold."""
        user = self._user()
        if not user:
            return 0.0
        return float(np.mean([c.latency <= scale * c.slo_s for c in user]))

    def slo_curve(self, scales: Sequence[float]) -> List[Tuple[float, float]]:
        """SLO-attainment vs threshold-scale curve (paper Fig 4 x-axis)."""
        return [(s, self.slo_attainment(s)) for s in scales]

    def avg_latency(self) -> float:
        user = self._user()
        return float(np.mean([c.latency for c in user])) if user else float("nan")

    def latency_percentile(self, p: float) -> float:
        user = self._user()
        return float(np.percentile([c.latency for c in user], p)) if user else float("nan")

    def latency_cdf(self, n: int = 200) -> List[Tuple[float, float]]:
        lats = np.sort([c.latency for c in self._user()])
        if lats.size == 0:
            return []
        qs = np.linspace(0, 1, n)
        return list(zip(np.quantile(lats, qs).tolist(), qs.tolist()))

    def windowed_latency(self, window: float, t_end: float) -> List[Tuple[float, float]]:
        """Windowed average latency by finish time (paper Fig 5 black line)."""
        out = []
        for t0 in np.arange(0.0, t_end, window):
            w = [c.latency for c in self._user() if t0 <= c.finish < t0 + window]
            if w:
                out.append((t0 + window / 2, float(np.mean(w))))
        return out

    def avg_ttft(self) -> float:
        vals = [c.ttft for c in self._user() if np.isfinite(c.ttft)]
        return float(np.mean(vals)) if vals else float("nan")

    def ttft_percentile(self, p: float) -> float:
        vals = [c.ttft for c in self._user() if np.isfinite(c.ttft)]
        return float(np.percentile(vals, p)) if vals else float("nan")

    def avg_queue_wait(self) -> float:
        vals = [c.queue_wait for c in self._user() if np.isfinite(c.queue_wait)]
        return float(np.mean(vals)) if vals else float("nan")

    def delegation_rate(self) -> float:
        user = self._user()
        return float(np.mean([c.delegated for c in user])) if user else 0.0

    def per_executor_counts(self, user_only: bool = True) -> Dict[str, int]:
        """Completions per executing node.  Like every other aggregate
        here this defaults to USER traffic — duel challengers/judges used
        to be counted too, which overstated duel-heavy nodes' share.
        ``user_only=False`` restores the raw count for duel accounting."""
        out: Dict[str, int] = {}
        for c in (self._user() if user_only else self.completed):
            out[c.executor] = out.get(c.executor, 0) + 1
        return out
