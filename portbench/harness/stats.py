"""The end-to-end arithmetic over one run's requests: percentiles over all
requests, failures counted, rates over the whole window."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass
class Served:
    """What the benchmark saw of one request, on its own clock (seconds
    after traffic started): when it was due, when its first token came
    back (the return of the step that sampled it), when it finished, and
    how many tokens it was given (steps from the first to the last token,
    both included)."""
    rid: str
    due: float
    first: Optional[float] = None
    finish: Optional[float] = None
    tokens: int = 0


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_values(reqs: Sequence[Served], end: float) -> List[float]:
    """First-token time minus due time of every request; one with no
    first token by ``end`` (the end of the run) is failed and counts as
    ``end - due``, the least it would have taken."""
    return [(r.first if r.first is not None else end) - r.due for r in reqs]


def tpot_values(reqs: Sequence[Served]) -> List[float]:
    """(finish - first token) / (tokens - 1) of every finished request with
    two tokens or more."""
    return [(r.finish - r.first) / (r.tokens - 1) for r in reqs
            if r.finish is not None and r.first is not None
            and r.tokens > 1]


def failed(reqs: Sequence[Served]) -> int:
    return sum(1 for r in reqs if r.finish is None)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles``' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def end_to_end(reqs: Sequence[Served], tokens_in_window: int,
               window_s: float, end: float) -> Dict[str, float]:
    """The run's user-side numbers over the window's requests."""
    out = {"ttft_p95_ms": percentile(ttft_values(reqs, end), 95) * 1e3,
           "output_tokens_per_s": tokens_in_window / window_s}
    tp = tpot_values(reqs)
    if tp:
        out["tpot_p95_ms"] = percentile(tp, 95) * 1e3
    return out
